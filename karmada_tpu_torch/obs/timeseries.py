"""Metric time-series: a bounded ring sampler over the metric Registry
(counterpart of the JAX package's ``obs/timeseries.py``).

The in-process retention tier the SLO plane (obs/slo) computes burn
rates over:

  * ``MetricRing`` -- a bounded ring of ``(t, Registry.snapshot())``
    samples (structured dicts, no text-format round trip).  ``t`` is
    whatever clock the caller passes: the scheduler samples on its
    CYCLE clock (``SchedulingQueue.now``), which is the loadgen
    VirtualClock in compressed soaks -- a 10-minute synthetic soak
    produces a real 10-minute series in milliseconds of wall time.
  * ``maybe_sample(now)`` -- the hot-path hook (scheduler/service's
    cycle and its periodic flush).  Disarmed cost is one module-global
    read; armed, it refreshes the card's memory gauges (obs/devprof),
    appends one snapshot, and lets the armed SLO evaluator judge the
    fresh window.
  * ``series_window`` / ``state_payload`` -- flatten ring samples into
    per-series point lists (counters carry a reset-aware windowed delta;
    histograms flatten to ``_count`` / ``_sum`` series), and
    ``render_top`` the one-screen dashboard over that payload.

Armed by ``serve --telemetry[=RING]`` (cli) and directly via
``configure()``.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

from karmada_tpu_torch.utils.metrics import REGISTRY, Registry

SAMPLES_TOTAL = REGISTRY.counter(
    "karmada_telemetry_samples_total",
    "Metric-registry snapshots appended to the telemetry ring",
)
RING_DROPPED = REGISTRY.counter(
    "karmada_telemetry_ring_dropped_total",
    "Telemetry ring samples evicted by the capacity bound (oldest first)",
)


class MetricRing:
    """Bounded ring of (t, snapshot) samples over one Registry."""

    def __init__(self, capacity: int = 512, registry: Registry = REGISTRY,
                 min_interval_s: float = 0.0) -> None:
        self.capacity = max(2, int(capacity))
        self.registry = registry
        self.min_interval_s = float(min_interval_s)
        self._lock = threading.Lock()
        # guarded-by: _lock; mutators: sample
        self._ring: deque = deque(maxlen=self.capacity)
        self._dropped = 0      # guarded-by: _lock; mutators: sample
        self._out_of_order = 0  # guarded-by: _lock; mutators: sample
        self._last_t: Optional[float] = None  # guarded-by: _lock; mutators: sample

    def sample(self, now: float, force: bool = False,
               prepare=None) -> bool:
        """Append one snapshot stamped `now`.  Respects min_interval_s
        (on the SAMPLING clock, so virtual-time soaks pace on virtual
        time) unless `force`; returns whether a sample was taken.
        `prepare` runs only AFTER the throttle admits the sample and
        before the snapshot (per-sample refresh work — e.g. the memory
        gauges — must not be paid on throttled cycles).  The snapshot
        itself is taken OUTSIDE the ring lock — family locks already
        make it consistent, and a slow dashboard read of the ring must
        not stall the scheduler's cycle worker here."""
        with self._lock:
            if (not force and self._last_t is not None
                    and self.min_interval_s > 0
                    and now - self._last_t < self.min_interval_s):
                return False
            self._last_t = now
        if prepare is not None:
            prepare()
        snap = self.registry.snapshot()
        with self._lock:
            if self._ring and float(now) < self._ring[-1][0]:
                # two threads (cycle worker + periodic flush) can pass
                # the throttle concurrently and finish their snapshots
                # out of order; appending the stale one would break the
                # ring's time monotonicity and read as a counter reset
                # to counter_delta (inflating window deltas and burn
                # rates).  Drop the late arrival — the newer snapshot
                # already covers it.
                self._out_of_order += 1
                return False
            if len(self._ring) == self._ring.maxlen:
                self._dropped += 1
                RING_DROPPED.inc()
            self._ring.append((float(now), snap))
        SAMPLES_TOTAL.inc()
        return True

    def samples(self, n: Optional[int] = None) -> List[Tuple[float, dict]]:
        """The most recent n samples (all when n is None), oldest first.
        n=0 really means zero — never the whole-ring [-0:] surprise."""
        with self._lock:
            out = list(self._ring)
        if n is None:
            return out
        n = int(n)
        return out[-n:] if n > 0 else []

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    @property
    def out_of_order(self) -> int:
        with self._lock:
            return self._out_of_order

    def window(self) -> Tuple[Optional[float], Optional[float], int]:
        """(t_first, t_last, count) of the retained window."""
        with self._lock:
            if not self._ring:
                return None, None, 0
            return self._ring[0][0], self._ring[-1][0], len(self._ring)


def counter_delta(points: Sequence[Tuple[float, float]]) -> float:
    """Windowed increase of a counter series, reset-aware: a restarted
    process re-registers its counters at 0, so a drop between adjacent
    points is a reset and the post-reset value is all increase — the
    window delta never goes negative and never swallows pre-reset
    growth (the Prometheus increase() contract)."""
    delta = 0.0
    prev: Optional[float] = None
    for _, v in points:
        if prev is not None:
            delta += v if v < prev else v - prev
        prev = v
    return delta


def _key(name: str, label_names: Sequence[str],
         label_values: Sequence[str]) -> str:
    if not label_names:
        return name
    inner = ",".join(f'{n}="{v}"' for n, v in zip(label_names, label_values))
    return f"{name}{{{inner}}}"


def series_window(samples: Sequence[Tuple[float, dict]],
                  prefix: Optional[str] = None) -> Dict[str, dict]:
    """Flatten ring samples into per-series point lists:

        {series_key: {"type": ..., "points": [[t, v], ...],
                      "delta": windowed increase   # counters
                      "last": last value}}         # gauges

    Histogram families flatten to their ``<name>_count`` and
    ``<name>_sum`` derived series (both counter-semantics).  A series
    absent from early samples (labels born mid-window) starts at its
    first appearance.  `prefix` filters family names."""
    series: Dict[str, dict] = {}
    for t, snap in samples:
        for name, fam in snap.items():
            if prefix and not name.startswith(prefix):
                continue
            ftype = fam["type"]
            for s in fam["samples"]:
                if ftype == "histogram":
                    pairs = ((f"{name}_count", float(s["count"]), "counter"),
                             (f"{name}_sum", float(s["sum"]), "counter"))
                else:
                    pairs = ((name, float(s["value"]), ftype),)
                for sname, val, stype in pairs:
                    k = _key(sname, fam["labels"], s["labels"])
                    rec = series.setdefault(
                        k, {"type": stype, "points": []})
                    rec["points"].append([round(t, 6), val])
    for rec in series.values():
        if rec["type"] == "counter":
            rec["delta"] = round(counter_delta(rec["points"]), 6)
        else:
            rec["last"] = rec["points"][-1][1]
    return series


# -- the process-wide sampler -------------------------------------------------
_ACTIVE: Optional[MetricRing] = None  # guarded-by: _ACTIVE_LOCK
_ACTIVE_LOCK = threading.Lock()


def configure(capacity: int = 512, registry: Registry = REGISTRY,
              min_interval_s: float = 0.0) -> MetricRing:
    """Arm the process-wide telemetry ring (serve --telemetry)."""
    global _ACTIVE
    ring = MetricRing(capacity, registry, min_interval_s)
    with _ACTIVE_LOCK:
        _ACTIVE = ring
    return ring


def active() -> Optional[MetricRing]:
    with _ACTIVE_LOCK:
        return _ACTIVE


def disarm() -> None:
    global _ACTIVE
    with _ACTIVE_LOCK:
        _ACTIVE = None
    from karmada_tpu_torch.obs import slo as obs_slo

    obs_slo.disarm()


def maybe_sample(now: float) -> bool:
    """The scheduler hot-path hook: one module-global read when
    disarmed; armed, refresh the per-device memory gauges (devprof —
    the "per guarded cycle" contract), append one ring sample, and run
    the armed SLO evaluator over the fresh window."""
    # lock-free read on the hot path (an atomic reference in CPython):
    # the disarmed serve cycle must pay one global read, not a lock
    # acquisition — the same discipline as the chaos plane's seams
    ring = _ACTIVE
    if ring is None:
        return False
    from karmada_tpu_torch.obs import devprof, slo as obs_slo

    # the memory refresh rides the ring's throttle (prepare runs only
    # on admitted samples): a plane cycling every few ms must not poll
    # the card's memory_stats() per cycle when the ring keeps one sample
    # per --telemetry-interval
    took = ring.sample(now, prepare=devprof.refresh_memory_gauges)
    if took:
        ev = obs_slo.active()
        if ev is not None:
            ev.evaluate(ring)
    return took


def state_payload(n: Optional[int] = None,
                  prefix: Optional[str] = None,
                  include_points: bool = True) -> dict:
    """The time-series payload (the JAX package's /debug/timeseries).
    include_points=False strips the per-series point lists and keeps only
    the window aggregates (delta / last) -- a dashboard summary must not
    serialize the whole ring per poll."""
    ring = active()
    if ring is None:
        return {"enabled": False, "samples": 0, "series": {}}
    samples = ring.samples(n)
    t0, t1, count = ring.window()
    series = series_window(samples, prefix=prefix)
    if not include_points:
        for rec in series.values():
            rec.pop("points", None)
    return {
        "enabled": True,
        "capacity": ring.capacity,
        "min_interval_s": ring.min_interval_s,
        "samples": count,
        "returned_samples": len(samples),
        "dropped": ring.dropped,
        "out_of_order": ring.out_of_order,
        "window_s": (round(t1 - t0, 6)
                     if t0 is not None and t1 is not None else 0.0),
        "t_first": t0,
        "t_last": t1,
        "series": series,
    }


# -- the one-screen dashboard -------------------------------------------------

def _fmt_rate(delta: float, window_s: float, unit: str = "/s") -> str:
    if window_s <= 0:
        return "-"
    return f"{delta / window_s:.1f}{unit}"


def render_top(ts_payload: dict, slo_payload: Optional[dict] = None) -> str:
    """One-screen live dashboard over a time-series payload (+ the
    optional SLO verdict): queue depths, the cycle budget
    breakdown (where a second of scheduling goes, from the per-step
    latency histogram), the h2d binding-field counter, and shed /
    eviction rates over the retained window."""
    if not ts_payload.get("enabled"):
        return ("telemetry plane is disabled on the server "
                "(serve --telemetry to arm the ring sampler)")
    series = ts_payload.get("series") or {}
    window = float(ts_payload.get("window_s") or 0.0)
    lines = [
        f"telemetry window {window:.3f}s "
        f"({ts_payload.get('samples')} sample(s), "
        f"{len(series)} series, dropped {ts_payload.get('dropped')})",
    ]

    def gauge(key):
        rec = series.get(key)
        return rec.get("last") if rec else None

    def delta(key) -> float:
        rec = series.get(key)
        return float(rec.get("delta") or 0.0) if rec else 0.0

    depths = {q: gauge(f'karmada_scheduler_queue_depth{{queue="{q}"}}')
              for q in ("active", "backoff", "unschedulable")}
    lines.append("  queue depth  " + "  ".join(
        f"{q}={int(v) if v is not None else '-'}"
        for q, v in depths.items()))
    # cycle budget: per-step solve-time share over the window
    steps = ("Encode", "H2D", "Solve", "D2H", "Decode", "Serial")
    step_d = {
        st: delta("karmada_scheduler_scheduling_algorithm_duration_seconds"
                  f'_sum{{schedule_step="{st}"}}')
        for st in steps}
    total = sum(step_d.values())
    if total > 0:
        lines.append("  cycle budget " + "  ".join(
            f"{st}={d / total:.0%}" for st, d in step_d.items() if d > 0))
    else:
        lines.append("  cycle budget (no solver traffic in window)")
    attempts = delta("karmada_scheduler_schedule_attempts_total"
                     '{result="scheduled",schedule_type="reconcile"}')
    lines.append(
        f"  scheduled {int(attempts)} ({_fmt_rate(attempts, window)}); "
        f"h2d binding fields "
        f"{int(delta('karmada_solver_h2d_binding_fields_total'))}")
    shed = delta('karmada_scheduler_admission_total{decision="shed"}')
    admitted = delta('karmada_scheduler_admission_total{decision="admitted"}')
    evict = sum(rec.get("delta") or 0.0 for k, rec in series.items()
                if k.startswith("karmada_rebalance_evictions_total"))
    lines.append(f"  admission admitted={int(admitted)} shed={int(shed)} "
                 f"({_fmt_rate(shed, window)}); "
                 f"rebalance evictions={int(evict)}")
    if slo_payload and slo_payload.get("enabled"):
        for obj in slo_payload.get("objectives", []):
            mark = {True: "OK ", False: "BURN", None: "n/a "}[
                obj.get("healthy")]
            lines.append(
                f"  slo [{mark}] {obj['name']}: "
                f"burn short={obj.get('burn_rate', {}).get('short')} "
                f"long={obj.get('burn_rate', {}).get('long')} "
                f"budget {obj.get('budget_remaining')}")
        watchdog = slo_payload.get("regression")
        if watchdog:
            lines.append(
                f"  regression watchdog: tripped={watchdog.get('tripped')} "
                f"live={watchdog.get('live_bps')} bindings/s "
                f"floor={watchdog.get('floor_bps')}")
    return "\n".join(lines)
