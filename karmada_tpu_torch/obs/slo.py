"""SLO error budgets: declarative objectives + multi-window burn rates
(counterpart of the JAX package's ``obs/slo.py``).

Evaluates declarative objectives over the telemetry ring
(obs/timeseries) with the standard SRE multi-window burn-rate method:

  * An ``Objective`` is one of three kinds --
      ``latency``: a histogram family; a good event is an observation at
        or under ``threshold_s`` (judged from windowed bucket deltas, no
        raw samples needed);
      ``ratio``:   good fraction = 1 - bad_counter_delta / total_delta;
      ``zero``:    a counter whose windowed delta must be exactly 0
        (conservation violations).
  * Burn rate = (error fraction in window) / (1 - target): burn 1.0
    spends the budget exactly at the sustainable rate; the evaluator
    computes it over a SHORT window (the freshest ring fraction -- fast
    detection) and the LONG window (the whole retained ring).  An
    objective is unhealthy only when BOTH windows burn above 1.0 -- the
    multi-window rule that suppresses blips without missing sustained
    burn.
  * The regression watchdog compares live steady-state bindings/s
    (schedule-attempt counter deltas over the long window) against a
    baseline envelope and TRIPS A GAUGE -- never a crash.  The port's
    envelope loader reads only a path its caller gives: the port has no
    committed baseline of its own, so with no path the watchdog stays off.

Exported per evaluation: ``karmada_slo_healthy{slo}``,
``karmada_slo_burn_rate_milli{slo,window}``,
``karmada_slo_budget_remaining_milli{slo}``, and the watchdog's
``karmada_slo_regression_tripped`` / ``karmada_slo_live_bindings_per_s``.
Read back through ``state_payload()`` and the SOAK payload's ``slo``.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from karmada_tpu_torch.utils.metrics import REGISTRY, quantile_from_buckets

SLO_HEALTHY = REGISTRY.gauge(
    "karmada_slo_healthy",
    "1 while the objective's error budget is not burning in both "
    "windows (multi-window burn rate rule); 0 while it is",
    ("slo",),
)
SLO_BURN_MILLI = REGISTRY.gauge(
    "karmada_slo_burn_rate_milli",
    "Error-budget burn rate x1000 per objective and window (1000 = "
    "spending the budget exactly at the sustainable rate)",
    ("slo", "window"),
)
SLO_BUDGET_MILLI = REGISTRY.gauge(
    "karmada_slo_budget_remaining_milli",
    "Remaining error budget x1000 over the long window (1000 = "
    "untouched, 0 = exhausted)",
    ("slo",),
)
REGRESSION_TRIPPED = REGISTRY.gauge(
    "karmada_slo_regression_tripped",
    "1 while live steady-state bindings/s sits below the committed "
    "baseline envelope floor (the runtime regression watchdog)",
)
LIVE_BPS = REGISTRY.gauge(
    "karmada_slo_live_bindings_per_s",
    "Live scheduled-bindings throughput over the telemetry ring's long "
    "window (the regression watchdog's input)",
)

#: burn rates are capped here before export (a zero-total window with a
#: violation would otherwise be infinite; milli-gauges stay finite)
BURN_CAP = 1000.0


@dataclass(frozen=True)
class Objective:
    """One declarative objective."""

    name: str
    kind: str                       # latency | ratio | zero
    target: float = 0.99            # good-event fraction the SLO promises
    # latency kind: histogram family + the bound a good observation meets
    metric: str = ""
    threshold_s: float = 1.0
    # ratio/zero kinds: counter families summed across label sets; the
    # optional {label_name: value} filter restricts which sets count
    bad: Tuple[str, Optional[Tuple[Tuple[str, str], ...]]] = ("", None)
    total: Tuple[str, Optional[Tuple[Tuple[str, str], ...]]] = ("", None)

    def budget(self) -> float:
        return max(1.0 - self.target, 1e-9)


def default_objectives(schedule_deadline_s: float = 1.0,
                       dwell_deadline_s: Optional[float] = None,
                       shed_target: float = 0.99,
                       estimator_target: float = 0.99) -> Tuple[Objective, ...]:
    """The stock objective set: the <1s p99 schedule-latency north star,
    queue-dwell p99, the shed ratio, the conservation invariant, and the
    estimator error rate (errors per scheduling attempt).

    dwell_deadline_s defaults to TWICE the schedule bound: under
    deadline-based batch formation entries dwell at the batch deadline
    by design, so a dwell objective at the schedule bound itself would
    page on healthy coalescing.  Thresholds are judged conservatively
    at bucket resolution (the last histogram bound at or under the
    threshold) — an off-bucket threshold rounds the error fraction UP,
    never down."""
    if dwell_deadline_s is None:
        dwell_deadline_s = 2.0 * schedule_deadline_s
    return (
        Objective("schedule_p99", "latency", target=0.99,
                  metric="karmada_scheduler_e2e_scheduling_duration_seconds",
                  threshold_s=schedule_deadline_s),
        Objective("dwell_p99", "latency", target=0.99,
                  metric="karmada_scheduler_queue_dwell_seconds",
                  threshold_s=dwell_deadline_s),
        Objective("shed_ratio", "ratio", target=shed_target,
                  bad=("karmada_scheduler_admission_total",
                       (("decision", "shed"),)),
                  total=("karmada_scheduler_admission_total", None)),
        Objective("conservation", "zero",
                  bad=("karmada_rebalance_conservation_violations_total",
                       None)),
        Objective("estimator_errors", "ratio", target=estimator_target,
                  bad=("karmada_estimator_errors_total", None),
                  total=("karmada_scheduler_schedule_attempts_total", None)),
    )


def _counter_sum(snap: dict, name: str,
                 labels: Optional[Tuple[Tuple[str, str], ...]]) -> float:
    """Sum one counter family's value across its label sets, optionally
    filtered by {label_name: value} pairs."""
    fam = snap.get(name)
    if fam is None:
        return 0.0
    names = fam["labels"]
    want = dict(labels) if labels else {}
    total = 0.0
    for s in fam["samples"]:
        have = dict(zip(names, s["labels"]))
        if all(have.get(k) == v for k, v in want.items()):
            total += s["value"]
    return total


def _hist_fold(snap: dict, name: str) -> Tuple[int, List[int], List[float]]:
    """(total, cumulative bucket counts, bounds) of a histogram family
    summed across label sets."""
    fam = snap.get(name)
    if fam is None:
        return 0, [], []
    bounds = fam.get("bounds") or []
    total, cum = 0, [0] * len(bounds)
    for s in fam["samples"]:
        total += s["count"]
        for i, c in enumerate(s["buckets"]):
            cum[i] += c
    return total, cum, bounds


def _delta(a: float, b: float) -> float:
    """Counter delta between window ends, reset-aware (a restart makes
    the end value all increase)."""
    return b if b < a else b - a


class SloEvaluator:
    """Evaluates objectives over a MetricRing and exports the gauges."""

    def __init__(self, objectives: Optional[Sequence[Objective]] = None,
                 short_frac: float = 0.25,
                 watchdog: Optional["RegressionWatchdog"] = None) -> None:
        self.objectives = tuple(objectives if objectives is not None
                                else default_objectives())
        self.short_frac = min(max(short_frac, 0.01), 1.0)
        self.watchdog = watchdog
        self._lock = threading.Lock()
        self._last: dict = {"enabled": True, "objectives": [],
                            "regression": None}  # guarded-by: _lock; mutators: evaluate
        # incident-trigger edge state (evaluate-thread owned): triggers
        # fire on the healthy->unhealthy / watchdog-trip TRANSITIONS
        # only, never per unhealthy window
        self._prev_healthy: Optional[bool] = None
        self._prev_tripped = False

    # -- window math --------------------------------------------------------
    def _err_frac(self, obj: Objective, first: dict,
                  last: dict) -> Tuple[Optional[float], float]:
        """(error fraction, event total) for one window; fraction None
        when the window saw no qualifying events (no data != healthy)."""
        if obj.kind == "latency":
            t0, c0, bounds = _hist_fold(first, obj.metric)
            t1, c1, _ = _hist_fold(last, obj.metric)
            if t1 < t0:  # restart inside the window
                t0, c0 = 0, [0] * len(bounds)
            d_total = t1 - t0
            if d_total <= 0 or not bounds:
                return None, 0.0
            # good = observations <= the LAST bound at or under the
            # threshold (conservative: observations between that bound
            # and the threshold count as misses — bucket resolution
            # rounds the error fraction UP, never hides a miss)
            idx = None
            for i, b in enumerate(bounds):
                if b <= obj.threshold_s:
                    idx = i
            if idx is None:
                good = 0  # threshold under every bound: nothing provably good
            else:
                good = c1[idx] - (c0[idx] if c0 else 0)
            bad = max(0.0, d_total - good)
            return bad / d_total, float(d_total)
        bad = _delta(_counter_sum(first, *obj.bad),
                     _counter_sum(last, *obj.bad))
        if obj.kind == "zero":
            return (1.0 if bad > 0 else 0.0), bad
        total = _delta(_counter_sum(first, *obj.total),
                       _counter_sum(last, *obj.total))
        if total <= 0:
            return None, 0.0
        return min(bad / total, 1.0), total

    def _judge(self, obj: Objective,
               samples: List[Tuple[float, dict]]) -> dict:
        n = len(samples)
        short_n = max(2, int(round(self.short_frac * n)))
        windows = {"long": samples, "short": samples[-short_n:]}
        burn: Dict[str, Optional[float]] = {}
        frac: Dict[str, Optional[float]] = {}
        events: Dict[str, float] = {}
        for wname, w in windows.items():
            if len(w) < 2:
                burn[wname] = frac[wname] = None
                events[wname] = 0.0
                continue
            f, total = self._err_frac(obj, w[0][1], w[-1][1])
            frac[wname] = f
            events[wname] = total
            burn[wname] = (None if f is None
                           else min(f / obj.budget(), BURN_CAP))
        if obj.kind == "zero":
            healthy = (None if burn["long"] is None
                       else events["long"] == 0.0)
        elif burn["long"] is None and burn["short"] is None:
            healthy = None  # no data: reported, never asserted healthy
        else:
            # multi-window rule: unhealthy only when every window with
            # data burns above 1.0
            with_data = [b for b in (burn["short"], burn["long"])
                         if b is not None]
            healthy = not all(b > 1.0 for b in with_data)
        budget_rem = (None if frac["long"] is None else
                      max(0.0, 1.0 - frac["long"] / obj.budget()))
        rec = {
            "name": obj.name,
            "kind": obj.kind,
            "target": obj.target,
            "healthy": healthy,
            "burn_rate": {k: (None if v is None else round(v, 4))
                          for k, v in burn.items()},
            "error_fraction": {k: (None if v is None else round(v, 6))
                               for k, v in frac.items()},
            "events": {k: round(v, 1) for k, v in events.items()},
            "budget_remaining": (None if budget_rem is None
                                 else round(budget_rem, 4)),
        }
        if obj.kind == "latency":
            rec["threshold_s"] = obj.threshold_s
            # the window's estimated quantile rides along so the verdict
            # is inspectable, not just boolean
            t0, c0, bounds = _hist_fold(samples[0][1], obj.metric)
            t1, c1, _ = _hist_fold(samples[-1][1], obj.metric)
            if t1 < t0:
                t0, c0 = 0, [0] * len(bounds)
            d = [b - a for a, b in zip(c0 or [0] * len(bounds), c1)]
            p99 = quantile_from_buckets(bounds, d, t1 - t0, obj.target)
            rec["estimated_p"] = (None if t1 - t0 <= 0
                                  else round(float(p99), 6))
        # gauges: healthy None (no data) exports 1 — absence of traffic
        # must not page; the payload keeps the tri-state
        SLO_HEALTHY.set(0.0 if healthy is False else 1.0, slo=obj.name)
        for wname in ("short", "long"):
            if burn[wname] is not None:
                SLO_BURN_MILLI.set(round(burn[wname] * 1000.0),
                                   slo=obj.name, window=wname)
        if budget_rem is not None:
            SLO_BUDGET_MILLI.set(round(budget_rem * 1000.0), slo=obj.name)
        return rec

    def evaluate(self, ring) -> dict:
        """Judge every objective over the ring's current window, export
        the gauges, run the watchdog, and cache the payload for
        state_payload()."""
        samples = ring.samples()
        payload: dict = {
            "enabled": True,
            "window": {"samples": len(samples),
                       "span_s": (round(samples[-1][0] - samples[0][0], 6)
                                  if len(samples) >= 2 else 0.0),
                       "short_frac": self.short_frac},
            "objectives": [self._judge(o, samples) for o in self.objectives],
        }
        payload["healthy"] = all(o["healthy"] is not False
                                 for o in payload["objectives"])
        payload["regression"] = (self.watchdog.check(samples)
                                 if self.watchdog is not None else None)
        with self._lock:
            self._last = payload
        # incident triggers AFTER _lock releases: the bundle capture
        # reads last() and must not nest under the evaluator's lock
        from karmada_tpu_torch.obs import incidents as obs_incidents

        healthy = payload["healthy"]
        if healthy is False and self._prev_healthy is not False:
            obs_incidents.trigger(
                obs_incidents.TRIGGER_SLO_UNHEALTHY,
                "SLO transitioned healthy -> unhealthy",
                detail={"unhealthy": [o["name"] for o in
                                      payload["objectives"]
                                      if o["healthy"] is False]})
        self._prev_healthy = healthy
        tripped = bool(self.watchdog is not None and self.watchdog.tripped)
        if tripped and not self._prev_tripped:
            obs_incidents.trigger(
                obs_incidents.TRIGGER_REGRESSION,
                "regression watchdog tripped: live throughput under the "
                "baseline envelope floor",
                detail=payload["regression"])
        self._prev_tripped = tripped
        return payload

    def last(self) -> dict:
        with self._lock:
            return self._last


class RegressionWatchdog:
    """Trips a gauge when live steady-state throughput falls below the
    committed baseline envelope's floor.  Throughput under LIGHT load
    equals the arrival rate, not capability, so the watchdog judges
    only windows where the plane was actually BUSY — a standing active
    queue in at least ``min_busy_frac`` of the window's samples (the
    queue-depth gauge is in the same ring) — with real traffic
    (``min_window_bindings``).  "When there is standing work, the plane
    must clear it at no less than the envelope floor."  A trip is a
    GAUGE (+ payload detail), never an exception — the SLO plane
    observes regressions, it does not cause outages."""

    def __init__(self, baseline_bps: float, floor_frac: float = 0.02,
                 min_window_bindings: int = 256,
                 min_busy_frac: float = 0.5) -> None:
        self.baseline_bps = float(baseline_bps)
        self.floor_frac = float(floor_frac)
        self.min_window_bindings = int(min_window_bindings)
        self.min_busy_frac = float(min_busy_frac)
        self.tripped = False

    @property
    def floor_bps(self) -> float:
        return self.baseline_bps * self.floor_frac

    def check(self, samples) -> dict:
        rec = {"baseline_bps": round(self.baseline_bps, 1),
               "floor_bps": round(self.floor_bps, 1),
               "floor_frac": self.floor_frac,
               "live_bps": None, "window_bindings": 0.0,
               "busy_frac": None,
               "tripped": self.tripped}
        if len(samples) < 2:
            return rec
        (t0, first), (t1, last) = samples[0], samples[-1]
        span = t1 - t0
        labels = (("result", "scheduled"),)
        scheduled = _delta(
            _counter_sum(first, "karmada_scheduler_schedule_attempts_total",
                         labels),
            _counter_sum(last, "karmada_scheduler_schedule_attempts_total",
                         labels))
        busy = sum(
            1 for _, snap in samples
            if _counter_sum(snap, "karmada_scheduler_queue_depth",
                            (("queue", "active"),)) > 0)
        busy_frac = busy / len(samples)
        rec.update(window_bindings=round(scheduled, 1),
                   busy_frac=round(busy_frac, 3))
        if (span <= 0 or scheduled < self.min_window_bindings
                or busy_frac < self.min_busy_frac):
            return rec  # not a saturated window: keep the last verdict
        live = scheduled / span
        LIVE_BPS.set(round(live, 3))
        self.tripped = live < self.floor_bps
        REGRESSION_TRIPPED.set(1.0 if self.tripped else 0.0)
        rec.update(live_bps=round(live, 1), tripped=self.tripped)
        return rec


def load_baseline_envelope(path: Optional[str] = None) -> Optional[dict]:
    """A baseline envelope: the JSON file at `path` whose ``value`` is a
    steady-state bindings/s.  None when no path is given or the file is
    absent / unreadable -- the watchdog then stays disarmed, reported as
    such, never a crash."""
    import json

    if path is None:
        return None
    try:
        with open(path) as f:
            rec = json.load(f)
        value = float(rec.get("value") or 0.0)
    except (OSError, ValueError, TypeError, AttributeError):
        return None
    if value <= 0:
        return None
    return {"path": path, "bps": value, "metric": rec.get("metric")}


# -- process-wide evaluator ---------------------------------------------------
_ACTIVE: Optional[SloEvaluator] = None  # guarded-by: _ACTIVE_LOCK
_ACTIVE_LOCK = threading.Lock()


def configure(objectives: Optional[Sequence[Objective]] = None,
              short_frac: float = 0.25,
              watchdog: Optional[RegressionWatchdog] = None,
              baseline_path: Optional[str] = None,
              arm_watchdog: bool = True) -> SloEvaluator:
    """Arm the process-wide SLO evaluator.  With no explicit watchdog, the
    envelope at `baseline_path` arms the default one; no path (or no
    readable envelope) leaves the watchdog off (reported in the payload).
    ``arm_watchdog=False`` skips it entirely -- compressed virtual-time
    soaks are not the envelope's regime."""
    global _ACTIVE
    if watchdog is None and arm_watchdog:
        env = load_baseline_envelope(baseline_path)
        if env is not None:
            watchdog = RegressionWatchdog(env["bps"])
    ev = SloEvaluator(objectives, short_frac=short_frac, watchdog=watchdog)
    with _ACTIVE_LOCK:
        _ACTIVE = ev
    return ev


def active() -> Optional[SloEvaluator]:
    # lock-free read: the sampler consults this once per armed sample
    return _ACTIVE


def disarm() -> None:
    global _ACTIVE
    with _ACTIVE_LOCK:
        _ACTIVE = None


def state_payload() -> dict:
    """The SLO payload (the JAX package's /debug/slo): the most recent
    evaluation, or the disarmed marker so it can be polled
    unconditionally."""
    ev = active()
    if ev is None:
        return {"enabled": False, "objectives": []}
    return ev.last()
