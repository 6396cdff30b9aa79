"""The telemetry planes of the port -- obs/timeseries (the metric ring),
obs/slo (objectives, burn rates, the regression watchdog) and
obs/incidents (the flight ring, the trigger bus, the bundles) -- against
the JAX package's, on the CPU, tolerance 0.

- The ring over the same metric history (each package's own fresh
  Registry, the same increments): samples, throttling, out-of-order
  drops, eviction, `series_window`, `state_payload` (with and without
  points) and `counter_delta` equal.
- The SLO evaluator over the same histories -- latency, ratio and zero
  objectives, the default objective set, the no-data tri-state, the
  multi-window rule -- and the regression watchdog's trip and clear:
  payloads, exported gauges and the incident triggers they fire equal;
  `render_top` renders the same screen.  The envelope loader reads only
  the path it is given (the port has no committed baseline of its own).
- The incident plane: the flight ring (bounded, disarmable), the
  per-kind cooldown on an injected clock, the bounded index with its
  on-disk fallback, each bundle's sections (the JAX bundle's `locks`
  block is not part of the port), the InvariantViolation trigger and the
  reentrancy latch: equal, wall-clock fields masked.
- The Scheduler's hooks: a cycle lands one "cycle" flight record and a
  ring sample on the queue's clock; an incremental cycle an
  "incremental" record.
"""

import importlib
import json

import pytest

from torch_fixtures import collect_jax_planes  # noqa: F401 — autouse
from torch_soak import fresh_ledger

PKGS = ("karmada_tpu", "karmada_tpu_torch")


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


@pytest.fixture(autouse=True)
def _disarm_planes():
    yield
    for pkg in PKGS:
        mod(pkg, "obs.timeseries").disarm()
        mod(pkg, "obs.slo").disarm()
        mod(pkg, "obs.incidents").disarm()
        mod(pkg, "obs.incidents").configure_flight()
        mod(pkg, "chaos").disarm()


class _Clock:
    def __init__(self, t: float = 100.0) -> None:
        self.t = t

    def __call__(self) -> float:
        return self.t


# -- the ring -------------------------------------------------------------------

def _ring(pkg):
    M = mod(pkg, "utils.metrics")
    TS = mod(pkg, "obs.timeseries")
    r = M.Registry()
    c = r.counter("karmada_test_events_total", "events", ("kind",))
    g = r.gauge("karmada_test_depth", "depth")
    h = r.histogram("karmada_test_latency_seconds", "latency",
                    buckets=M.exponential_buckets(0.001, 2, 10))
    ring = TS.MetricRing(capacity=5, registry=r, min_interval_s=0.5)
    took = [ring.sample(0.0)]
    for i in range(1, 12):
        c.inc(i, kind="a" if i % 2 else "b")
        g.set(float(i * 3))
        h.observe(0.002 * i)
        took.append(ring.sample(i * 0.3))
    took.append(ring.sample(1.0, force=True))   # out of order: dropped
    took.append(ring.sample(10.0, force=True))
    TS._ACTIVE = ring  # noqa: SLF001 — the payload reads the active ring
    payload = TS.state_payload()
    summary = TS.state_payload(n=2, prefix="karmada_test_depth",
                               include_points=False)
    TS.disarm()
    deltas = TS.counter_delta([(0, 1.0), (1, 4.0), (2, 2.0), (3, 5.0)])
    return (took, [(t, json.dumps(s, sort_keys=True))
                   for t, s in ring.samples()], ring.dropped,
            ring.out_of_order, ring.window(), payload, summary, deltas)


def test_ring_and_series_equal():
    j, p = (_ring(pkg) for pkg in PKGS)
    assert p == j
    took, samples, dropped, ooo, window, payload, summary, deltas = p
    assert len(samples) == 5 and dropped > 0 and ooo == 1
    assert deltas == 8.0 and summary["series"]
    assert payload["enabled"] and payload["samples"] == 5


# -- the SLO evaluator ------------------------------------------------------------

def _slo(pkg):
    M = mod(pkg, "utils.metrics")
    TS = mod(pkg, "obs.timeseries")
    SLO = mod(pkg, "obs.slo")
    INC = mod(pkg, "obs.incidents")
    SM = mod(pkg, "scheduler.metrics")
    INC.configure(None, cooldown_s=0.0, clock=_Clock())
    r = M.Registry()
    e2e = r.histogram(SM.E2E_LATENCY.name, "e2e",
                      ("result", "schedule_type"),
                      buckets=list(SM.E2E_LATENCY.buckets))
    dwell = r.histogram(SM.QUEUE_DWELL.name, "dwell", ("origin",),
                        buckets=list(SM.QUEUE_DWELL.buckets))
    adm = r.counter("karmada_scheduler_admission_total", "adm",
                    ("decision",))
    cons = r.counter("karmada_rebalance_conservation_violations_total", "c")
    est = r.counter("karmada_estimator_errors_total", "e", ("kind",))
    att = r.counter("karmada_scheduler_schedule_attempts_total", "a",
                    ("result", "schedule_type"))
    depth = r.gauge("karmada_scheduler_queue_depth", "d", ("queue",))
    ring = TS.MetricRing(capacity=32, registry=r)
    wd = SLO.RegressionWatchdog(baseline_bps=500.0, floor_frac=0.5,
                                min_window_bindings=10)
    ev = SLO.SloEvaluator(SLO.default_objectives(schedule_deadline_s=0.5),
                          short_frac=0.25, watchdog=wd)
    ring.sample(-1.0, force=True)
    out = [ev.evaluate(ring)]  # one sample: every verdict None
    for i in range(12):
        t = float(i)
        bad_phase = 4 <= i < 9
        for _ in range(20):
            e2e.observe(2.0 if bad_phase else 0.1, result="scheduled",
                        schedule_type="reconcile")
            dwell.observe(0.2, origin="queue")
        adm.inc(20, decision="admitted")
        if bad_phase:
            adm.inc(3, decision="shed")
            est.inc(kind="timeout")
        if i == 7:
            cons.inc()
        att.inc(100 if i < 6 else 5, result="scheduled",
                schedule_type="reconcile")
        depth.set(4.0, queue="active")
        ring.sample(t, force=True)
        out.append(ev.evaluate(ring))
    gauges = {o.name: (SLO.SLO_HEALTHY.value(slo=o.name),
                       SLO.SLO_BURN_MILLI.value(slo=o.name, window="long"),
                       SLO.SLO_BUDGET_MILLI.value(slo=o.name))
              for o in ev.objectives}
    top = TS.render_top(
        {**_ts_payload(TS, ring), "enabled": True}, ev.last())
    disabled = TS.render_top({"enabled": False})
    SLO._ACTIVE = ev  # noqa: SLF001
    payload = SLO.state_payload()
    SLO.disarm()
    index = INC.state_payload()
    for e in index["incidents"]:
        e.pop("capture_s")
    return (out, gauges, SLO.REGRESSION_TRIPPED.value(),
            SLO.LIVE_BPS.value(), top, disabled, payload,
            SLO.state_payload(), index)


def _ts_payload(TS, ring):
    samples = ring.samples()
    return {"series": TS.series_window(samples),
            "window_s": samples[-1][0] - samples[0][0],
            "samples": len(samples), "dropped": ring.dropped}


def test_slo_evaluator_and_watchdog_equal():
    j, p = (_slo(pkg) for pkg in PKGS)
    assert p == j
    out, gauges, tripped, _, top, _, payload, off, index = p
    assert out[0]["objectives"][0]["healthy"] is None
    assert any(o["healthy"] is False for o in payload["objectives"])
    assert tripped == 1.0 and off == {"enabled": False, "objectives": []}
    assert {"slo-unhealthy", "regression-watchdog"} <= set(
        index["by_trigger"])
    assert "slo [BURN]" in top


def _envelope(pkg, tmp_path):
    SLO = mod(pkg, "obs.slo")
    good = tmp_path / f"{pkg}-good.json"
    good.write_text(json.dumps({"value": 1234.5, "metric": "bps"}))
    bad = tmp_path / f"{pkg}-bad.json"
    bad.write_text("not json")
    ev = SLO.configure(baseline_path=str(good))
    return (SLO.load_baseline_envelope(str(good))["bps"],
            SLO.load_baseline_envelope(str(bad)),
            SLO.load_baseline_envelope(str(tmp_path / "missing.json")),
            ev.watchdog.baseline_bps)


def test_baseline_envelope_from_a_given_path(tmp_path):
    """The envelope loader on a path it is given: the same envelope, and
    None for an unreadable or missing file, on both packages; the port
    reads no envelope unless given a path."""
    j, p = (_envelope(pkg, tmp_path) for pkg in PKGS)
    assert p[:3] == (1234.5, None, None)
    assert j[0] == p[0] and j[2] == p[2] and p[3] == 1234.5
    SLO = mod("karmada_tpu_torch", "obs.slo")
    assert SLO.load_baseline_envelope() is None
    assert SLO.configure().watchdog is None


# -- the incident plane --------------------------------------------------------------

def _mask(obj):
    """Bundle / index fields that read the wall clock or a path."""
    if isinstance(obj, dict):
        return {k: _mask(v) for k, v in obj.items()
                if k not in ("capture_s", "wall_unix", "path", "dir",
                             "trace_id") and not k.endswith("timestamp")}
    if isinstance(obj, list):
        return [_mask(v) for v in obj]
    return obj


def _incidents(pkg, tmp_path):
    with fresh_ledger(pkg):
        return _incidents_run(pkg, tmp_path)


def _incidents_run(pkg, tmp_path):
    INC = mod(pkg, "obs.incidents")
    G = mod(pkg, "analysis.guards")
    flight = INC.configure_flight(capacity=3)
    for i in range(5):
        INC.record("cycle", cycle_id=i, batch=i * 2)
    INC.arm_flight(False)
    off = INC.record("cycle", cycle_id=99)
    INC.arm_flight(True)
    clock = _Clock()
    disarmed = INC.trigger(INC.TRIGGER_CYCLE_FAULT, "x")
    store = INC.configure(str(tmp_path / pkg), cooldown_s=60.0, keep=2,
                          clock=clock)
    ids = [INC.trigger(INC.TRIGGER_CYCLE_FAULT, "first",
                       refs=["ns/a", ("ns", "b")], detail={"n": 1})]
    clock.t += 30.0
    ids.append(INC.trigger(INC.TRIGGER_CYCLE_FAULT, "suppressed"))
    ids.append(INC.trigger(INC.TRIGGER_BACKEND_DEGRADE, "other kind"))
    clock.t += 31.0
    ids.append(INC.trigger(INC.TRIGGER_CYCLE_FAULT, "after the cooldown"))
    G.InvariantViolation("a poisoned plane")
    ids.append("iv")
    with pytest.raises(AssertionError):
        store.trigger("no-such-kind")
    index = INC.state_payload()
    evicted = INC.bundle_payload(ids[0])  # from disk: the index kept 2
    last = INC.bundle_payload(ids[3])
    sections = sorted(last)
    INC.disarm()
    return (ids, off, disarmed, flight.stats(),
            [r["cycle_id"] for r in flight.snapshot()],
            _mask(index), _mask(evicted), _mask(last), sections,
            INC.state_payload()["enabled"])


def test_incident_plane_equal(tmp_path):
    j, p = (_incidents(pkg, tmp_path) for pkg in PKGS)
    # the JAX bundle's `locks` block (utils/locks) is not part of the port
    jl = list(j)
    for k in (6, 7):
        jl[k] = {key: v for key, v in j[k].items() if key != "locks"}
    jl[8] = [s for s in j[8] if s != "locks"]
    assert p == tuple(jl)
    ids, off, disarmed, stats, kept, index = p[:6]
    assert ids[1] is None and None not in (ids[0], ids[2], ids[3])
    assert off is False and disarmed is None
    assert stats == {"recorded": 5, "retained": 3, "capacity": 3}
    assert index["by_trigger"] == {"cycle-fault": 2, "backend-degrade": 1,
                                   "invariant-violation": 1}
    assert index["suppressed"] == {"cycle-fault": 1}
    assert len(index["incidents"]) == 2 and p[6]["summary"] == "first"


# -- the Scheduler's hooks -----------------------------------------------------------

def _cycle_hooks(pkg):
    INC = mod(pkg, "obs.incidents")
    TS = mod(pkg, "obs.timeseries")
    D = mod(pkg, "loadgen.driver")
    S = mod(pkg, "store.store")
    W = mod(pkg, "store.worker")
    Q = mod(pkg, "scheduler.queue")
    Sch = mod(pkg, "scheduler.service")
    flight = INC.configure_flight(capacity=64)
    clock = _Clock(5.0)
    ring = TS.configure(capacity=16)
    store, rt = S.ObjectStore(), W.Runtime()
    kw = {"device": "cpu"} if pkg == "karmada_tpu_torch" else {}
    Sch.Scheduler(store, rt, backend="device",
                  queue=Q.SchedulingQueue(now=clock), **kw)
    for i in range(2):
        store.create(D.build_cluster(f"h-m{i}"))
    for i in range(3):
        store.create(D.build_binding(f"h-b{i}"))
    rt.pump()
    clock.t += 1.0
    rt.tick()
    recs = [{k: r[k] for k in ("kind", "cycle_id", "popped", "batch",
                               "cut", "backend", "fault", "scheduled",
                               "unschedulable", "errors", "depths")}
            for r in flight.snapshot()]
    return recs, [t for t, _ in ring.samples()]


def test_scheduler_cycle_hooks_equal():
    j, p = (_cycle_hooks(pkg) for pkg in PKGS)
    assert p == j
    recs, times = p
    assert recs and recs[0]["kind"] == "cycle" and recs[0]["scheduled"] == 3
    assert times and times[0] == 5.0
