"""Flight-recorder, metrics and lifecycle-ledger parity: the port's
obs/trace, obs/recorder, obs/export, obs/events, utils/metrics and
scheduler/metrics against the JAX package's, tolerance 0.

The same calls go to both packages' objects: span trees (names, parents,
attributes; times and ids masked), the ring's eviction and drop count,
the slowest-N shelf, a zombie's late spans, the text waterfall and the
stage aggregates of one trace (a fixed trace dict, so its times are
exact), the ledger's coalescing, eviction, timelines and cursors on an
injected clock, and the metrics primitives' text exposition.  Then one
compressed ServeSlice soak of each package: the scheduler.cycle span
attributes (the strides included) and the span name -> count equal.

The soaks run through tests/torch_soak.soak, which holds the
Schedulers' host clock still: both Schedulers floor each binding's e2e
sample at its cycle's wall seconds, which would make the samples depend
on the host's load.  It also holds back their wall-clock deferred-cut
timer, which would add a no-op cycle at a point the host's load sets;
`test_soak_starts_no_cut_timer` pins that.
"""

import json

import pytest

from torch_fixtures import collect_jax_planes  # noqa: F401 — autouse
from torch_soak import PKGS, mod, soak


def both(fn, *args):
    return [fn(pkg, *args) for pkg in PKGS]


# -- trace trees ------------------------------------------------------------

def _masked(trace):
    """A trace dict without times and ids: names, parent names, attrs."""
    by_id = {s["span_id"]: s for s in trace["spans"]}
    spans = sorted(
        (s["name"],
         by_id[s["parent_id"]]["name"] if s["parent_id"] in by_id else None,
         json.dumps(s["attrs"], sort_keys=True, default=str))
        for s in trace["spans"])
    return {"root": trace["root"], "cancelled": trace["cancelled"],
            "n": len(trace["spans"]), "spans": spans}


def _tree_calls(pkg):
    obs = mod(pkg, "obs")
    tracer = obs.trace.Tracer()
    assert tracer.start_span("off") is obs.NOOP_SPAN  # disabled: the no-op
    assert not obs.NOOP_SPAN
    rec = tracer.configure(capacity=8, slow_keep=2)
    with tracer.span("root", a=1) as root:
        with tracer.span("child", b=2) as ch:
            ch.set_attr(c=3)
            with tracer.span("grandchild"):
                pass
        explicit = tracer.start_span("explicit", parent=root, d=4)
        explicit.end(e=5)
        dangling = tracer.start_span("dangling", parent=root)
        parent = tracer.current()
    # a zombie touching a finalized trace is ignored
    late = tracer.start_span("late", parent=parent)
    assert late is obs.NOOP_SPAN
    dangling.end()  # after the root ended: no record
    with tracer.span("second"):
        try:
            with tracer.span("fails"):
                raise KeyError("boom")
        except KeyError:
            pass
    with tracer.attach(None):
        pass
    out = [_masked(t) for t in rec.recent()]
    tracer.disable()
    assert tracer.start_span("after") is obs.NOOP_SPAN
    return out


def test_span_trees_equal():
    j, p = both(_tree_calls)
    assert p == j
    assert p[0]["n"] == 5 and ("dangling", "root", '{"unfinished": true}') \
        in p[0]["spans"]
    assert p[1]["spans"][0][2] == json.dumps({"error": "KeyError('boom')"})


def _attach_calls(pkg):
    import threading

    obs = mod(pkg, "obs")
    tracer = obs.trace.Tracer()
    rec = tracer.configure(capacity=4)
    with tracer.span("cycle"):
        parent = tracer.current()

        def run():
            with tracer.attach(parent):
                with tracer.span("on-thread"):
                    pass

        t = threading.Thread(target=run)
        t.start()
        t.join()
    return [_masked(tr) for tr in rec.recent()]


def test_thread_attach_parents_across_threads():
    j, p = both(_attach_calls)
    assert p == j
    assert ("on-thread", "cycle", "{}") in p[0]["spans"]


def _trace(i, dur):
    return {"trace_id": f"t{i:06x}", "root": "scheduler.cycle",
            "start_unix": 1.0 + i, "duration_s": dur, "cancelled": False,
            "spans": [{"name": "scheduler.cycle", "span_id": 1,
                       "parent_id": None, "start_s": 0.0, "end_s": dur,
                       "attrs": {"bindings": i}}]}


def _ring_calls(pkg):
    R = mod(pkg, "obs.recorder").TraceRecorder
    rec = R(capacity=3, slow_keep=2)
    durs = [0.5, 0.1, 0.9, 0.3, 0.7, 0.2]
    for i, d in enumerate(durs):
        rec.record(_trace(i, d))
    return {"recent": [t["trace_id"] for t in rec.recent()],
            "slowest": [t["trace_id"] for t in rec.slowest()],
            "dropped": rec.dropped, "stats": rec.stats(),
            "get_ring": rec.get("t000005")["duration_s"],
            "get_shelf": rec.get("t000002")["duration_s"],
            "get_gone": rec.get("t000001"),
            "floor": R(capacity=0, slow_keep=-1).stats()}


def test_ring_eviction_drops_and_slowest_shelf():
    j, p = both(_ring_calls)
    assert p == j
    assert p["dropped"] == 3 and p["slowest"] == ["t000002", "t000004"]


def _pipeline_trace():
    spans = [
        ("scheduler.cycle", 1, None, 0.0, 0.010, {"bindings": 64,
                                                   "backend": "device"}),
        ("pipeline.cycle", 2, 1, 0.0005, 0.0095, {"items": 64}),
        ("pipeline.chunk", 3, 2, 0.001, 0.006, {"index": 0}),
        ("pipeline.encode", 4, 3, 0.001, 0.002, {}),
        ("pipeline.dispatch", 5, 3, 0.002, 0.0025, {}),
        ("pipeline.chunk", 6, 2, 0.0021, 0.009, {"index": 1}),
        ("pipeline.encode", 7, 6, 0.0021, 0.0035, {}),
        ("pipeline.solve_wait", 8, 3, 0.0035, 0.0045, {}),
        ("pipeline.d2h", 9, 3, 0.0045, 0.005, {}),
        ("pipeline.decode", 10, 3, 0.005, 0.006, {"ratio": 0.123456789}),
        ("orphan", 11, 99, 0.007, 0.008, {}),
    ]
    return {"trace_id": "t00abcd", "root": "scheduler.cycle",
            "start_unix": 12.5, "duration_s": 0.010, "cancelled": False,
            "spans": [{"name": n, "span_id": i, "parent_id": pi,
                       "start_s": a, "end_s": b, "attrs": at}
                      for n, i, pi, a, b, at in spans]}


def _export_calls(pkg):
    E = mod(pkg, "obs.export")
    R = mod(pkg, "obs.recorder").TraceRecorder
    tr = _pipeline_trace()
    rec = R(capacity=4)
    rec.record(tr)
    return {"summary": E.summarize(tr), "json": E.to_json(tr),
            "stages": E.stage_summary(tr),
            "all": E.stage_summary(tr, prefix=""),
            "timeline": E.latest_pipeline_timeline(rec),
            "none": E.latest_pipeline_timeline(None),
            "waterfall": E.render_waterfall(tr),
            "narrow": E.render_waterfall(tr, width=12, label_width=10)}


def test_export_waterfall_and_stage_aggregates_equal():
    j, p = both(_export_calls)
    assert p == j
    assert "pipeline.solve_wait" in p["waterfall"]


def _masked_waterfall(text):
    import re

    return re.sub(r"[0-9.]+ms", "<ms>", re.sub(r"\|[ #]*\|", "|<bar>|",
                                                text))


def test_waterfall_of_a_recorded_trace_equal_with_times_masked():
    def run(pkg):
        obs = mod(pkg, "obs")
        tracer = obs.trace.Tracer()
        rec = tracer.configure(capacity=2)
        with tracer.span(obs.SPAN_CYCLE, bindings=3):
            with tracer.span(obs.SPAN_PIPELINE):
                with tracer.span(obs.SPAN_ENCODE):
                    pass
        text = mod(pkg, "obs.export").render_waterfall(rec.recent()[0])
        return _masked_waterfall(text.split("\n", 1)[1])

    j, p = both(run)
    assert p == j


def test_span_vocabulary_equal():
    j, p = (mod(pkg, "obs") for pkg in PKGS)
    assert p.SPAN_NAMES == j.SPAN_NAMES
    assert p.PIPELINE_STAGE_SPANS == j.PIPELINE_STAGE_SPANS
    assert p.SPAN_RECONCILE_PREFIX == j.SPAN_RECONCILE_PREFIX
    assert len(set(p.SPAN_NAMES)) == len(p.SPAN_NAMES)


# -- the lifecycle ledger -----------------------------------------------------

class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        self.t += 0.5
        return self.t


def _ledger_calls(pkg):
    E = mod(pkg, "obs.events")
    led = E.EventLedger(capacity=5, now=_Clock())
    ids = []
    for i in range(3):  # coalesces on the tail
        ids.append(led.record(E.SCHEDULER_REF, E.TYPE_NORMAL,
                              E.REASON_BATCH_FORMED, "cut", cycle_id=i))
    ref = E.ObjectRef(kind="ResourceBinding", namespace="ns", name="a")
    for i in range(6):
        ids.append(led.record(ref, E.TYPE_WARNING, E.REASON_BINDING_SHED,
                              f"shed {i}", origin="admission"))
    led.link_decision(ids[-1], 42)
    return {"ids": ids,
            "list": [e.to_dict() for e in led.list()],
            "timeline": led.timeline("ResourceBinding", "ns", "a"),
            "sched": led.timeline("Scheduler", "", "scheduler"),
            "recent": led.recent(n=3), "since": led.recent(n=2, since=5),
            "zero": led.recent(n=0), "counters": led.counters()}


def test_event_ledger_coalesces_evicts_and_pages_equal():
    j, p = both(_ledger_calls)
    assert p == j
    assert p["counters"]["evicted"] == 2 and p["counters"]["coalesced"] == 2


def _process_ledger_calls(pkg):
    E = mod(pkg, "obs.events")
    U = mod(pkg, "utils.events")
    prev = E.ledger()
    try:
        E.configure(capacity=16, now=_Clock())
        E.emit_key(("ns", "b"), E.TYPE_NORMAL, E.REASON_BINDING_ENQUEUED,
                   "enqueued", origin="active")
        E.emit_key("odd-key", E.TYPE_NORMAL, E.REASON_BINDING_ENQUEUED,
                   "enqueued")
        E.disarm()
        assert E.emit(E.SCHEDULER_REF, E.TYPE_NORMAL,
                      E.REASON_BATCH_FORMED, "off") is None
        assert U.EventRecorder().event(E.SCHEDULER_REF, E.TYPE_NORMAL,
                                       E.REASON_BATCH_FORMED, "off") is None
        private = U.EventRecorder(capacity=4, now=_Clock())
        assert private.private
        private.event(E.SCHEDULER_REF, E.TYPE_NORMAL,
                      E.REASON_BATCH_FORMED, "private")
        E.arm()
        prev_clock = E.set_clock(_Clock())
        E.emit(E.SCHEDULER_REF, E.TYPE_WARNING, E.REASON_CYCLE_FAULT, "x")
        E.set_clock(prev_clock)
        return {"state": E.state_payload(n=8),
                "timeline": E.timeline_payload("ns", "b"),
                "private": [e.to_dict() for e in private.list()],
                "armed": E.armed()}
    finally:
        E.arm()
        E._LEDGER[0] = prev  # noqa: SLF001 — restore the process ledger


def test_process_ledger_arm_disarm_and_payloads_equal():
    j, p = both(_process_ledger_calls)
    assert p == j
    assert p["state"]["stats"]["recorded"] == 3


# -- metrics primitives ---------------------------------------------------------

def _metrics_calls(pkg):
    M = mod(pkg, "utils.metrics")
    reg = M.Registry()
    c = reg.counter("t_total", 'a "quoted"\nhelp', ("k",))
    c.inc(k="a")
    c.inc(2.5, k='b"\\')
    assert reg.counter("t_total") is c
    g = reg.gauge("t_gauge", "g")
    g.set(3)
    g.add(-1.5)
    h = reg.histogram("t_hist", "h", ("stage",),
                      buckets=[0.5, 0.1, 0.1, float("inf"), 2])
    for v in (0.05, 0.3, 1.0, 7.0):
        h.observe(v, stage="x")
    with pytest.raises(ValueError):
        c.inc(j="wrong")
    return {"dump": reg.dump(), "snap": reg.snapshot(),
            "q": [h.quantile(x, stage="x") for x in (0.25, 0.5, 0.99)],
            "count": h.count(stage="x"), "sum": h.sum(stage="x"),
            "total": c.total(), "buckets": M.exponential_buckets(0.001, 2, 5),
            "qfb": [M.quantile_from_buckets([1, 2], [1, 3], 3, 0.9),
                    M.quantile_from_buckets([1, 2], [0, 0], 0, 0.5)]}


def test_metrics_primitives_exposition_equal():
    j, p = both(_metrics_calls)
    q_nan_j, q_nan_p = j["qfb"].pop(), p["qfb"].pop()
    assert q_nan_j != q_nan_j and q_nan_p != q_nan_p  # NaN on both
    assert p == j


def test_scheduler_metric_families_equal():
    """Every family of scheduler/metrics: name, type, labels, buckets."""
    def fams(pkg):
        sm = mod(pkg, "scheduler.metrics")
        out = {}
        for attr in dir(sm):
            m = getattr(sm, attr)
            if hasattr(m, "TYPE") and hasattr(m, "label_names"):
                out[attr] = (m.name, m.TYPE, m.label_names, m.help,
                             list(getattr(m, "buckets", [])))
            elif attr.isupper() and isinstance(m, str):
                out[attr] = m
        return out

    j, p = both(fams)
    assert p == j
    for name in ("QUEUE_INCOMING", "QUEUE_DEPTH", "QUEUE_OLDEST_AGE",
                 "ADMISSION", "BATCH_SIZE", "OVERLOAD_MODE",
                 "SCHEDULE_ATTEMPTS", "E2E_LATENCY", "STEP_LATENCY",
                 "UNSCHEDULABLE", "CYCLE_FAULTS", "BACKEND_DEGRADED",
                 "BACKEND_REARMED", "PRIORITY_PUSHES"):
        assert name in p


# -- one soak of each package: cycle spans ------------------------------------

def soak_traces(pkg, name, backend="serial"):
    return soak(pkg, name, backend)[1].recorder.recent()


def _cycle_attrs(traces):
    return [s["attrs"] for t in traces for s in t["spans"]
            if s["name"] == "scheduler.cycle"]


def _name_counts(traces):
    out = {}
    for t in traces:
        for s in t["spans"]:
            out[s["name"]] = out.get(s["name"], 0) + 1
    return out


@pytest.mark.parametrize("name", ["steady", "storm"])
def test_serve_slice_cycle_spans_equal(name):
    j, p = both(soak_traces, name)
    assert _cycle_attrs(p) == _cycle_attrs(j)
    assert _name_counts(p) == _name_counts(j)
    attrs = _cycle_attrs(p)
    assert attrs and all({"bindings", "backend", "dwell_samples",
                          "dwell_stride", "e2e_samples", "e2e_stride",
                          "overload"} <= set(a) for a in attrs)
    assert [t["root"] for t in p] == [t["root"] for t in j]


class _CountingTimers:
    """A threading module whose Timer only counts its start() calls (a
    stand-in put into both packages' scheduler/service modules)."""

    def __init__(self):
        import threading

        self._threading = threading
        self.started = 0
        outer = self

        class Timer:
            daemon = True

            def __init__(self, *args, **kwargs):
                pass

            def start(self):
                outer.started += 1

            def cancel(self):
                pass

        self.Timer = Timer

    def __getattr__(self, name):
        return getattr(self._threading, name)


def test_soak_starts_no_cut_timer(monkeypatch):
    """A storm soak through tests/torch_soak.soak arms the Schedulers'
    wall-clock deferred-cut timer in neither package: the soak holds it
    back, so a loaded host cannot add a no-op cycle (the storm case of
    test_serve_slice_cycle_spans_equal).  Without the hold each package
    starts at least one timer here."""
    counting = _CountingTimers()
    for pkg in PKGS:
        monkeypatch.setattr(mod(pkg, "scheduler.service"), "threading",
                            counting)
    for pkg in PKGS:
        payload = soak(pkg, "storm")[0]
        assert payload["scheduled"] > 0
    assert counting.started == 0


def test_device_cycle_spans_cover_the_pipeline_stages():
    """The device backend (the port on device="cpu"): every cycle span
    has its pipeline stages under it, named and counted as the JAX
    package's are."""
    j, p = both(soak_traces, "megafleet", "device")
    assert _name_counts(p) == _name_counts(j)
    assert _cycle_attrs(p) == _cycle_attrs(j)
    names = set(_name_counts(p))
    obs = mod("karmada_tpu_torch", "obs")
    assert set(obs.PIPELINE_STAGE_SPANS) <= names
    assert obs.SPAN_PIPELINE in names and obs.SPAN_CHUNK in names


def test_tracer_off_is_the_default_and_costs_no_span():
    obs = mod("karmada_tpu_torch", "obs")
    assert obs.TRACER.recorder is None
    assert obs.TRACER.start_span(obs.SPAN_CYCLE) is obs.NOOP_SPAN
