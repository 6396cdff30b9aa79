"""The debug server (utils/httpserve.ObservabilityServer) and the CLI
verbs that read it, of the port against the JAX package's, on the CPU
(the port on device="cpu"), tolerance 0 (after tests/test_obs_http.py
and tests/test_observability_http.py).

Both packages' servers run over planes built from the same seed, each
bound to port 0 on 127.0.0.1 and stopped by a fixture.  Every route of
the JAX server's `_route` answers the same status, content type and
body on both, with these masks (`masked`):

- WALL_KEYS: fields that read the wall clock wherever they appear (the
  ledger's and the fire log's stamps, capture and wall seconds);
- the resident and rebalance payloads drop the keys one package alone
  reports (tests/torch_soak.PORT_ONLY / JAX_ONLY: the card the port's
  planes live on; the JAX device plane's fallback flags);
- /debug/state's `device_probe`, `aot` and `locks` blocks are compared
  by their keys and `shortlist` by its `active` flag: their values are
  process-wide history (the probe, the warm hook, the live locks the
  rest of the suite left in each registry, the tier's lifetime
  counters, which the JAX server reports only once its tier's module
  was imported);
- rendered screens whose numbers read the wall clock (the rebalance
  budget's window age, the incident index's capture seconds) are held
  equal per server (both CLIs), their payloads across servers;
- /debug/profile's record is each package's own profiler: the status
  codes (200, 400, 409) are compared, and the port's record holds its
  chrome trace and kernel names.

Unknown ids answer a JSON 404 body, a handler exception a JSON 500, a
disarmed plane {"enabled": false}.  The explain and trace recorders are
injected (`ObservabilityServer(recorder=, decisions=)`): the JAX
package's process-wide decision recorder is never armed (its Scheduler's
`configure` is replaced by one returning a private recorder).  /whatif
moves no placement.

The verbs (events, describe --endpoint, explain, trace, resident,
rebalance, whatif, incidents, loadgen --endpoint, profile) run from both
CLIs against both servers: each server's answers print the same on both
CLIs (ages masked), and the same on both servers where the payloads are
equal.
"""

import contextlib
import importlib
import json
import re
import threading
import urllib.error
import urllib.request

import pytest

import torch_loop as TL
import torch_soak as TS
from torch_fixtures import collect_jax_planes  # noqa: F401 — autouse
from torch_loop import deterministic_uids  # noqa: F401 — autouse

PKGS = TS.PKGS
JAX, PORT = PKGS

#: fields that read the wall clock, dropped wherever they appear
WALL_KEYS = frozenset({
    "ts", "wall_s", "wall_unix", "at_unix", "capture_s", "held_for_s",
    "first_timestamp", "last_timestamp", "start_unix",
    "last_scheduled_time", "dir", "path",
    "t",  # a flight record's wall stamp
})
#: /debug/state blocks compared by their keys (module docstring)
STATE_BY_KEYS = ("device_probe", "aot", "locks")


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def masked(obj, drop=frozenset()):
    if isinstance(obj, dict):
        return {k: masked(v, drop) for k, v in obj.items()
                if k not in WALL_KEYS and k not in drop}
    if isinstance(obj, list):
        return [masked(v, drop) for v in obj]
    return obj


def _disarm_all():
    for pkg in PKGS:
        mod(pkg, "chaos").disarm()
        for name in ("obs.timeseries", "obs.slo", "obs.incidents"):
            mod(pkg, name).disarm()
        mod(pkg, "resident").set_active(None)
        mod(pkg, "rebalance").set_active(None)
        mod(pkg, "facade").set_active(None)
        mod(pkg, "loadgen.driver").set_active(None)
        mod(pkg, "obs").TRACER.disable()


@pytest.fixture(autouse=True)
def _planes(monkeypatch):
    """Every plane of both packages disarmed around each test, fresh
    flight rings, and the JAX package's process-wide decision recorder
    read as disarmed here (a test elsewhere in the process may have armed
    it)."""
    monkeypatch.setattr(mod(JAX, "obs.decisions"), "_RECORDER", [None])
    mod(JAX, "ops.tensors")._FLEET_CAP_MEMO.clear()  # noqa: SLF001
    _disarm_all()
    for pkg in PKGS:
        # fresh flight rings: the process rings hold earlier tests' cycles
        mod(pkg, "obs.incidents").configure_flight()
    yield
    _disarm_all()


@contextlib.contextmanager
def serving(pkg, **kw):
    srv = mod(pkg, "utils.httpserve").ObservabilityServer(**kw)
    base = srv.start(port=0)
    try:
        yield base
    finally:
        srv.stop()


def get(base, path):
    """(status, content type, body): JSON bodies parsed."""
    try:
        with urllib.request.urlopen(base + path, timeout=60) as r:
            code, ctype, raw = r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        code, ctype, raw = e.code, e.headers["Content-Type"], e.read()
    text = raw.decode()
    return code, ctype, (json.loads(text) if ctype == "application/json"
                         else text)


def routes(bases, paths, drop=frozenset()):
    """{pkg: [(path, status, ctype, masked body)]} over `paths`."""
    out = {}
    for pkg, base in bases.items():
        rows = []
        for path in paths:
            code, ctype, body = get(base, path)
            rows.append((path, code, ctype, masked(body, drop)))
        out[pkg] = rows
    return out


@contextlib.contextmanager
def both_serving(kw_of=lambda pkg: {}):
    with serving(JAX, **kw_of(JAX)) as jb, serving(PORT, **kw_of(PORT)) as pb:
        yield {JAX: jb, PORT: pb}


_AGE = re.compile(r"^\d+(\.\d+)?[smh](?=\s)", re.M)


def cli(pkg, argv, capsys):
    capsys.readouterr()
    try:
        rc = mod(pkg, "cli").main(argv)
    except SystemExit as e:
        rc = e.code
    out = capsys.readouterr()
    return rc, _AGE.sub("AGE", out.out), out.err


def verbs_equal(bases, argv, capsys, across=True):
    """`argv` (ENDPOINT replaced) from both CLIs against both servers:
    per server equal on both CLIs; with `across`, equal across servers
    too.  Returns the port CLI's answer from the port server."""
    answers = {}
    for srv, base in bases.items():
        args = [base if a == "ENDPOINT" else a for a in argv]
        j, p = (cli(pkg, args, capsys) for pkg in PKGS)
        assert p == j, (srv, argv)
        answers[srv] = p
    if across:
        assert answers[PORT] == answers[JAX], argv
    return answers[PORT]


# -- disarmed planes -------------------------------------------------------------

DISARMED = [
    "/healthz", "/readyz", "/debug/traces", "/debug/traces/slow",
    "/debug/traces/nosuchtrace", "/debug/traces/nosuchtrace?format=json",
    "/debug/load", "/debug/resident", "/debug/resident?recent=5",
    "/debug/chaos", "/debug/rebalance", "/debug/facade",
    "/whatif?query=placement", "/debug/timeseries", "/debug/slo",
    "/debug/incidents", "/debug/incidents/inc-nosuch", "/debug/explain",
    "/debug/explain/default/nosuchbinding", "/debug/events",
    "/debug/events/default/nosuchbinding", "/debug/events/no-slash",
    "/debug/nosuchendpoint", "/nosuchpath",
]


@pytest.mark.parametrize("path", DISARMED)
def test_disarmed_routes_equal(path):
    """No plane armed, no recorder injected, fresh ledgers: the same
    status, content type and body on both servers."""
    with TS.fresh_ledger(JAX), TS.fresh_ledger(PORT), both_serving() as b:
        got = routes(b, [path])
    assert got[PORT] == got[JAX]
    _, code, ctype, body = got[PORT][0]
    if path.startswith("/debug/") and code == 404:
        assert ctype == "application/json" and body["error"]
    if path == "/whatif?query=placement":
        assert code == 503 and body["enabled"] is False


def _state_by_keys(state):
    out = {k: (sorted(v) if k in STATE_BY_KEYS and isinstance(v, dict)
               else v) for k, v in state.items()}
    out["shortlist"] = state["shortlist"]["active"]
    return out


def test_state_disarmed_equal():
    with TS.fresh_ledger(JAX), TS.fresh_ledger(PORT), both_serving() as b:
        got = {pkg: get(base, "/debug/state") for pkg, base in b.items()}
    j, p = (got[pkg] for pkg in PKGS)
    assert p[:2] == j[:2] == (200, "application/json")
    assert _state_by_keys(p[2]) == _state_by_keys(j[2])
    assert p[2]["mesh"] == {"enabled": False, "shape": None, "devices": 1,
                            "platform": None}
    assert p[2]["locks"]["armed"] is False


def test_metrics_health_and_readiness():
    """/metrics is the registry's exposition (the port's with the
    karmada_lock_* families); /readyz follows the probe (503 when not
    ready) on both servers."""
    ready = {"ok": True}
    with both_serving(lambda pkg: {"ready_probe": lambda: ready["ok"]}) as b:
        metrics = {pkg: get(base, "/metrics") for pkg, base in b.items()}
        ok = routes(b, ["/readyz", "/healthz"])
        ready["ok"] = False
        not_ok = routes(b, ["/readyz"])
    assert metrics[PORT][:2] == metrics[JAX][:2] == (
        200, "text/plain; version=0.0.4")
    assert "karmada_lock_hold_seconds" in metrics[PORT][2]
    assert ok[PORT] == ok[JAX] and not_ok[PORT] == not_ok[JAX]
    assert not_ok[PORT][0][1:] == (503, "text/plain", "not ready")


def test_handler_exception_answers_json_500(monkeypatch):
    for pkg in PKGS:
        def boom():
            raise RuntimeError("boom")

        monkeypatch.setattr(mod(pkg, "chaos"), "state_payload", boom)
    with both_serving() as b:
        got = routes(b, ["/debug/chaos"])
    assert got[PORT] == got[JAX]
    assert got[PORT][0][1:] == (500, "application/json",
                                {"error": "RuntimeError('boom')"})


# -- a control plane: /debug/state, events, explain ---------------------------------

def _world(pkg, monkeypatch):
    """One package's control plane (serial backend, the explain plane
    armed on every cycle) with three members, a policy and two
    deployments, ticked to quiescence, then one deployment scaled past
    the fleet: (plane, its decision recorder)."""
    M = TL.MJ if pkg == JAX else TL.MP
    if pkg == JAX:
        rec = mod(JAX, "obs.decisions").DecisionRecorder()
        # the JAX Scheduler arms the process-wide recorder through
        # configure(): hand it a private one instead
        monkeypatch.setattr(mod(JAX, "obs.decisions"), "configure",
                            lambda *a, **k: rec)
    cp = TL.plane(M, "serial", explain=1.0)
    for name, cpu in (("m1", 8_000), ("m2", 4_000), ("m3", 2_000)):
        cp.add_member(name, cpu_milli=cpu)
    cp.tick()
    cp.apply_policy(_policy(M))
    for name, replicas in (("web", 6), ("api", 3)):
        cp.apply(_deployment(name, replicas))
    cp.tick()
    cp.apply(_deployment("api", 400))
    cp.tick()
    return cp, (rec if pkg == JAX else cp.scheduler.decisions)


def _deployment(name, replicas):
    return {"apiVersion": "apps/v1", "kind": "Deployment",
            "metadata": {"name": name, "namespace": "default"},
            "spec": {"replicas": replicas, "template": {"spec": {
                "containers": [{"name": "c", "image": "nginx",
                                "resources": {"requests": {
                                    "cpu": "500m"}}}]}}}}


def _policy(M):
    rs = M.ReplicaSchedulingStrategy(
        replica_scheduling_type=M.REPLICA_SCHEDULING_DIVIDED,
        replica_division_preference=M.REPLICA_DIVISION_WEIGHTED,
        weight_preference=M.ClusterPreferences(
            dynamic_weight=M.DYNAMIC_WEIGHT_AVAILABLE_REPLICAS))
    return M.PropagationPolicy(
        metadata=M.ObjectMeta(name="pp", namespace="default"),
        spec=M.PropagationSpec(
            resource_selectors=[M.ResourceSelector(api_version="apps/v1",
                                                   kind="Deployment")],
            placement=M.Placement(replica_scheduling=rs)))


@contextlib.contextmanager
def world_serving(monkeypatch):
    """Both packages' worlds in fresh ledgers, each behind its server
    (store and decision recorder injected)."""
    with TS.fresh_ledger(JAX), TS.fresh_ledger(PORT):
        worlds = {pkg: _world(pkg, monkeypatch) for pkg in PKGS}
        with both_serving(lambda pkg: {
                "store": worlds[pkg][0].store,
                "decisions": worlds[pkg][1]}) as b:
            yield b, worlds


WORLD_ROUTES = [
    "/debug/events", "/debug/events?n=3", "/debug/events?since=4",
    "/debug/events?n=bad", "/debug/events/default/web-deployment",
    "/debug/events/default/api-deployment", "/debug/explain",
    "/debug/explain/default/web-deployment",
    "/debug/explain/default/api-deployment",
    "/debug/explain/default/nosuchbinding",
]


def test_world_routes_equal(monkeypatch):
    """Events and explain over the same control plane: the timelines,
    the decisions, and their cross-links (a decision's event_id, an
    event's decision_id) equal on both servers; /debug/state's store
    and ledger blocks too."""
    with world_serving(monkeypatch) as (b, worlds):
        got = routes(b, WORLD_ROUTES)
        state = {pkg: get(base, "/debug/state")[2]
                 for pkg, base in b.items()}
    assert got[PORT] == got[JAX]
    bodies = {path: body for path, _, _, body in got[PORT]}
    web = bodies["/debug/events/default/web-deployment"]
    assert web["binding"]["clusters"] and web["events"]
    linked = [e for e in web["events"] if e["decision_id"] is not None]
    assert linked and web["decision"]["event_id"] == linked[-1]["id"]
    api = bodies["/debug/explain/default/api-deployment"]
    assert api["outcome"] != "scheduled" and api["event_id"] is not None
    assert bodies["/debug/explain"]["unschedulable"]
    j, p = (_state_by_keys(state[pkg]) for pkg in PKGS)
    assert p == j
    assert p["objects_by_kind"]["Cluster"] == 3 and p["explain"]


WORLD_VERBS = [
    ["events", "--endpoint", "ENDPOINT"],
    ["events", "--endpoint", "ENDPOINT", "--limit", "4"],
    ["events", "default/web-deployment", "--endpoint", "ENDPOINT"],
    ["events", "web-deployment", "--endpoint", "ENDPOINT"],
    ["describe", "default/api-deployment", "--endpoint", "ENDPOINT"],
    ["describe", "ResourceBinding", "web-deployment", "-n", "default",
     "--endpoint", "ENDPOINT"],
    ["describe", "nons", "--endpoint", "ENDPOINT"],
    ["explain", "--endpoint", "ENDPOINT"],
    ["explain", "default/web-deployment", "--endpoint", "ENDPOINT"],
    ["explain", "default/nosuch", "--endpoint", "ENDPOINT"],
    ["explain", "default/web-deployment"],
]


@pytest.mark.parametrize("argv", WORLD_VERBS, ids=" ".join)
def test_world_verbs_equal(argv, monkeypatch, capsys):
    with world_serving(monkeypatch) as (b, _):
        rc, out, err = verbs_equal(b, argv, capsys)
    if "nosuch" in " ".join(argv) or "nons" in argv or (
            "--endpoint" not in argv) or argv[1] == "web-deployment":
        assert rc == 1 and err
    else:
        assert rc == 0 and out


# -- traces ----------------------------------------------------------------------

def _trace(i, dur):
    return {"trace_id": f"t{i:06x}", "root": "scheduler.cycle",
            "start_unix": 1.0 + i, "duration_s": dur, "cancelled": False,
            "spans": [{"name": "scheduler.cycle", "span_id": 1,
                       "parent_id": None, "start_s": 0.0, "end_s": dur,
                       "attrs": {"bindings": i}},
                      {"name": "pipeline.chunk", "span_id": 2,
                       "parent_id": 1, "start_s": 0.1 * dur,
                       "end_s": 0.9 * dur, "attrs": {"index": 0}}]}


def _recorder(pkg):
    rec = mod(pkg, "obs.recorder").TraceRecorder(capacity=4, slow_keep=2)
    for i, d in enumerate([0.5, 0.1, 0.9, 0.3, 0.7, 0.2]):
        rec.record(_trace(i, d))
    return rec


TRACE_ROUTES = ["/debug/traces", "/debug/traces/slow",
                "/debug/traces/t000005", "/debug/traces/t000005?format=json",
                "/debug/traces/t000002", "/debug/traces/t000001",
                "/debug/state"]
TRACE_VERBS = [
    ["trace", "--endpoint", "ENDPOINT"],
    ["trace", "--endpoint", "ENDPOINT", "--slow"],
    ["trace", "--endpoint", "ENDPOINT", "t000005"],
    ["trace", "--endpoint", "ENDPOINT", "t000001"],
]


def test_trace_routes_and_verbs_equal(capsys):
    """An injected flight recorder: the ring, the slowest shelf, one trace
    as a waterfall and as JSON, an evicted id (404), /debug/state's
    `traces`; and `karmadactl trace` from both CLIs."""
    with both_serving(lambda pkg: {"recorder": _recorder(pkg)}) as b:
        got = routes(b, TRACE_ROUTES)
        answers = [verbs_equal(b, argv, capsys) for argv in TRACE_VERBS]
    j, p = ([(path, code, ctype, _state_by_keys(body)
              if path == "/debug/state" else body)
             for path, code, ctype, body in got[pkg]] for pkg in PKGS)
    assert p == j
    assert p[2][1:3] == (200, "text/plain") and "pipeline.chunk" in p[2][3]
    assert p[5][1] == 404
    assert p[6][3]["traces"]["recent"] == 4
    assert [a[0] for a in answers] == [0, 0, 0, 1]
    assert "t000005" in answers[0][1] and "|" in answers[2][1]


def test_trace_verb_reports_a_disabled_tracer(capsys):
    with both_serving() as b:
        rc, _, err = verbs_equal(b, ["trace", "--endpoint", "ENDPOINT"],
                                 capsys)
    assert rc == 1 and "tracing is disabled" in err


# -- the resident plane -------------------------------------------------------------

def test_resident_route_and_verb_equal(capsys):
    """The resident planes of the same churn stream (tests/
    test_torch_resident's `mixed` case) registered in both packages:
    /debug/resident with and without per-cycle records equal but for the
    keys one package alone reports; `karmadactl resident` from both
    CLIs."""
    import test_torch_resident as TR

    fleets = {JAX: TR._stream(TR.JAX, "mixed")[1],  # noqa: SLF001
              PORT: TR._stream(TR.PORT, "mixed")[1]}  # noqa: SLF001
    for pkg in PKGS:
        mod(pkg, "resident").set_active(fleets[pkg].fused)
    with both_serving() as b:
        got = {pkg: [get(base, path)[2] for path in (
            "/debug/resident", "/debug/resident?recent=3",
            "/debug/resident?recent=bad")]
            for pkg, base in b.items()}
        for argv in (["resident", "--endpoint", "ENDPOINT"],
                     ["resident", "--endpoint", "ENDPOINT", "--recent",
                      "3"]):
            rc, out, _ = verbs_equal(b, argv, capsys, across=False)
            assert rc == 0 and "resident-state plane: generation" in out
    for k in range(3):
        assert _one_side(got[PORT][k], TS.PORT_ONLY["resident"]) == \
            _one_side(got[JAX][k], TS.JAX_ONLY["resident"]), k
    assert len(got[PORT][1]["recent_cycles"]) == 3
    assert "recent_cycles" not in got[PORT][2]
    assert got[PORT][0]["device"] == "cpu"


def _one_side(payload, paths):
    """`payload` without the keys one package alone reports."""
    out = json.loads(json.dumps(payload))
    TS._drop(out, paths)  # noqa: SLF001
    return masked(out)


# -- the rebalance plane ------------------------------------------------------------

def test_rebalance_route_and_verb_equal(capsys):
    """The hotspot soak's rebalance plane (on the serial backend, as the
    JAX hotspot soak test places; K13's plain version scores it) is the
    active one in each package: /debug/rebalance equal but for the keys
    the port alone reports; `karmadactl rebalance` from both CLIs."""
    for pkg in PKGS:
        kw = {"device": "cpu"} if pkg == PORT else {}
        TS.soak(pkg, "hotspot", backend="serial", **kw)
    with both_serving() as b:
        got = {pkg: get(base, "/debug/rebalance")[2]
               for pkg, base in b.items()}
        rc, out, _ = verbs_equal(b, ["rebalance", "--endpoint", "ENDPOINT"],
                                 capsys, across=False)
    budget = ("budget/window_age_s",)  # the wall clock's age of the window
    assert _one_side(got[PORT], TS.PORT_ONLY["rebalance"] + budget) == \
        _one_side(got[JAX], budget)
    assert got[PORT]["enabled"] and got[PORT]["cycles"] > 0
    assert rc == 0 and "rebalance plane:" in out


# -- chaos, time series, SLO, incidents ---------------------------------------------

class _Clock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t


def _telemetry_world(pkg, tmp_path):
    """One package's chaos plane after a seeded fire sequence, a metric
    ring over a private registry, an SLO evaluator over it, and an
    incident store with three bundles."""
    chaos = mod(pkg, "chaos")
    plane = chaos.configure("store.watch:drop@0.5;worker.reconcile:error#3",
                            seed=7)
    for i in range(40):
        chaos.fire(("store.watch", "worker.reconcile")[i % 2], n=i)
    plane.add("device.cycle:hang:0.1#2")
    M = mod(pkg, "utils.metrics")
    TSM = mod(pkg, "obs.timeseries")
    SLO = mod(pkg, "obs.slo")
    r = M.Registry()
    c = r.counter("karmada_test_events_total", "events", ("kind",))
    g = r.gauge("karmada_test_depth", "depth")
    ring = TSM.MetricRing(capacity=8, registry=r)
    for i in range(10):
        c.inc(i + 1, kind="a" if i % 2 else "b")
        g.set(float(i * 3))
        ring.sample(float(i), force=True)
    TSM._ACTIVE = ring  # noqa: SLF001 — the payload reads the active ring
    ev = SLO.SloEvaluator(SLO.default_objectives(schedule_deadline_s=0.5))
    ev.evaluate(ring)
    SLO._ACTIVE = ev  # noqa: SLF001
    inc = mod(pkg, "obs.incidents")
    # a fresh flight ring: the process ring holds the earlier tests' cycles
    inc.configure_flight(capacity=64)
    clock = _Clock()
    inc.configure(str(tmp_path / pkg), cooldown_s=60.0, keep=2, clock=clock)
    ids = [inc.trigger(inc.TRIGGER_CYCLE_FAULT, "first",
                       refs=["default/a"], detail={"n": 1})]
    clock.t += 61.0
    ids.append(inc.trigger(inc.TRIGGER_BACKEND_DEGRADE, "second"))
    clock.t += 61.0
    ids.append(inc.trigger(inc.TRIGGER_CYCLE_FAULT, "third"))
    return ids


TELEMETRY_ROUTES = [
    "/debug/chaos", "/debug/timeseries", "/debug/timeseries?n=2",
    "/debug/timeseries?prefix=karmada_test_depth",
    "/debug/timeseries?points=0", "/debug/timeseries?n=x&points=0",
    "/debug/slo", "/debug/incidents",
]


def _bundle_masked(body):
    """An incident bundle: the `locks` block by its keys (its rows are
    each registry's live locks)."""
    if isinstance(body, dict) and isinstance(body.get("locks"), dict):
        body = {**body, "locks": sorted(body["locks"])}
    return body


def test_telemetry_routes_and_verbs_equal(tmp_path, capsys):
    ids = {pkg: _telemetry_world(pkg, tmp_path) for pkg in PKGS}
    assert ids[PORT] == ids[JAX]
    paths = TELEMETRY_ROUTES + [f"/debug/incidents/{i}" for i in ids[PORT]]
    with both_serving() as b:
        got = routes(b, paths)
        answers = [verbs_equal(b, ["incidents", "--endpoint", "ENDPOINT"],
                               capsys, across=False)]
        # a bundle's JSON carries its wall-clock stamps
        answers += [verbs_equal(b, argv, capsys, across=False)
                    for argv in (
                        ["incidents", ids[PORT][2], "--endpoint",
                         "ENDPOINT"],
                        ["incidents", "inc-nosuch", "--endpoint",
                         "ENDPOINT"],
                        ["describe", "incident", ids[PORT][1],
                         "--endpoint", "ENDPOINT"],
                        ["describe", "incident", "--endpoint",
                         "ENDPOINT"])]
    j, p = ([(path, code, ctype, _bundle_masked(body))
             for path, code, ctype, body in got[pkg]] for pkg in PKGS)
    assert p == j
    bodies = {path: (code, body) for path, code, _, body in p}
    assert bodies["/debug/chaos"][1]["enabled"]
    assert bodies["/debug/timeseries"][1]["samples"] == 8
    assert bodies["/debug/slo"][1]["enabled"]
    assert bodies[f"/debug/incidents/{ids[PORT][0]}"][0] == 200  # from disk
    assert [a[0] for a in answers] == [0, 0, 1, 0, 1]
    assert "captured 3 incident(s)" in answers[0][1]


# -- facade, what-if and the load generator ------------------------------------------

def _placements(store):
    return {(rb.metadata.namespace, rb.metadata.name): tuple(sorted(
        (t.name, t.replicas) for t in rb.spec.clusters))
        for rb in store.list("ResourceBinding")}


@contextlib.contextmanager
def traffic_serving():
    """Each package's steady soak (tests/torch_soak.soak): its driver
    registered as the active load generator and a FacadeService over its
    plane armed, behind both servers."""
    planes, services = {}, {}
    for pkg in PKGS:
        _, driver, plane = TS.soak(pkg, "steady")
        mod(pkg, "loadgen.driver").set_active(driver)
        services[pkg] = mod(pkg, "facade").FacadeService(
            plane.scheduler, plane.store, batch_window=8,
            batch_deadline_s=0.05)
        mod(pkg, "facade").set_active(services[pkg])
        planes[pkg] = plane
    try:
        with both_serving() as b:
            yield b, planes
    finally:
        for pkg in PKGS:
            mod(pkg, "facade").set_active(None)
            services[pkg].close()


WHATIF_ROUTES = [
    "/whatif?query=placement&replicas=10&cpu=1000m",
    "/whatif?query=placement&replicas=10&cpu=1000m&divided=false",
    "/whatif?query=headroom&cpu=1000m",
    "/whatif?query=cluster-loss&limit=64",
    "/whatif?query=cluster-loss&cluster=lg-m0",
    "/whatif?query=bogus", "/whatif?query=placement&replicas=ten",
    "/debug/facade", "/debug/load",
]


def test_whatif_facade_and_load_routes_equal():
    """/whatif's three queries, an unknown query and a bad number (400),
    the facade's counters after them and the load generator's state:
    equal on both servers; no query moved a placement."""
    with traffic_serving() as (b, planes):
        before = {pkg: _placements(planes[pkg].store) for pkg in PKGS}
        got = routes(b, WHATIF_ROUTES)
        after = {pkg: _placements(planes[pkg].store) for pkg in PKGS}
    assert got[PORT] == got[JAX]
    assert after == before and before[PORT] == before[JAX]
    codes = [code for _, code, _, _ in got[PORT]]
    assert codes == [200] * 5 + [400, 400, 200, 200]
    placement = got[PORT][0][3]
    assert placement["result"]["outcome"] == "scheduled"
    assert sum(a["replicas"]
               for a in placement["result"]["assignments"]) == 10
    assert got[PORT][7][3]["whatif"]
    assert got[PORT][8][3]["scenario"] == "steady"


TRAFFIC_VERBS = [
    ["whatif", "--endpoint", "ENDPOINT", "--query", "placement",
     "--replicas", "12", "--cpu", "500m"],
    ["whatif", "--endpoint", "ENDPOINT", "--query", "headroom", "--cpu",
     "2000m", "--format", "json"],
    ["whatif", "--endpoint", "ENDPOINT", "--query", "cluster-loss"],
    ["whatif", "--endpoint", "ENDPOINT", "--query", "placement",
     "--replicas", "3", "--duplicated", "--cluster", "lg-m1"],
    ["loadgen", "--endpoint", "ENDPOINT"],
]


@pytest.mark.parametrize("argv", TRAFFIC_VERBS, ids=" ".join)
def test_traffic_verbs_equal(argv, capsys):
    with traffic_serving() as (b, planes):
        before = {pkg: _placements(planes[pkg].store) for pkg in PKGS}
        rc, out, _ = verbs_equal(b, argv, capsys)
        assert {pkg: _placements(planes[pkg].store)
                for pkg in PKGS} == before
    assert rc == 0 and out


def test_whatif_verb_without_a_facade(capsys):
    with both_serving() as b:
        rc, _, err = verbs_equal(b, ["whatif", "--endpoint", "ENDPOINT"],
                                 capsys)
    assert rc == 1 and "facade plane not armed" in err


# -- the profiler ------------------------------------------------------------------

def test_profile_busy_and_bad_seconds_equal():
    """A second capture while one runs answers 409, a non-number 400, on
    both servers (each package's capture gate held)."""
    gates = [mod(pkg, "obs.devprof")._CAPTURE_GATE for pkg in PKGS]  # noqa: SLF001
    for g in gates:
        assert g.acquire(timeout=30)
    try:
        with both_serving(lambda pkg: {"device": "cpu"}
                          if pkg == PORT else {}) as b:
            got = routes(b, ["/debug/profile?seconds=0.1",
                             "/debug/profile?seconds=abc"])
    finally:
        for g in gates:
            g.release()
    assert got[PORT] == got[JAX]
    assert [code for _, code, _, _ in got[PORT]] == [409, 400]
    assert got[PORT][0][3]["busy"] is True


def test_profile_on_the_cpu_and_without_a_card(tmp_path, capsys):
    """The port's capture on device="cpu": 200 with the chrome trace on
    disk (a CPU window records no device kernel), and `karmadactl
    profile` from both CLIs reports it; without a card and without
    device="cpu" the capture answers a JSON 500 naming the missing card."""
    import torch

    with serving(PORT, device="cpu", profile_dir=str(tmp_path)) as base:
        code, ctype, rec = get(base, "/debug/profile?seconds=0.2")
        answers = [cli(pkg, ["profile", "--endpoint", base, "--seconds",
                             "0.2"], capsys) for pkg in PKGS]
    assert (code, ctype) == (200, "application/json")
    assert rec["ok"] and rec["device"] == "cpu" and rec["kernels"] == {}
    assert [f["path"].endswith("trace.json") for f in rec["files"]] == [True]
    assert [a[0] for a in answers] == [0, 0]
    for _, out, _ in answers:
        assert out.startswith("captured 0.2s profiler window")
        assert "trace.json" in out
    if torch.cuda.is_available():
        return
    with serving(PORT) as base:
        code, _, rec = get(base, "/debug/profile?seconds=0.1")
    assert code == 500 and "no CUDA device" in rec["error"]


# -- serve --metrics-port --check-invariants ------------------------------------------

def test_serve_binds_the_debug_server(tmp_path, capsys, monkeypatch):
    """`serve --metrics-port 0 --check-invariants --explain 1
    --trace-buffer 64 --telemetry 32` on the serial backend: the debug
    server answers while the plane serves (the explain plane injected,
    the flight recorder and telemetry published, the locks block armed
    with its watchdog running and no inversion), `karmadactl events` and
    `explain` read it, and serve stops with exit 0, the guards disarmed
    again."""
    import _thread

    monkeypatch.chdir(tmp_path)
    pcli = mod(PORT, "cli")
    httpserve = mod(PORT, "utils.httpserve")
    guards = mod(PORT, "analysis.guards")
    for argv in (["init"], ["join", "m1", "--cpu", "8"]):
        assert cli(PORT, ["--dir", "plane", *argv], capsys)[0] == 0
    bound = []
    start = httpserve.ObservabilityServer.start

    def recording_start(self, *a, **k):
        url = start(self, *a, **k)
        bound.append(url)
        return url

    monkeypatch.setattr(httpserve.ObservabilityServer, "start",
                        recording_start)
    seen = {}

    def poke():
        try:
            for _ in range(1200):
                if bound:
                    break
                threading.Event().wait(0.05)
            base = bound[0]
            # the controller threads start right after the bind
            threading.Event().wait(1.0)
            seen["state"] = get(base, "/debug/state")
            seen["explain"] = get(base, "/debug/explain")
            seen["traces"] = get(base, "/debug/traces")
            seen["timeseries"] = get(base, "/debug/timeseries?points=0")
            seen["events"] = pcli.main(["events", "--endpoint", base])
        finally:
            _thread.interrupt_main()

    t = threading.Thread(target=poke)
    t.start()
    try:
        rc, out, err = cli(PORT, [
            "--dir", "plane", "serve", "--backend", "serial",
            "--metrics-port", "0", "--check-invariants", "--explain", "1",
            "--trace-buffer", "64", "--telemetry", "32",
            "--telemetry-interval", "0", "--sync-period", "0.05"], capsys)
    finally:
        t.join(timeout=30)
        mod(PORT, "obs.timeseries").disarm()
        mod(PORT, "obs.slo").disarm()
    assert rc == 0, err
    assert "observability endpoint at http://127.0.0.1:" in out
    assert "lock race detector / deadlock watchdog" in out
    code, _, state = seen["state"]
    assert code == 200 and state["locks"]["armed"] is True
    assert state["locks"]["watchdog"]["running"] is True
    assert state["locks"]["inversions"]["recent"] == []
    assert state["objects_by_kind"]["Cluster"] == 1
    assert seen["explain"][2]["enabled"] is True
    assert seen["traces"][2]["enabled"] is True
    assert seen["timeseries"][2]["enabled"] is True
    assert seen["events"] == 0
    assert not guards.armed()
    assert mod(PORT, "utils.locks").state_payload()["watchdog"][
        "running"] is False
