"""The chaos plane (chaos/), the safety auditor and the runtime invariant
guards (analysis/guards) of the port against the JAX package's, on the
CPU (the port on device="cpu", the JAX package under JAX_PLATFORMS=cpu),
tolerance 0.

- The fault grammar: `parse_spec` over the good and bad specs of the JAX
  package's tests/test_chaos.py (one parametrised test): the same rules,
  or the same ValueError.
- Fire logs: the same spec, seed and fire sequence fire the same faults
  (the log's wall-clock stamps aside).
- Each seam's outcome: the watch bus's drop / dup / stall / reorder and
  `flush_held`; the worker reconcile's requeue; a dropped lease renewal
  aging the cluster to Unknown; the estimator modes and the circuit
  lifecycle on an injected clock (the facade client's seam too);
  cycle-fault containment (device.dispatch), d2h poison surfacing as
  InvariantViolation, degrade then cooldown re-arm and the one-way
  degrade (device.cycle:hang); the resident corruption's rebuilt batch.
- The `chaos` and `hotspot` SOAK payloads with the SLO, time-series and
  incident planes armed: equal, `safety_audit`, `chaos`, `slo` and
  `incidents` included, with the Schedulers' host clock held still
  and the deferred-cut timers held back (tests/torch_soak; the fire
  log's and the incident index's wall-clock fields masked; the resident
  and rebalance sections without the keys one package alone reports,
  named in tests/torch_soak.PORT_ONLY / JAX_ONLY, every other key
  present in both).
- The guards: `check_batch`, `check_used` and `check_d2h` raise the same
  InvariantViolation on the same bad inputs.
- The registry: every family the port registers equals the JAX
  package's by name, type, labels, help and buckets, and every JAX
  family but those of ops/meshing (not part of the port) is registered
  by the port.

Marked `gpu` (skipped here inside the test): a chaos soak on the card,
and the corruption travelling to the card's mirror through K10.
"""

import importlib
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_soak as TS
from torch_fixtures import collect_jax_planes  # noqa: F401 — autouse

PKGS = TS.PKGS
ROOT = Path(__file__).resolve().parent.parent


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


@pytest.fixture(autouse=True)
def _disarm_planes():
    """No test leaks an armed chaos, SLO, time-series or incident plane of
    either package into the rest of the suite."""
    yield
    for pkg in PKGS:
        mod(pkg, "chaos").disarm()
        mod(pkg, "obs.timeseries").disarm()
        mod(pkg, "obs.slo").disarm()
        mod(pkg, "obs.incidents").disarm()


# -- the fault grammar and the plane ------------------------------------------

SPECS = [
    "estimator.rpc:error@0.25;device.cycle:hang:2.5#1,store.watch:drop#3",
    "resident.mirror:corrupt#1",
    "rebalance.plan:skip#1; lease.heartbeat:drop@0.5",
    "",
    # the JAX tests' bad specs
    "nope.site:raise",
    "estimator.rpc:explode",
    "estimator.rpc",
    "estimator.rpc:error@2.0",
    "estimator.rpc:error#x",
    "device.cycle:hang:abc",
]


def _parse(pkg, spec):
    try:
        rules = mod(pkg, "chaos").parse_spec(spec, seed=5)
    except ValueError as e:
        return "ValueError", str(e)
    return [(r.to_dict(), r.rng.random()) for r in rules]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_spec_equal(spec):
    j, p = (_parse(pkg, spec) for pkg in PKGS)
    assert p == j


def _fires(pkg):
    chaos = mod(pkg, "chaos")
    plane = chaos.configure(
        "store.watch:drop@0.5;worker.reconcile:error#3;"
        "estimator.rpc:timeout@0.3", seed=7)
    sites = ("store.watch", "worker.reconcile", "estimator.rpc",
             "device.cycle")
    got = []
    for i in range(120):
        f = chaos.fire(sites[i % 4], n=i)
        got.append(None if f is None else (f.site, f.mode, f.arg))
        if i == 60:
            plane.add("device.cycle:hang:0.1#2")
        if i == 90:
            assert plane.clear("store.watch") == 1
    log = [{k: v for k, v in e.items() if k != "ts"}
           for e in plane.fire_log()]
    state = chaos.state_payload()
    for e in state["recent"]:
        e.pop("ts")
    out = (got, log, plane.fires_by_mode(), plane.unspent_rules(), state)
    chaos.disarm()
    return out, chaos.state_payload()


def test_fire_log_equal():
    j, p = (_fires(pkg) for pkg in PKGS)
    assert p == j
    assert p[1] == {"enabled": False}
    assert sum(g is not None for g in p[0][0]) > 20


# -- the watch bus, worker and lease seams ------------------------------------

def _bus(pkg):
    chaos = mod(pkg, "chaos")
    S = mod(pkg, "store.store")
    D = mod(pkg, "loadgen.driver")
    bus = S.WatchBus()
    seen = []
    bus.subscribe(lambda e: seen.append(e.obj.metadata.name))

    def pub(name):
        bus.publish(S.Event(type=S.ADDED, obj=D.build_binding(name)))

    steps = []
    for mode, names in (("drop", ["dropped", "a"]), ("dup", ["b"]),
                        ("stall", ["held", "c"]), ("reorder", ["late", "d"]),
                        ("stall", ["straggler"])):
        chaos.disarm()
        chaos.configure(f"store.watch:{mode}#1")
        for n in names:
            pub(n)
        steps.append(list(seen))
    steps.append((bus.flush_held(), list(seen), bus.flush_held()))
    return steps


def test_watch_bus_seam_equal():
    j, p = (_bus(pkg) for pkg in PKGS)
    assert p == j
    assert p[-1][1][-1] == "straggler" and p[-1][0] == 1


def _worker(pkg):
    chaos = mod(pkg, "chaos")
    W = mod(pkg, "store.worker")
    done = []
    w = W.AsyncWorker("chaos-parity", lambda key: done.append(key))
    chaos.configure("worker.reconcile:error#1")
    base = W.RECONCILE_ERRORS.value(worker="chaos-parity")
    w.enqueue("k")
    first = (w.process_one(), list(done), w.pending())
    second = (w.process_one(), list(done), w.pending())
    return first, second, W.RECONCILE_ERRORS.value(
        worker="chaos-parity") - base


def test_worker_reconcile_seam_equal():
    j, p = (_worker(pkg) for pkg in PKGS)
    assert p == j == ((True, [], 1), (True, ["k"], 0), 1.0)


def _lease(pkg):
    chaos = mod(pkg, "chaos")
    L = mod(pkg, "controllers.lease")
    C = mod(pkg, "models.cluster")
    M = mod(pkg, "models.meta")
    S = mod(pkg, "store.store")
    W = mod(pkg, "store.worker")
    store = S.ObjectStore()
    clock = {"now": 1000.0}
    store.create(C.Cluster(metadata=M.ObjectMeta(name="m1"),
                           spec=C.ClusterSpec()))
    L.renew_cluster_lease(store, "m1", clock=lambda: clock["now"])
    monitor = L.ClusterLeaseMonitor(store, W.Runtime(),
                                    clock=lambda: clock["now"])
    chaos.configure("lease.heartbeat:drop")
    clock["now"] += 20.0
    L.renew_cluster_lease(store, "m1", clock=lambda: clock["now"])
    renewed = store.get(L.Lease.KIND, L.LEASE_NAMESPACE, "m1").renew_time
    clock["now"] += 100.0
    monitor.check_all()
    cond = M.get_condition(store.get(C.Cluster.KIND, "", "m1")
                           .status.conditions, C.COND_CLUSTER_READY)
    return renewed, cond.status, cond.reason, chaos.active().fires()


def test_lease_heartbeat_drop_equal():
    j, p = (_lease(pkg) for pkg in PKGS)
    assert p == j
    assert p[0] == 1000.0 and p[1] == "Unknown" and p[3] == 1


# -- the estimator seam and the circuit ----------------------------------------

class _Flaky:
    """A transport raising (or returning) a scripted sequence, then
    answering cleanly (the JAX tests' _FlakyTransport)."""

    def __init__(self, script):
        self.script = list(script)
        self.calls = 0

    def call(self, method, request):
        self.calls += 1
        if self.script:
            item = self.script.pop(0)
            if isinstance(item, BaseException):
                raise item
            return item
        return {"maxReplicas": 7, "unschedulableReplicas": 4}


def _estimator(pkg):
    chaos = mod(pkg, "chaos")
    E = mod(pkg, "estimator.client")
    clock = {"now": 0.0}
    errors = E.ESTIMATOR_ERRORS
    kinds = ("unreachable", "timeout", "malformed", "circuit_open")
    base = {k: errors.value(kind=k) for k in kinds}
    br = E.CircuitBreaker(failure_threshold=2, reset_timeout_s=10.0,
                          clock=lambda: clock["now"])
    client = E.AccurateEstimatorClient(breaker=br, sleep=lambda _s: None,
                                       retry_attempts=1)
    client.register("c1", _Flaky([]))
    seq = []

    def ask():
        seq.append((client.unschedulable_replicas("c1", "Deployment", "ns",
                                                  "x"), br.state("c1")))

    for spec in ("estimator.rpc:garbage#1", "estimator.rpc:slow:0.0#1",
                 "estimator.rpc:error#1", "estimator.rpc:timeout#1"):
        chaos.disarm()
        chaos.configure(spec)
        ask()
    ask()                      # open: short-circuited, off the wire
    clock["now"] += 10.0
    chaos.disarm()
    chaos.configure("estimator.rpc:error#1")
    ask()                      # half-open probe fails: open again
    clock["now"] += 10.0
    ask()                      # the next probe answers: closed
    try:
        client.close()
    except AttributeError:     # the JAX client keeps its pool
        pass
    transitions = [(t["cluster"], t["from"], t["to"], t["ts"])
                   for t in br.transition_log()]
    return (seq, transitions,
            {k: errors.value(kind=k) - base[k] for k in kinds},
            E.CIRCUIT_STATE.value(cluster="c1"))


def test_estimator_modes_and_circuit_equal():
    j, p = (_estimator(pkg) for pkg in PKGS)
    assert p == j
    assert [t[2] for t in p[1]] == ["open", "half-open", "open",
                                    "half-open", "closed"]


def _facade_client(pkg):
    chaos = mod(pkg, "chaos")
    E = mod(pkg, "estimator.client")
    F = mod(pkg, "facade.client")
    W = mod(pkg, "facade.messages")
    kinds = ("unreachable", "timeout", "malformed")
    base = {k: E.ESTIMATOR_ERRORS.value(kind=k) for k in kinds}
    flaky = _Flaky([])
    client = F.FacadeClient(flaky, retry_attempts=1, sleep=lambda _s: None)
    out = []
    for spec in ("estimator.rpc:error#1", "estimator.rpc:timeout#1",
                 "estimator.rpc:garbage#1"):
        chaos.disarm()
        chaos.configure(spec)
        try:
            client.whatif(W.WhatIfRequest(query="placement", replicas=1))
            out.append("answered")
        except Exception as e:  # noqa: BLE001 — the typed failure
            out.append(type(e).__name__)
    return (out, {k: E.ESTIMATOR_ERRORS.value(kind=k) - base[k]
                  for k in kinds}, flaky.calls,
            [t["to"] for t in client.breaker.transition_log()])


def test_facade_client_seam_equal():
    """The facade client's estimator.rpc seam: error / timeout / garbage
    surface as the typed failures, counted on the estimator families,
    and trip the endpoint's circuit, on both packages alike."""
    j, p = (_facade_client(pkg) for pkg in PKGS)
    assert p == j
    assert p[0] == ["EstimatorUnreachable", "EstimatorTimeout",
                    "EstimatorMalformed"]
    assert p[1] == {"unreachable": 1, "timeout": 1, "malformed": 1}


# -- the Scheduler's device seams -----------------------------------------------

def _slice(pkg, **kw):
    S = mod(pkg, "store.store")
    W = mod(pkg, "store.worker")
    Q = mod(pkg, "scheduler.queue")
    D = mod(pkg, "loadgen.driver")
    Sch = mod(pkg, "scheduler.service")
    if pkg == "karmada_tpu_torch":
        kw["device"] = "cpu"
    store, rt = S.ObjectStore(), W.Runtime()
    sched = Sch.Scheduler(store, rt, backend="device",
                          queue=Q.SchedulingQueue(initial_backoff_s=0.0),
                          **kw)
    for i in range(2):
        store.create(D.build_cluster(f"cf-m{i}"))
    return store, rt, sched, D


def _placed(store):
    return {rb.metadata.name: sorted((t.name, t.replicas)
                                     for t in rb.spec.clusters)
            for rb in store.list("ResourceBinding")}


@pytest.mark.parametrize("spec,kind", [
    ("device.dispatch:raise#1", "ChaosFault"),
    ("device.d2h:poison#1", "InvariantViolation"),
    ("device.d2h:raise#1", "ChaosFault"),
])
def test_cycle_fault_containment_equal(spec, kind):
    """A dispatch raise, a poisoned COO plane (the d2h guard raises
    InvariantViolation on the poisoned copy) and a d2h raise: the cycle
    fault is contained, the popped bindings re-queued and scheduled on
    the retry, on both packages alike."""
    out = {}
    for pkg in PKGS:
        M = mod(pkg, "scheduler.metrics")
        store, rt, sched, D = _slice(pkg)
        for i in range(3):
            store.create(D.build_binding(f"cf-b{i}"))
        mod(pkg, "chaos").configure(spec)
        base = M.CYCLE_FAULTS.value(kind=kind)
        rt.pump()
        mid = (M.CYCLE_FAULTS.value(kind=kind) - base,
               sched.queue.depths()["backoff"], _placed(store))
        rt.tick()
        out[pkg] = (mid, _placed(store),
                    mod(pkg, "chaos").active().fires())
    assert out["karmada_tpu_torch"] == out["karmada_tpu"]
    (faults, backoff, _), placed, fires = out["karmada_tpu_torch"]
    assert faults == 1 and backoff == 3 and fires == 1
    assert all(placed.values())


def _degrade(pkg, recover):
    M = mod(pkg, "scheduler.metrics")
    store, rt, sched, D = _slice(pkg, device_cycle_timeout_s=None,
                                 device_recover_cycles=recover)
    store.create(D.build_binding("dg-warm"))
    rt.pump()  # unguarded: pays the first calls
    sched.device_cycle_timeout_s = 0.5
    mod(pkg, "chaos").configure("device.cycle:hang:1.0#1")
    d0 = M.BACKEND_DEGRADED.total()
    r0 = M.BACKEND_REARMED.value(backend="device")
    backends = []
    for i in range(1, 4):
        store.create(D.build_binding(f"dg-b{i}"))
        rt.pump()
        rt.tick()
        backends.append(sched.backend != "device")
    time.sleep(0.6)  # the abandoned zombie's sleep ends inside the test
    return (backends, M.BACKEND_DEGRADED.total() - d0,
            M.BACKEND_REARMED.value(backend="device") - r0,
            sched._degraded_from, _placed(store))  # noqa: SLF001


@pytest.mark.parametrize("recover", [1, None], ids=["rearm", "one-way"])
def test_degrade_and_rearm_equal(recover):
    """device.cycle:hang under the guard: the cycle abandoned, the backend
    degraded (then re-armed after the cooldown, or for good without
    one), every binding placed, on both packages alike."""
    j, p = (_degrade(pkg, recover) for pkg in PKGS)
    assert p == j
    backends, degraded, rearmed, _, placed = p
    assert degraded == 1 and all(placed.values())
    if recover:
        assert rearmed == 1 and backends[-1] is False
    else:
        assert rearmed == 0 and all(backends)


def _corrupt(pkg):
    chaos = mod(pkg, "chaos")
    D = mod(pkg, "loadgen.driver")
    R = mod(pkg, "resident")
    RS = mod(pkg, "resident.state")
    T = mod(pkg, "ops.tensors")
    clusters = [D.build_cluster(f"rc-m{i}") for i in range(3)]
    bindings = [D.build_binding(f"rc-b{i}") for i in range(4)]
    items = [(rb.spec, rb.status) for rb in bindings]
    tokens = [R.RowToken(f"{D.LOADGEN_NS}/rc-b{i}", 1) for i in range(4)]
    state = (R.ResidentState(audit_interval=0, device="cpu")
             if pkg == "karmada_tpu_torch" else
             R.ResidentState(device_plane=False, audit_interval=0))
    state.begin_cycle(clusters)
    state.encode_cycle(items, tokens)  # adopt
    state.begin_cycle(clusters)
    chaos.configure("resident.mirror:corrupt#1")
    m0 = RS.RESIDENT_AUDITS.value(outcome="mismatch")
    served = state.encode_cycle(items, tokens)
    fresh = T.encode_batch(items, state.cindex, state.estimator)
    stats = state.stats()
    state.begin_cycle(clusters)
    again = state.encode_cycle(items, tokens)
    fields = {f: np.asarray(getattr(served, f)).tolist()
              for f in T.FIELD_DTYPES if getattr(served, f, None) is not None}
    return (fields, RS.compare_batches(served, fresh),
            RS.compare_batches(again, fresh),
            RS.RESIDENT_AUDITS.value(outcome="mismatch") - m0,
            stats["audits"], stats["rebuilds"],
            stats["last_audit"]["fields"], chaos.active().fires())


def test_resident_corruption_rebuilt_batch_equal():
    """resident.mirror:corrupt: the forced audit catches the flipped
    lane, the plane rebuilds, and the served batch is the fresh encode,
    field for field the JAX package's."""
    j, p = (_corrupt(pkg) for pkg in PKGS)
    assert p == j
    assert p[1] == [] and p[2] == [] and p[3] == 1
    assert p[6] == ["pods_allowed"] and p[7] == 1


# -- the chaos and hotspot soaks ------------------------------------------------

def _join_zombies(timeout: float = 30.0) -> None:
    """Wait for the abandoned device cycles' threads of both packages'
    guards (named "scheduler-device-cycle"): a zombie ending inside the
    next test would close its spans into that test's recorder."""
    import threading

    for t in threading.enumerate():
        if t.name == "scheduler-device-cycle":
            t.join(timeout)


#: the chaos soak's hang and guard, widened from the catalog's 3 s / 2 s:
#: under a loaded test host a plain CPU cycle may outlast 2 s, and an
#: extra degrade would make the two packages' payloads differ by host load
SOAK_HANG = ("device.cycle:hang:3#1", "device.cycle:hang:8#1")
SOAK_GUARD_S = 6.0


def _soak(pkg, name, plane_kw):
    import dataclasses

    L = mod(pkg, "loadgen")
    slo = mod(pkg, "obs.slo")
    ts = mod(pkg, "obs.timeseries")
    inc = mod(pkg, "obs.incidents")
    scenario = L.get_scenario(name)
    if name == "chaos":
        scenario = dataclasses.replace(scenario, events=tuple(
            dataclasses.replace(e, spec=SOAK_HANG[1])
            if e.spec == SOAK_HANG[0] else e for e in scenario.events))
        assert SOAK_HANG[1] in [e.spec for e in scenario.events]
    clock, model = L.VirtualClock(), L.ServiceModel()
    kw = dict(plane_kw)
    if pkg == "karmada_tpu_torch":
        kw["device"] = "cpu"
    kw.setdefault("backend", "device")
    plane = L.ServeSlice(scenario, clock, model, **kw)
    if name == "chaos":
        # the guarded plane's first calls must not read as a hung cycle (as
        # the JAX chaos soak test warms it); the hotspot soak runs as the
        # catalog has it, with no warm bindings loading its fleet
        L.warm_device_path(plane, sizes=(2, 9, 17, 64), aot_variants=False)
    ts.configure(capacity=256)
    slo.configure(arm_watchdog=False)
    inc.configure(None, cooldown_s=60.0, clock=clock.now)
    driver = L.LoadDriver(plane, scenario, clock=clock, model=model, seed=0)
    with TS.fresh_ledger(pkg), TS.frozen_cycle_clock(), \
            TS.held_cut_timers():
        payload = driver.run()
    _join_zombies()
    samples = len(ts.active())
    for section in (payload["incidents"] or {}).get("incidents", ()):
        section.pop("capture_s")
    return payload, TS.placements(plane), samples


@pytest.mark.chaos
@pytest.mark.parametrize("name,plane_kw", [
    ("chaos", {"resident": True, "resident_audit_interval": 0,
               "device_cycle_timeout_s": SOAK_GUARD_S,
               "device_recover_cycles": 2}),
    # the JAX hotspot soak test's plane: ops/serial packs the hot clusters
    # (on the device backend this scenario never overcommits)
    ("hotspot", {"backend": "serial"}),
], ids=["chaos", "hotspot"])
def test_fault_soak_payload_equal(name, plane_kw):
    """The catalog's chaos soak (the JAX chaos soak test's plane, its hang
    and guard widened: SOAK_HANG) and hotspot soak (the JAX hotspot soak
    test's plane, unwarmed), the SLO / time-series / incident planes
    armed: SOAK payloads equal, `safety_audit` with no violation."""
    (jp, jplace, jn), (pp, pplace, pn) = (_soak(pkg, name, plane_kw)
                                          for pkg in PKGS)
    j, p = TS.cross_comparable(jp, pp)
    assert p == j
    assert pplace == jplace and pn == jn > 0
    audit = pp["safety_audit"]
    assert audit["violations"] == []
    assert pp["slo"]["enabled"] and pp["incidents"]["enabled"]
    if name == "chaos":
        assert audit["fault_fires"]["device.cycle"] == 1
        assert audit["fault_fires"]["resident.mirror"] == 1
        assert audit["metric_deltas"]["backend_rearmed"] >= 1
        assert {"backend-degrade", "cycle-fault"} <= set(
            pp["incidents"]["by_trigger"])
    else:
        assert pp["chaos"]["fired_by_site"] == {"rebalance.plan": 1}
        assert pp["rebalance"]["conservation_violations"] == 0
        assert pp["rebalance"]["evictions"] > 0
    assert not mod("karmada_tpu_torch", "chaos").armed()


# -- the guards ------------------------------------------------------------------

def _batch(pkg):
    D = mod(pkg, "loadgen.driver")
    T = mod(pkg, "ops.tensors")
    clusters = [D.build_cluster(f"g-m{i}") for i in range(3)]
    items = [(rb.spec, rb.status)
             for rb in (D.build_binding(f"g-b{i}") for i in range(2))]
    return T.encode_batch(items, T.ClusterIndex.build(clusters))


def _guards(pkg):
    G = mod(pkg, "analysis.guards")
    batch = _batch(pkg)
    out = []

    def attempt(fn, *args):
        try:
            fn(*args)
            out.append("ok")
        except G.InvariantViolation as e:
            out.append(str(e))

    attempt(G.check_batch, batch)
    for field, value in (("replicas", batch.replicas.astype(np.int32)),
                         ("pl_mask", np.ones((batch.pl_mask.shape[0],
                                              batch.C + 1), bool)),
                         ("req_milli", None)):
        bad = _batch(pkg)
        setattr(bad, field, value)
        attempt(G.check_batch, bad, "case")
    used = (np.zeros((batch.C, 2), np.int64), np.zeros(batch.C, np.int64),
            np.zeros((1, batch.C), np.int64))
    attempt(G.check_used, used)
    attempt(G.check_used, used[:2])
    attempt(G.check_used, (used[0].astype(np.int32),) + used[1:])
    i32 = np.int32
    for idx, val, st in (
            (np.array([0, 5], i32), np.array([1, 2], i32), np.zeros(2, i32)),
            (np.array([0, 99], i32), np.array([1, 2], i32), np.zeros(2, i32)),
            (np.array([0], i32), np.array([-1], i32), np.zeros(2, i32)),
            (np.array([0], i32), np.array([1], i32), np.array([9], i32)),
            (np.array([0.5]), np.array([1], i32), np.zeros(1, i32)),
            (np.array([np.nan]), np.array([1], i32), np.zeros(1, i32)),
            (np.array([0], np.int64), np.array([1], i32), np.zeros(1, i32))):
        attempt(G.check_d2h, idx, val, st, 16)
    return out


def test_guards_equal_on_bad_inputs():
    j, p = (_guards(pkg) for pkg in PKGS)
    assert p == j
    assert p[0] == "ok" and p[4] == "ok" and p[7] == "ok"
    assert sum(o != "ok" for o in p) == len(p) - 3


def test_guards_armed_on_the_port_solver(monkeypatch):
    """Armed, the port's solver entry points check their batch and carry
    before anything runs, and the d2h check reads finalize_compact's host
    copies: a clean solve passes, a drifted dtype raises."""
    G = mod("karmada_tpu_torch", "analysis.guards")
    PS = mod("karmada_tpu_torch", "ops.solver")
    monkeypatch.setattr(G, "_ARMED", [True])
    batch = _batch("karmada_tpu_torch")
    idx, val, st, nnz = PS.solve_compact(batch, device="cpu")
    assert nnz == len(idx) > 0
    batch.replicas = batch.replicas.astype(np.int32)
    for call in (lambda: PS.solve(batch, device="cpu"),
                 lambda: PS.dispatch_compact(batch, device="cpu")):
        with pytest.raises(G.InvariantViolation, match="replicas"):
            call()


def test_guards_arm_from_the_environment():
    """KARMADA_CHECK_INVARIANTS arms both packages' guards at import, and
    an InvariantViolation fires the armed incident plane's trigger."""
    code = ("import sys; sys.path.insert(0, {root!r})\n"
            "from karmada_tpu_torch.analysis import guards\n"
            "from karmada_tpu_torch.obs import incidents\n"
            "assert guards.armed()\n"
            "incidents.configure(None)\n"
            "guards.InvariantViolation('probe')\n"
            "print(incidents.state_payload()['by_trigger'])\n")
    env = {"KARMADA_CHECK_INVARIANTS": "1", "PATH": "/usr/bin:/bin"}
    proc = subprocess.run(
        [sys.executable, "-c", code.format(root=str(ROOT))],
        capture_output=True, text=True, timeout=120, env=env)
    assert proc.returncode == 0, proc.stderr
    assert "{'invariant-violation': 1}" in proc.stdout


# -- the registry ------------------------------------------------------------------

#: JAX modules whose families the port does not register: their planes are
#: not part of the port (ops/meshing: ROADMAP Queue A item 10)
LEFT_OUT = ("karmada_tpu.ops.meshing",)

#: the port modules that register the families
PORT_FAMILY_MODULES = (
    "scheduler.metrics", "obs.events", "chaos.plane", "obs.incidents",
    "obs.slo", "obs.timeseries", "estimator.client", "facade.metrics",
    "rebalance.plane", "rebalance.pacing", "resident.state",
    "ops.shortlist", "ops.solver", "ops.tensors", "ops.dirty",
    "ops.resident_gather", "scheduler.incremental", "store.worker",
    "controllers.execution", "obs.decisions", "obs.devprof",
    "ops.aotcache", "utils.deviceprobe", "controllers.status",
    "utils.locks")


def _families(pkg, modules):
    reg = mod(pkg, "utils.metrics").REGISTRY
    for m in modules:
        importlib.import_module(m)
    return {name: (type(m).__name__, tuple(m.label_names), m.help,
                   list(getattr(m, "buckets", [])))
            for name, m in reg._metrics.items()}  # noqa: SLF001


def test_registry_families_equal():
    p = _families("karmada_tpu_torch", [f"karmada_tpu_torch.{m}"
                                        for m in PORT_FAMILY_MODULES])
    j = _families("karmada_tpu", [f"karmada_tpu.{m}"
                                  for m in PORT_FAMILY_MODULES] + list(
                                      LEFT_OUT))
    left = {name for name in j if name.startswith("karmada_mesh")}
    assert set(p) == set(j) - left
    for name in p:
        assert p[name] == j[name], name
    assert len(p) >= 89


# -- on the card -------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels run only on the card)")


@pytest.mark.gpu
def test_chaos_soak_on_the_card():
    """The catalog's chaos soak on the card (420 bindings, a few seconds
    there): no violation, the device seams fired, degrade and re-arm,
    K1-K4 and K10 launched."""
    _card()
    L = mod("karmada_tpu_torch", "loadgen")
    K = mod("karmada_tpu_torch", "ops.kernels")
    scenario = L.get_scenario("chaos")
    clock, model = L.VirtualClock(), L.ServiceModel()
    plane = L.ServeSlice(scenario, clock, model, backend="device",
                         resident=True, resident_audit_interval=0,
                         device_cycle_timeout_s=2.0,
                         device_recover_cycles=2)
    L.warm_device_path(plane)
    K.reset_counts()
    driver = L.LoadDriver(plane, scenario, clock=clock, model=model, seed=0)
    p = driver.run()
    torch.cuda.synchronize()
    audit = p["safety_audit"]
    assert audit["violations"] == []
    assert audit["fault_fires"]["device.cycle"] == 1
    assert audit["metric_deltas"]["backend_rearmed"] >= 1
    assert plane.scheduler.backend == "device"
    for k in ("capacity", "schedule_rows", "webster_batch", "compact",
              "scatter_lanes"):
        assert K.LAUNCHES[k] > 0, k


@pytest.mark.gpu
def test_corruption_travels_through_k10_on_the_card():
    """resident.mirror:corrupt on the card: the flipped lane reaches the
    card's pods_allowed mirror through one K10 scatter, the forced audit
    compares its fresh encode with that mirror, catches it, and the
    rebuilt mirror equals the fresh encode bit for bit."""
    _card()
    chaos = mod("karmada_tpu_torch", "chaos")
    D = mod("karmada_tpu_torch", "loadgen.driver")
    R = mod("karmada_tpu_torch", "resident")
    K = mod("karmada_tpu_torch", "ops.kernels")
    T = mod("karmada_tpu_torch", "ops.tensors")
    clusters = [D.build_cluster(f"rc-m{i}") for i in range(5)]
    items = [(rb.spec, rb.status)
             for rb in (D.build_binding(f"rc-b{i}") for i in range(8))]
    tokens = [R.RowToken(f"{D.LOADGEN_NS}/rc-b{i}", 1) for i in range(8)]
    state = R.ResidentState(audit_interval=0)
    state.begin_cycle(clusters)
    state.encode_cycle(items, tokens)
    state.begin_cycle(clusters)
    chaos.configure("resident.mirror:corrupt#1")
    K.reset_counts()
    seen = {}
    audit = state.audit

    def spy(items_, batch, *a, **kw):
        seen["pods_allowed"] = np.array(batch.pods_allowed)
        return audit(items_, batch, *a, **kw)

    state.audit = spy
    state.encode_cycle(items, tokens)
    torch.cuda.synchronize()
    fresh = T.encode_batch(items, state.cindex, state.estimator)
    assert K.LAUNCHES["scatter_lanes"] >= 1
    assert not np.array_equal(seen["pods_allowed"][:fresh.n_clusters],
                              fresh.pods_allowed[:fresh.n_clusters])
    assert state.stats()["audits"]["mismatch"] == 1
    mirror = state.device_mirrors.mirrors["pods_allowed"].cpu().numpy()
    assert np.array_equal(mirror[:fresh.n_clusters],
                          fresh.pods_allowed[:fresh.n_clusters])


