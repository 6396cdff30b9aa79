"""Control-plane parity: the port's ObjectStore and Runtime
(karmada_tpu_torch/store), SchedulingQueue (scheduler/queue.py) and
Scheduler (scheduler/service.py, device="cpu") behave as the JAX
package's on the same inputs, tolerance 0:

  * the store and runtime cases of tests/test_store.py, run on both
    packages with equal traces (rv, generation, events, conflicts);
  * one scripted sequence of queue operations (push, pop, backoff,
    unschedulable, flushes, move_all, forget, the admission gate) on
    both queues under one clock: equal pops, depths and oldest ages;
  * a JAX Scheduler(backend="device") and the port Scheduler on mirrored
    stores under one queue clock: creates, a cluster event, an
    unschedulable binding parked and then released, affinity failover
    across two terms, a churn window -- plain and with the fused
    resident plane: equal spec.clusters, conditions, generations and
    queue depths after every tick;
  * the closed rebalance loop: both Schedulers with rebalance= armed and
    a GracefulEvictionController each, two clusters crushed, ticks until
    convergence and until every drain settles: equal per-cycle plane
    snapshots and final placements, no conservation violation.
"""

import random

import pytest

import torch_scenarios as S
from torch_fixtures import collect_jax_planes  # noqa: F401 — autouse
from karmada_tpu import rebalance as jax_rebalance_mod
from karmada_tpu import resident as jax_resident_mod
from karmada_tpu.ops import tensors as JT

MJ = S.models_of("karmada_tpu")
MP = S.models_of("karmada_tpu_torch")


@pytest.fixture(autouse=True)
def _clean_globals():
    JT._FLEET_CAP_MEMO.clear()  # process-wide in the JAX package
    yield
    JT._FLEET_CAP_MEMO.clear()
    jax_rebalance_mod.set_active(None)
    jax_resident_mod.set_active(None)



def _pkg(name):
    """(models, store module, worker module, queue module, Scheduler,
    RebalanceConfig, GracefulEvictionController, Scheduler kwargs)."""
    import importlib

    st = importlib.import_module(f"{name}.store.store")
    wk = importlib.import_module(f"{name}.store.worker")
    qu = importlib.import_module(f"{name}.scheduler.queue")
    sv = importlib.import_module(f"{name}.scheduler.service")
    rb = importlib.import_module(f"{name}.rebalance")
    fo = importlib.import_module(f"{name}.controllers.failover")
    kw = ({"backend": "device"} if name == "karmada_tpu"
          else {"device": "cpu"})
    return (S.models_of(name), st, wk, qu, sv.Scheduler, rb.RebalanceConfig,
            fo.GracefulEvictionController, kw)


PKGS = ("karmada_tpu", "karmada_tpu_torch")


# -- store and runtime (tests/test_store.py) ------------------------------------

def _case_create_get_list(M, st, wk):
    s = st.ObjectStore()
    out = [s.create(M.Cluster(metadata=M.ObjectMeta(name=n)))
           .metadata.resource_version for n in ("m2", "m1")]
    out.append([c.name for c in s.list("Cluster")])
    for fn in (lambda: s.create(M.Cluster(metadata=M.ObjectMeta(name="m1"))),
               lambda: s.get("Cluster", "", "nope")):
        with pytest.raises((st.AlreadyExistsError, st.NotFoundError)) as e:
            fn()
        out.append(type(e.value).__name__)
    return out


def _case_rv_generation(M, st, wk):
    s = st.ObjectStore()
    c = s.create(M.Cluster(metadata=M.ObjectMeta(name="m1")))
    out = [(c.metadata.resource_version, c.metadata.generation)]
    c.spec.region = "us-east"
    c = s.update(c)
    out.append((c.metadata.resource_version, c.metadata.generation))
    c.status.kubernetes_version = "1.30"  # status only: no generation bump
    c = s.update(c)
    out.append((c.metadata.resource_version, c.metadata.generation))
    c = s.update(c)  # identical content: no new rv
    out.append((c.metadata.resource_version, c.metadata.generation))
    return out


def _case_conflict(M, st, wk):
    s = st.ObjectStore()
    c = s.create(M.Cluster(metadata=M.ObjectMeta(name="m1")))
    stale = s.get("Cluster", "", "m1")
    c.spec.region = "a"
    s.update(c)
    stale.spec.region = "b"
    with pytest.raises(st.ConflictError):
        s.update(stale)
    s.mutate("Cluster", "", "m1", lambda o: setattr(o.spec, "region", "r1"))
    got = s.get("Cluster", "", "m1")
    return [got.spec.region, got.metadata.resource_version]


def _case_watch(M, st, wk):
    s = st.ObjectStore()
    events = []
    s.bus.subscribe(lambda e: events.append(
        (e.type, e.obj.name, e.obj.metadata.resource_version,
         e.old.metadata.resource_version if e.old else None)),
        kind="Cluster")
    c = s.create(M.Cluster(metadata=M.ObjectMeta(name="m1")))
    c.spec.region = "r"

    def nested(e):  # a subscriber that writes: delivered after, in order
        if e.type == st.ADDED and e.obj.KIND == "Cluster":
            s.create(M.ResourceBinding(metadata=M.ObjectMeta(
                namespace="d", name=e.obj.name)))
    s.bus.subscribe(nested)
    s.update(c)
    s.create(M.Cluster(metadata=M.ObjectMeta(name="m2")))
    s.delete("Cluster", "", "m1")
    return events + [[rb.name for rb in s.list("ResourceBinding")]]


def _case_finalizers(M, st, wk):
    s = st.ObjectStore()
    c = M.Cluster(metadata=M.ObjectMeta(name="m1"))
    c.metadata.finalizers = ["karmada.io/cluster-controller"]
    s.create(c)
    s.delete("Cluster", "", "m1")
    obj = s.get("Cluster", "", "m1")
    out = [obj.metadata.deleting]
    obj.metadata.finalizers = []
    s.update(obj)
    return out + [s.try_get("Cluster", "", "m1") is None, len(s),
                  s.counts_by_kind()]


def _case_worker(M, st, wk):
    seen = []

    def reconcile(key):
        seen.append(key)
        if len(seen) == 1:
            raise RuntimeError("transient")
        if key == "b" and seen.count("b") < 3:
            return False  # asks for a requeue
        return None

    w = wk.AsyncWorker("t", reconcile, max_retries=3)
    rt = wk.Runtime()
    rt.register(w)
    for k in ("a", "a", "b"):
        w.enqueue(k)  # an in-queue key dedups
    rt.pump()
    return [seen, w.pending()]


@pytest.mark.parametrize("case", [
    _case_create_get_list, _case_rv_generation, _case_conflict, _case_watch,
    _case_finalizers, _case_worker], ids=lambda f: f.__name__[6:])
def test_store_and_runtime_match_jax(case):
    traces = []
    for name in PKGS:
        M, st, wk = _pkg(name)[:3]
        traces.append(case(M, st, wk))
    assert traces[0] == traces[1]


def test_runtime_counts_contained_reconcile_errors():
    from karmada_tpu_torch.store import AsyncWorker, Runtime

    def reconcile(key):
        raise ValueError(key)

    rt = Runtime()
    w = rt.register(AsyncWorker("boom", reconcile, max_retries=2))
    w.enqueue("k")
    rt.pump()
    assert w.reconcile_errors == 3  # the first try and two retries
    assert rt.reconcile_errors() == {"boom": 3, "periodic": 0}


def _tracker_windows(name):
    """Three watch windows through a DeltaTracker tapped on the bus:
    membership, capacity/api/label churn, binding writes and a delete."""
    import importlib

    M, st = _pkg(name)[:2]
    res = importlib.import_module(f"{name}.resident.deltas")
    store = st.ObjectStore()
    tracker = res.DeltaTracker()
    store.bus.subscribe(tracker.on_event)
    out = []

    def window():
        d = tracker.drain()
        out.append((d.structural, d.structural_reason, dict(d.clusters),
                    d.binding_events, list(d.bindings_deleted),
                    list(d.bindings_touched)))

    for c in S.control_fleet(M, random.Random(1), 3):
        store.create(c)
    window()
    S.crush(M, store, "m000", 100)  # capacity

    def api(c):
        c.status.api_enablements = []
    store.mutate("Cluster", "", "m001", api)
    S.crush(M, store, "m001", 90)  # weaker than api: coalesces into it
    for rb in S.control_bindings(M, random.Random(2), 3, [
            M.Placement(replica_scheduling=S._dynamic(M))]):
        store.create(rb)
    window()

    def label(c):
        c.metadata.labels["tier"] = "gold"
    store.mutate("Cluster", "", "m002", label)
    store.delete("ResourceBinding", "ns1", "app-0001")
    window()
    return out


def test_delta_tracker_matches_jax():
    want = _tracker_windows("karmada_tpu")
    got = _tracker_windows("karmada_tpu_torch")
    assert got == want
    assert got[0][:2] == (True, "membership")
    assert got[1][2] == {"m000": "capacity", "m001": "api"}
    assert got[2][1] == "cluster-labels" and got[2][4] == [("ns1",
                                                            "app-0001")]


# -- the scheduling queue -----------------------------------------------------

def _queue_script(qu, seed, max_resident):
    rng = random.Random(seed)
    clock = S.FakeClock()
    q = qu.SchedulingQueue(now=clock, max_resident=max_resident)
    popped = {}
    trace = []
    keys = [("ns", f"b{i}") for i in range(24)]
    for _ in range(300):
        op = rng.random()
        key = rng.choice(keys)
        if op < 0.3:
            trace.append(q.push(key, rng.randint(0, 3),
                                origin=rng.choice(["active", "rebalance"])))
        elif op < 0.45:
            got = q.pop_ready(rng.choice([None, 1, 4]))
            for info in got:
                popped[info.key] = info
            trace.append([(i.key, i.priority, i.attempts, i.origin)
                          for i in got])
        elif op < 0.6 and popped:
            k = rng.choice(sorted(popped))
            info = popped.pop(k)
            info.attempts += 1
            if rng.random() < 0.5:
                q.push_backoff_if_not_present(info)
            else:
                q.push_unschedulable_if_not_present(info, reason="capacity")
        elif op < 0.7:
            trace.append((q.flush_backoff(), q.flush_unschedulable_leftover()))
        elif op < 0.75:
            trace.append(q.move_all_to_active_or_backoff())
        elif op < 0.8:
            q.forget(key)
        else:
            clock.advance(rng.choice([0.5, 1.0, 3.0, 400.0]))
        trace.append((q.depths(), q.oldest_ages(), q.has(key),
                      q.unschedulable_reasons()))
    return trace


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("max_resident", [None, 8])
def test_queue_script_matches_jax(seed, max_resident):
    from karmada_tpu.scheduler import queue as JQ
    from karmada_tpu_torch.scheduler import queue as PQ

    assert (_queue_script(JQ, seed, max_resident)
            == _queue_script(PQ, seed, max_resident))


# -- the Scheduler on mirrored stores -----------------------------------------

def _scheduler_run(name, resident):
    M, st, wk, qu, Scheduler, _, _, kw = _pkg(name)
    rng = random.Random(11)
    clock = S.FakeClock()
    store, rt = st.ObjectStore(), wk.Runtime()
    fleet = S.control_fleet(M, rng, 8)
    names = [c.name for c in fleet]
    for c in fleet:
        store.create(c)
    sched = Scheduler(store, rt, queue=qu.SchedulingQueue(now=clock),
                      pipeline_chunk=16, waves=4, resident=resident,
                      resident_fused=resident, resident_audit_interval=2,
                      **kw)
    trace = []

    def tick(advance=1.0):
        clock.advance(advance)
        rt.tick()
        trace.append((S.placements_of(store), sched.queue.depths()))

    pls = S.control_placements(M, rng, names)
    bindings = S.control_bindings(M, rng, 40, pls)
    # more replicas than the whole fleet holds: parked unschedulable
    big = S.control_bindings(M, random.Random(5), 1, pls[:1])[0]
    big.metadata.name = big.spec.resource.name = "huge"
    big.spec.replicas = 4_000
    for rb in bindings + [big]:
        store.create(rb)
    tick()
    S.crush(M, store, names[0], 100)  # a cluster event
    tick()
    store.create(S.pods_cluster(M, "m-big", 100_000, cpu_milli=10**8))
    tick()
    tick(advance=15.0)  # past the backoff: the huge binding lands
    for rb in bindings[:6]:  # one churn window
        def grow(obj):
            obj.spec.replicas += 1
        store.mutate("ResourceBinding", rb.namespace, rb.name, grow)
    tick()
    tick()
    stats = sched.resident_state() if resident else None
    return trace, stats


@pytest.mark.parametrize("resident", [False, True],
                         ids=["plain", "resident_fused"])
def test_scheduler_matches_jax(resident):
    jax_trace, jax_stats = _scheduler_run("karmada_tpu", resident)
    port_trace, port_stats = _scheduler_run("karmada_tpu_torch", resident)
    assert len(jax_trace) == len(port_trace) == 6
    for i, (a, b) in enumerate(zip(jax_trace, port_trace)):
        assert a == b, f"tick {i}"
    final = port_trace[-1][0]
    assert final[("ns0", "huge")][1][0][:2] == ("Scheduled", "True")
    assert any(v[4] == "backup" for v in final.values())  # failover ran
    parked = port_trace[0][1]["unschedulable"] + port_trace[1][1]["backoff"]
    assert parked >= 1
    if resident:
        assert port_stats["fused"]["cycles"] > 0
        assert port_stats["audits"]["ok"] > 0
        assert port_stats["audits"] == jax_stats["audits"]
        assert port_stats["audits"]["mismatch"] == 0


# -- the closed rebalance loop ------------------------------------------------

def _loop_run(name):
    M, st, wk, qu, Scheduler, RebalanceConfig, Gec, kw = _pkg(name)
    rng = random.Random(3)
    clock = S.FakeClock()
    store, rt = st.ObjectStore(), wk.Runtime()
    fleet = S.control_fleet(M, rng, 12)
    names = [c.name for c in fleet]
    for c in fleet:
        store.create(c)
    sched = Scheduler(
        store, rt, queue=qu.SchedulingQueue(now=clock), pipeline_chunk=64,
        waves=4, rebalance=30.0,
        rebalance_cfg=RebalanceConfig(
            interval_s=30.0, max_evictions_per_cycle=64,
            budget_per_cluster=24, budget_interval_s=60.0),
        rebalance_clock=clock, **kw)
    gec = Gec(store, rt, grace_period_s=300.0, clock=clock)
    # the capacity-aware Divided placements (DynamicWeight, Aggregated,
    # region spread, the affinity-failover pair): their re-place respects
    # capacity, so the drained load does not come back
    pls = [p for i, p in enumerate(S.control_placements(M, rng, names))
           if i in (0, 1, 4, 5)]
    for rb in S.control_bindings(M, rng, 300, pls):
        store.create(rb)
    rt.pump()
    S.report_allocated(M, store)
    rt.pump()
    held = S.committed_by_cluster(store.list("ResourceBinding"))
    for n in sorted(held, key=lambda n: (-held[n], n))[:2]:
        S.crush(M, store, n, held[n])
    plane = sched.rebalance_plane
    snaps = []
    for _ in range(20):
        clock.advance(30.0)
        rt.tick()
        snaps.append(plane.stats()["last"])
        if plane.converged():
            break
    rounds = len(snaps)
    for _ in range(20):
        if plane.pending_drains() == 0:
            break
        clock.advance(gec.grace_period_s)
        rt.tick()
    return (snaps, S.placements_of(store), plane.stats(), rounds,
            plane.pending_drains(), sched)


def test_closed_rebalance_loop_matches_jax():
    j = _loop_run("karmada_tpu")
    p = _loop_run("karmada_tpu_torch")
    snaps, final, stats, rounds, pending, sched = p
    assert snaps == j[0]
    assert final == j[1]
    assert stats["evictions"] == j[2]["evictions"] > 0
    assert snaps[-1]["converged"] and rounds < 20
    assert stats["conservation_violations"] == 0 == j[2][
        "conservation_violations"]
    assert pending == 0 == j[4]
    assert sched.faults() == {}
    assert sched.priority_pushes["rebalance"] == stats["evictions"]
    for key, (targets, conds, gen, observed, _aff) in final.items():
        assert conds and conds[0][:2] == ("Scheduled", "True"), key
        assert gen == observed, key
