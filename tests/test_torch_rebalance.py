"""Rebalance-plane parity: the port's detect (karmada_tpu_torch
ops/rebalance_detect.py, K13's plain version) and RebalancePlane
(rebalance/plane.py) equal the JAX package's on the same inputs,
tolerance 0:

  * score(..., device="cpu") against JAX rebalance_detect.score over
    seeded random lanes (C in 1, 7, 64, 4096; negatives, zero capacity
    with load, invalid lanes; thresholds 500/1000/1500; spread tolerance
    off (the plane's 1 << 20 sentinel), 50 and 200), all-zero lanes, and
    the plane over an empty fleet (no detect);
  * the plane mechanics of tests/test_rebalance.py on the port:
    overcommit and saturation, invalid lanes, threshold scaling, the
    spread gate, drain -> graceful eviction + promotion, budget pacing
    (and the two-consumer budget property), the conservation audit,
    Duplicated never drained, a raising cycle contained and counted;
  * three plane cycles of both packages over mirrored stores (stub
    scheduler, one clock, two clusters crushed): equal snapshots,
    promotions, eviction tasks and budget state;
  * the capacity memo is per plane: two stores with equal cluster names
    and resourceVersions but different pods score differently.
"""

import random

import numpy as np
import pytest

import torch_scenarios as S
from karmada_tpu import rebalance as jax_rebalance_mod
from karmada_tpu.ops import rebalance_detect as JRD
from karmada_tpu.ops import tensors as JT
from karmada_tpu.rebalance import EvictionBudget as JaxBudget
from karmada_tpu.rebalance import RebalanceConfig as JaxConfig
from karmada_tpu.rebalance import RebalancePlane as JaxPlane
from karmada_tpu.store.store import ObjectStore as JaxStore
from karmada_tpu_torch.ops import rebalance_detect as PRD
from karmada_tpu_torch.rebalance import (
    EvictionBudget,
    RebalanceConfig,
    RebalancePlane,
    render_state,
)
from karmada_tpu_torch.rebalance import plane as plane_mod
from karmada_tpu_torch.store import ObjectStore

MJ = S.models_of("karmada_tpu")
MP = S.models_of("karmada_tpu_torch")
SPREAD_OFF = plane_mod.SPREAD_REPORT_ONLY


@pytest.fixture(autouse=True)
def _clean_globals():
    # the JAX package's capacity memo is process-wide and keyed by
    # (name, resourceVersion): stores built by earlier tests with the same
    # names and rvs would hand the JAX plane their pods (the port keeps
    # one memo per plane; test_capacity_memo_is_per_plane)
    JT._FLEET_CAP_MEMO.clear()
    yield
    JT._FLEET_CAP_MEMO.clear()
    jax_rebalance_mod.set_active(None)


# -- K13's plain version against the JAX program --------------------------------

def _lanes(rng, C):
    com = rng.integers(-50, 1 << 20, C)
    cap = rng.integers(-50, 1 << 20, C)
    cap[rng.random(C) < 0.15] = 0          # zero capacity, load or not
    com[rng.random(C) < 0.1] = 0
    valid = rng.random(C) < 0.85
    return com, cap, valid


def _same(com, cap, valid, thr, tol):
    want = JRD.score(com, cap, valid, thr, tol)
    got = PRD.score(com, cap, valid, thr, tol, device="cpu")
    for w, g in zip(want, got):
        assert g.dtype == np.int64 and g.shape == w.shape
        assert np.array_equal(w, g)
    return got


@pytest.mark.parametrize("C", [1, 7, 64, 4096])
@pytest.mark.parametrize("thr", [500, 1000, 1500])
@pytest.mark.parametrize("tol", [SPREAD_OFF, 50, 200])
def test_score_matches_jax(C, thr, tol):
    rng = np.random.default_rng(C * 7 + thr + tol % 997)
    _same(*_lanes(rng, C), thr, tol)


def test_score_all_zero_and_saturated_lanes():
    z = np.zeros(16, np.int64)
    need, over, div = _same(z, z, np.ones(16, bool), 1000, SPREAD_OFF)
    assert not need.any() and not over.any() and not div.any()
    # zero capacity with load on a valid lane: the sentinel, whole load
    # drains; the same lane invalid: nothing
    com = np.array([7, 7, 0]); cap = np.array([0, 0, 0])
    need, over, _ = _same(com, cap, np.array([True, False, True]), 1000,
                          SPREAD_OFF)
    assert over[0] == PRD.OVER_SATURATED and need[0] == 7
    assert need[1] == 0 and over[1] == 0 and over[2] == 0


def test_detect_overcommit_threshold_and_spread_gate():
    need, over, _ = PRD.score(np.array([480, 20, 10, 7]),
                              np.array([300, 1000, 1000, 0]),
                              np.ones(4, bool), 1000, SPREAD_OFF,
                              device="cpu")
    assert over[0] == 1600 and need[0] == 180 and need[3] == 7
    assert need[1] == 0 and need[2] == 0
    need, _, _ = PRD.score(np.array([140, 160]), np.array([100, 100]),
                           np.ones(2, bool), 1500, SPREAD_OFF, device="cpu")
    assert need.tolist() == [0, 10]
    com, cap = np.array([90, 10, 0, 0]), np.array([100, 100, 100, 100])
    need0, _, div = PRD.score(com, cap, np.ones(4, bool), 2000, 1 << 20,
                              device="cpu")
    assert int(div[0]) == 900 - 250 and not need0.any()
    need1, _, _ = PRD.score(com, cap, np.ones(4, bool), 2000, 300,
                            device="cpu")
    assert int(need1[0]) == 90 - (250 + 300) * 100 // 1000
    assert not need1[1:].any()


def test_score_kernel_on_cpu_takes_the_plain_version():
    import torch

    from karmada_tpu_torch.ops import kernels

    before = kernels.LAUNCHES["rebalance_score"]
    com = torch.tensor([5, 0], dtype=torch.int64)
    out = PRD.score_kernel(com, torch.tensor([4, 0], dtype=torch.int64),
                           torch.tensor([True, True]), 1000, SPREAD_OFF)
    assert [o.tolist() for o in out] == [[1, 0], [1250, 0], [0, 0]]
    assert kernels.LAUNCHES["rebalance_score"] == before


# -- plane mechanics (tests/test_rebalance.py on the port) ----------------------

class _SchedStub:
    """The slice of Scheduler the plane touches: a queue clock + promote."""

    def __init__(self, clock):
        self.queue = type("Q", (), {"now": staticmethod(clock)})()
        self.promoted = []

    def promote(self, key, priority=0, origin="rebalance"):
        self.promoted.append((key, priority, origin))
        return "admitted"


def _divided(M, name, targets, replicas=None, dup=False):
    total = sum(r for _, r in targets)
    rs = (M.ReplicaSchedulingStrategy(
        replica_scheduling_type=M.REPLICA_SCHEDULING_DUPLICATED) if dup
        else M.ReplicaSchedulingStrategy(
            replica_scheduling_type=M.REPLICA_SCHEDULING_DIVIDED,
            replica_division_preference=M.REPLICA_DIVISION_AGGREGATED))
    return M.ResourceBinding(
        metadata=M.ObjectMeta(namespace="ns", name=name),
        spec=M.ResourceBindingSpec(
            resource=M.ObjectReference(api_version="apps/v1",
                                       kind="Deployment", namespace="ns",
                                       name=name, uid=f"uid-{name}"),
            replicas=replicas if replicas is not None else total,
            placement=M.Placement(replica_scheduling=rs),
            clusters=[M.TargetCluster(name=c, replicas=r)
                      for c, r in targets]))


def _env(per_cluster=8, pods=100):
    clock = S.FakeClock()
    store = ObjectStore()
    for n in ("m1", "m2"):
        store.create(S.pods_cluster(MP, n, pods))
    sched = _SchedStub(clock)
    budget = EvictionBudget(per_cluster=per_cluster, interval_s=60.0,
                            clock=clock)
    plane = RebalancePlane(store, sched, cfg=RebalanceConfig(interval_s=5.0),
                           budget=budget, clock=clock, device="cpu")
    return clock, store, sched, plane


def _set_pods(M, store, name, pods):
    def fn(c):
        c.status.resource_summary.allocatable["pods"] = (
            M.Quantity.from_units(pods))
    store.mutate("Cluster", "", name, fn)


def test_drain_evicts_gracefully_and_promotes():
    _, store, sched, plane = _env()
    for i in range(4):
        store.create(_divided(MP, f"b{i}", [("m1", 10)]))
    _set_pods(MP, store, "m1", 20)
    snap = plane.run_cycle()
    assert snap["clusters"]["m1"]["drain_need"] == 20
    assert snap["evicted"] == 2  # 2 x 10 replicas cover the need
    drained = [rb for rb in store.list("ResourceBinding")
               if rb.spec.graceful_eviction_tasks]
    assert len(drained) == 2
    for rb in drained:
        task = rb.spec.graceful_eviction_tasks[0]
        assert (task.producer, task.from_cluster, task.replicas) == (
            "rebalance", "m1", 10)
        assert not rb.spec.clusters
    assert [o for _, _, o in sched.promoted] == ["rebalance"] * 2
    assert snap["violations"] == 0
    snap2 = plane.run_cycle()  # in-flight drains are not drained again
    assert snap2["evicted"] <= 2
    for rb in store.list("ResourceBinding"):
        assert len([t for t in rb.spec.graceful_eviction_tasks
                    if t.producer == "rebalance"]) <= 1


def test_drain_invalid_lane_never_selected():
    _, store, sched, plane = _env()
    store.create(_divided(MP, "b0", [("m1", 50)]))

    def drop_pods(c):
        del c.status.resource_summary.allocatable["pods"]
    store.mutate("Cluster", "", "m1", drop_pods)
    snap = plane.run_cycle()
    assert snap["clusters"]["m1"]["drain_need"] == 0
    assert snap["evicted"] == 0 and not sched.promoted


def test_drain_respects_budget_pacing():
    clock, store, _, plane = _env(per_cluster=3)
    for i in range(20):
        store.create(_divided(MP, f"b{i:02d}", [("m1", 10)]))
    _set_pods(MP, store, "m1", 10)
    assert plane.run_cycle()["evicted"] == 3
    assert plane.run_cycle()["evicted"] == 0  # same window
    clock.advance(60.0)
    assert plane.run_cycle()["evicted"] == 3  # the window rolled
    assert plane.budget.state()["granted_by_consumer"] == {"rebalance": 6}
    # one denial ends each cycle's drain of m1
    assert plane.budget.state()["denied_by_consumer"] == {"rebalance": 3}


def test_budget_property_two_consumers_never_exceed():
    clock = S.FakeClock()
    budget = EvictionBudget(per_cluster=5, interval_s=10.0, clock=clock)
    rng = random.Random(42)
    grants = {"m1": 0, "m2": 0}
    for _ in range(200):
        cluster = rng.choice(["m1", "m2"])
        consumer = rng.choice(["descheduler", "rebalance"])
        if budget.try_acquire(cluster, consumer=consumer):
            grants[cluster] += 1
    assert grants == {"m1": 5, "m2": 5}
    assert sum(budget.spent.values()) == 10
    assert sum(budget.denied.values()) == 190
    clock.advance(10.0)
    assert budget.try_acquire("m1")
    assert budget.remaining("m1") == 4


def test_conservation_violation_detected():
    _, store, _, plane = _env()
    rb = _divided(MP, "hurt", [("m1", 2)], replicas=5)
    rb.spec.graceful_eviction_tasks.append(MP.GracefulEvictionTask(
        from_cluster="m2", replicas=1, producer="rebalance"))
    store.create(rb)  # serving 3 < desired 5
    snap = plane.run_cycle()
    assert snap["violations"] == 1
    st = plane.stats()
    assert st["conservation_violations"] == 1
    assert st["violation_samples"][-1]["binding"] == "ns/hurt"
    assert "1 conservation violation(s)" in render_state(st)


def test_duplicated_bindings_never_drained():
    _, store, sched, plane = _env()
    store.create(_divided(MP, "dup", [("m1", 200)], replicas=200, dup=True))
    _set_pods(MP, store, "m1", 10)
    snap = plane.run_cycle()
    assert snap["clusters"]["m1"]["drain_need"] > 0
    assert snap["evicted"] == 0 and not sched.promoted
    assert not snap["converged"] and not plane.converged()


def test_raising_cycle_contained_and_counted(monkeypatch):
    clock, _, _, plane = _env()

    def boom(*a, **k):
        raise RuntimeError("detect failed")
    monkeypatch.setattr(PRD, "score", boom)
    plane.maybe_run()  # must not raise
    assert plane.cycle_faults == {"RuntimeError": 1}
    assert plane.stats()["cycle_faults"] == {"RuntimeError": 1}
    plane.maybe_run()  # inside the interval: no cycle
    assert plane.cycle_faults == {"RuntimeError": 1}


def test_empty_fleet_runs_no_detect(monkeypatch):
    clock = S.FakeClock()
    plane = RebalancePlane(ObjectStore(), _SchedStub(clock), clock=clock,
                           device="cpu")
    monkeypatch.setattr(PRD, "score", None)  # any detect call would raise
    snap = plane.run_cycle()
    assert snap["clusters"] == {} and snap["converged"]
    assert plane.converged() and plane.pending_drains() == 0


# -- three plane cycles, JAX against the port ------------------------------------

def _mirrored_store(M, Store, seed):
    """12 clusters, 120 bindings with random targets (Divided mixes and
    some Duplicated), two clusters crushed to 60% of what they hold."""
    rng = random.Random(seed)
    store = Store()
    fleet = S.control_fleet(M, rng, 12)
    names = [c.name for c in fleet]
    for c in fleet:
        store.create(c)
    pls = S.control_placements(M, rng, names)
    bindings = S.control_bindings(M, rng, 120, pls, replicas=(2, 5, 9, 14))
    for rb in bindings:
        k = rng.randint(1, 3)
        picks = rng.sample(names[:6], k)
        rb.spec.clusters = [M.TargetCluster(name=n, replicas=rb.spec.replicas)
                            for n in sorted(picks)]
        store.create(rb)
    held = S.committed_by_cluster(bindings)
    for n in sorted(held, key=lambda n: (-held[n], n))[:2]:
        S.crush(M, store, n, held[n])
    return store


def _tasks(store):
    return {(rb.namespace, rb.name): [
        (t.from_cluster, t.replicas, t.producer, t.reason,
         t.creation_timestamp) for t in rb.spec.graceful_eviction_tasks]
        for rb in store.list("ResourceBinding")}


@pytest.mark.parametrize("seed", [0, 1])
def test_plane_cycles_match_jax(seed):
    out = []
    for M, Store, Plane, Config, Budget, kw in (
            (MJ, JaxStore, JaxPlane, JaxConfig, JaxBudget, {}),
            (MP, ObjectStore, RebalancePlane, RebalanceConfig,
             EvictionBudget, {"device": "cpu"})):
        clock = S.FakeClock()
        store = _mirrored_store(M, Store, seed)
        sched = _SchedStub(clock)
        cfg = Config(interval_s=30.0, max_evictions_per_cycle=12,
                     budget_per_cluster=5, budget_interval_s=60.0)
        plane = Plane(store, sched, cfg=cfg,
                      budget=Budget(per_cluster=5, interval_s=60.0,
                                    clock=clock), clock=clock, **kw)
        snaps, budgets = [], []
        for _ in range(3):
            clock.advance(30.0)
            snaps.append(plane.run_cycle())
            st = plane.budget.state()
            budgets.append({k: st[k] for k in ("per_cluster", "interval_s",
                                               "window_age_s", "spent")})
        stats = plane.stats()
        out.append((snaps, list(sched.promoted), _tasks(store), budgets,
                    {k: stats[k] for k in ("cycles", "evictions",
                                           "conservation_violations",
                                           "peak_over_milli", "last")}))
    jax_run, port_run = out
    assert sum(s["evicted"] for s in port_run[0]) > 0
    for a, b in zip(jax_run, port_run):
        assert a == b


# -- the capacity memo belongs to the plane --------------------------------------

def test_capacity_memo_is_per_plane():
    """Equal names and resourceVersions, different pods: each plane reads
    its own store (a process-wide memo keyed by (name, rv) would hand
    the second store the first one's capacity)."""
    planes = []
    for pods in (100, 10):
        clock = S.FakeClock()
        store = ObjectStore()
        store.create(S.pods_cluster(MP, "m1", pods))  # rv 1 in both
        store.create(_divided(MP, "b0", [("m1", 50)]))
        planes.append(RebalancePlane(store, _SchedStub(clock), clock=clock,
                                     device="cpu"))
    a, b = (p.run_cycle()["clusters"]["m1"] for p in planes)
    assert (a["capacity"], a["drain_need"]) == (100, 0)
    assert (b["capacity"], b["drain_need"]) == (10, 40)
