"""The port's C++ serial control (native/serial_solver.cc through
native.schedule_batch_native) agrees with the port's ops/serial.schedule
binding for binding -- same targets, same failure class -- and with the
JAX package's native.run_marshaled on the same inputs: bench.py's mix,
taints / affinity / static weights, scale paths and fresh reassignment,
region spread DFS, non-workload zero propagation; the classes it does not
support are marked STATUS_UNSUPPORTED, never mis-scheduled.  The port's
Scheduler(backend="native") and (backend="serial") schedule a store as the
JAX Scheduler with the same backend does; processes that build the native
sources at once into one fresh directory all load them."""

import os
import random
import subprocess
import sys
from pathlib import Path

import pytest

import torch_scenarios as S
from torch_fixtures import collect_jax_planes  # noqa: F401 — autouse
from karmada_tpu import native as JN
from karmada_tpu import rebalance as jax_rebalance_mod
from karmada_tpu import resident as jax_resident_mod
from karmada_tpu.ops import tensors as JT
from karmada_tpu_torch import native as PN
from karmada_tpu_torch.estimator.general import GeneralEstimator
from karmada_tpu_torch.ops import serial as PSer

MJ = S.models_of("karmada_tpu")
MP = S.models_of("karmada_tpu_torch")
ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _clean_globals():
    JT._FLEET_CAP_MEMO.clear()  # process-wide in the JAX package
    yield
    JT._FLEET_CAP_MEMO.clear()
    jax_rebalance_mod.set_active(None)
    jax_resident_mod.set_active(None)



def mk_cluster(M, name, region="", cpu=32000, mem=128, pods=110, taints=(),
               deleting=False, no_summary=False):
    return M.Cluster(
        metadata=M.ObjectMeta(name=name,
                              deletion_timestamp=1.0 if deleting else None),
        spec=M.ClusterSpec(region=region, taints=list(taints)),
        status=M.ClusterStatus(
            api_enablements=[M.APIEnablement(S.GVK[0], [S.GVK[1]])],
            resource_summary=None if no_summary else M.ResourceSummary(
                allocatable={"cpu": M.Quantity.from_milli(cpu),
                             "memory": M.Quantity.from_units(mem),
                             "pods": M.Quantity.from_units(pods)},
                allocated={})))


def mk_binding(M, name, placement, replicas=10, cpu_m=250, prev=(),
               fresh=False, requirements=True):
    spec = M.ResourceBindingSpec(
        resource=M.ObjectReference(api_version=S.GVK[0], kind=S.GVK[1],
                                   namespace="default", name=name,
                                   uid=f"uid-{name}"),
        replicas=replicas,
        replica_requirements=(M.ReplicaRequirements(resource_request={
            "cpu": M.Quantity.from_milli(cpu_m)}) if requirements else None),
        placement=placement,
        clusters=[M.TargetCluster(name=n, replicas=r) for n, r in prev],
        reschedule_triggered_at=100.0 if fresh else None)
    return spec, M.ResourceBindingStatus()


def _divided(M, **kw):
    return M.ReplicaSchedulingStrategy(
        replica_scheduling_type=M.REPLICA_SCHEDULING_DIVIDED, **kw)


def _dynamic(M):
    return _divided(M, replica_division_preference=M.REPLICA_DIVISION_WEIGHTED,
                    weight_preference=M.ClusterPreferences(
                        dynamic_weight=M.DYNAMIC_WEIGHT_AVAILABLE_REPLICAS))


def case_bench(M):
    return S.bench_scenario(M, 7, 96, 384)[:2]


def case_taints_affinity_weights(M):
    taint = M.Taint(key="maintenance", value="true",
                    effect=M.EFFECT_NO_SCHEDULE)
    clusters = [
        mk_cluster(M, "m-a", region="r1"),
        mk_cluster(M, "m-b", region="r1", taints=[taint]),
        mk_cluster(M, "m-c", region="r2"),
        mk_cluster(M, "m-d", region="r2", deleting=True),
        mk_cluster(M, "m-e", no_summary=True),
    ]
    tolerate = M.Toleration(key="maintenance", operator="Exists")
    weights = M.ClusterPreferences(static_weight_list=[
        M.StaticClusterWeight(
            target_cluster=M.ClusterAffinity(cluster_names=["m-a"]), weight=3),
        M.StaticClusterWeight(
            target_cluster=M.ClusterAffinity(cluster_names=["m-c"]), weight=1)])
    items = [
        mk_binding(M, "tainted", M.Placement(replica_scheduling=_dynamic(M))),
        mk_binding(M, "tolerated", M.Placement(
            cluster_tolerations=[tolerate], replica_scheduling=_dynamic(M))),
        mk_binding(M, "affinity", M.Placement(
            cluster_affinity=M.ClusterAffinity(cluster_names=["m-a", "m-c"]),
            replica_scheduling=M.ReplicaSchedulingStrategy(
                replica_scheduling_type=M.REPLICA_SCHEDULING_DUPLICATED)),
            replicas=3),
        mk_binding(M, "static-weighted", M.Placement(
            replica_scheduling=_divided(
                M, replica_division_preference=M.REPLICA_DIVISION_WEIGHTED,
                weight_preference=weights)), replicas=8),
        mk_binding(M, "no-fit", M.Placement(
            cluster_affinity=M.ClusterAffinity(cluster_names=["absent"])),
            replicas=2),
    ]
    return clusters, items


def case_scale_and_fresh(M):
    clusters = [mk_cluster(M, f"m-{i}", region=f"r{i % 3}", cpu=64000,
                           pods=200) for i in range(12)]
    dyn = M.Placement(replica_scheduling=_dynamic(M))
    agg = M.Placement(replica_scheduling=_divided(
        M, replica_division_preference=M.REPLICA_DIVISION_AGGREGATED))
    items = [
        mk_binding(M, "up", dyn, replicas=20, prev=[("m-1", 3), ("m-2", 3)]),
        mk_binding(M, "down", dyn, replicas=10,
                   prev=[("m-0", 10), ("m-3", 12), ("m-5", 8)]),
        mk_binding(M, "same", dyn, replicas=6, prev=[("m-1", 2), ("m-2", 4)]),
        mk_binding(M, "fresh", dyn, replicas=9, prev=[("m-7", 9)],
                   fresh=True),
        mk_binding(M, "agg-up", agg, replicas=14, prev=[("m-4", 4)]),
    ]
    return clusters, items


def case_region_spread(M):
    rng = random.Random(3)
    clusters = [mk_cluster(M, f"m-{i:02d}", region=f"r{i % 5}",
                           cpu=rng.randint(8000, 64000),
                           pods=rng.randint(30, 200)) for i in range(30)]
    items = []
    for i in range(24):
        rmin = rng.randint(1, 2)
        p = M.Placement(
            spread_constraints=[
                M.SpreadConstraint(spread_by_field=M.SPREAD_BY_FIELD_REGION,
                                   min_groups=rmin,
                                   max_groups=rng.randint(rmin, 4)),
                M.SpreadConstraint(spread_by_field=M.SPREAD_BY_FIELD_CLUSTER,
                                   min_groups=2,
                                   max_groups=rng.randint(2, 8))],
            replica_scheduling=_dynamic(M))
        items.append(mk_binding(M, f"spread-{i}", p,
                                replicas=rng.choice([3, 10, 40])))
    return clusters, items


def case_non_workload(M):
    """ConfigMap-style bindings (replicas 0, no requirements) propagate to
    every candidate with zero replicas (core/common.go:44-78)."""
    clusters = [mk_cluster(M, n) for n in ("m-a", "m-b", "m-c")]
    return clusters, [mk_binding(M, "cm", M.Placement(), replicas=0,
                                 requirements=False)]


CASES = {"bench": case_bench, "taints": case_taints_affinity_weights,
         "scale": case_scale_and_fresh, "region_spread": case_region_spread,
         "non_workload": case_non_workload}


def _serial_status(spec, status, clusters, cal):
    try:
        want = PSer.schedule(spec, status, clusters, cal)
    except PSer.FitError:
        return PN.STATUS_FIT_ERROR, {}
    except PSer.UnschedulableError:
        return PN.STATUS_UNSCHEDULABLE, {}
    except PSer.NoClusterAvailableError:
        return PN.STATUS_NO_CLUSTER, {}
    return PN.STATUS_OK, {t.name: t.replicas for t in want}


@pytest.mark.parametrize("case", sorted(CASES))
def test_control_equals_serial_and_jax(case):
    cp, ip = CASES[case](MP)
    cj, ij = CASES[case](MJ)
    snap = PN.NativeSnapshot(cp, PN.collect_res_names(ip))
    got = PN.schedule_batch_native(ip, snap)
    jsnap = JN.NativeSnapshot(cj, JN.collect_res_names(ij))
    jgot = JN.run_marshaled(JN.marshal_batch(ij, jsnap), jsnap)
    cal = PSer.make_cal_available([GeneralEstimator()])
    statuses = set()
    for (spec, status), (st, targets), (jst, jtargets) in zip(ip, got, jgot):
        name = spec.resource.name
        assert st != PN.STATUS_UNSUPPORTED, f"{name}: unexpectedly unsupported"
        want_st, want = _serial_status(spec, status, cp, cal)
        assert st == want_st == jst, (name, st, want_st, jst)
        if st == PN.STATUS_OK:
            got_d = {t.name: t.replicas for t in targets}
            assert got_d == want == {t.name: t.replicas for t in jtargets}, (
                name, got_d, want)
            assert all(type(t) is MP.TargetCluster for t in targets)
        statuses.add(st)
    if case == "taints":
        assert {PN.STATUS_OK, PN.STATUS_FIT_ERROR} <= statuses
    if case == "non_workload":
        assert {t.replicas for t in got[0][1]} == {0} and len(got[0][1]) == 3


def case_unsupported(M):
    """The control's serial-only classes: a vanished previous cluster, a
    multi-component set, a weight of 2^31, a resource-model histogram."""
    clusters = [mk_cluster(M, "m-a"), mk_cluster(M, "m-b")]
    req = M.ReplicaRequirements(resource_request={
        "cpu": M.Quantity.from_milli(100)})
    vanished = mk_binding(M, "vanished", M.Placement(), replicas=5,
                          prev=[("gone", 5)])
    multi = mk_binding(M, "multi", M.Placement(), replicas=2)
    multi[0].components = [
        M.Component(name="a", replicas=1, replica_requirements=req),
        M.Component(name="b", replicas=1, replica_requirements=req)]
    heavy = mk_binding(M, "heavy", M.Placement(replica_scheduling=_divided(
        M, replica_division_preference=M.REPLICA_DIVISION_WEIGHTED,
        weight_preference=M.ClusterPreferences(static_weight_list=[
            M.StaticClusterWeight(
                target_cluster=M.ClusterAffinity(cluster_names=["m-a"]),
                weight=1 << 31)]))), replicas=3)
    return clusters, [vanished, multi, heavy]


def test_unsupported_marked_not_wrong():
    for M, mod in ((MP, PN), (MJ, JN)):
        clusters, items = case_unsupported(M)
        snap = mod.NativeSnapshot(clusters, ["cpu"])
        got = mod.schedule_batch_native(items, snap)
        assert [st for st, _ in got] == [mod.STATUS_UNSUPPORTED] * 3
        # a resource-model histogram anywhere in the fleet marks every row
        clusters[0].status.resource_summary.allocatable_modelings = [
            M.AllocatableModeling(grade=0, count=1)]
        ok = [mk_binding(M, "plain", M.Placement(), replicas=1)]
        snap = mod.NativeSnapshot(clusters, ["cpu"])
        assert mod.schedule_batch_native(ok, snap)[0][0] == (
            mod.STATUS_UNSUPPORTED)


# -- the Scheduler's host backends on mirrored stores -------------------------

def _scheduler_run(name, backend, empty_prop):
    import importlib

    M = S.models_of(name)
    st = importlib.import_module(f"{name}.store.store")
    wk = importlib.import_module(f"{name}.store.worker")
    qu = importlib.import_module(f"{name}.scheduler.queue")
    sv = importlib.import_module(f"{name}.scheduler.service")
    rng = random.Random(11)
    clock = S.FakeClock()
    store, rt = st.ObjectStore(), wk.Runtime()
    fleet = S.control_fleet(M, rng, 8)
    names = [c.name for c in fleet]
    for c in fleet:
        store.create(c)
    sched = sv.Scheduler(store, rt, backend=backend,
                         queue=qu.SchedulingQueue(now=clock),
                         enable_empty_workload_propagation=empty_prop)
    trace = []

    def tick(advance=1.0):
        clock.advance(advance)
        rt.tick()
        trace.append((S.placements_of(store), sched.queue.depths()))

    pls = S.control_placements(M, rng, names)
    bindings = S.control_bindings(M, rng, 40, pls)
    big = S.control_bindings(M, random.Random(5), 1, pls[:1])[0]
    big.metadata.name = big.spec.resource.name = "huge"
    big.spec.replicas = 4_000  # more than the fleet holds: parked
    cm = S.control_bindings(M, random.Random(6), 1, pls[3:4])[0]
    cm.metadata.name = cm.spec.resource.name = "config"
    cm.spec.replicas, cm.spec.replica_requirements = 0, None
    for rb in bindings + [big, cm]:
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
    return trace, sched


@pytest.mark.parametrize("backend,empty_prop", [
    ("native", False), ("serial", False), ("native", True)])
def test_scheduler_host_backends_match_jax(backend, empty_prop):
    jax_trace, _ = _scheduler_run("karmada_tpu", backend, empty_prop)
    port_trace, sched = _scheduler_run("karmada_tpu_torch", backend,
                                       empty_prop)
    assert len(jax_trace) == len(port_trace) == 6
    for i, (a, b) in enumerate(zip(jax_trace, port_trace)):
        assert a == b, f"tick {i}"
    final = port_trace[-1][0]
    assert final[("ns0", "huge")][1][0][:2] == ("Scheduled", "True")
    assert any(v[4] == "backup" for v in final.values())  # failover ran
    assert sched.faults() == {} and sched.device is None
    log = list(sched.cycle_log)
    assert log and all(e["backend"] == backend and e["fault"] is None
                       for e in log)
    native_s = sum(e["native_s"] for e in log)
    serial_s = sum(e["serial_s"] for e in log)
    assert serial_s > 0
    assert (native_s > 0) == (backend == "native" and not empty_prop)


def test_scheduler_backend_arms_device_planes_only_on_device():
    from karmada_tpu_torch.scheduler import Scheduler
    from karmada_tpu_torch.store import ObjectStore, Runtime

    sched = Scheduler(ObjectStore(), Runtime(), backend="native",
                      resident=True, shortlist_k=8)
    assert sched.backend == "native" and sched.device is None
    assert sched._resident is None and sched.shortlist is None
    with pytest.raises(ValueError, match="backend"):
        Scheduler(ObjectStore(), Runtime(), backend="tpu")


_BUILD = r"""
import sys
sys.path.insert(0, {root!r})
from karmada_tpu_torch import native
paths = native.build()
assert native.schedule_batch_native([], native.NativeSnapshot([], [])) == []
print("BUILT", native.COUNTS["builds"], sorted(str(p) for p in paths.values()))
"""


def test_concurrent_builds_all_load(tmp_path):
    """Two processes building into one fresh directory at once: each
    compiles to a file of its own and moves it into place, and both load
    whole libraries."""
    env = dict(os.environ, KARMADA_TORCH_NATIVE_BUILD_DIR=str(tmp_path))
    env.pop("PYTHONPATH", None)
    code = _BUILD.format(root=str(ROOT))
    procs = [subprocess.Popen([sys.executable, "-c", code], env=env,
                              cwd=str(ROOT), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, out + err
    lines = [next(ln for ln in out.splitlines() if ln.startswith("BUILT"))
             for out, _err in outs]
    assert lines[0].split(" ", 2)[2] == lines[1].split(" ", 2)[2]
    built = sorted(p.name for p in tmp_path.rglob("*") if p.is_file())
    assert len(built) == 3 and not any(".tmp" in n for n in built), built
