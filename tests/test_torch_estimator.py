"""Accurate-estimator-tier parity: the port's estimator/{wire,server,
client}.py, Scheduler(estimators=) and controllers/descheduler.py against
the JAX package's, tolerance 0.

  * every case of tests/test_estimator_tier.py, the component-set case
    and the four node-packing cases of tests/test_multi_component.py, on
    both packages: equal answers, each also held to the JAX test's value
    (the TCP round trip over a real localhost socket, as the JAX test);
  * the client's hardening: the breaker's transitions, typed errors and
    retries counted by kind, the rv-keyed memo's skips, and deregister
    releasing transport, breaker state and memo -- driven by a transport
    that raises, in place of the JAX package's chaos seam;
  * a mixed batch (device-route rows, host-route rows, a multi-component
    row) under Scheduler(estimators=[GeneralEstimator(), client]) on the
    serial, native and device (device="cpu") backends: the port's
    placements equal the JAX Scheduler's row by row;
  * tests/test_failover.py::test_descheduler_moves_stuck_replicas through
    both ControlPlanes (torch_loop), snapshots equal after each tick, and
    tests/test_rebalance.py::test_descheduler_and_rebalance_share_one_budget
    on both packages.
"""

import importlib

import pytest

import torch_scenarios as S
from torch_fixtures import collect_jax_planes  # noqa: F401 — autouse
from torch_loop import (  # noqa: F401 — deterministic_uids is autouse
    MJ,
    MP,
    Clock,
    deterministic_uids,
    plane,
    run_both,
    snapshot,
)

BACKENDS = ["serial", "native", "device"]


def tier(name):
    """One package's estimator tier and the models it speaks."""
    M = S.models_of(name)
    for mod in ("estimator.client", "estimator.server", "estimator.wire",
                "estimator.general", "members.member", "utils.features",
                "store.store", "store.worker", "rebalance",
                "controllers.descheduler", "ops.serial", "scheduler"):
        setattr(M, mod.split(".")[-1], importlib.import_module(
            f"{name}.{mod}"))
    M.name = name
    return M


EJ, EP = tier("karmada_tpu"), tier("karmada_tpu_torch")


@pytest.fixture(autouse=True)
def _clean_memo():
    # the JAX package's fleet-capacity memo is process-wide and keyed by
    # (name, resourceVersion): clusters of an earlier test would leak in
    fleet_memo = importlib.import_module("karmada_tpu.ops.tensors")
    fleet_memo._FLEET_CAP_MEMO.clear()
    yield
    fleet_memo._FLEET_CAP_MEMO.clear()


def member_with_nodes(E):
    Q = E.Quantity
    return E.member.FakeMemberCluster(name="m1", nodes=[
        E.member.FakeNode(name="n1", cpu_milli=4000,
                          memory_milli=Q.parse("8Gi").milli, pods=10,
                          labels={"tier": "fast"}),
        E.member.FakeNode(name="n2", cpu_milli=2000,
                          memory_milli=Q.parse("4Gi").milli, pods=10),
    ])


def req(E, cpu="1", memory="1Gi", selector=None):
    return E.ReplicaRequirements(
        resource_request={"cpu": E.Quantity.parse(cpu),
                          "memory": E.Quantity.parse(memory)},
        node_claim=E.NodeClaim(node_selector=selector) if selector else None,
    )


def local_client(E, member, **kw):
    client = E.client.AccurateEstimatorClient(**kw)
    client.register(member.name, E.wire.LocalTransport(
        E.server.AccurateEstimatorServer(member).handle))
    return client


def close_client(E, client):
    if E is EP:
        client.close()
    else:
        client._pool.shutdown(wait=True)  # noqa: SLF001 — no close() there


def eater(replicas, cpu="1", memory="1Gi", name="eater"):
    return {"apiVersion": "apps/v1", "kind": "Deployment",
            "metadata": {"name": name, "namespace": "default"},
            "spec": {"replicas": replicas, "template": {"spec": {
                "containers": [{"name": "c", "resources": {"requests": {
                    "cpu": cpu, "memory": memory}}}]}}}}


# -- tests/test_estimator_tier.py ---------------------------------------------

def case_node_level_estimate(E):
    return E.server.AccurateEstimatorServer(
        member_with_nodes(E)).max_available_replicas(req(E)), 6


def case_node_selector_filters_nodes(E):
    return E.server.AccurateEstimatorServer(
        member_with_nodes(E)).max_available_replicas(
            req(E, selector={"tier": "fast"})), 4


def case_applied_workloads_consume_capacity(E):
    member = member_with_nodes(E)
    member.apply(eater(3))
    return E.server.AccurateEstimatorServer(
        member).max_available_replicas(req(E)), 3


def case_unschedulable_replicas_counted(E):
    member = E.member.FakeMemberCluster(name="m1",
                                        cpu_allocatable_milli=2000)
    member.apply(eater(5, memory="0", name="big"))
    return E.server.AccurateEstimatorServer(member).unschedulable_replicas(
        "Deployment", "default", "big"), 3


def case_accurate_client_min_merge_and_sentinel(E):
    client = local_client(E, member_with_nodes(E))
    clusters = [E.Cluster(metadata=E.ObjectMeta(name="m1")),
                E.Cluster(metadata=E.ObjectMeta(name="m2"))]
    try:
        out = client.max_available_replicas(clusters, req(E))
    finally:
        close_client(E, client)
    return {t.name: t.replicas for t in out}, {"m1": 6, "m2": -1}


def case_tcp_transport_roundtrip(E):
    impl = E.server.AccurateEstimatorServer(member_with_nodes(E))
    srv = E.wire.serve_tcp(impl.handle)
    host, port = srv.server_address
    client = E.client.AccurateEstimatorClient()
    try:
        client.register("m1", E.wire.TcpTransport(host, port))
        out = client.max_available_replicas(
            [E.Cluster(metadata=E.ObjectMeta(name="m1"))], req(E))
        stuck = client.unschedulable_replicas("m1", "Deployment",
                                              "default", "x")
        client.deregister("m1")
    finally:
        srv.shutdown()
        srv.server_close()
        close_client(E, client)
    return (out[0].replicas, stuck), (6, 0)


def case_snapshot_estimator_matches_accurate(E):
    client = local_client(E, member_with_nodes(E))
    snap = E.client.SnapshotEstimator(client)
    clusters = [E.Cluster(metadata=E.ObjectMeta(name="m1"))]
    got = []
    try:
        for r in (req(E), req(E, cpu="500m", memory="512Mi"), None):
            got.append((client.max_available_replicas(clusters, r)[0]
                        .replicas,
                        snap.max_available_replicas(clusters, r)[0]
                        .replicas))
    finally:
        close_client(E, client)
    assert all(a == b for a, b in got)
    return got, [(6, 6), (12, 12), (20, 20)]


def case_scheduler_uses_accurate_estimator(E):
    member = member_with_nodes(E)
    client = local_client(E, member)
    cluster = E.Cluster(
        metadata=E.ObjectMeta(name="m1"),
        status=E.ClusterStatus(
            api_enablements=[E.APIEnablement("apps/v1", ["Deployment"])],
            resource_summary=member.resource_summary()))
    spec = E.ResourceBindingSpec(
        resource=E.ObjectReference(api_version="apps/v1", kind="Deployment",
                                   name="x", uid="u"),
        replicas=3, replica_requirements=req(E))
    cal = E.serial.make_cal_available([E.general.GeneralEstimator(), client])
    try:
        out = cal([cluster], spec)
    finally:
        close_client(E, client)
    return out[0].replicas, 6


def case_resource_quota_plugin_caps_estimate(E):
    member = E.member.FakeMemberCluster(name="m1",
                                        cpu_allocatable_milli=64_000)
    member.apply({
        "apiVersion": "v1", "kind": "ResourceQuota",
        "metadata": {"name": "team-a", "namespace": "default"},
        "spec": {"hard": {"cpu": "2", "memory": "8Gi"}},
        "status": {"used": {"cpu": "500m"}},
    })
    Q = E.Quantity
    r = E.ReplicaRequirements(
        resource_request={"cpu": Q.parse("500m"), "memory": Q.parse("1Gi")},
        namespace="default")
    other = E.ReplicaRequirements(resource_request={"cpu": Q.parse("500m")},
                                  namespace="prod")
    off = E.server.AccurateEstimatorServer(
        member, gates=E.features.FeatureGates())
    on = E.server.AccurateEstimatorServer(
        member, gates=E.features.FeatureGates({"ResourceQuotaEstimate":
                                               True}))
    got = (off.max_available_replicas(r), on.max_available_replicas(r),
           on.max_available_replicas(other))
    assert got[0] > 3 and got[2] > 3
    return got[1], 3


# -- tests/test_multi_component.py: component sets and node packing -----------

def flink_components(E):
    Q = E.Quantity
    return [
        E.Component(name="jobmanager", replicas=1,
                    replica_requirements=E.ReplicaRequirements(
                        resource_request={"cpu": Q.parse("1"),
                                          "memory": Q.parse("2Gi")})),
        E.Component(name="taskmanager", replicas=3,
                    replica_requirements=E.ReplicaRequirements(
                        resource_request={"cpu": Q.parse("2"),
                                          "memory": Q.parse("4Gi")})),
    ]


def case_estimator_server_component_sets(E):
    m = E.member.FakeMemberCluster("m", cpu_allocatable_milli=64_000,
                                   memory_allocatable_gi=256,
                                   pods_allocatable=110)
    return (E.server.AccurateEstimatorServer(m)
            .max_available_component_sets(flink_components(E))), 9


def _one(E, name, replicas, **request):
    rr = (E.ReplicaRequirements(resource_request={
        k: E.Quantity.parse(v) for k, v in request.items()})
        if request else None)
    return [E.Component(name=name, replicas=replicas,
                        replica_requirements=rr)]


def case_node_packing_fragmentation_caught(E):
    comps = _one(E, "big", 1, cpu="2")
    f = E.wire.max_sets_from_free_table
    return (f([{"cpu": 1000, "pods": 10}, {"cpu": 1000, "pods": 10}], comps),
            f([{"cpu": 2000, "pods": 10}], comps)), (0, 1)


def case_node_packing_spreads_replicas_across_nodes(E):
    comps = _one(E, "tm", 3, cpu="1")
    f = E.wire.max_sets_from_free_table
    return (f([{"cpu": 1000, "pods": 5}] * 3, comps),
            f([{"cpu": 2000, "pods": 5}] * 3, comps)), (1, 2)


def case_node_packing_pods_only_matches_pool(E):
    return E.wire.max_sets_from_free_table(
        [{"pods": 3}, {"pods": 4}], _one(E, "c", 2)), 3


def case_node_packing_memory_units(E):
    gib = 1 << 30
    free = [{"memory": 3 * gib * 1000, "pods": 10},
            {"memory": 3 * gib * 1000, "pods": 10}]
    return E.wire.max_sets_from_free_table(
        free, _one(E, "m", 1, memory="2Gi")), 2


CASES = [
    case_node_level_estimate,
    case_node_selector_filters_nodes,
    case_applied_workloads_consume_capacity,
    case_unschedulable_replicas_counted,
    case_accurate_client_min_merge_and_sentinel,
    case_tcp_transport_roundtrip,
    case_snapshot_estimator_matches_accurate,
    case_scheduler_uses_accurate_estimator,
    case_resource_quota_plugin_caps_estimate,
    case_estimator_server_component_sets,
    case_node_packing_fragmentation_caught,
    case_node_packing_spreads_replicas_across_nodes,
    case_node_packing_pods_only_matches_pool,
    case_node_packing_memory_units,
]


@pytest.mark.parametrize("case", CASES, ids=lambda f: f.__name__[5:])
def test_estimator_tier_parity(case):
    got_jax, want = case(EJ)
    got_port, want_port = case(EP)
    assert got_jax == want
    assert got_port == got_jax and want_port == want


def plan_walk(E):
    """A member's admission plan and unschedulable counts as its state
    moves: a workload applied, its pods cut, its nodes' pods freed."""
    member = E.member.FakeMemberCluster(name="m1",
                                        cpu_allocatable_milli=4000)
    member.apply(eater(3, memory="0", name="a"))
    member.apply(eater(4, memory="0", name="b"))
    out = [dict(member.admission_plan()),
           member.unschedulable_replicas("Deployment", "default", "b")]
    member.pods_allocatable = 2
    out += [dict(member.admission_plan()),
            member.unschedulable_replicas("Deployment", "default", "a")]
    member.delete("Deployment", "default", "a")
    out += [dict(member.admission_plan()),
            member.unschedulable_replicas("Deployment", "default", "b")]
    return out, member


def test_member_admission_plan_is_kept_until_its_state_moves():
    """The port keeps one admission plan a member state (tick, the metrics
    plane and the estimator read it): the same answers as the JAX
    package's plan, recomputed at every step."""
    (want, _), (got, member) = plan_walk(EJ), plan_walk(EP)
    assert got == want
    assert want[1] == 3 and want[3] == 1 and want[5] == 2
    plan = member.admission_plan()
    assert member.admission_plan() is plan
    member.tick()  # status writes move the member's store revision
    assert member.admission_plan() is not plan
    assert member.admission_plan() == plan


# -- the client's hardening ---------------------------------------------------

class Flaky:
    """A transport that raises `errors` (one a call) before answering
    through `inner`: the JAX chaos seam's error / timeout / garbage
    modes without the seam."""

    def __init__(self, inner, errors):
        self.inner, self.errors, self.calls, self.closed = inner, \
            list(errors), 0, False

    def call(self, method, body):
        self.calls += 1
        if self.errors:
            err = self.errors.pop(0)
            if err == "garbage":
                return {"maxReplicas": "garbage",
                        "unschedulableReplicas": "garbage"}
            raise err
        return self.inner.call(method, body)

    def close(self):
        self.closed = True


def test_client_hardening_counts_typed_errors_and_breaker():
    """Retries with full jitter, typed classification counted by kind,
    the breaker's open -> half-open -> closed walk, the memo's skips and
    deregister's release -- the same answers in both packages."""
    runs = []
    for E in (EJ, EP):
        now = [0.0]
        member = member_with_nodes(E)
        inner = E.wire.LocalTransport(
            E.server.AccurateEstimatorServer(member).handle)
        flaky = Flaky(inner, [ConnectionError("refused"),
                              TimeoutError("slow"), "garbage",
                              ConnectionError("refused"),
                              ConnectionError("refused"),
                              ConnectionError("refused")])
        slept = []
        breaker = E.client.CircuitBreaker(failure_threshold=2,
                                          reset_timeout_s=10.0,
                                          clock=lambda: now[0])
        client = E.client.AccurateEstimatorClient(
            breaker=breaker, retry_attempts=3, sleep=slept.append)
        client.register("m1", flaky)
        cl = [E.Cluster(metadata=E.ObjectMeta(name="m1",
                                              resource_version=7))]
        log = []
        try:
            # three failed attempts: one call, the sentinel
            log.append(client.max_available_replicas(cl, req(E))[0].replicas)
            # three more: the breaker opens at its second failed call
            log.append(client.unschedulable_replicas(
                "m1", "Deployment", "default", "x"))
            log.append(breaker.state("m1"))
            log.append(client.max_available_replicas(cl, req(E))[0].replicas)
            now[0] = 11.0  # one half-open probe flies and succeeds
            log.append(client.max_available_replicas(cl, req(E))[0].replicas)
            log.append(client.max_available_replicas(cl, req(E))[0].replicas)
            log.append([(t["from"], t["to"])
                        for t in breaker.transition_log()])
            log.append((flaky.calls, len(slept)))
            log.append([round(s, 12) for s in slept])
            client.deregister("m1")
            log.append((flaky.closed, breaker.states(),
                        client._memo))  # noqa: SLF001
            log.append(client.max_available_replicas(cl, req(E))[0].replicas)
        finally:
            close_client(E, client)
        if E is EP:
            counts = client.counts()
            assert counts["errors"] == {"unreachable": 4, "timeout": 1,
                                        "malformed": 1, "circuit_open": 1}
            assert counts["retries"] == {"MaxAvailableReplicas": 2,
                                         "GetUnschedulableReplicas": 2}
            assert counts["rpc_skipped"] == {"MaxAvailableReplicas": 1}
        runs.append(log)
    assert runs[0] == runs[1]
    assert runs[1][:6] == [-1, -1, "open", -1, 6, 6]
    assert runs[1][6] == [("closed", "open"), ("open", "half-open"),
                          ("half-open", "closed")]
    assert runs[1][9] == (True, {}, {})


# -- Scheduler(estimators=): a mixed batch on every backend ------------------

def fragmented_fleet(E):
    """Members whose nodes are fragmented, so the accurate tier answers
    less than the GeneralEstimator on 1500m pods, and their Clusters."""
    Q = E.Quantity
    shapes = {"m0": [2000] * 4, "m1": [4000] * 2, "m2": [8000],
              "m3": [1000] * 8}
    zones = {"m0": "z0", "m1": "z0", "m2": "z1", "m3": "z1"}
    members, clusters = {}, []
    for name, cpus in shapes.items():
        m = E.member.FakeMemberCluster(name=name, nodes=[
            E.member.FakeNode(name=f"{name}-n{i}", cpu_milli=c,
                              memory_milli=Q.parse("16Gi").milli, pods=20)
            for i, c in enumerate(cpus)])
        members[name] = m
        clusters.append(E.Cluster(
            metadata=E.ObjectMeta(name=name, resource_version=1),
            spec=E.ClusterSpec(region="r0", zone=zones[name]),
            status=E.ClusterStatus(
                api_enablements=[E.APIEnablement("apps/v1", ["Deployment"])],
                resource_summary=m.resource_summary())))
    return members, clusters


def mixed_bindings(E):
    Q = E.Quantity

    def rb(name, replicas, strategy, spread=None, components=None,
           prev=()):
        return E.ResourceBinding(
            metadata=E.ObjectMeta(namespace="default", name=name),
            spec=E.ResourceBindingSpec(
                resource=E.ObjectReference(
                    api_version="apps/v1", kind="Deployment",
                    namespace="default", name=name, uid=f"uid-{name}"),
                replicas=replicas,
                replica_requirements=(None if components else
                                      E.ReplicaRequirements(resource_request={
                                          "cpu": Q.parse("1500m")})),
                components=components or [],
                placement=E.Placement(replica_scheduling=strategy,
                                      spread_constraints=spread or []),
                clusters=[E.TargetCluster(name=n, replicas=r)
                          for n, r in prev]))

    dyn = E.ReplicaSchedulingStrategy(
        replica_scheduling_type=E.REPLICA_SCHEDULING_DIVIDED,
        replica_division_preference=E.REPLICA_DIVISION_WEIGHTED,
        weight_preference=E.ClusterPreferences(
            dynamic_weight=E.DYNAMIC_WEIGHT_AVAILABLE_REPLICAS))
    agg = E.ReplicaSchedulingStrategy(
        replica_scheduling_type=E.REPLICA_SCHEDULING_DIVIDED,
        replica_division_preference=E.REPLICA_DIVISION_AGGREGATED)
    dup = E.ReplicaSchedulingStrategy(
        replica_scheduling_type=E.REPLICA_SCHEDULING_DUPLICATED)

    def sc(field, lo, hi):
        return E.SpreadConstraint(spread_by_field=field, min_groups=lo,
                                  max_groups=hi)

    comps = [E.Component(name="jm", replicas=1,
                         replica_requirements=E.ReplicaRequirements(
                             resource_request={"cpu": Q.parse("1500m")})),
             E.Component(name="tm", replicas=2,
                         replica_requirements=E.ReplicaRequirements(
                             resource_request={"cpu": Q.parse("1500m")}))]
    cluster1 = [sc(E.SPREAD_BY_FIELD_CLUSTER, 1, 1)]
    region1 = [sc(E.SPREAD_BY_FIELD_REGION, 1, 1),
               sc(E.SPREAD_BY_FIELD_CLUSTER, 1, 1)]
    # device routes: the main route, the region-spread plane and a set
    # row; host routes: a previous cluster gone from the fleet, a set row
    # under region spread, zone-only spread
    return [rb("dyn", 9, dyn), rb("agg", 7, agg), rb("dup", 2, dup),
            rb("region-dyn", 5, dyn, region1[:1]),
            rb("sets", 0, None, cluster1, comps),
            rb("huge", 40, agg),
            rb("gone-dyn", 9, dyn, prev=[("gone", 3), ("m3", 2)]),
            rb("gone-agg", 7, agg, prev=[("gone", 4)]),
            rb("region-sets", 0, None, region1, comps),
            rb("zone-dyn", 9, dyn, [sc(E.SPREAD_BY_FIELD_ZONE, 1, 2)])]


def solve_mixed(E, backend, with_client):
    members, clusters = fragmented_fleet(E)
    store, runtime = E.store.ObjectStore(), E.worker.Runtime()
    client = E.client.AccurateEstimatorClient()
    for name, m in members.items():
        client.register(name, E.wire.LocalTransport(
            E.server.AccurateEstimatorServer(m).handle))
    estimators = ([E.general.GeneralEstimator(), client] if with_client
                  else None)
    kw = {"device": "cpu"} if (E is EP and backend == "device") else {}
    sched = E.scheduler.Scheduler(store, runtime, backend=backend,
                                  estimators=estimators, **kw)
    try:
        results, _ = sched.solve_batch(mixed_bindings(E), clusters)
    finally:
        close_client(E, client)
    out = []
    for i in range(len(results)):
        r = results[i]
        out.append(type(r).__name__ if isinstance(r, Exception)
                   else sorted((t.name, t.replicas) for t in r))
    return out


@pytest.mark.parametrize("backend", BACKENDS)
def test_scheduler_estimators_parity(backend):
    """Rows on a device route price with the GeneralEstimator, host rows
    min-merge over [GeneralEstimator(), client], "native" leaves every
    row to the serial path -- the port's placements equal the JAX
    Scheduler's row by row (its backend "device" on the CPU)."""
    got = solve_mixed(EP, backend, True)
    assert got == solve_mixed(EJ, backend, True)
    # the accurate tier bites on the host rows (on "native", every row)
    alone = solve_mixed(EP, backend, False)
    assert got[6:9] != alone[6:9]
    if backend == "device":
        assert got[:6] == alone[:6]


# -- the descheduler ----------------------------------------------------------

def dynamic_policy(M):
    return M.PropagationPolicy(
        metadata=M.ObjectMeta(name="pp", namespace="default"),
        spec=M.PropagationSpec(
            resource_selectors=[M.ResourceSelector(api_version="apps/v1",
                                                   kind="Deployment")],
            placement=M.Placement(
                replica_scheduling=M.ReplicaSchedulingStrategy(
                    replica_scheduling_type=M.REPLICA_SCHEDULING_DIVIDED,
                    replica_division_preference=M.REPLICA_DIVISION_WEIGHTED,
                    weight_preference=M.ClusterPreferences(
                        dynamic_weight=M.DYNAMIC_WEIGHT_AVAILABLE_REPLICAS)))))


def sc_descheduler_moves_stuck_replicas(M, backend, log):
    cp = plane(M, backend, Clock(), enable_descheduler=True)
    cp.add_member("m1", cpu_milli=64_000)
    cp.add_member("m2", cpu_milli=64_000)
    cp.tick()
    cp.apply_policy(dynamic_policy(M))
    cp.apply({"apiVersion": "apps/v1", "kind": "Deployment",
              "metadata": {"name": "app", "namespace": "default"},
              "spec": {"replicas": 8, "template": {"spec": {"containers": [
                  {"name": "app", "image": "app:1", "resources": {
                      "requests": {"cpu": "500m", "memory": "1Gi"}}}]}}}})
    cp.tick()
    log.append(snapshot(cp))
    rb = cp.store.get("ResourceBinding", "default", "app-deployment")
    split = {t.name: t.replicas for t in rb.spec.clusters}
    assert sum(split.values()) == 8
    victim, other = sorted(split)[1], sorted(split)[0]
    cp.member(victim).cpu_allocatable_milli = 1000  # fits 2 of 500m
    for _ in range(2):
        cp.tick()
        log.append(snapshot(cp))
    rb = cp.store.get("ResourceBinding", "default", "app-deployment")
    after = {t.name: t.replicas for t in rb.spec.clusters}
    assert sum(after.values()) == 8
    assert after.get(victim, 0) <= 2 and after[other] >= 6
    log.append(after)
    return cp


@pytest.mark.parametrize("backend", BACKENDS)
def test_descheduler_moves_stuck_replicas_parity(backend):
    cps, logs = run_both(sc_descheduler_moves_stuck_replicas, backend)
    assert cps[1].descheduler.shrinks >= 1
    assert cps[1].descheduler_estimator.counts()["errors"] == {}


def test_unjoin_deregisters_the_estimator_server():
    """add_member registers a member's estimator server, unjoin releases
    it, in both ControlPlanes."""
    seen = []
    for M in (MJ, MP):
        cp = plane(M, "serial", Clock())
        cp.add_member("m1")
        cp.add_member("m2")
        before = sorted(cp.descheduler_estimator.transports)
        cp.unjoin("m1")
        seen.append((before, sorted(cp.descheduler_estimator.transports),
                     cp.descheduler))
    assert seen[0] == seen[1] == (["m1", "m2"], ["m2"], None)


class _SchedStub:
    """The slice of Scheduler the rebalance plane touches."""

    def __init__(self, clock):
        self.queue = type("Q", (), {"now": staticmethod(clock)})()
        self.promoted = []

    def promote(self, key, priority=0, origin="rebalance"):
        self.promoted.append((key, priority, origin))
        return "admitted"


class _Member:
    healthy = True

    def unschedulable_replicas(self, *a):
        return 1  # every binding always has one stuck replica


def _budget_run(E):
    clock = S.FakeClock()
    store = E.store.ObjectStore()
    for n in ("m1", "m2"):
        store.create(S.pods_cluster(E, n, 100))
    budget = E.rebalance.EvictionBudget(per_cluster=4, interval_s=60.0,
                                        clock=clock)
    kw = {"device": "cpu"} if E is EP else {}
    plane_ = E.rebalance.RebalancePlane(
        store, _SchedStub(clock),
        cfg=E.rebalance.RebalanceConfig(interval_s=5.0), budget=budget,
        clock=clock, **kw)
    desched = E.descheduler.Descheduler(
        store, E.worker.Runtime(), {"m1": _Member(), "m2": _Member()},
        budget=budget)
    agg = E.ReplicaSchedulingStrategy(
        replica_scheduling_type=E.REPLICA_SCHEDULING_DIVIDED,
        replica_division_preference=E.REPLICA_DIVISION_AGGREGATED)
    for i in range(12):
        store.create(E.ResourceBinding(
            metadata=E.ObjectMeta(namespace="ns", name=f"b{i}"),
            spec=E.ResourceBindingSpec(
                resource=E.ObjectReference(
                    api_version="apps/v1", kind="Deployment",
                    namespace="ns", name=f"b{i}", uid=f"uid-b{i}"),
                replicas=10, placement=E.Placement(replica_scheduling=agg),
                clusters=[E.TargetCluster(name="m1", replicas=10)])))

    def crush(c):
        c.status.resource_summary.allocatable["pods"] = (
            E.Quantity.parse("10"))
    store.mutate("Cluster", "", "m1", crush)
    log = []
    desched.run_once()
    log.append(sum(1 for rb in store.list("ResourceBinding")
                   if sum(t.replicas for t in rb.spec.clusters) < 10
                   and not rb.spec.graceful_eviction_tasks))
    log.append(plane_.run_cycle()["evicted"])
    clock.advance(60.0)
    log.append(plane_.run_cycle()["evicted"])
    log.append(sorted((rb.name, [(t.name, t.replicas)
                                 for t in rb.spec.clusters])
                      for rb in store.list("ResourceBinding")))
    return log


def test_descheduler_and_rebalance_share_one_budget_parity():
    """Both evictors on one budget: the descheduler's shrinks draw the
    window's tokens, the rebalance plane finds m1's spent, the next
    window drains -- equal in both packages."""
    jax_rebalance = importlib.import_module("karmada_tpu.rebalance")
    try:
        got = _budget_run(EP)
        assert got == _budget_run(EJ)
    finally:
        jax_rebalance.set_active(None)
    assert got[0] == 4 and got[1] == 0 and 0 < got[2] <= 4


def test_descheduler_counts_denied_shrinks():
    """The port's Descheduler counts the shrinks it wrote and those the
    shared budget denied (the JAX one emits neither count)."""
    clock = S.FakeClock()
    store = EP.store.ObjectStore()
    budget = EP.rebalance.EvictionBudget(per_cluster=2, interval_s=60.0,
                                         clock=clock)
    desched = EP.descheduler.Descheduler(
        store, EP.worker.Runtime(), {"m1": _Member()}, budget=budget)
    agg = EP.ReplicaSchedulingStrategy(
        replica_scheduling_type=EP.REPLICA_SCHEDULING_DIVIDED,
        replica_division_preference=EP.REPLICA_DIVISION_AGGREGATED)
    for i in range(5):
        store.create(EP.ResourceBinding(
            metadata=EP.ObjectMeta(namespace="ns", name=f"b{i}"),
            spec=EP.ResourceBindingSpec(
                resource=EP.ObjectReference(kind="Deployment", name=f"b{i}"),
                replicas=3, placement=EP.Placement(replica_scheduling=agg),
                clusters=[EP.TargetCluster(name="m1", replicas=3)])))
    desched.run_once()
    assert (desched.shrinks, desched.denied) == (2, 3)
    assert sorted(sum(t.replicas for t in rb.spec.clusters)
                  for rb in store.visit("ResourceBinding")) == [2, 2, 3, 3, 3]

