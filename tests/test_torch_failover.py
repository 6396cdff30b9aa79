"""Failover-loop parity: the port's ControlPlane and controllers
(karmada_tpu_torch/controllers/{lease,cluster,failover}.py, e2e.py)
against the JAX package's, tolerance 0.

Every case of tests/test_failover.py but the descheduler's (that one is in
tests/test_torch_estimator.py), tests/test_failover_storm.py, tests/test_cluster_lease.py
and tests/test_cluster_lifecycle.py runs as a scenario on both packages:
the JAX ControlPlane on exactly the ported controllers
(``controllers=`` store/worker.PORTED_CONTROLLERS), the port's on
backends "serial", "native" and "device" with device="cpu" (the JAX side
then runs "serial").  Each scenario holds both planes to the JAX test's
own assertions, and their logs and normalized snapshots (every object of
the control plane and of each member; uids, resourceVersions and
wall-clock times cleared, torch_loop.CLEARED) must be equal.  Both planes
read one clock that only the scenario moves, except where the JAX test
reads the wall clock.  The controller-level cases (the lease monitor on
a bare store, the state-preservation flow) run once: no scheduler.
"""

import pytest

from torch_fixtures import collect_jax_planes  # noqa: F401 — autouse
from torch_loop import (  # noqa: F401 — deterministic_uids is autouse
    MJ,
    MP,
    Clock,
    assert_same,
    deterministic_uids,
    plane,
    run_both,
    snapshot,
)

BACKENDS = ["serial", "native", "device"]


def dynamic_policy(M, name="pp", propagate_deps=False, failover=None):
    return M.PropagationPolicy(
        metadata=M.ObjectMeta(name=name, namespace="default"),
        spec=M.PropagationSpec(
            resource_selectors=[M.ResourceSelector(api_version="apps/v1",
                                                   kind="Deployment")],
            placement=M.Placement(
                replica_scheduling=M.ReplicaSchedulingStrategy(
                    replica_scheduling_type=M.REPLICA_SCHEDULING_DIVIDED,
                    replica_division_preference=M.REPLICA_DIVISION_WEIGHTED,
                    weight_preference=M.ClusterPreferences(
                        dynamic_weight=M.DYNAMIC_WEIGHT_AVAILABLE_REPLICAS))),
            propagate_deps=propagate_deps,
            failover=failover))


def deployment(replicas=6, volumes=None, name="app", cpu="500m"):
    spec = {"containers": [{"name": "app", "image": "app:1",
                            "resources": {"requests": {"cpu": cpu,
                                                       "memory": "1Gi"}}}]}
    if volumes:
        spec["volumes"] = volumes
    return {"apiVersion": "apps/v1", "kind": "Deployment",
            "metadata": {"name": name, "namespace": "default"},
            "spec": {"replicas": replicas, "template": {"spec": spec}}}


def rb_of(cp, name="app-deployment"):
    return cp.store.get("ResourceBinding", "default", name)


def split(cp, name="app-deployment"):
    return {t.name: t.replicas for t in rb_of(cp, name).spec.clusters}


def two_members(M, backend, clock, **kw):
    cp = plane(M, backend, clock, **kw)
    cp.add_member("m1", cpu_milli=64_000)
    cp.add_member("m2", cpu_milli=64_000)
    return cp


# -- tests/test_failover.py ---------------------------------------------------

def sc_cluster_failure_evicts_and_reschedules(M, backend, log):
    cp = two_members(M, backend, Clock(), eviction_grace_period_s=0,
                     default_toleration_seconds=None)
    cp.tick()
    cp.apply_policy(dynamic_policy(M))
    cp.apply(deployment(6))
    cp.tick()
    before = split(cp)
    assert sum(before.values()) == 6 and len(before) == 2
    cp.member("m2").healthy = False
    cp.tick()
    cp.tick()
    after = split(cp)
    assert "m2" not in after and sum(after.values()) == 6
    rb = rb_of(cp)
    assert not rb.spec.graceful_eviction_tasks
    assert cp.store.try_get("Work", "karmada-es-m2",
                            M.binding.work_name(rb)) is None
    log += [before, after]
    return cp


def sc_eviction_task_keeps_stale_work_until_drained(M, backend, log):
    cp = two_members(M, backend, Clock(), eviction_grace_period_s=3600)
    cp.tick()
    cp.apply_policy(dynamic_policy(M))
    cp.apply(deployment(6))
    cp.tick()
    cp.member("m2").healthy = False
    cp.tick()
    rb = rb_of(cp)
    if rb.spec.graceful_eviction_tasks:
        assert cp.store.try_get("Work", "karmada-es-m2",
                                M.binding.work_name(rb)) is not None
    log.append(len(rb.spec.graceful_eviction_tasks))
    cp.tick()
    cp.tick()
    assert not rb_of(cp).spec.graceful_eviction_tasks
    return cp


def sc_cluster_recovery_removes_taint(M, backend, log):
    cp = plane(M, backend, Clock())
    cp.add_member("m1")
    cp.tick()
    cp.member("m1").healthy = False
    cp.tick()
    cluster = cp.store.get("Cluster", "", "m1")
    assert any(t.key == "cluster.karmada.io/not-ready"
               for t in cluster.spec.taints)
    cp.member("m1").healthy = True
    cp.tick()
    assert not cp.store.get("Cluster", "", "m1").spec.taints
    return cp


def sc_application_failover_moves_unhealthy_workload(M, backend, log):
    cp = two_members(M, backend, Clock(), eviction_grace_period_s=0)
    cp.tick()
    cp.apply_policy(dynamic_policy(
        M, failover=M.FailoverBehavior(toleration_seconds=0)))
    cp.apply(deployment(4))
    cp.tick()
    targets = set(split(cp))
    assert len(targets) == 2
    victim = sorted(targets)[0]
    cp.member(victim).cpu_allocatable_milli = 100
    cp.tick()
    cp.tick()
    after = split(cp)
    assert victim not in after and sum(after.values()) == 4
    log.append(after)
    return cp


def sc_namespace_sync_to_all_members(M, backend, log):
    cp = plane(M, backend, Clock())
    cp.add_member("m1")
    cp.tick()
    cp.apply({"apiVersion": "v1", "kind": "Namespace",
              "metadata": {"name": "team-a"}})
    cp.tick()
    assert cp.member("m1").get("Namespace", "", "team-a") is not None
    cp.add_member("m2")
    cp.tick()
    assert cp.member("m2").get("Namespace", "", "team-a") is not None
    return cp


def sc_dependencies_follow_parent_schedule(M, backend, log):
    cp = two_members(M, backend, Clock())
    cp.tick()
    cp.apply({"apiVersion": "v1", "kind": "ConfigMap",
              "metadata": {"name": "app-config", "namespace": "default"},
              "data": {"k": "v"}})
    cp.apply_policy(dynamic_policy(M, propagate_deps=True))
    cp.apply(deployment(4, volumes=[
        {"name": "cfg", "configMap": {"name": "app-config"}}]))
    cp.tick()
    rb = rb_of(cp)
    attached = rb_of(cp, "app-config-configmap")
    assert attached.spec.required_by[0].clusters == rb.spec.clusters
    for t in rb.spec.clusters:
        assert cp.member(t.name).get("ConfigMap", "default",
                                     "app-config") is not None
    return cp


def sc_dependencies_released_when_propagation_stops(M, backend, log):
    """propagateDeps turned off: the attached binding loses its parent's
    snapshot and label and, with no other parent, goes away."""
    cp = sc_dependencies_follow_parent_schedule(M, backend, log)

    def stop(p):
        p.spec.propagate_deps = False
    cp.store.mutate("PropagationPolicy", "default", "pp", stop)
    cp.tick()
    cp.tick()
    log.append(cp.store.try_get("ResourceBinding", "default",
                                "app-config-configmap") is None)
    return cp


def sc_toleration_seconds_delays_and_cancels_eviction(M, backend, log):
    clock = Clock()
    cp = two_members(M, backend, clock)
    cp.apply_policy(dynamic_policy(M))
    cp.apply(deployment(replicas=4))
    cp.tick()
    tols = {t.key: t.toleration_seconds
            for t in rb_of(cp).spec.placement.cluster_tolerations}
    assert tols.get("cluster.karmada.io/not-ready") == 300
    cp.member("m1").healthy = False
    cp.tick()
    cluster = cp.store.get("Cluster", "", "m1")
    assert any(t.key.endswith("not-ready") for t in cluster.spec.taints)
    assert not rb_of(cp).spec.graceful_eviction_tasks
    clock.advance(60.0)
    cp.member("m1").healthy = True
    cp.tick()
    clock.advance(600.0)
    cp.tick()
    assert not rb_of(cp).spec.graceful_eviction_tasks
    cp.member("m2").healthy = False
    cp.tick()
    assert "m2" in split(cp)
    clock.advance(301.0)
    cp.tick()
    assert "m2" not in split(cp) and sum(split(cp).values()) == 4
    log.append(split(cp))
    return cp


def sc_stateful_failover_injection_gate_off_by_default(M, backend, log):
    F = M.failover
    st = {"replicas": 3, "conds": [{"type": "Ready", "ok": True}],
          "name": "db-0"}
    log.append([F.parse_json_path(st, p) for p in (
        "{.replicas}", ".conds[0].type", "conds[0].ok", "{.name}")])
    for bad in ("{.missing}", ".conds[7].type"):
        with pytest.raises(KeyError):
            F.parse_json_path(st, bad)
    log.append(F.build_preserved_label_state(
        [M.StatePreservationRule("a", "{.replicas}")], st))
    cp = two_members(M, backend, Clock(), eviction_grace_period_s=600)
    cp.tick()
    cp.apply_policy(dynamic_policy(M, failover=M.FailoverBehavior(
        toleration_seconds=0,
        state_preservation=[M.StatePreservationRule("x", "{.replicas}")])))
    cp.apply(deployment(4))
    cp.tick()
    victim = sorted(split(cp))[0]
    cp.member(victim).cpu_allocatable_milli = 100
    cp.tick()
    cp.tick()
    rb = rb_of(cp)
    assert victim not in {t.name for t in rb.spec.clusters}
    for task in rb.spec.graceful_eviction_tasks:
        assert task.preserved_label_state == {}
    return cp


FAILOVER = [sc_cluster_failure_evicts_and_reschedules,
            sc_eviction_task_keeps_stale_work_until_drained,
            sc_cluster_recovery_removes_taint,
            sc_application_failover_moves_unhealthy_workload,
            sc_namespace_sync_to_all_members,
            sc_dependencies_follow_parent_schedule,
            sc_dependencies_released_when_propagation_stops,
            sc_toleration_seconds_delays_and_cancels_eviction,
            sc_stateful_failover_injection_gate_off_by_default]


def sc_stateful_failover_injection_propagates_preserved_labels(M, log):
    """The JAX test's controller-level flow: application failover on a
    bare store with the StatefulFailoverInjection gate on, then the
    binding controller's render injecting the preserved labels."""
    M.GATES.set("StatefulFailoverInjection", True)
    try:
        store = M.ObjectStore()
        runtime = M.Runtime()
        clock = Clock()
        afc = M.failover.ApplicationFailoverController(store, runtime,
                                                       clock=clock)
        M.binding.BindingController(store, runtime)
        for m in ("m1", "m2"):
            store.create(M.Cluster(metadata=M.ObjectMeta(name=m)))
        store.create(M.Unstructured.from_manifest(deployment(4)))
        rb = M.ResourceBinding(
            metadata=M.ObjectMeta(name="app-deployment",
                                  namespace="default"),
            spec=M.ResourceBindingSpec(
                resource=M.ObjectReference(
                    api_version="apps/v1", kind="Deployment",
                    namespace="default", name="app", uid="u1"),
                replicas=4,
                clusters=[M.TargetCluster(name="m1", replicas=4)],
                failover=M.FailoverBehavior(
                    toleration_seconds=0, purge_mode="Immediately",
                    state_preservation=[
                        M.StatePreservationRule(
                            "failover.karmada.io/observed-replicas",
                            "{.replicas}"),
                        M.StatePreservationRule(
                            "failover.karmada.io/ready",
                            ".readyReplicas")])))
        rb.status.aggregated_status = [M.AggregatedStatusItem(
            cluster_name="m1", status={"replicas": 4, "readyReplicas": 0},
            applied=True, health="Unhealthy")]
        store.create(rb)
        runtime.pump()
        afc.run_once()
        clock.advance(1.0)
        afc.run_once()
        rb = store.get("ResourceBinding", "default", "app-deployment")
        assert not rb.spec.clusters
        task = rb.spec.graceful_eviction_tasks[-1]
        assert task.purge_mode == "Immediately"
        assert task.clusters_before_failover == ["m1"]
        log.append(dict(task.preserved_label_state))

        def reschedule(obj):
            obj.spec.clusters = [M.TargetCluster(name="m2", replicas=4)]
        store.mutate("ResourceBinding", "default", "app-deployment",
                     reschedule)
        runtime.pump()
        rb = store.get("ResourceBinding", "default", "app-deployment")
        w = store.get("Work", "karmada-es-m2", M.binding.work_name(rb))
        labels = w.spec.workload[0]["metadata"].get("labels", {})
        assert labels.get("failover.karmada.io/observed-replicas") == "4"
        assert labels.get("failover.karmada.io/ready") == "0"
        assert store.try_get("Work", "karmada-es-m1",
                             M.binding.work_name(rb)) is None
        tmpl = store.get("Deployment", "default", "app")
        assert "failover.karmada.io/observed-replicas" not in (
            tmpl.manifest["metadata"].get("labels") or {})
        log.append(labels)
        return store
    finally:
        M.GATES.set("StatefulFailoverInjection", False)


# -- tests/test_failover_storm.py ---------------------------------------------

def sc_failover_chain_under_virtual_clock_storm(M, backend, log):
    clock = Clock()
    cp = plane(M, backend, clock, eviction_grace_period_s=3600)
    for m in ("m1", "m2", "m3", "m4"):
        cp.add_member(m, cpu_milli=64_000)
    cp.apply_policy(dynamic_policy(M))
    cp.apply(deployment(8))
    cp.tick()
    before = split(cp)
    assert sum(before.values()) == 8 and len(before) == 4
    taint = M.failover.TAINT_NOT_READY
    cp.member("m3").healthy = False
    cp.member("m4").healthy = False
    cp.tick()
    for m in ("m3", "m4"):
        assert any(t.key == taint for t in
                   cp.store.get("Cluster", "", m).spec.taints)
    rb = rb_of(cp)
    assert {t.name for t in rb.spec.clusters} >= {"m3", "m4"}
    assert not rb.spec.graceful_eviction_tasks
    clock.advance(120.0)
    cp.member("m4").healthy = True
    cp.tick()
    assert not any(t.key == taint for t in
                   cp.store.get("Cluster", "", "m4").spec.taints)
    clock.advance(301.0)
    cp.tick()
    rb = rb_of(cp)
    names = split(cp)
    assert "m3" not in names and "m4" in names
    assert sum(names.values()) == 8
    log.append(bool(rb.spec.graceful_eviction_tasks))
    if rb.spec.graceful_eviction_tasks:
        assert rb.spec.graceful_eviction_tasks[0].from_cluster == "m3"
        assert cp.store.try_get("Work", "karmada-es-m3",
                                M.binding.work_name(rb)) is not None
    cp.tick()
    cp.tick()
    rb = rb_of(cp)
    assert not rb.spec.graceful_eviction_tasks
    assert cp.store.try_get("Work", "karmada-es-m3",
                            M.binding.work_name(rb)) is None
    cp.member("m3").healthy = True
    cp.tick()
    assert not any(t.key == taint for t in
                   cp.store.get("Cluster", "", "m3").spec.taints)
    return cp


def sc_storm_eviction_pacing_is_rate_limited(M, backend, log):
    clock = Clock()
    cp = two_members(M, backend, clock, eviction_rate=1.0,
                     eviction_grace_period_s=0,
                     default_toleration_seconds=None)
    cp.apply_policy(dynamic_policy(M))
    for i in range(4):
        cp.apply(deployment(2, name=f"app{i}"))
    cp.tick()
    cp.member("m2").healthy = False
    cp.tick()
    pending = cp.eviction_queue.pending()
    assert 4 - pending < 4
    log.append(pending)
    for _ in range(8):
        clock.advance(1.0)
        cp.tick()
    assert cp.eviction_queue.pending() == 0
    for i in range(4):
        names = split(cp, f"app{i}-deployment")
        assert "m2" not in names and sum(names.values()) == 2
    return cp


# -- tests/test_cluster_lease.py ----------------------------------------------

def sc_collector_renews_lease_each_cycle(M, backend, log):
    clock = Clock()
    cp = plane(M, backend, clock)
    cp.add_member("m1")
    cp.tick()
    L = M.lease
    first = cp.store.get("Lease", L.LEASE_NAMESPACE, "m1").renew_time
    clock.advance(0.02)
    if M is MJ:
        import time

        time.sleep(0.02)  # the JAX collector renews on the wall clock
    cp.tick()
    assert cp.store.get("Lease", L.LEASE_NAMESPACE, "m1").renew_time > first
    cond = M.get_condition(cp.store.get("Cluster", "", "m1")
                           .status.conditions, M.COND_CLUSTER_READY)
    assert cond.status == "True"
    return cp


def sc_dead_collector_in_control_plane_taints_cluster(M, backend, log):
    cp = plane(M, backend, Clock())
    cp.add_member("m1")
    cp.tick()
    del cp.cluster_status.members["m1"]

    def age(lease):
        lease.renew_time -= 10_000.0
    cp.store.mutate("Lease", M.lease.LEASE_NAMESPACE, "m1", age)
    cp.tick()
    cluster = cp.store.get("Cluster", "", "m1")
    cond = M.get_condition(cluster.status.conditions, M.COND_CLUSTER_READY)
    assert cond.status == "Unknown"
    assert any(t.key == M.failover.TAINT_NOT_READY
               for t in cluster.spec.taints)
    return cp


def sc_unjoin_deletes_lease(M, backend, log):
    cp = plane(M, backend, Clock())
    cp.add_member("m1")
    cp.tick()
    assert cp.store.try_get("Lease", M.lease.LEASE_NAMESPACE, "m1")
    cp.unjoin("m1")
    assert cp.store.try_get("Lease", M.lease.LEASE_NAMESPACE, "m1") is None
    return cp


def _monitor_case(interval, steps):
    def scenario(M, log):
        store = M.ObjectStore()
        runtime = M.Runtime(periodic_interval_s=interval)
        clock = Clock()
        store.create(M.Cluster(metadata=M.ObjectMeta(name="m1"),
                               spec=M.ClusterSpec()))
        M.lease.renew_cluster_lease(store, "m1", clock=clock)
        monitor = M.lease.ClusterLeaseMonitor(store, runtime,
                                              grace_multiplier=4.0,
                                              clock=clock)
        for advance, renew in steps:
            clock.advance(advance)
            if renew:
                M.lease.renew_cluster_lease(store, "m1", clock=clock)
            monitor.check_all()
            cond = M.get_condition(store.get("Cluster", "", "m1")
                                   .status.conditions, M.COND_CLUSTER_READY)
            log.append(None if cond is None else cond.status)
        return store
    return scenario


# test_stale_lease_degrades_to_unknown_and_taints: fresh, far past grace,
# then a renewed lease that does not flip Ready back
sc_stale_lease_degrades_to_unknown = _monitor_case(
    0.5, ((0.0, False), (1000.0, False), (0.0, True)))
# test_slow_sync_period_widens_grace: within 4 x 60 s, then beyond
sc_slow_sync_period_widens_grace = _monitor_case(
    60.0, ((120.0, False), (200.0, False)))


# -- tests/test_cluster_lifecycle.py ------------------------------------------

def lifecycle_policy(M):
    p = dynamic_policy(M)
    return p


def nginx(name="nginx", replicas=4):
    return {"apiVersion": "apps/v1", "kind": "Deployment",
            "metadata": {"name": name, "namespace": "default"},
            "spec": {"replicas": replicas, "template": {"spec": {
                "containers": [{"name": "c", "resources": {"requests": {
                    "cpu": "100m", "memory": "1Gi"}}}]}}}}


def sc_join_adds_finalizer_and_execution_space(M, backend, log):
    cp = plane(M, backend, Clock())
    cp.add_member("m1")
    cp.tick()
    cluster = cp.store.get("Cluster", "", "m1")
    assert M.cluster.CLUSTER_FINALIZER in cluster.metadata.finalizers
    ns = cp.store.try_get("Namespace", "", "karmada-es-m1")
    assert ns.metadata.labels["karmada.io/execution-space-for"] == "m1"
    return cp


def sc_unjoin_drains_works_then_releases_cluster(M, backend, log):
    cp = plane(M, backend, Clock())
    cp.add_member("m1")
    cp.add_member("m2")
    cp.tick()
    cp.store.create(lifecycle_policy(M))
    cp.apply(nginx())
    cp.tick()
    assert cp.store.list("Work", "karmada-es-m1")
    cp.unjoin("m1")
    cp.tick()
    assert cp.store.list("Work", "karmada-es-m1") == []
    assert cp.store.try_get("Namespace", "", "karmada-es-m1") is None
    assert cp.store.try_get("Cluster", "", "m1") is None
    assert cp.store.list("Work", "karmada-es-m2")
    return cp


def sc_unjoin_reschedules_bindings_off_the_removed_cluster(M, backend, log):
    cp = two_members(M, backend, Clock())
    cp.tick()
    cp.store.create(lifecycle_policy(M))
    cp.apply(nginx(replicas=4))
    cp.tick()
    assert set(split(cp, "nginx-deployment")) == {"m1", "m2"}
    cp.unjoin("m1")
    cp.tick()
    assert split(cp, "nginx-deployment") == {"m2": 4}
    cp.apply(nginx(replicas=5))
    cp.tick()
    assert cp.store.list("Work", "karmada-es-m1") == []
    return cp


def _evicted_count(cp) -> int:
    n = 0
    for rb in cp.store.list("ResourceBinding"):
        if any(t.from_cluster == "m1"
               for t in rb.spec.graceful_eviction_tasks):
            n += 1
        elif not any(tc.name == "m1" for tc in rb.spec.clusters):
            n += 1
    return n


def sc_eviction_rate_limits_mass_failure(M, backend, log):
    clock = Clock(1_000_000.0)
    cp = two_members(M, backend, clock, eviction_rate=2.0,
                     default_toleration_seconds=None)
    cp.tick()
    cp.store.create(lifecycle_policy(M))
    for i in range(6):
        cp.apply(nginx(name=f"app-{i}", replicas=2))
    cp.tick()
    cp.member("m1").healthy = False
    cp.tick()
    counts = [_evicted_count(cp)]
    for _ in range(2):
        clock.advance(1.0)
        cp.tick()
        counts.append(_evicted_count(cp))
    assert counts == [2, 4, 6], counts
    return cp


def sc_eviction_rate_zero_halts(M, backend, log):
    clock = Clock(1_000_000.0)
    cp = two_members(M, backend, clock, eviction_rate=0.0,
                     default_toleration_seconds=None)
    cp.tick()
    cp.store.create(lifecycle_policy(M))
    cp.apply(nginx())
    cp.tick()
    cp.member("m1").healthy = False
    cp.tick()
    clock.advance(3600)
    cp.tick()
    assert not rb_of(cp, "nginx-deployment").spec.graceful_eviction_tasks
    assert cp.eviction_queue.pending() >= 1
    log.append(cp.eviction_queue.pending())
    return cp


LOOP = FAILOVER + [
    sc_failover_chain_under_virtual_clock_storm,
    sc_storm_eviction_pacing_is_rate_limited,
    sc_collector_renews_lease_each_cycle,
    sc_dead_collector_in_control_plane_taints_cluster,
    sc_unjoin_deletes_lease,
    sc_join_adds_finalizer_and_execution_space,
    sc_unjoin_drains_works_then_releases_cluster,
    sc_unjoin_reschedules_bindings_off_the_removed_cluster,
    sc_eviction_rate_limits_mass_failure,
    sc_eviction_rate_zero_halts,
]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("scenario", LOOP, ids=lambda f: f.__name__[3:])
def test_failover_parity(scenario, backend):
    run_both(scenario, backend)


@pytest.mark.parametrize("scenario", [
    sc_stateful_failover_injection_propagates_preserved_labels,
    sc_stale_lease_degrades_to_unknown,
    sc_slow_sync_period_widens_grace,
], ids=lambda f: f.__name__[3:])
def test_controller_parity(scenario):
    logs = ([], [])
    stores = [scenario(M, log) for M, log in zip((MJ, MP), logs)]
    assert logs[0] == logs[1]
    assert_same(snapshot(stores[0]), snapshot(stores[1]))


def test_scenarios_hold_what_the_jax_tests_assert():
    """The JAX tests' observations that the scenarios log, on the port."""
    log = []
    sc_stale_lease_degrades_to_unknown(MP, log)
    assert log == [None, "Unknown", "Unknown"]
    log = []
    sc_slow_sync_period_widens_grace(MP, log)
    assert log == [None, "Unknown"]
    log = []
    sc_stateful_failover_injection_propagates_preserved_labels(MP, log)
    assert log[0] == {"failover.karmada.io/observed-replicas": "4",
                      "failover.karmada.io/ready": "0"}
    log = []
    sc_stateful_failover_injection_gate_off_by_default(MP, "serial", log)
    assert log[:2] == [["3", "Ready", "true", "db-0"], {"a": "3"}]


def test_controllers_outside_the_port_are_refused():
    """A governed controller the port has not taken is refused by name;
    "*" and a disabled one run what the port has."""
    for name in ("cronfederatedhpa", "federatedhpa", "mcs", "unified-auth"):
        with pytest.raises(ValueError, match="not ported"):
            MP.Runtime(controllers=f"detector,{name}")
    assert MP.Runtime(controllers="detector,descheduler").controller_enabled(
        "descheduler")
    rt = MP.Runtime(controllers="*,-federatedhpa,-taint-manager")
    assert not rt.controller_enabled("taint-manager")
    assert rt.controller_enabled("cluster-taint")
    with pytest.raises(ValueError, match="unknown"):
        MP.Runtime(controllers="detecter")


def test_taint_index_drops_a_build_a_binding_write_overtook():
    """A binding write while the taint manager builds its cluster ->
    bindings index (serve mode: another thread) leaves the index unset,
    so the next reconcile lists the bindings again; a build that no write
    overtook is kept."""
    cp = two_members(MP, "serial", Clock())
    cp.apply_policy(dynamic_policy(MP))
    cp.apply(deployment(4))
    cp.tick()
    tm = cp.taint_manager
    visit = tm.store.visit

    def overtaken(kind):
        for rb in visit(kind):
            yield rb
            tm._on_binding_event(None)  # a write on another thread

    tm._on_binding_event(None)
    tm.store.visit = overtaken
    assert [rb.name for rb in tm._bindings_on("m1")] == ["app-deployment"]
    assert tm._targets is None
    tm.store.visit = visit
    assert [rb.name for rb in tm._bindings_on("m1")] == ["app-deployment"]
    assert tm._targets is not None


@pytest.mark.parametrize("backend", BACKENDS)
def test_rehydrated_controllers_spec_parity(backend, tmp_path):
    """A controllers spec stored in the controller-manager ConfigMap that
    disables a controller and names one the port has not taken: the port
    drops the unported name with a warning and honours the rest, as the
    JAX package honours the whole spec -- the disabled taint manager
    evicts nothing from a failed member in either plane."""
    # the other controllers the port lacks are disabled, so that both
    # planes run the same set
    stored = ",".join(["*", "-taint-manager"] + [
        f"-{n}" for n in sorted(MP.worker.GOVERNED_CONTROLLERS
                                - MP.worker.PORTED_CONTROLLERS
                                - {"federatedhpa"})] + ["federatedhpa"])

    def scenario(M, backend, log):
        d = str(tmp_path / M.name)
        first = plane(M, backend, Clock(), persist_dir=d)
        first.apply({"apiVersion": "v1", "kind": "ConfigMap",
                     "metadata": {"name": "controller-manager",
                                  "namespace": "karmada-system"},
                     "data": {"controllers": stored}})
        if M is MP:
            with pytest.warns(UserWarning, match="federatedhpa"):
                cp = plane(M, backend, Clock(), persist_dir=d,
                           controllers=None)
            assert cp.runtime.unported_dropped == {"federatedhpa"}
        else:
            cp = plane(M, backend, Clock(), persist_dir=d, controllers=None)
        log.append([cp.runtime.controller_enabled(n) for n in (
            "taint-manager", "cluster-taint", "graceful-eviction")])
        cp.add_member("m1", cpu_milli=64_000)
        cp.add_member("m2", cpu_milli=64_000)
        cp.apply_policy(dynamic_policy(M))
        cp.apply(deployment(4))
        cp.tick()
        cp.member("m2").healthy = False
        cp.tick()
        cp.tick()
        log.append((split(cp), [t.key for t in cp.store.get(
            "Cluster", "", "m2").spec.taints]))
        return cp
    _, logs = run_both(scenario, backend)
    assert logs[1][0] == [False, True, True]
    taken, taints = logs[1][1]
    assert "m2" in taken and "cluster.karmada.io/not-ready" in taints


def test_controllers_filter_parity():
    """`controllers=` drops a disabled controller's worker and periodic
    hooks in both packages: with the taint controllers off, a failed
    member is never tainted and nothing is evicted."""
    spec = ",".join(sorted(MP.worker.PORTED_CONTROLLERS
                           - {"cluster-taint", "taint-manager"}))

    def scenario(M, backend, log):
        cp = two_members(M, backend, Clock(), controllers=spec,
                         default_toleration_seconds=None)
        cp.apply_policy(dynamic_policy(M))
        cp.apply(deployment(4))
        cp.tick()
        cp.member("m2").healthy = False
        cp.tick()
        log.append((split(cp), cp.store.get("Cluster", "", "m2")
                    .spec.taints))
        return cp
    _, logs = run_both(scenario, "serial")
    assert len(logs[1][0][0]) == 2 and logs[1][0][1] == []
