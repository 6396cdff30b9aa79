"""The propagation loop's lifecycle events of the port against the JAX
package's, on the CPU, tolerance 0: execution's SyncSucceed / SyncFailed
on each Work sync, the status collector's ClusterReady / ClusterNotReady
on readiness transitions (the push collector's and a Pull member's
agent's, through the agent's `recorder`), and the lease monitor's
ClusterStatusUnknown when a Lease ages past its grace.

One scenario runs on both packages' control planes (the serial backend,
uids from a counter, each into a fresh process ledger): a Duplicated
deployment over two push members and a Pull member, one push member
already running an object of the same name (ConflictResolution Abort:
the sync fails), then an outage and a recovery of the other push member,
then the lease monitor reading a clock an hour ahead.  The ledgers'
recent rings and every Cluster's and Work's timeline are equal, the
events' wall-clock stamps masked; the plane's snapshots are equal too.
`ControlPlane.metrics_dump` is the process registry's exposition on both.
"""

import importlib
import time

import torch_loop as TL
import torch_soak as TS
from torch_fixtures import collect_jax_planes  # noqa: F401 — autouse
from torch_loop import deterministic_uids  # noqa: F401 — autouse

STAMPS = ("first_timestamp", "last_timestamp")


def _masked(events):
    return [{k: v for k, v in e.items() if k not in STAMPS} for e in events]


def _deployment(replicas):
    return {"apiVersion": "apps/v1", "kind": "Deployment",
            "metadata": {"name": "nginx", "namespace": "default"},
            "spec": {"replicas": replicas, "template": {"spec": {
                "containers": [{"name": "nginx", "image": "nginx:1.19",
                                "resources": {"requests": {
                                    "cpu": "500m"}}}]}}}}


def _policy(M):
    rs = M.ReplicaSchedulingStrategy(
        replica_scheduling_type=M.REPLICA_SCHEDULING_DUPLICATED)
    return M.PropagationPolicy(
        metadata=M.ObjectMeta(name="nginx-pp", namespace="default"),
        spec=M.PropagationSpec(
            resource_selectors=[M.ResourceSelector(api_version="apps/v1",
                                                   kind="Deployment")],
            placement=M.Placement(replica_scheduling=rs)))


def _scenario(M, log):
    cp = TL.plane(M, "serial", TL.Clock())
    cp.add_member("m1", cpu_milli=64_000)
    cp.add_member("m2", cpu_milli=64_000)
    cp.add_member("pull-1", cpu_milli=64_000, sync_mode="Pull")
    cp.tick()
    cp.member("m1").apply(_deployment(1))  # not made by a Work: Abort
    cp.apply_policy(_policy(M))
    cp.apply(_deployment(2))
    cp.tick()
    log.append(sorted(t.name for t in cp.store.get(
        "ResourceBinding", "default", "nginx-deployment").spec.clusters))
    cp.member("m2").healthy = False  # an outage
    cp.tick()
    cp.member("m2").healthy = True   # and its recovery
    cp.apply(_deployment(3))
    cp.tick()
    # the monitor an hour ahead: every Lease is past its grace
    cp.lease_monitor.clock = lambda: time.time() + 3600.0
    cp.lease_monitor.check_all()
    log.append(sorted((c.name, [x.status for x in c.status.conditions
                                if x.type == "Ready"][0])
                      for c in cp.store.list("Cluster")))
    cp.lease_monitor.clock = time.time
    cp.tick()
    return cp


def _run(pkg):
    M = TL.MJ if pkg == "karmada_tpu" else TL.MP
    events = importlib.import_module(f"{pkg}.obs.events")
    log = []
    with TS.fresh_ledger(pkg):
        cp = _scenario(M, log)
        led = events.ledger()
        timelines = {
            (o.KIND, o.metadata.namespace, o.metadata.name): _masked(
                led.timeline(o.KIND, o.metadata.namespace, o.metadata.name))
            for kind in ("Cluster", "Work") for o in cp.store.list(kind)}
        ring = _masked(led.recent(n=4096))
        counters = led.counters()
    return cp, log, timelines, ring, counters


def test_loop_event_timelines_equal():
    (jcp, jlog, jt, jr, jc), (pcp, plog, pt, pr, pc) = (
        _run(pkg) for pkg in TS.PKGS)
    assert plog == jlog
    assert plog[0] == ["m1", "m2", "pull-1"]
    assert {s for _, s in plog[1]} == {"Unknown"}
    assert pt == jt
    assert pr == jr and pc == jc
    TL.assert_same(TL.snapshot(jcp), TL.snapshot(pcp))
    reasons = {e["reason"] for e in pr}
    assert {"SyncSucceed", "SyncFailed", "ClusterReady", "ClusterNotReady",
            "ClusterStatusUnknown"} <= reasons
    m2 = pt[("Cluster", "", "m2")]
    assert [e["reason"] for e in m2 if e["reason"].startswith(
        "ClusterNot") or e["reason"] == "ClusterReady"] == [
            "ClusterReady", "ClusterNotReady", "ClusterReady"]
    pull = pt[("Cluster", "", "pull-1")]
    assert [e["origin"] for e in pull if e["reason"] == "ClusterReady"] == [
        "cluster-status"]
    failed = [e for tl in pt.values() for e in tl
              if e["reason"] == "SyncFailed"]
    assert failed and all(e["kind"] == "Work" for e in failed)


def test_metrics_dump_is_the_registry_exposition():
    """`ControlPlane.metrics_dump()` is the process registry's text
    exposition on both packages, the karmada_lock_* families and the
    loop's cluster gauges in it (which families a process has registered
    depends on the modules it imported, so the two dumps are not compared
    with each other)."""
    for M in (TL.MJ, TL.MP):
        registry = importlib.import_module(
            f"{M.name}.utils.metrics").REGISTRY
        cp = TL.plane(M, "serial")
        cp.add_member("m1", cpu_milli=8_000)
        cp.tick()
        dump = cp.metrics_dump()
        assert dump == registry.dump()
        assert "# TYPE karmada_lock_hold_seconds histogram" in dump
        assert 'karmada_cluster_cpu_allocatable_number{cluster_name="m1"}' \
            in dump
