"""The port store's additions (karmada_tpu_torch/store/store.py): the
read path that does not copy (visit / visit_all), the kind-and-namespace
index behind list(), and the admission seam with its nested-write depth.

  * visit(kind[, namespace]) returns what list() returns (equal objects,
    the same order) and visit_all() what items() returns, across creates,
    updates, finalizer-gated and plain deletes;
  * the objects a visit handed out are unchanged after a Scheduler cycle,
    a rebalance round with drains and a graceful-eviction resync -- the
    callers that scan without copying (the Cluster-event handler, the
    rebalance plane, the eviction resync) never write through them;
  * admission mutates and validates inside create and update, before the
    write; a plugin that writes to the store defers its event to the
    outermost writer, so events still arrive in resourceVersion order.
"""

import copy
import random

import pytest

import torch_scenarios as S
from karmada_tpu_torch.controllers.failover import GracefulEvictionController
from karmada_tpu_torch.models.meta import ObjectMeta
from karmada_tpu_torch.models.unstructured import Unstructured
from karmada_tpu_torch.rebalance import RebalanceConfig
from karmada_tpu_torch.scheduler import Scheduler, SchedulingQueue
from karmada_tpu_torch.store import ObjectStore, Runtime
from karmada_tpu_torch.webhook import AdmissionDenied, AdmissionRegistry

M = S.models_of("karmada_tpu_torch")


def template(name, ns="default", finalizers=()):
    obj = Unstructured.from_manifest({
        "apiVersion": "v1", "kind": "ConfigMap",
        "metadata": {"name": name, "namespace": ns}, "data": {"k": name}})
    obj.metadata.finalizers = list(finalizers)
    return obj


def assert_views_agree(store):
    for kind in store.counts_by_kind():
        assert store.visit(kind) == store.list(kind)
        for ns in {o.metadata.namespace for o in store.visit(kind)}:
            assert store.visit(kind, ns) == store.list(kind, ns)
    assert store.visit_all() == list(store.items())
    assert len(store.visit_all()) == len(store)


def test_visit_equals_list_across_writes():
    rng = random.Random(5)
    store = ObjectStore()
    assert store.visit("ConfigMap") == [] and store.counts_by_kind() == {}
    names = [f"c{i:02d}" for i in range(30)]
    for n in rng.sample(names, len(names)):
        store.create(template(n, ns=rng.choice(["a", "b", ""]),
                              finalizers=["f"] if n < "c05" else ()))
    for c in S.control_fleet(M, rng, 5):
        store.create(c)
    assert_views_agree(store)
    assert [o.name for o in store.visit("ConfigMap")] == [
        o.name for o in sorted(store.list("ConfigMap"),
                               key=lambda o: (o.namespace, o.name))]
    for n in names[::3]:
        obj = next(o for o in store.list("ConfigMap") if o.name == n)
        obj.manifest["data"] = {"k": "changed"}
        store.update(obj)
    for n in names[::4]:
        ns = next(o.namespace for o in store.list("ConfigMap")
                  if o.name == n)
        store.delete("ConfigMap", ns, n)  # finalizers: only marked
    assert_views_agree(store)
    marked = [o for o in store.visit("ConfigMap")
              if o.metadata.deletion_timestamp is not None]
    assert {o.name for o in marked} == {n for n in names[::4] if n < "c05"}
    for o in marked:
        o = store.get("ConfigMap", o.namespace, o.name)
        o.metadata.finalizers = []
        store.update(o)  # finalizers drained: removed
    assert_views_agree(store)
    assert store.counts_by_kind() == {
        "ConfigMap": 30 - len(names[::4]), "Cluster": 5}
    assert store.revision >= max(o.metadata.resource_version
                                 for o in store.visit_all())


def test_visited_objects_unchanged_by_a_cycle_and_a_rebalance_round():
    rng, clock = random.Random(3), S.FakeClock()
    store, rt = ObjectStore(), Runtime()
    fleet = S.control_fleet(M, rng, 12)
    for c in fleet:
        store.create(c)
    sched = Scheduler(store, rt, device="cpu",
                      queue=SchedulingQueue(now=clock), rebalance=30.0,
                      rebalance_clock=clock,
                      rebalance_cfg=RebalanceConfig(budget_per_cluster=24))
    GracefulEvictionController(store, rt, grace_period_s=300, clock=clock)
    pls = S.control_placements(M, rng, [c.name for c in fleet])
    for rb in S.control_bindings(M, rng, 300, [pls[i] for i in (0, 1, 4, 5)]):
        store.create(rb)
    seen = store.visit("ResourceBinding") + store.visit("Cluster")
    frozen = copy.deepcopy(seen)
    rt.pump()  # the scheduler cycle
    S.report_allocated(M, store)  # Cluster events: the handler's scan
    rt.pump()
    seen2 = store.visit("ResourceBinding") + store.visit("Cluster")
    frozen2 = copy.deepcopy(seen2)
    held = S.committed_by_cluster(store.list("ResourceBinding"))
    for n in sorted(held, key=lambda n: -held[n])[:2]:
        S.crush(M, store, n, held[n])
    evicted = 0
    for _ in range(6):
        clock.advance(30)
        rt.tick()  # rebalance rounds, drains, re-places, eviction resyncs
        evicted = sched.rebalance_plane.stats()["evictions"]
    assert evicted > 0 and sched.cycle_log
    assert seen == frozen and seen2 == frozen2
    assert sched.faults() == {} and not any(rt.reconcile_errors().values())
    assert sched.cluster_events > 0 and sched.cluster_event_s > 0
    assert_views_agree(store)


def test_admission_inside_the_write_and_nested_writes_drain_in_order():
    reg = AdmissionRegistry()
    store = ObjectStore(admission=reg)
    seen = []
    store.bus.subscribe(lambda ev: seen.append(
        (ev.type, ev.kind, ev.obj.metadata.resource_version)))

    def audit(op, obj, old):
        # a plugin that writes another kind from inside the write
        store.create(Unstructured(
            metadata=ObjectMeta(name=f"audit-{obj.name}-{op.lower()}",
                                namespace="default"),
            manifest={"apiVersion": "v1", "kind": "Event"}))
        obj.manifest.setdefault("data", {})["admitted"] = op

    def deny_empty(op, obj, old):
        return None if obj.manifest.get("data", {}).get("k") else "empty"

    reg.register_mutating("ConfigMap", audit)
    reg.register_validating("ConfigMap", deny_empty)
    stored = store.create(template("x"))
    assert stored.manifest["data"]["admitted"] == "CREATE"
    obj = store.get("ConfigMap", "default", "x")
    obj.manifest["data"]["k"] = "y"
    assert store.update(obj).manifest["data"]["admitted"] == "UPDATE"
    bad = template("z")
    bad.manifest["data"] = {}
    with pytest.raises(AdmissionDenied, match="empty"):
        store.create(bad)
    assert store.try_get("ConfigMap", "default", "z") is None
    # the denied write's nested create stays (the mutator ran) and its
    # event waits for the next writer's drain, as in the JAX package
    assert store.try_get("Event", "default", "audit-z-create") is not None
    assert [k for _, k, _ in seen] == ["Event", "ConfigMap", "Event",
                                       "ConfigMap"]
    store.create(template("w"))
    # every event delivered, in resourceVersion order (the nested creates
    # took the lower rvs and drained with the outer write)
    assert [rv for _, _, rv in seen] == sorted(rv for _, _, rv in seen)
    assert [k for _, k, _ in seen][4:] == ["Event", "Event", "ConfigMap"]
