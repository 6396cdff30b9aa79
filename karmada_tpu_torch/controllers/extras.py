"""Auxiliary controllers: rebalancer, condition-driven taints, remedy, quota.

Counterpart of the JAX package's ``controllers/extras.py``.  As there,
the rebalancer's rescheduleTriggeredAt / finishTime and a taint policy's
timeAdded read the wall clock (time.time), not a plane's clock; the reads
that only look take the stored objects without copying
(ObjectStore.visit / peek).

* WorkloadRebalancerController -- pkg/controllers/workloadrebalancer/
  workloadrebalancer_controller.go:78: stamps rescheduleTriggeredAt on each
  listed workload's binding so the scheduler runs a Fresh re-assignment.
* ClusterTaintPolicyController -- pkg/controllers/taint/
  clustertaintpolicy_controller.go:60: condition-matched taint add/remove.
* RemedyController -- pkg/controllers/remediation/remedy_controller.go:51:
  Remedy x cluster conditions -> cluster.status.remedyActions.
* FederatedResourceQuotaController -- pkg/controllers/federatedresourcequota/
  *.go:65-68: static per-cluster quota split rendered into per-cluster
  ResourceQuota Works + usage aggregation into the FRQ status.
"""

from __future__ import annotations

import time
from typing import Dict, List

from karmada_tpu_torch.controllers.binding import execution_namespace
from karmada_tpu_torch.controllers.detector import binding_name
from karmada_tpu_torch.models.cluster import Cluster, Taint
from karmada_tpu_torch.models.extras import (
    ClusterQuotaStatus,
    ClusterTaintPolicy,
    FederatedResourceQuota,
    MatchCondition,
    ObservedWorkload,
    Remedy,
    WorkloadRebalancer,
)
from karmada_tpu_torch.models.meta import get_condition
from karmada_tpu_torch.models.work import ResourceBinding, Work, WorkSpec
from karmada_tpu_torch.store.store import Event, NotFoundError, ObjectStore
from karmada_tpu_torch.store.worker import AsyncWorker, Runtime
from karmada_tpu_torch.utils.quantity import Quantity
from karmada_tpu_torch.webhook.builtin import calculate_rb_usage


class WorkloadRebalancerController:
    def __init__(self, store: ObjectStore, runtime: Runtime) -> None:
        self.store = store
        self.worker = runtime.register(AsyncWorker("rebalancer", self._reconcile))
        store.bus.subscribe(self._on_event, kind=WorkloadRebalancer.KIND)

    def _on_event(self, event: Event) -> None:
        self.worker.enqueue(event.obj.name)

    def _reconcile(self, name) -> None:
        wr = self.store.try_get(WorkloadRebalancer.KIND, "", name)
        if wr is None or wr.status.finish_time is not None:
            return
        observed: List[ObservedWorkload] = []
        now = time.time()
        for ref in wr.spec.workloads:
            rb_name = binding_name(ref.kind, ref.name)
            rb = self.store.try_get(ResourceBinding.KIND, ref.namespace, rb_name)
            if rb is None:
                observed.append(ObservedWorkload(workload=ref, result="NotFound"))
                continue

            def trigger(obj: ResourceBinding) -> None:
                obj.spec.reschedule_triggered_at = now

            try:
                self.store.mutate(ResourceBinding.KIND, ref.namespace, rb_name, trigger)
                observed.append(ObservedWorkload(workload=ref, result="Successful"))
            except NotFoundError:
                observed.append(ObservedWorkload(workload=ref, result="NotFound"))

        def finish(obj: WorkloadRebalancer) -> None:
            obj.status.observed_workloads = observed
            obj.status.finish_time = now

        self.store.mutate(WorkloadRebalancer.KIND, "", name, finish)


def _condition_matches(cluster: Cluster, matches: List[MatchCondition]) -> bool:
    """All matchConditions must hold (clustertaintpolicy semantics)."""
    if not matches:
        return False
    for m in matches:
        cond = get_condition(cluster.status.conditions, m.condition_type)
        status = cond.status if cond is not None else "Unknown"
        if m.operator == "In" and status not in m.status_values:
            return False
        if m.operator == "NotIn" and status in m.status_values:
            return False
    return True


class ClusterTaintPolicyController:
    def __init__(self, store: ObjectStore, runtime: Runtime) -> None:
        self.store = store
        self.worker = runtime.register(AsyncWorker("taint-policy", self._reconcile))
        store.bus.subscribe(self._on_event)

    def _on_event(self, event: Event) -> None:
        if event.kind == Cluster.KIND:
            self.worker.enqueue(event.obj.name)
        elif event.kind == ClusterTaintPolicy.KIND:
            for c in self.store.visit(Cluster.KIND):
                self.worker.enqueue(c.name)

    def _reconcile(self, cluster_name) -> None:
        cluster = self.store.peek(Cluster.KIND, "", cluster_name)
        if cluster is None:
            return
        add: Dict[tuple, Taint] = {}
        remove: set = set()
        for policy in self.store.visit(ClusterTaintPolicy.KIND):
            spec = policy.spec
            if spec.target_clusters is not None and not spec.target_clusters.matches(
                cluster
            ):
                continue
            for t in spec.taints:
                key = (t.key, t.effect)
                if _condition_matches(cluster, spec.add_on_conditions):
                    add[key] = Taint(key=t.key, value=t.value, effect=t.effect,
                                     time_added=time.time())
                elif _condition_matches(cluster, spec.remove_on_conditions):
                    remove.add(key)
        if not add and not remove:
            return

        def update(c: Cluster) -> None:
            existing = {(t.key, t.effect): t for t in c.spec.taints}
            for key, taint in add.items():
                if key not in existing:
                    existing[key] = taint
            for key in remove:
                if key not in add:
                    existing.pop(key, None)
            c.spec.taints = sorted(existing.values(), key=lambda t: (t.key, t.effect))

        self.store.mutate(Cluster.KIND, "", cluster_name, update)


class RemedyController:
    def __init__(self, store: ObjectStore, runtime: Runtime) -> None:
        self.store = store
        self.worker = runtime.register(AsyncWorker("remedy", self._reconcile))
        store.bus.subscribe(self._on_event)

    def _on_event(self, event: Event) -> None:
        if event.kind == Cluster.KIND:
            self.worker.enqueue(event.obj.name)
        elif event.kind == Remedy.KIND:
            for c in self.store.visit(Cluster.KIND):
                self.worker.enqueue(c.name)

    def _reconcile(self, cluster_name) -> None:
        cluster = self.store.peek(Cluster.KIND, "", cluster_name)
        if cluster is None:
            return
        actions: set = set()
        for remedy in self.store.visit(Remedy.KIND):
            spec = remedy.spec
            if spec.cluster_affinity is not None and not spec.cluster_affinity.matches(
                cluster
            ):
                continue
            if not spec.decision_matches:
                actions.update(spec.actions)  # unconditional remedy
                continue
            for dm in spec.decision_matches:
                cond = get_condition(
                    cluster.status.conditions, dm.cluster_condition_type
                )
                if cond is not None and cond.status == dm.cluster_condition_status:
                    actions.update(spec.actions)
                    break
        wanted = sorted(actions)
        if cluster.status.remedy_actions == wanted:
            return

        def update(c: Cluster) -> None:
            c.status.remedy_actions = wanted

        self.store.mutate(Cluster.KIND, "", cluster_name, update)


class FederatedResourceQuotaController:
    """Static split -> per-cluster ResourceQuota Works + usage aggregation.

    Overall-only quotas (no static assignments) follow the reference's
    enforcement controller instead (federated_resource_quota_enforcement_
    controller.go:239 collectQuotaStatus): status.overallUsed is
    recalculated from the namespace's ResourceBindings, reconciling on FRQ
    changes and on every binding change in the namespace."""

    def __init__(self, store: ObjectStore, runtime: Runtime) -> None:
        self.store = store
        self.worker = runtime.register(AsyncWorker("frq", self._reconcile))
        store.bus.subscribe(self._on_event, kind=FederatedResourceQuota.KIND)
        store.bus.subscribe(self._on_binding_event, kind="ResourceBinding")

    def _on_event(self, event: Event) -> None:
        self.worker.enqueue((event.obj.namespace, event.obj.name))

    def _on_binding_event(self, event: Event) -> None:
        ns = event.obj.namespace
        for frq in self.store.visit(FederatedResourceQuota.KIND, ns):
            self.worker.enqueue((ns, frq.metadata.name))

    def _work_id(self, ns: str, name: str) -> str:
        return f"resourcequota-{ns}-{name}"

    def _reconcile(self, key) -> None:
        ns, name = key
        frq = self.store.try_get(FederatedResourceQuota.KIND, ns, name)
        if frq is None or frq.metadata.deleting:
            for c in self.store.visit(Cluster.KIND):
                try:
                    self.store.delete(
                        Work.KIND, execution_namespace(c.name), self._work_id(ns, name)
                    )
                except NotFoundError:
                    pass
            return
        assigned_clusters = {a.cluster_name for a in frq.spec.static_assignments}
        # drop Works for clusters no longer in the static assignment list
        for c in self.store.visit(Cluster.KIND):
            if c.name in assigned_clusters:
                continue
            try:
                self.store.delete(
                    Work.KIND, execution_namespace(c.name), self._work_id(ns, name)
                )
            except NotFoundError:
                pass
        for assignment in frq.spec.static_assignments:
            manifest = {
                "apiVersion": "v1",
                "kind": "ResourceQuota",
                "metadata": {"name": name, "namespace": ns},
                "spec": {"hard": {k: str(v) for k, v in assignment.hard.items()}},
            }
            wns = execution_namespace(assignment.cluster_name)
            wid = self._work_id(ns, name)
            existing = self.store.try_get(Work.KIND, wns, wid)
            if existing is None:
                w = Work()
                w.metadata.namespace = wns
                w.metadata.name = wid
                w.spec = WorkSpec(workload=[manifest])
                self.store.create(w)
            else:
                def update(w: Work) -> None:
                    w.spec.workload = [manifest]
                self.store.mutate(Work.KIND, wns, wid, update)

        # overall-only quota: recalculate overallUsed from the namespace's
        # ResourceBindings (collectQuotaStatus), the same usage math the
        # admission gate applies — the two converge on the same number
        if not frq.spec.static_assignments:
            overall_used = {}
            for rb in self.store.visit("ResourceBinding", ns):
                for k, milli in calculate_rb_usage(rb).items():
                    overall_used[k] = Quantity(
                        overall_used.get(k, Quantity(0)).milli + milli
                    )

            def set_overall(obj: FederatedResourceQuota) -> None:
                obj.status.overall = dict(obj.spec.overall)
                obj.status.overall_used = overall_used
                obj.status.aggregated_status = []

            self.store.mutate(FederatedResourceQuota.KIND, ns, name, set_overall)
            return

        # aggregate usage from the member-side ResourceQuota statuses
        agg: List = []
        overall_used: Dict[str, Quantity] = {}
        for assignment in frq.spec.static_assignments:
            w = self.store.try_get(
                Work.KIND, execution_namespace(assignment.cluster_name),
                self._work_id(ns, name),
            )
            used: Dict[str, Quantity] = {}
            if w is not None:
                for ms in w.status.manifest_statuses:
                    for k, v in ((ms.status or {}).get("used") or {}).items():
                        used[k] = Quantity.parse(v)
            agg.append(ClusterQuotaStatus(
                cluster_name=assignment.cluster_name,
                hard=dict(assignment.hard), used=used,
            ))
            for k, v in used.items():
                overall_used[k] = overall_used.get(k, Quantity(0)) + v

        def set_status(obj: FederatedResourceQuota) -> None:
            obj.status.overall = dict(obj.spec.overall)
            obj.status.overall_used = overall_used
            obj.status.aggregated_status = agg

        self.store.mutate(FederatedResourceQuota.KIND, ns, name, set_status)
