"""Status controllers: the "backward pass" of the propagation loop.

* WorkStatusController -- mirrors pkg/controllers/status/
  work_status_controller.go:84-438: watches applied objects in member
  clusters (per-member informers), reflects status+health into
  work.status.manifestStatuses via the interpreter, and recreates
  desired-but-deleted member objects (:310).
* BindingStatusController -- rb_status_controller.go:60: aggregates Work
  statuses into binding.status.aggregatedStatus, sets FullyApplied, and
  writes the template's aggregated status via the interpreter.
* ClusterStatusController -- cluster_status_controller.go:127-680: the
  per-cluster heartbeat; collects health, APIEnablements, and the
  ResourceSummary capacity tensor source from the member simulator.

Counterpart of the JAX package's ``controllers/status.py``.  The cluster
collector renews each cluster's heartbeat Lease after its collect
(controllers/lease.py) on the wall clock, as the JAX collector does,
whatever clock the plane's other controllers read.  It sets the
karmada_cluster_* gauges after each collect; it records no readiness
events (they wait with the loop's events).  The reads that only look -- a member
object's Work (a scan of its execution namespace), a binding's Works and
template -- take the stored objects without copying (ObjectStore.visit / peek); the aggregated
items reach the store through mutate, which copies.
"""

from __future__ import annotations

from typing import Dict, Optional

from karmada_tpu_torch.controllers.binding import (
    WORK_BINDING_LABEL,
    execution_namespace,
    work_name,
)
from karmada_tpu_torch.estimator.general import produce_allocatable_modelings
from karmada_tpu_torch.interpreter import ResourceInterpreter
from karmada_tpu_torch.members.member import FakeMemberCluster
from karmada_tpu_torch.models.cluster import (
    COND_CLUSTER_READY,
    COND_COMPLETE_API_ENABLEMENTS,
    Cluster,
)
from karmada_tpu_torch.models.meta import Condition, deep_get, set_condition
from karmada_tpu_torch.models.unstructured import Unstructured
from karmada_tpu_torch.models.work import (
    COND_FULLY_APPLIED,
    COND_WORK_APPLIED,
    AggregatedStatusItem,
    ManifestStatus,
    ResourceBinding,
    Work,
)
from karmada_tpu_torch.store.store import DELETED, Event, NotFoundError, ObjectStore
from karmada_tpu_torch.store.worker import AsyncWorker, Runtime


class WorkStatusController:
    def __init__(
        self,
        store: ObjectStore,
        runtime: Runtime,
        members: Dict[str, FakeMemberCluster],
        interpreter: Optional[ResourceInterpreter] = None,
    ) -> None:
        self.store = store
        self.members = members
        self.interpreter = interpreter or ResourceInterpreter()
        self.worker = runtime.register(AsyncWorker("work-status", self._reconcile))
        # per-member informers (buildResourceInformers :128)
        for name, member in members.items():
            member.store.bus.subscribe(self._member_event(name))

    def _member_event(self, cluster: str):
        def handler(event: Event) -> None:
            obj = event.obj
            self.worker.enqueue(
                (cluster, obj.KIND, obj.namespace, obj.name, event.type == DELETED)
            )

        return handler

    def _reconcile(self, key) -> None:
        cluster, kind, ns, name, deleted = key
        member = self.members.get(cluster)
        if member is None:
            return
        # find the Work desiring this object
        work = self._work_for(cluster, kind, ns, name)
        if work is None:
            return
        if deleted or member.get(kind, ns, name) is None:
            # desired object vanished from the member: recreate (:310) --
            # through the same managed-marking the execution path uses
            from karmada_tpu_torch.controllers.execution import _mark_managed

            if not work.metadata.deleting and not work.spec.suspend_dispatching:
                for manifest in work.spec.workload:
                    if (
                        manifest.get("kind") == kind
                        and deep_get(manifest, "metadata.name") == name
                    ):
                        member.apply(_mark_managed(manifest))
            return
        observed = member.get(kind, ns, name)
        status = self.interpreter.reflect_status(observed.manifest)
        health = self.interpreter.interpret_health(observed.manifest)
        ms = ManifestStatus(
            identifier={"kind": kind, "namespace": ns, "name": name},
            status=status,
            health=health,
        )

        def update(w: Work) -> None:
            rest = [
                m for m in w.status.manifest_statuses
                if m.identifier != ms.identifier
            ]
            w.status.manifest_statuses = rest + [ms]

        try:
            self.store.mutate(Work.KIND, work.metadata.namespace, work.name, update)
        except NotFoundError:
            pass

    def _work_for(self, cluster: str, kind: str, ns: str, name: str) -> Optional[Work]:
        for w in self.store.visit(Work.KIND, execution_namespace(cluster)):
            for manifest in w.spec.workload:
                if (
                    manifest.get("kind") == kind
                    and deep_get(manifest, "metadata.namespace", "") == ns
                    and deep_get(manifest, "metadata.name") == name
                ):
                    return w
        return None


class BindingStatusController:
    def __init__(
        self,
        store: ObjectStore,
        runtime: Runtime,
        interpreter: Optional[ResourceInterpreter] = None,
    ) -> None:
        self.store = store
        self.interpreter = interpreter or ResourceInterpreter()
        self.worker = runtime.register(AsyncWorker("binding-status", self._reconcile))
        store.bus.subscribe(self._on_event, kind=Work.KIND)

    def _on_event(self, event: Event) -> None:
        label = event.obj.metadata.labels.get(WORK_BINDING_LABEL, "")
        if label and "." in label:
            ns, name = label.split(".", 1)
            self.worker.enqueue((ns, name))

    def _reconcile(self, key) -> None:
        ns, name = key
        rb = self.store.peek(ResourceBinding.KIND, ns, name)
        if rb is None:
            return
        items = []
        applied_all = bool(rb.spec.clusters)
        wname = work_name(rb)
        for target in rb.spec.clusters:
            w = self.store.peek(Work.KIND, execution_namespace(target.name),
                                wname)
            if w is None:
                applied_all = False
                continue
            applied = any(
                c.type == COND_WORK_APPLIED and c.status == "True"
                for c in w.status.conditions
            )
            applied_all = applied_all and applied
            status = None
            health = "Unknown"
            for m in w.status.manifest_statuses:
                status = m.status
                health = m.health
            items.append(AggregatedStatusItem(
                cluster_name=target.name, status=status, applied=applied,
                health=health,
            ))

        def update(obj: ResourceBinding) -> None:
            obj.status.aggregated_status = items
            set_condition(obj.status.conditions, Condition(
                type=COND_FULLY_APPLIED,
                status="True" if applied_all else "False",
                reason="FullyAppliedSuccess" if applied_all else "FullyAppliedFailed",
            ))

        self.store.mutate(ResourceBinding.KIND, ns, name, update)

        # reflect the aggregate onto the template (AggregateStatus)
        resource = rb.spec.resource
        template = self.store.peek(resource.kind, resource.namespace,
                                   resource.name)
        if template is not None and isinstance(template, Unstructured) and items:
            merged = self.interpreter.aggregate_status(template.to_manifest(), items)
            if merged.get("status") != template.manifest.get("status"):
                def set_status(t: Unstructured) -> None:
                    t.manifest["status"] = merged.get("status")
                try:
                    self.store.mutate(
                        resource.kind, resource.namespace, resource.name, set_status
                    )
                except NotFoundError:
                    pass



from karmada_tpu_torch.utils.metrics import REGISTRY as _REGISTRY

CLUSTER_READY_STATE = _REGISTRY.gauge(
    "karmada_cluster_ready_state", "State of the cluster (1 ready, 0 not)",
    ("cluster_name",))
CLUSTER_CPU_ALLOCATABLE = _REGISTRY.gauge(
    "karmada_cluster_cpu_allocatable_number", "Allocatable cluster CPU cores",
    ("cluster_name",))
CLUSTER_CPU_ALLOCATED = _REGISTRY.gauge(
    "karmada_cluster_cpu_allocated_number", "Allocated cluster CPU cores",
    ("cluster_name",))
CLUSTER_MEMORY_ALLOCATABLE = _REGISTRY.gauge(
    "karmada_cluster_memory_allocatable_bytes", "Allocatable cluster memory",
    ("cluster_name",))
CLUSTER_MEMORY_ALLOCATED = _REGISTRY.gauge(
    "karmada_cluster_memory_allocated_bytes", "Allocated cluster memory",
    ("cluster_name",))
CLUSTER_POD_ALLOCATABLE = _REGISTRY.gauge(
    "karmada_cluster_pod_allocatable_number", "Allocatable cluster pod slots",
    ("cluster_name",))
CLUSTER_POD_ALLOCATED = _REGISTRY.gauge(
    "karmada_cluster_pod_allocated_number", "Allocated cluster pod slots",
    ("cluster_name",))


def _export_gauges(cluster: Cluster) -> None:
    """karmada_cluster_* gauges (pkg/metrics/cluster.go:57-132), set after
    every collect."""
    CLUSTER_READY_STATE.set(1.0 if cluster.ready else 0.0,
                            cluster_name=cluster.name)
    summary = cluster.status.resource_summary
    if summary is None:
        return
    for res, gauge_alloc, gauge_used in (
        ("cpu", CLUSTER_CPU_ALLOCATABLE, CLUSTER_CPU_ALLOCATED),
        ("memory", CLUSTER_MEMORY_ALLOCATABLE, CLUSTER_MEMORY_ALLOCATED),
        ("pods", CLUSTER_POD_ALLOCATABLE, CLUSTER_POD_ALLOCATED),
    ):
        alloc = summary.allocatable.get(res)
        used = summary.allocated.get(res)
        if alloc is not None:
            gauge_alloc.set(alloc.milli / 1000.0, cluster_name=cluster.name)
        if used is not None:
            gauge_used.set(used.milli / 1000.0, cluster_name=cluster.name)


class ClusterStatusController:
    """Periodic heartbeat: member telemetry -> Cluster.status."""

    def __init__(
        self,
        store: ObjectStore,
        runtime: Runtime,
        members: Dict[str, FakeMemberCluster],
    ) -> None:
        self.store = store
        self.members = members
        # name -> (the member's state_key, the Cluster's resourceVersion)
        # after its last collect: the update is a function of the two, so
        # while both hold it would write nothing again
        self._collected: Dict[str, tuple] = {}
        runtime.register_periodic(self.collect_all, name="cluster-status")

    def collect_all(self) -> None:
        from karmada_tpu_torch.controllers.lease import renew_cluster_lease

        for name, member in self.members.items():
            cluster = self.store.peek(Cluster.KIND, "", name)
            if cluster is None:
                continue
            key = (member.state_key(), tuple(
                (a.group_version, tuple(a.resources))
                for a in member.api_enablements))
            if self._collected.get(name) != (
                    key, cluster.metadata.resource_version):
                self._collect(name, member, key)
            # heartbeat lease: proves THIS collector is alive, independent
            # of the member's own health (cluster_status_controller.go:399)
            renew_cluster_lease(self.store, name)

    def _collect(self, name: str, member: FakeMemberCluster, key) -> None:
        def update(c: Cluster, member=member) -> None:
            online = member.healthy
            set_condition(c.status.conditions, Condition(
                type=COND_CLUSTER_READY,
                status="True" if online else "False",
                reason="ClusterReady" if online else "ClusterNotReachable",
            ))
            if online:
                c.status.api_enablements = list(member.api_enablements)
                set_condition(c.status.conditions, Condition(
                    type=COND_COMPLETE_API_ENABLEMENTS, status="True",
                    reason="CollectionSucceed",
                ))
                c.status.resource_summary = member.resource_summary()
                if c.spec.resource_models:
                    # feature CustomizedClusterResourceModeling
                    # (cluster_status_controller.go:282 -> modeling.go)
                    c.status.resource_summary.allocatable_modelings = (
                        produce_allocatable_modelings(
                            member, c.spec.resource_models
                        )
                    )

        stored = self.store.mutate(Cluster.KIND, "", name, update)
        self._collected[name] = (key, stored.metadata.resource_version)
        _export_gauges(stored)
