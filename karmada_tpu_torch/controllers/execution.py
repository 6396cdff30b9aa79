"""Execution controller + object watcher: apply Work to member clusters.

Mirrors reference pkg/controllers/execution/execution_controller.go:82-160
(gate on cluster Ready + dispatch suspension, then sync manifests) and
pkg/util/objectwatcher/objectwatcher.go:57-330 (create/update with retained
member-side fields and ConflictResolution overwrite/abort).  The member
"API server" here is a FakeMemberCluster; real clients slot in behind the
same apply interface.

Counterpart of the JAX package's ``controllers/execution.py``.  Every
sync records the JAX controller's SyncSucceed / SyncFailed event on the
Work and is observed on karmada_work_sync_workload_duration_seconds; the
port also counts the syncs that hit an apply error
(`ExecutionController.sync_failures`, and by cluster in
`sync_failures_by_cluster`; the errors stand in the Work's
Applied=False condition).
The reconcile reads the Work, its Cluster and binding, and the member's
object as stored (ObjectStore.peek): it only looks, and writes through
the member's apply and the store's mutate.
"""

from __future__ import annotations

import copy
import time
from typing import Dict, Optional

from karmada_tpu_torch.controllers.binding import (
    EXECUTION_NS_PREFIX,
    WORK_BINDING_LABEL,
    execution_namespace,
)
from karmada_tpu_torch.interpreter import ResourceInterpreter
from karmada_tpu_torch.members.member import FakeMemberCluster
from karmada_tpu_torch.models.cluster import Cluster
from karmada_tpu_torch.models.meta import Condition, deep_get, set_condition
from karmada_tpu_torch.models.work import COND_WORK_APPLIED, ResourceBinding, Work
from karmada_tpu_torch.store.store import DELETED, Event, ObjectStore
from karmada_tpu_torch.store.worker import AsyncWorker, Runtime
from karmada_tpu_torch.utils import events as ev
from karmada_tpu_torch.utils.metrics import REGISTRY, exponential_buckets

# execution_controller.go:154 metrics.ObserveSyncWorkloadLatency
SYNC_WORKLOAD_LATENCY = REGISTRY.histogram(
    "karmada_work_sync_workload_duration_seconds",
    "Duration in seconds to sync a Work's manifests to its member cluster",
    ("result",),
    buckets=exponential_buckets(0.001, 2, 12),
)

# annotation carrying the conflict policy down to the apply engine
CONFLICT_ANNOTATION = "work.karmada.io/conflict-resolution"


class ObjectWatcher:
    """Apply engine for one member cluster (objectwatcher.go:57)."""

    def __init__(self, interpreter: ResourceInterpreter) -> None:
        self.interpreter = interpreter
        # version records: (cluster, kind, ns, name) -> member resourceVersion
        self._versions: Dict[tuple, int] = {}

    def create_or_update(
        self, member: FakeMemberCluster, manifest: Dict, conflict_resolution: str
    ) -> None:
        kind = manifest.get("kind", "")
        ns = deep_get(manifest, "metadata.namespace", "")
        name = deep_get(manifest, "metadata.name", "")
        observed = member.store.peek(kind, ns, name)
        if observed is None:
            member.apply(manifest)
        else:
            rec = self._versions.get((member.name, kind, ns, name))
            managed = deep_get(
                observed.manifest, "metadata.annotations", {}
            ).get("work.karmada.io/managed") == "true"
            if rec is None and not managed and conflict_resolution != "Overwrite":
                raise RuntimeError(
                    f"conflict: {kind} {ns}/{name} exists in {member.name} "
                    f"and ConflictResolution is Abort"
                )
            desired = self.interpreter.retain(manifest, observed.manifest)
            member.apply(desired)
        applied = member.store.peek(kind, ns, name)
        if applied is not None:
            self._versions[(member.name, kind, ns, name)] = (
                applied.metadata.resource_version
            )

    def delete(self, member: FakeMemberCluster, manifest: Dict) -> None:
        kind = manifest.get("kind", "")
        ns = deep_get(manifest, "metadata.namespace", "")
        name = deep_get(manifest, "metadata.name", "")
        member.delete(kind, ns, name)
        self._versions.pop((member.name, kind, ns, name), None)


def _mark_managed(manifest: Dict) -> Dict:
    out = copy.deepcopy(manifest)
    out.setdefault("metadata", {}).setdefault("annotations", {})[
        "work.karmada.io/managed"
    ] = "true"
    return out


class ExecutionController:
    def __init__(
        self,
        store: ObjectStore,
        runtime: Runtime,
        members: Dict[str, FakeMemberCluster],
        interpreter: Optional[ResourceInterpreter] = None,
        recorder: Optional[ev.EventRecorder] = None,
    ) -> None:
        self.store = store
        self.members = members
        self.recorder = recorder if recorder is not None else ev.EventRecorder()
        #: Work syncs that hit an apply error (the Work is marked
        #: Applied=False and requeued), in all and by cluster
        self.sync_failures = 0
        self.sync_failures_by_cluster: Dict[str, int] = {}
        self.watcher = ObjectWatcher(interpreter or ResourceInterpreter())
        self._deleted: Dict[tuple, list] = {}
        self.worker = runtime.register(AsyncWorker("execution", self._reconcile))
        store.bus.subscribe(self._on_event, kind=Work.KIND)
        store.bus.subscribe(self._on_cluster_event, kind=Cluster.KIND)

    def _on_cluster_event(self, event: Event) -> None:
        # a cluster turning Ready must replay its pending Works (the retry
        # budget may have been exhausted while it was down)
        if event.obj.ready:  # type: ignore[union-attr]
            ns = execution_namespace(event.obj.name)
            for w in self.store.visit(Work.KIND, ns):
                self.worker.enqueue((ns, w.name, False))

    def _on_event(self, event: Event) -> None:
        if event.type == DELETED:
            # the Work is gone from the store; carry its manifests for teardown
            self._deleted[(event.obj.namespace, event.obj.name)] = list(
                event.obj.spec.workload
            )
        self.worker.enqueue(
            (event.obj.namespace, event.obj.name, event.type == DELETED)
        )

    def _cluster_ready(self, name: str) -> bool:
        c = self.store.peek(Cluster.KIND, "", name)
        return c is not None and c.ready  # type: ignore[union-attr]

    def _reconcile(self, key) -> Optional[bool]:
        ns, name, deleted = key
        cluster_name = ns[len(EXECUTION_NS_PREFIX):]
        member = self.members.get(cluster_name)
        work = None if deleted else self.store.peek(Work.KIND, ns, name)
        if work is None or work.metadata.deleting:
            # Work removed: tear the manifests down in the member cluster
            manifests = self._deleted.pop((ns, name), None)
            if manifests is None and work is not None:
                manifests = work.spec.workload
            if member is not None:
                for manifest in manifests or []:
                    self.watcher.delete(member, manifest)
            return None
        if member is None:
            return None
        if work.spec.suspend_dispatching:
            return None
        if not self._cluster_ready(cluster_name):
            return False  # requeue until the cluster turns Ready
        errors = []
        sync_start = time.perf_counter()
        conflict = "Abort"
        label = work.metadata.labels.get(WORK_BINDING_LABEL, "")
        if label and "." in label:
            rb_ns, rb_name = label.split(".", 1)
            rb = self.store.peek(ResourceBinding.KIND, rb_ns, rb_name)
            if rb is not None:
                conflict = rb.spec.conflict_resolution
        for manifest in work.spec.workload:
            try:
                self.watcher.create_or_update(member, _mark_managed(manifest), conflict)
            # surfaced in the Work's Applied=False condition and counted
            except Exception as e:  # noqa: BLE001
                errors.append(str(e))

        def set_applied(w: Work) -> None:
            ok = not errors
            set_condition(w.status.conditions, Condition(
                type=COND_WORK_APPLIED,
                status="True" if ok else "False",
                reason="AppliedSuccessful" if ok else "AppliedFailed",
                message="; ".join(errors),
            ))

        self.store.mutate(Work.KIND, ns, name, set_applied)
        SYNC_WORKLOAD_LATENCY.observe(
            time.perf_counter() - sync_start,
            result="error" if errors else "success",
        )
        if errors:
            self.sync_failures += 1
            self.sync_failures_by_cluster[cluster_name] = (
                self.sync_failures_by_cluster.get(cluster_name, 0) + 1)
            self.recorder.event(work, ev.TYPE_WARNING,
                                ev.REASON_SYNC_WORKLOAD_FAILED, "; ".join(errors))
        else:
            self.recorder.event(
                work, ev.TYPE_NORMAL, ev.REASON_SYNC_WORKLOAD_SUCCEED,
                f"Successfully applied manifests to cluster {cluster_name}.",
            )
        return None if not errors else False
