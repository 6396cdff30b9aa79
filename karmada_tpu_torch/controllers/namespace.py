"""Namespace sync: auto-propagate namespaces to every member cluster.

Counterpart of the JAX package's ``controllers/namespace.py``.

Mirrors reference pkg/controllers/namespace/namespace_sync_controller.go:70:
each non-system Namespace template is rendered into a Work for every known
cluster (no policy needed); new clusters receive all existing namespaces.
The scans of clusters only read names, without copying
(ObjectStore.visit).  A Cluster event enqueues the namespaces that sync
(the reconcile skips the others anyway), which the controller keeps as
a set from the Namespace events: each joined cluster's execution space
is a karmada- namespace, so a fleet's worth of them would otherwise be
walked on every Cluster event.
"""

from __future__ import annotations

from karmada_tpu_torch.controllers.binding import execution_namespace
from karmada_tpu_torch.interpreter.interpreter import prune_for_propagation
from karmada_tpu_torch.models.cluster import Cluster
from karmada_tpu_torch.models.unstructured import Unstructured
from karmada_tpu_torch.models.work import Work, WorkSpec
from karmada_tpu_torch.store.store import DELETED, Event, NotFoundError, ObjectStore
from karmada_tpu_torch.store.worker import AsyncWorker, Runtime

SKIPPED_PREFIXES = ("kube-", "karmada-")
SKIPPED = {"default", "kube-system", "kube-public"}


def should_sync(name: str) -> bool:
    return name not in SKIPPED and not any(
        name.startswith(p) for p in SKIPPED_PREFIXES
    )


class NamespaceSyncController:
    def __init__(self, store: ObjectStore, runtime: Runtime) -> None:
        self.store = store
        #: the names of the stored Namespaces that sync, in store order
        self._synced = {ns.name: None for ns in store.visit("Namespace")
                        if should_sync(ns.name)}
        self.worker = runtime.register(AsyncWorker("namespace-sync", self._reconcile))
        store.bus.subscribe(self._on_event)

    def _on_event(self, event: Event) -> None:
        if event.kind == "Namespace":
            name = event.obj.name
            if event.type == DELETED:
                self._synced.pop(name, None)
            elif should_sync(name):
                self._synced.setdefault(name, None)
            self.worker.enqueue((name, event.type == DELETED))
        elif event.kind == Cluster.KIND and event.type != DELETED:
            for name in list(self._synced):
                self.worker.enqueue((name, False))

    def _reconcile(self, key) -> None:
        name, deleted = key
        if not should_sync(name):
            return
        obj = self.store.try_get("Namespace", "", name)
        work_id = f"namespace-{name}"
        if deleted or obj is None or obj.metadata.deleting:
            for c in self.store.visit(Cluster.KIND):
                try:
                    self.store.delete(Work.KIND, execution_namespace(c.name), work_id)
                except NotFoundError:
                    pass
            return
        assert isinstance(obj, Unstructured)
        manifest = prune_for_propagation(obj.to_manifest())
        for c in self.store.visit(Cluster.KIND):
            ns = execution_namespace(c.name)
            existing = self.store.try_get(Work.KIND, ns, work_id)
            if existing is None:
                w = Work()
                w.metadata.namespace = ns
                w.metadata.name = work_id
                w.spec = WorkSpec(workload=[manifest])
                self.store.create(w)
            else:
                def update(w: Work) -> None:
                    w.spec.workload = [manifest]
                self.store.mutate(Work.KIND, ns, work_id, update)
