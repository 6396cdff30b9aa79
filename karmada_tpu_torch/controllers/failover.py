"""Graceful eviction: the part of the failover loop the rebalance plane
drains through.

Counterpart of a subset of the JAX package's ``controllers/failover.py``:

* evict_cluster -- binding_types.go GracefulEvict: the cluster leaves
  spec.clusters and a GracefulEvictionTask is appended, so the scheduler
  re-places the lost replicas while the old Work survives until the task
  drains.
* GracefulEvictionController -- pkg/controllers/gracefuleviction/
  evictiontask.go:38-116: a task drains once every scheduled cluster of
  the binding reports a healthy replacement, or once its grace period
  lapses; SuppressDeletion pins it.

The taint controllers and application failover wait for the port's
controller manager.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

from karmada_tpu_torch.models.work import GracefulEvictionTask, ResourceBinding
from karmada_tpu_torch.store.store import Event, ObjectStore
from karmada_tpu_torch.store.worker import AsyncWorker, Runtime

DEFAULT_GRACE_PERIOD_S = 600


def evict_cluster(
    rb: ResourceBinding,
    cluster: str,
    reason: str,
    producer: str,
    grace_period_seconds: Optional[int] = None,
    suppress_deletion: Optional[bool] = None,
    now: Optional[float] = None,
    purge_mode: str = "",
    preserved_label_state: Optional[Dict[str, str]] = None,
    clusters_before_failover: Optional[list] = None,
) -> bool:
    """binding_types.go GracefulEvict semantics; returns True if changed."""
    target = next((t for t in rb.spec.clusters if t.name == cluster), None)
    if target is None:
        return False
    rb.spec.clusters = [t for t in rb.spec.clusters if t.name != cluster]
    if any(t.from_cluster == cluster for t in rb.spec.graceful_eviction_tasks):
        return True
    rb.spec.graceful_eviction_tasks.append(GracefulEvictionTask(
        from_cluster=cluster,
        replicas=target.replicas,
        reason=reason,
        producer=producer,
        grace_period_seconds=grace_period_seconds,
        suppress_deletion=suppress_deletion,
        creation_timestamp=now if now is not None else time.time(),
        purge_mode=purge_mode,
        preserved_label_state=dict(preserved_label_state or {}),
        clusters_before_failover=list(clusters_before_failover or []),
    ))
    return True


class GracefulEvictionController:
    """Drain eviction tasks once replacement is healthy or grace expires."""

    def __init__(self, store: ObjectStore, runtime: Runtime,
                 grace_period_s: float = DEFAULT_GRACE_PERIOD_S,
                 clock=None) -> None:
        self.store = store
        self.clock = clock if clock is not None else time.time
        self.grace_period_s = grace_period_s
        self.worker = runtime.register(
            AsyncWorker("graceful-eviction", self._reconcile))
        store.bus.subscribe(self._on_event, kind=ResourceBinding.KIND)
        runtime.register_periodic(self.resync)

    def resync(self) -> None:
        for rb in self.store.visit(ResourceBinding.KIND):
            if rb.spec.graceful_eviction_tasks:
                self.worker.enqueue((rb.namespace, rb.name))

    def _on_event(self, event: Event) -> None:
        if event.obj.spec.graceful_eviction_tasks:
            self.worker.enqueue((event.obj.namespace, event.obj.name))

    @staticmethod
    def _replacement_ready(rb: ResourceBinding) -> bool:
        """assessEvictionTasks health gate: every scheduled cluster applied
        and healthy (evictiontask.go:70-96)."""
        if not rb.spec.clusters:
            return False
        by_cluster = {i.cluster_name: i for i in rb.status.aggregated_status}
        for target in rb.spec.clusters:
            item = by_cluster.get(target.name)
            if item is None or not item.applied or item.health != "Healthy":
                return False
        return True

    def _reconcile(self, key) -> None:
        ns, name = key
        rb = self.store.try_get(ResourceBinding.KIND, ns, name)
        if rb is None or not rb.spec.graceful_eviction_tasks:
            return
        now = self.clock()
        ready = self._replacement_ready(rb)
        keep = []
        for task in rb.spec.graceful_eviction_tasks:
            if task.suppress_deletion:
                keep.append(task)
                continue
            grace = (task.grace_period_seconds
                     if task.grace_period_seconds is not None
                     else self.grace_period_s)
            if ready or now - task.creation_timestamp >= grace:
                continue  # drop the task; the binding controller prunes
            keep.append(task)
        if len(keep) != len(rb.spec.graceful_eviction_tasks):
            drained = ({t.from_cluster for t in rb.spec.graceful_eviction_tasks}
                       - {t.from_cluster for t in keep})

            def update(obj: ResourceBinding) -> None:
                obj.spec.graceful_eviction_tasks = [
                    t for t in obj.spec.graceful_eviction_tasks
                    if t.from_cluster not in drained]
            self.store.mutate(ResourceBinding.KIND, ns, name, update)
