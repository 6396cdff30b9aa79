"""Cluster lifecycle (join/unjoin) + rate-limited eviction.

Counterpart of the JAX package's ``controllers/cluster.py``.  Reference: pkg/controllers/cluster/cluster_controller.go:156-381 —
  * join: finalizer on the Cluster + execution space (the karmada-es-<name>
    namespace every Work for that cluster lives in);
  * unjoin: drain the execution space (delete Works), delete the space,
    then release the finalizer so the Cluster object goes away;
and eviction_worker.go + dynamic_rate_limiter.go — taint-driven evictions
flow through a rate-limited queue (ResourceEvictionRate items/second;
rate 0 halts evictions) so a zone-wide outage drains gradually instead of
stampeding every binding through rescheduling at once.

The reads that only look take the stored objects without copying
(ObjectStore.visit / peek).  An eviction that raises is requeued, as in the JAX
package, and counted on `RateLimitedEvictionQueue.failures`.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Callable, Hashable, Optional

from karmada_tpu_torch.controllers.binding import execution_namespace
from karmada_tpu_torch.models.cluster import Cluster
from karmada_tpu_torch.models.unstructured import Unstructured
from karmada_tpu_torch.models.work import ResourceBinding, Work
from karmada_tpu_torch.store.store import Event, NotFoundError, ObjectStore
from karmada_tpu_torch.store.worker import AsyncWorker, Runtime

CLUSTER_FINALIZER = "karmada.io/cluster-controller"


class ClusterLifecycleController:
    def __init__(self, store: ObjectStore, runtime: Runtime) -> None:
        self.store = store
        self.worker = runtime.register(AsyncWorker("cluster-lifecycle", self._reconcile))
        store.bus.subscribe(self._on_event, kind=Cluster.KIND)
        # finalizer-held Works drain asynchronously: the periodic resync
        # retries deleting clusters until their execution space empties
        runtime.register_periodic(self._resync_deleting, name="cluster-lifecycle")

    def _on_event(self, event: Event) -> None:
        self.worker.enqueue(event.obj.name)

    def _resync_deleting(self) -> None:
        for c in self.store.visit(Cluster.KIND):
            if c.metadata.deleting:
                self.worker.enqueue(c.metadata.name)

    def _reconcile(self, name: str) -> None:
        cluster = self.store.peek(Cluster.KIND, "", name)
        if cluster is None:
            return
        if cluster.metadata.deleting:
            self._unjoin(cluster)
            return
        # join: finalizer + execution space (createExecutionSpace :380)
        if CLUSTER_FINALIZER not in cluster.metadata.finalizers:
            def add_fin(c: Cluster) -> None:
                if CLUSTER_FINALIZER not in c.metadata.finalizers:
                    c.metadata.finalizers.append(CLUSTER_FINALIZER)
            self.store.mutate(Cluster.KIND, "", name, add_fin)
        ns_name = execution_namespace(name)
        if self.store.peek("Namespace", "", ns_name) is None:
            self.store.create(Unstructured.from_manifest({
                "apiVersion": "v1", "kind": "Namespace",
                "metadata": {"name": ns_name, "labels": {
                    "karmada.io/managed": "true",
                    "karmada.io/execution-space-for": name,
                }},
            }))

    def _unjoin(self, cluster: Cluster) -> None:
        """removeCluster (:220): strip the cluster from schedule results,
        drain Works, drop the space, release the finalizer — ordering
        guarantees no Work survives its cluster."""
        name = cluster.metadata.name
        ns_name = execution_namespace(name)
        # bindings still targeting the vanishing cluster must lose it NOW:
        # the spec change re-enqueues the scheduler (which tops the lost
        # replicas back up elsewhere) and stops the binding controller from
        # re-creating orphan Works in the drained space
        for rb in self.store.visit(ResourceBinding.KIND):
            if not any(tc.name == name for tc in rb.spec.clusters):
                continue

            def strip(obj: ResourceBinding) -> None:
                obj.spec.clusters = [
                    tc for tc in obj.spec.clusters if tc.name != name
                ]
                obj.spec.graceful_eviction_tasks = [
                    t for t in obj.spec.graceful_eviction_tasks
                    if t.from_cluster != name
                ]
            try:
                self.store.mutate(ResourceBinding.KIND, rb.namespace, rb.name, strip)
            except NotFoundError:
                pass
        for w in self.store.visit(Work.KIND, ns_name):
            try:
                self.store.delete(Work.KIND, ns_name, w.name)
            except NotFoundError:
                pass
        if self.store.visit(Work.KIND, ns_name):
            return  # finalizer-held Works drain first; retry on their events
        try:
            self.store.delete("Namespace", "", ns_name)
        except NotFoundError:
            pass
        if CLUSTER_FINALIZER in cluster.metadata.finalizers:
            def drop_fin(c: Cluster) -> None:
                if CLUSTER_FINALIZER in c.metadata.finalizers:
                    c.metadata.finalizers.remove(CLUSTER_FINALIZER)
            try:
                self.store.mutate(Cluster.KIND, "", name, drop_fin)
            except NotFoundError:
                pass


class RateLimitedEvictionQueue:
    """Token-bucket pacing for evictions (eviction_worker.go semantics:
    one item per 1/rate seconds; rate 0 halts).  Items are dedup-ed keys;
    a periodic hook drains up to the accrued allowance each tick."""

    def __init__(
        self,
        runtime: Runtime,
        process: Callable[[Hashable], None],
        rate_per_s: float = 10.0,
        clock: Callable[[], float] = time.time,
        controller_name: Optional[str] = None,
    ) -> None:
        self.process = process
        self.rate = rate_per_s
        self.clock = clock
        self._pending: "OrderedDict[Hashable, None]" = OrderedDict()
        self._tokens = max(rate_per_s, 1.0) if rate_per_s > 0 else 0.0
        self._burst = max(rate_per_s, 1.0)
        self._last = clock()
        #: evictions that raised (requeued at the back)
        self.failures = 0
        # the owning controller's enablement switch governs the drain; a
        # generic utility must not hard-code any controller's name
        runtime.register_periodic(self.drain, name=controller_name)

    def add(self, key: Hashable) -> None:
        self._pending.setdefault(key, None)

    def pending(self) -> int:
        return len(self._pending)

    def drain(self) -> None:
        if self.rate <= 0:
            return  # evictions halted (the reference's maxEvictionDelay path)
        now = self.clock()
        self._tokens = min(self._burst, self._tokens + (now - self._last) * self.rate)
        self._last = now
        while self._pending and self._tokens >= 1.0:
            key, _ = self._pending.popitem(last=False)
            self._tokens -= 1.0
            try:
                self.process(key)
            except Exception:  # noqa: BLE001 -- an eviction must not be lost
                import traceback

                traceback.print_exc()
                self.failures += 1
                # requeue at the back; the spent token still paces retries
                self._pending[key] = None
