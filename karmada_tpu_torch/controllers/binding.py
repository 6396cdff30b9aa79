"""ResourceBinding controller: render per-cluster Work objects.

Mirrors reference pkg/controllers/binding/binding_controller.go:71-198 +
common.go:51-151 ensureWork: merge RequiredBy snapshots into the target
list, revise replicas via the interpreter for Divided scheduling
(common.go:81-89), divide Job completions (:95-108), apply override
policies (:112), and write one Work per target cluster into the cluster's
execution namespace (karmada-es-<cluster>); stale Works for dropped
clusters are removed.

Counterpart of the JAX package's ``controllers/binding.py``, without its
flight-recorder span.  Where the JAX controller lists every Work to find
a binding's (by the binding label), this one keeps that label's Works in
an index fed by the Work watch (`_works_of`), walked in the list's
(namespace, name) order.  The reconcile reads the binding, its template
and its clusters as stored (ObjectStore.peek / visit): it only looks, and
every Work it renders reaches the store through create / mutate, which
copy.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

from karmada_tpu_torch import obs
from karmada_tpu_torch.controllers.override import OverrideManager
from karmada_tpu_torch.interpreter import ResourceInterpreter
from karmada_tpu_torch.models.policy import REPLICA_SCHEDULING_DIVIDED
from karmada_tpu_torch.models.unstructured import Unstructured
from karmada_tpu_torch.models.work import (
    ResourceBinding,
    TargetCluster,
    Work,
    WorkSpec,
    merge_target_clusters,
)
from karmada_tpu_torch.ops.webster import dispense_by_weight, fnv32a
from karmada_tpu_torch.store.store import (
    DELETED,
    Event,
    NotFoundError,
    ObjectStore,
)
from karmada_tpu_torch.store.worker import AsyncWorker, Runtime

EXECUTION_NS_PREFIX = "karmada-es-"
WORK_BINDING_LABEL = "resourcebinding.karmada.io/key"


def execution_namespace(cluster: str) -> str:
    return EXECUTION_NS_PREFIX + cluster


def work_name(binding: ResourceBinding) -> str:
    """Collision-free Work name (names.GenerateWorkName in the reference):
    the '-'-joined readable prefix is ambiguous (ns='a-b',name='c' vs
    ns='a',name='b-c'), so a hash of the full (kind, ns, name) tuple is
    appended to disambiguate."""
    ref = binding.spec.resource
    h = fnv32a(f"{ref.kind}\x00{ref.namespace}\x00{ref.name}")
    return f"{ref.name.lower()}-{ref.kind.lower()}-{h:08x}"


class BindingController:
    def __init__(
        self,
        store: ObjectStore,
        runtime: Runtime,
        interpreter: Optional[ResourceInterpreter] = None,
    ) -> None:
        self.store = store
        self.interpreter = interpreter or ResourceInterpreter()
        self.overrides = OverrideManager(store)
        # binding label -> the (namespace, name) of every Work carrying it,
        # and each indexed Work's label (fed by the Work watch)
        self._by_label: Dict[str, Set[Tuple[str, str]]] = {}
        self._label_of: Dict[Tuple[str, str], str] = {}
        self.worker = runtime.register(AsyncWorker("binding", self._reconcile))
        store.bus.subscribe(self._on_event)
        store.bus.subscribe(self._on_work_event, kind=Work.KIND)
        for w in store.visit(Work.KIND):
            self._index_work((w.namespace, w.name),
                             w.metadata.labels.get(WORK_BINDING_LABEL))

    def _on_event(self, event: Event) -> None:
        if event.kind == ResourceBinding.KIND:
            self.worker.enqueue((event.obj.namespace, event.obj.name))
        elif event.kind in ("OverridePolicy", "ClusterOverridePolicy"):
            for rb in self.store.visit(ResourceBinding.KIND):
                self.worker.enqueue((rb.namespace, rb.name))

    # -- the Works of a binding label --------------------------------------
    def _index_work(self, key: Tuple[str, str], label: Optional[str]) -> None:
        old = self._label_of.pop(key, None)
        if old is not None:
            keys = self._by_label[old]
            keys.discard(key)
            if not keys:
                del self._by_label[old]
        if label is not None:
            self._label_of[key] = label
            self._by_label.setdefault(label, set()).add(key)

    def _on_work_event(self, event: Event) -> None:
        w = event.obj
        self._index_work(
            (w.namespace, w.name),
            None if event.type == DELETED
            else w.metadata.labels.get(WORK_BINDING_LABEL))

    def _works_of(self, label: str) -> List[Tuple[str, str]]:
        """(namespace, name) of the Works labelled `label`, sorted as
        store.list orders them."""
        return sorted(self._by_label.get(label, ()))

    # -- helpers ------------------------------------------------------------
    def _divided(self, rb: ResourceBinding) -> bool:
        placement = rb.spec.placement
        return (
            placement is not None
            and placement.replica_scheduling is not None
            and placement.replica_scheduling.replica_scheduling_type
            == REPLICA_SCHEDULING_DIVIDED
        )

    def _target_clusters(self, rb: ResourceBinding) -> List[TargetCluster]:
        """mergeTargetClusters (common.go:56-66): RequiredBy joins targets."""
        targets = list(rb.spec.clusters)
        for snapshot in rb.spec.required_by:
            targets = merge_target_clusters(targets, snapshot.clusters)
        return targets

    def _job_completions(
        self, rb: ResourceBinding, manifest: Dict, targets: List[TargetCluster]
    ) -> Dict[str, int]:
        """divideReplicasByJobCompletions (common.go:95-108): completions
        split by the same Webster weights as the replica division."""
        from karmada_tpu_torch.models.meta import deep_get

        completions = deep_get(manifest, "spec.completions")
        if manifest.get("kind") != "Job" or completions is None or not self._divided(rb):
            return {}
        weights = {t.name: t.replicas for t in targets}
        return dispense_by_weight(int(completions), weights, None, rb.spec.resource.uid)

    # -- reconcile ----------------------------------------------------------
    def _reconcile(self, key) -> None:
        ns, name = key
        rb = self.store.peek(ResourceBinding.KIND, ns, name)
        if rb is None or rb.metadata.deleting:
            self._remove_works(ns, name, keep=set())
            return
        resource = rb.spec.resource
        template = self.store.peek(resource.kind, resource.namespace,
                                   resource.name)
        if template is None or not isinstance(template, Unstructured):
            return
        from karmada_tpu_torch.interpreter.interpreter import prune_for_propagation

        manifest = prune_for_propagation(template.to_manifest())
        targets = self._target_clusters(rb)
        completions = self._job_completions(rb, manifest, targets)

        # Immediately-purged clusters do not keep their old Work alive; the
        # task itself survives only as the injection payload carrier
        eviction = {t.from_cluster for t in rb.spec.graceful_eviction_tasks
                    if t.purge_mode != "Immediately"}
        keep = set()
        # flight recorder: per-target Work rendering is where a binding
        # reconcile's time goes -- one span under the worker's reconcile
        with obs.TRACER.span(obs.SPAN_BINDING_RENDER,
                             targets=len(targets)):
            for target in targets:
                # never materialize a Work for a cluster that no longer
                # exists: an unjoined cluster's execution space has been
                # drained and nothing would ever clean an orphan up
                cluster = self._cluster(target.name)
                if cluster is None:
                    continue
                m = dict(manifest)
                if self._divided(rb) and rb.spec.replicas > 0:
                    m = self.interpreter.revise_replica(m, target.replicas)
                if target.name in completions:
                    m = self.interpreter.revise_job_completions(
                        m, completions[target.name])
                m = self.overrides.apply(m, cluster)
                m = self._inject_preserved_state(rb, target, m, len(targets))
                suspend = self._suspended(rb, target.name)
                self._ensure_work(rb, target.name, m, suspend)
                keep.add(target.name)
        # graceful eviction: keep the old Work until the task drains
        keep |= eviction
        self._remove_works(ns, name, keep)

    def _inject_preserved_state(self, rb: ResourceBinding,
                                target: TargetCluster, manifest: Dict,
                                n_targets: int) -> Dict:
        """StatefulFailoverInjection (binding/common.go:171-207
        injectReservedLabelState): merge the last eviction task's preserved
        label state into the replacement cluster's rendered workload.
        Restrictions mirror the reference: single-target bindings only,
        latest task must be an Immediately/Directly purge with a non-empty
        payload, and the move-to cluster must not be one the application
        ran on before the failover."""
        from karmada_tpu_torch.utils.features import GATES

        if not GATES.enabled("StatefulFailoverInjection"):
            return manifest
        if n_targets > 1 or not rb.spec.graceful_eviction_tasks:
            return manifest
        task = rb.spec.graceful_eviction_tasks[-1]
        if task.purge_mode not in ("Immediately", "Directly"):
            return manifest
        if target.name in task.clusters_before_failover:
            return manifest
        if not task.preserved_label_state:
            return manifest
        m = dict(manifest)
        meta = dict(m.get("metadata") or {})
        labels = dict(meta.get("labels") or {})
        labels.update(task.preserved_label_state)
        meta["labels"] = labels
        m["metadata"] = meta
        return m

    def _suspended(self, rb: ResourceBinding, cluster: str) -> bool:
        s = rb.spec.suspension
        if s is None:
            return False
        if s.dispatching:
            return True
        return cluster in (s.dispatching_on_clusters or [])

    def _cluster(self, name: str):
        return self.store.peek("Cluster", "", name)

    def _ensure_work(self, rb: ResourceBinding, cluster: str, manifest, suspend: bool) -> None:
        ns = execution_namespace(cluster)
        name = work_name(rb)
        label_val = f"{rb.namespace}.{rb.name}"
        existing = self.store.peek(Work.KIND, ns, name)
        if existing is None:
            w = Work()
            w.metadata.namespace = ns
            w.metadata.name = name
            w.metadata.labels[WORK_BINDING_LABEL] = label_val
            w.spec = WorkSpec(workload=[manifest], suspend_dispatching=suspend)
            self.store.create(w)
        else:
            def update(w):
                w.metadata.labels[WORK_BINDING_LABEL] = label_val
                w.spec.workload = [manifest]
                w.spec.suspend_dispatching = suspend
            self.store.mutate(Work.KIND, ns, name, update)

    def _remove_works(self, rb_ns: str, rb_name: str, keep) -> None:
        for ns, name in self._works_of(f"{rb_ns}.{rb_name}"):
            if ns[len(EXECUTION_NS_PREFIX):] in keep:
                continue
            try:
                self.store.delete(Work.KIND, ns, name)
            except NotFoundError:
                pass
