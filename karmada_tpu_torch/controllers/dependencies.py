"""Dependencies distributor: propagate what a workload needs alongside it.

Counterpart of the JAX package's ``controllers/dependencies.py``.

Mirrors reference pkg/dependenciesdistributor/dependencies_distributor.go:
117-489: when a binding has propagateDeps=true, the interpreter's
GetDependencies lists the ConfigMaps/Secrets/PVCs/ServiceAccounts its pod
template references; each existing dependency gets an *attached*
ResourceBinding whose RequiredBy snapshot mirrors the independent binding's
schedule result (syncScheduleResultToAttachedBindings :381), so the binding
controller propagates it to the same clusters.  Attached bindings are never
scheduled themselves.

The distributor keeps the ids of the independent bindings that own
attached bindings (read from the store at construction, kept up to date
by its own writes: only it writes those labels), so the garbage
collection that follows every binding event scans the store only for a
binding that owns some; its reads only look (ObjectStore.peek / visit).
"""

from __future__ import annotations

from karmada_tpu_torch.controllers.detector import binding_name
from karmada_tpu_torch.ops.webster import fnv32a
from karmada_tpu_torch.interpreter import ResourceInterpreter
from karmada_tpu_torch.models.unstructured import Unstructured
from karmada_tpu_torch.models.work import (
    BindingSnapshot,
    ObjectReference,
    ResourceBinding,
    ResourceBindingSpec,
)
from karmada_tpu_torch.store.store import Event, NotFoundError, ObjectStore
from karmada_tpu_torch.store.worker import AsyncWorker, Runtime

ATTACHED_LABEL = "resourcebinding.karmada.io/depended-by"


def attached_label_key(parent_id: str) -> str:
    """Per-parent label key, so two independent bindings sharing a dependency
    each own their marker (reference dependencies_distributor.go keys labels
    by a hash of the independent binding's id for the same reason)."""
    return f"{ATTACHED_LABEL}-{fnv32a(parent_id):08x}"


def _is_attached(rb: ResourceBinding) -> bool:
    return any(k.startswith(ATTACHED_LABEL) for k in rb.metadata.labels)


class DependenciesDistributor:
    def __init__(
        self,
        store: ObjectStore,
        runtime: Runtime,
        interpreter: ResourceInterpreter | None = None,
    ) -> None:
        self.store = store
        self.interpreter = interpreter or ResourceInterpreter()
        #: independent bindings' ids that own attached bindings
        self._parents = {
            v for rb in store.visit(ResourceBinding.KIND)
            for k, v in rb.metadata.labels.items()
            if k.startswith(ATTACHED_LABEL)}
        self.worker = runtime.register(AsyncWorker("deps-distributor", self._reconcile))
        store.bus.subscribe(self._on_event, kind=ResourceBinding.KIND)

    def _on_event(self, event: Event) -> None:
        rb = event.obj
        # enqueue regardless of propagate_deps: a flip to False must GC the
        # attached bindings (the reconcile handles both directions)
        if not _is_attached(rb):
            self.worker.enqueue((rb.namespace, rb.name))

    def _reconcile(self, key) -> None:
        ns, name = key
        rb = self.store.peek(ResourceBinding.KIND, ns, name)
        parent_id = f"{ns}.{name}"
        if rb is None or rb.metadata.deleting or not rb.spec.propagate_deps:
            self._gc(parent_id, keep=set())
            return
        resource = rb.spec.resource
        template = self.store.peek(resource.kind, resource.namespace,
                                   resource.name)
        if template is None or not isinstance(template, Unstructured):
            return
        deps = self.interpreter.get_dependencies(template.to_manifest())
        snapshot = BindingSnapshot(
            namespace=ns, name=name, clusters=list(rb.spec.clusters)
        )
        keep = set()
        for dep in deps:
            dep_obj = self.store.peek(dep.kind, dep.namespace, dep.name)
            if dep_obj is None:
                continue  # dependency not present in the control plane yet
            attached_name = binding_name(dep.kind, dep.name)
            keep.add(attached_name)
            self._parents.add(parent_id)
            existing = self.store.try_get(ResourceBinding.KIND, dep.namespace,
                                          attached_name)
            if existing is None:
                arb = ResourceBinding()
                arb.metadata.namespace = dep.namespace
                arb.metadata.name = attached_name
                arb.metadata.labels[attached_label_key(parent_id)] = parent_id
                arb.spec = ResourceBindingSpec(
                    resource=ObjectReference(
                        api_version=dep.api_version, kind=dep.kind,
                        namespace=dep.namespace, name=dep.name,
                        uid=dep_obj.metadata.uid,
                    ),
                    required_by=[snapshot],
                )
                self.store.create(arb)
            else:
                def update(obj: ResourceBinding) -> None:
                    obj.metadata.labels[attached_label_key(parent_id)] = parent_id
                    rest = [s for s in obj.spec.required_by
                            if (s.namespace, s.name) != (ns, name)]
                    obj.spec.required_by = rest + [snapshot]
                self.store.mutate(ResourceBinding.KIND, dep.namespace,
                                  attached_name, update)
        self._gc(parent_id, keep)

    def _gc(self, parent_id: str, keep) -> None:
        if parent_id not in self._parents:
            return  # owns no attached binding
        if not keep:
            self._parents.discard(parent_id)
        key = attached_label_key(parent_id)
        for rb in self.store.visit(ResourceBinding.KIND):
            if rb.metadata.labels.get(key) != parent_id:
                continue
            if rb.name in keep:
                continue
            ns, name = parent_id.split(".", 1)

            def update(obj: ResourceBinding, ns=ns, name=name, key=key) -> None:
                obj.spec.required_by = [
                    s for s in obj.spec.required_by
                    if (s.namespace, s.name) != (ns, name)
                ]
                obj.metadata.labels.pop(key, None)

            try:
                self.store.mutate(ResourceBinding.KIND, rb.namespace, rb.name, update)
                cur = self.store.get(ResourceBinding.KIND, rb.namespace, rb.name)
                if not cur.spec.required_by and not cur.spec.placement:
                    self.store.delete(ResourceBinding.KIND, rb.namespace, rb.name)
            except NotFoundError:
                pass
