"""ResourceDetector: match templates to policies, emit ResourceBindings.

Mirrors reference pkg/detector/detector.go: watches every template kind
(dynamic informers, :183), matches template<->policy (LookForMatchedPolicy
:382 -- namespaced PropagationPolicy beats ClusterPropagationPolicy;
explicit priority, then name-selector specificity, then alphabetical),
claims the object, and builds the ResourceBinding (BuildResourceBinding
:793) with replicas/requirements from the resource interpreter
(applyReplicaInterpretation :1455).  Policy create/update fans out to all
matching templates (:991); policy delete releases claims and GCs bindings.

Counterpart of the JAX package's ``controllers/detector.py``, without its
flight-recorder span.  The reads that only look (the template, its
current claim and binding, the policies to match, the bindings a deleted
policy owned, the templates a policy change re-queues) take the stored
objects without copying (ObjectStore.peek / visit / visit_all); a
matched policy's placement reaches the store only through create /
mutate, which copy it.
"""

from __future__ import annotations

from typing import Optional, Tuple

from karmada_tpu_torch import obs
from karmada_tpu_torch.controllers.override import selector_matches
from karmada_tpu_torch.interpreter import ResourceInterpreter
from karmada_tpu_torch.models.meta import OwnerReference
from karmada_tpu_torch.models.policy import (
    LAZY_ACTIVATION,
    ClusterPropagationPolicy,
    PropagationPolicy,
    ResourceSelector,
)
from karmada_tpu_torch.models.unstructured import Unstructured
from karmada_tpu_torch.models.work import (
    BindingSuspension,
    ObjectReference,
    ResourceBinding,
    ResourceBindingSpec,
)
from karmada_tpu_torch.store.store import DELETED, Event, NotFoundError, ObjectStore
from karmada_tpu_torch.store.worker import AsyncWorker, Runtime

# claim labels (reference pkg/util/constants: PropagationPolicy labels)
POLICY_LABEL = "propagationpolicy.karmada.io/permanent-id"
CLUSTER_POLICY_LABEL = "clusterpropagationpolicy.karmada.io/permanent-id"
BINDING_POLICY_LABEL = POLICY_LABEL

# kinds owned by the framework itself -- never treated as templates
FRAMEWORK_KINDS = {
    "Cluster", "PropagationPolicy", "ClusterPropagationPolicy",
    "OverridePolicy", "ClusterOverridePolicy", "ResourceBinding",
    "ClusterResourceBinding", "Work", "FederatedResourceQuota",
    "WorkloadRebalancer", "FederatedHPA", "CronFederatedHPA", "Remedy",
    "ClusterTaintPolicy", "MultiClusterService", "ResourceRegistry",
    "ResourceInterpreterCustomization",
}


def binding_name(kind: str, name: str) -> str:
    """names.GenerateBindingName: lowercase kind suffix."""
    return f"{name}-{kind.lower()}"


def _selector_specificity(sel: ResourceSelector) -> int:
    """name match > label-selector match > kind-wide (detector/policy.go)."""
    if sel.name:
        return 2
    if sel.label_selector is not None:
        return 1
    return 0


class ResourceDetector:
    def __init__(
        self,
        store: ObjectStore,
        runtime: Runtime,
        interpreter: Optional[ResourceInterpreter] = None,
    ) -> None:
        self.store = store
        self.interpreter = interpreter or ResourceInterpreter()
        self.worker = runtime.register(AsyncWorker("detector", self._reconcile))
        self.policy_worker = runtime.register(
            AsyncWorker("detector-policy", self._reconcile_policy)
        )
        store.bus.subscribe(self._on_event)

    # -- event wiring -------------------------------------------------------
    def _on_event(self, event: Event) -> None:
        kind = event.kind
        if kind in (PropagationPolicy.KIND, ClusterPropagationPolicy.KIND):
            self.policy_worker.enqueue((kind, event.obj.namespace, event.obj.name,
                                        event.type == DELETED))
            return
        if kind in FRAMEWORK_KINDS or not isinstance(event.obj, Unstructured):
            return
        self.worker.enqueue((kind, event.obj.namespace, event.obj.name, False))

    # -- policy fan-out -----------------------------------------------------
    def _reconcile_policy(self, key) -> None:
        kind, namespace, name, deleted = key
        if deleted:
            label = POLICY_LABEL if kind == PropagationPolicy.KIND else CLUSTER_POLICY_LABEL
            uid = f"{namespace}/{name}" if namespace else name
            for rb in self.store.visit(ResourceBinding.KIND):
                if rb.metadata.labels.get(label) == uid:
                    try:
                        self.store.delete(ResourceBinding.KIND, rb.namespace, rb.name)
                    except NotFoundError:
                        pass
        # re-evaluate every template (policy preemption/claim updates);
        # from_policy=True so Lazy activation can defer (detector.go:1485)
        for obj in self.store.visit_all():
            if isinstance(obj, Unstructured) and obj.KIND not in FRAMEWORK_KINDS:
                self.worker.enqueue((obj.KIND, obj.namespace, obj.name, True))

    # -- template reconcile -------------------------------------------------
    def _matched_policies(
        self, obj: Unstructured, manifest: dict
    ) -> Tuple[Optional[PropagationPolicy], Optional[ClusterPropagationPolicy]]:
        def best(policies):
            matched = []
            for p in policies:
                for sel in p.spec.resource_selectors:
                    if selector_matches(sel, manifest):
                        matched.append((p.spec.priority, _selector_specificity(sel), p))
                        break
            if not matched:
                return None
            # highest priority, then most specific selector, then name asc
            matched.sort(key=lambda t: (-t[0], -t[1], t[2].name))
            return matched[0][2]

        pps = self.store.visit(PropagationPolicy.KIND, obj.namespace)
        cpps = self.store.visit(ClusterPropagationPolicy.KIND)
        return best(pps), best(cpps)

    def _current_claim(self, obj: Unstructured):
        """The policy currently claiming `obj` via claim labels (or None)."""
        pid = obj.metadata.labels.get(POLICY_LABEL)
        if pid is not None:
            ns, _, nm = pid.partition("/")
            return self.store.peek(PropagationPolicy.KIND, ns, nm)
        pid = obj.metadata.labels.get(CLUSTER_POLICY_LABEL)
        if pid is not None:
            return self.store.peek(ClusterPropagationPolicy.KIND, "", pid)
        return None

    @staticmethod
    def _still_matches(policy, manifest) -> bool:
        return any(
            selector_matches(sel, manifest) for sel in policy.spec.resource_selectors
        )

    def _effective_policy(self, obj: Unstructured, manifest: dict, pp, cpp):
        """Claim stickiness + preemption (preemption.go:50-107).

        An object claimed by a still-matching policy STAYS claimed; a
        different policy takes over only with `preemption: Always` and the
        reference's priority rule (high-priority PP > low-priority PP >
        CPP; CPP preempts CPP by priority only).
        """
        challenger = pp if pp is not None else cpp
        cur = self._current_claim(obj)
        if cur is None or not self._still_matches(cur, manifest):
            return challenger
        if challenger is None or challenger is cur:
            return cur
        cur_is_cpp = isinstance(cur, ClusterPropagationPolicy)
        ch_is_cpp = isinstance(challenger, ClusterPropagationPolicy)
        always = challenger.spec.preemption == "Always"
        if not always:
            return cur
        if cur_is_cpp and not ch_is_cpp:
            return challenger  # PP > CPP (preemptClusterPropagationPolicyDirectly)
        if cur_is_cpp == ch_is_cpp and challenger.spec.priority > cur.spec.priority:
            return challenger
        return cur

    def _reconcile(self, key) -> None:
        kind, namespace, name, from_policy = key
        obj = self.store.peek(kind, namespace, name)
        rb_name = binding_name(kind, name)
        if obj is None or obj.metadata.deleting:
            try:
                self.store.delete(ResourceBinding.KIND, namespace, rb_name)
            except NotFoundError:
                pass
            return
        assert isinstance(obj, Unstructured)
        manifest = obj.to_manifest()
        # flight recorder: policy matching is the detector's hot phase,
        # so it gets its own span under the worker's reconcile root
        with obs.TRACER.span(obs.SPAN_DETECTOR_MATCH, kind=kind,
                             template=name) as sp:
            pp, cpp = self._matched_policies(obj, manifest)
            policy = self._effective_policy(obj, manifest, pp, cpp)
            if sp:
                sp.set_attr(matched=policy.name if policy else None)
        # Lazy activation (detector.go:1485-1497): a policy-driven change
        # does not touch templates whose effective policy is Lazy -- the new
        # policy content applies only when the resource itself next changes
        if (
            from_policy
            and policy is not None
            and policy.spec.activation_preference == LAZY_ACTIVATION
        ):
            return
        if policy is None:
            # no policy claims it; drop a stale binding if we created one
            try:
                self.store.delete(ResourceBinding.KIND, namespace, rb_name)
            except NotFoundError:
                pass
            return
        label = POLICY_LABEL if isinstance(policy, PropagationPolicy) and not isinstance(
            policy, ClusterPropagationPolicy) else CLUSTER_POLICY_LABEL
        policy_id = (
            f"{policy.metadata.namespace}/{policy.name}"
            if policy.metadata.namespace
            else policy.name
        )

        other_label = (
            CLUSTER_POLICY_LABEL if label == POLICY_LABEL else POLICY_LABEL
        )
        # claim the template (ClaimPolicyForObject, detector/claim.go);
        # preemption drops the losing policy's claim so its deletion can no
        # longer GC this object's binding
        if (
            obj.metadata.labels.get(label) != policy_id
            or other_label in obj.metadata.labels
        ):
            def claim(o):
                o.metadata.labels[label] = policy_id
                o.metadata.labels.pop(other_label, None)
            self.store.mutate(kind, namespace, name, claim)

        # applyReplicaInterpretation (detector.go:1454-1482): components win
        # over plain replicas when an InterpretComponent customization exists
        components = self.interpreter.get_components(manifest)
        if components is not None:
            replicas, requirements = 0, None
        else:
            components = []
            replicas, requirements = self.interpreter.get_replicas(manifest)
        spec = policy.spec
        suspension = None
        if spec.suspension is not None:
            suspension = BindingSuspension(
                scheduling=spec.suspension.scheduling,
                dispatching=spec.suspension.dispatching,
            )

        existing = self.store.peek(ResourceBinding.KIND, namespace, rb_name)
        if existing is None:
            rb = ResourceBinding()
            rb.metadata.name = rb_name
            rb.metadata.namespace = namespace
            rb.metadata.labels[label] = policy_id
            rb.metadata.labels.pop(other_label, None)
            rb.metadata.owner_references = [OwnerReference(
                api_version=obj.API_VERSION, kind=kind, name=name,
                uid=obj.metadata.uid,
            )]
            rb.spec = ResourceBindingSpec(
                resource=ObjectReference(
                    api_version=obj.API_VERSION, kind=kind, namespace=namespace,
                    name=name, uid=obj.metadata.uid,
                    resource_version=obj.metadata.resource_version,
                ),
                replicas=replicas,
                replica_requirements=requirements,
                components=list(components),
                placement=spec.placement,
                propagate_deps=spec.propagate_deps,
                conflict_resolution=spec.conflict_resolution,
                schedule_priority=spec.schedule_priority,
                suspension=suspension,
                failover=spec.failover,
            )
            self.store.create(rb)
        else:
            def update(rb):
                rb.metadata.labels[label] = policy_id
                rb.metadata.labels.pop(other_label, None)
                # preserve the schedule result + eviction state; refresh the rest
                rb.spec.resource.resource_version = obj.metadata.resource_version
                rb.spec.resource.uid = obj.metadata.uid
                rb.spec.replicas = replicas
                rb.spec.replica_requirements = requirements
                rb.spec.components = list(components)
                rb.spec.placement = spec.placement
                rb.spec.propagate_deps = spec.propagate_deps
                rb.spec.conflict_resolution = spec.conflict_resolution
                rb.spec.schedule_priority = spec.schedule_priority
                rb.spec.suspension = suspension
                rb.spec.failover = spec.failover
            self.store.mutate(ResourceBinding.KIND, namespace, rb_name, update)
