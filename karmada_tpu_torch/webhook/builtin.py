"""Built-in admission plugins, mirroring the reference karmada-webhook set.

Counterpart of the JAX package's ``webhook/builtin.py`` (reference
pkg/webhook/<kind>/{mutating,validating}.go):
  * PropagationPolicy / ClusterPropagationPolicy -- placement validation
    (spread-constraint min<=max, static weights positive, toleration
    seconds non-negative, preemption enum) + defaulting, with the default
    not-ready / unreachable NoExecute tolerations.
  * OverridePolicy / ClusterOverridePolicy -- overrider plausibility.
  * ResourceInterpreterWebhook -- endpoint scheme and explicit rules.
  * FederatedResourceQuota -- overall quantities non-negative; static
    assignments within overall.
  * FederatedHPA -- structural bounds and metric-target coherence.
  * ResourceBinding -- FederatedResourceQuota ENFORCEMENT (the reference's
    pkg/webhook/resourcebinding/validating.go quota gate behind the
    FederatedQuotaEnforcement feature gate): the scheduler's .spec.clusters
    patch is denied when the namespace's quota would be exceeded, and FRQ
    overallUsed is bumped atomically on success.
"""

from __future__ import annotations

from typing import Dict, Optional

from karmada_tpu_torch.models.autoscaling import (
    TARGET_AVERAGE_VALUE,
    TARGET_UTILIZATION,
    TARGET_VALUE,
    FederatedHPA,
)
from karmada_tpu_torch.models.config import ResourceInterpreterWebhook
from karmada_tpu_torch.models.extras import FederatedResourceQuota
from karmada_tpu_torch.models.policy import (
    ClusterOverridePolicy,
    ClusterPropagationPolicy,
    OverridePolicy,
    PropagationPolicy,
    Toleration,
)
from karmada_tpu_torch.models.work import ResourceBinding
from karmada_tpu_torch.utils.features import GATES, FeatureGates
from karmada_tpu_torch.utils.quantity import Quantity
from karmada_tpu_torch.webhook.admission import OP_CREATE, AdmissionRegistry


# -- PropagationPolicy ------------------------------------------------------


def _validate_placement(placement) -> Optional[str]:
    if placement is None:
        return None
    for sc in placement.spread_constraints:
        if sc.min_groups < 0 or sc.max_groups < 0:
            return "spreadConstraint groups must be non-negative"
        if sc.max_groups and sc.min_groups and sc.max_groups < sc.min_groups:
            return "spreadConstraint maxGroups lower than minGroups"
        if sc.spread_by_field and sc.spread_by_label:
            return "spreadByField and spreadByLabel are mutually exclusive"
    for tol in placement.cluster_tolerations:
        if tol.toleration_seconds is not None and tol.toleration_seconds < 0:
            return "tolerationSeconds must be non-negative"
    rs = placement.replica_scheduling
    if rs is not None and rs.weight_preference is not None:
        for w in rs.weight_preference.static_weight_list:
            if w.weight < 0:
                return "staticWeightList weight must be non-negative"
    return None


def validate_propagation_policy(op, p, old) -> Optional[str]:
    if not p.spec.resource_selectors:
        return "resourceSelectors must not be empty"
    if p.spec.preemption not in ("", "Never", "Always"):
        return f"invalid preemption {p.spec.preemption!r}"
    if p.spec.activation_preference not in ("", "Lazy"):
        return f"invalid activationPreference {p.spec.activation_preference!r}"
    return _validate_placement(p.spec.placement)


class DefaultPropagationPolicy:
    """Mutating defaults (pkg/webhook/propagationpolicy/mutating.go),
    including the default NoExecute tolerations for the not-ready and
    unreachable cluster taints (webhook flags
    --default-not-ready-toleration-seconds /
    --default-unreachable-toleration-seconds, 300s): a briefly-flapping
    cluster must not evict workloads the moment it is tainted."""

    NOT_READY = "cluster.karmada.io/not-ready"
    UNREACHABLE = "cluster.karmada.io/unreachable"

    def __init__(self, toleration_seconds: Optional[int] = 300) -> None:
        self.toleration_seconds = toleration_seconds

    def __call__(self, op, p, old) -> None:
        if not p.spec.preemption:
            p.spec.preemption = "Never"
        if p.spec.conflict_resolution not in ("Abort", "Overwrite"):
            p.spec.conflict_resolution = "Abort"
        placement = p.spec.placement
        if placement is None or self.toleration_seconds is None:
            return
        present = {t.key for t in placement.cluster_tolerations}
        for key in (self.NOT_READY, self.UNREACHABLE):
            if key not in present:
                placement.cluster_tolerations.append(Toleration(
                    key=key, operator="Exists", effect="NoExecute",
                    toleration_seconds=self.toleration_seconds,
                ))


def default_propagation_policy(op, p, old) -> None:
    """Module-level default chain with the reference's 300s tolerations."""
    DefaultPropagationPolicy()(op, p, old)


# -- OverridePolicy ---------------------------------------------------------


def validate_override_policy(op, p, old) -> Optional[str]:
    for rule in getattr(p.spec, "override_rules", []):
        ov = rule.overriders
        if ov is None:
            continue
        for po in ov.plaintext:
            if po.operator not in ("add", "remove", "replace"):
                return f"invalid plaintext operator {po.operator!r}"
        for io in ov.image_overrider:
            if io.operator not in ("add", "remove", "replace"):
                return f"invalid imageOverrider operator {io.operator!r}"
    return None


# -- ResourceInterpreterWebhook ----------------------------------------------


def validate_interpreter_webhook(op, w, old) -> Optional[str]:
    """ResourceInterpreterWebhook admission (the reference validates these
    in cmd/webhook, webhook.go:186-232): endpoint scheme + non-empty rules
    with explicit wildcards, so a half-built config can never silently
    hijack interpretation (interpreter/webhook._rule_matches)."""
    spec = w.spec
    if not spec.endpoint:
        return "endpoint must not be empty"
    if not (spec.endpoint.startswith("http://")
            or spec.endpoint.startswith("local:")):
        return f"unsupported endpoint scheme {spec.endpoint!r}"
    if not spec.rules:
        return "rules must not be empty"
    for rule in spec.rules:
        if not rule.api_versions or not rule.kinds or not rule.operations:
            return ("every rule needs explicit apiVersions, kinds and "
                    "operations (use \"*\" for wildcard)")
    if spec.timeout_s <= 0:
        return "timeout_s must be positive"
    return None


def validate_frq(op, q, old) -> Optional[str]:
    for name, qty in q.spec.overall.items():
        if qty.milli < 0:
            return f"overall[{name}] must be non-negative"
    summed: Dict[str, int] = {}
    for sa in q.spec.static_assignments:
        for name, qty in sa.hard.items():
            if qty.milli < 0:
                return f"staticAssignments[{sa.cluster_name}][{name}] must be non-negative"
            summed[name] = summed.get(name, 0) + qty.milli
    # the SUM of the static split must stay within overall, or the object
    # distributes more hard quota than it guarantees
    for name, total in summed.items():
        if name in q.spec.overall and total > q.spec.overall[name].milli:
            return f"staticAssignments sum for {name} exceeds overall"
    return None


def validate_federated_hpa(op, hpa, old) -> Optional[str]:
    """FederatedHPA admission (reference pkg/webhook/federatedhpa):
    structural bounds plus metric-target coherence — a target whose type
    doesn't match its set value field would otherwise silently hold the
    workload at current replicas forever (controllers/federatedhpa.py
    refuses to guess)."""
    s = hpa.spec
    if s.max_replicas < 1:
        return "maxReplicas must be >= 1"
    if s.min_replicas < 1 or s.min_replicas > s.max_replicas:
        return "minReplicas must be in [1, maxReplicas]"
    if not s.scale_target_ref.kind or not s.scale_target_ref.name:
        return "scaleTargetRef.kind and .name are required"

    def check_target(where: str, target, allowed) -> Optional[str]:
        if target.type not in allowed:
            return (f"{where}: target type {target.type!r} not supported "
                    f"(allowed: {sorted(allowed)})")
        field_of = {TARGET_UTILIZATION: target.average_utilization,
                    TARGET_AVERAGE_VALUE: target.average_value,
                    TARGET_VALUE: target.value}
        if field_of[target.type] is None:
            return (f"{where}: target type {target.type!r} requires its "
                    "matching value field")
        if field_of[target.type] <= 0:
            return f"{where}: target value must be positive"
        return None

    for i, m in enumerate(s.metrics):
        where = f"metrics[{i}]"
        if m.resource is not None:
            err = check_target(where, m.resource.target,
                               {TARGET_UTILIZATION, TARGET_AVERAGE_VALUE})
        elif m.pods is not None:
            if not m.pods.metric:
                return f"{where}: pods.metric name is required"
            err = check_target(where, m.pods.target, {TARGET_AVERAGE_VALUE})
        elif m.object is not None:
            if not m.object.metric or not m.object.described_object.name:
                return f"{where}: object.metric and describedObject required"
            err = check_target(where, m.object.target,
                               {TARGET_VALUE, TARGET_AVERAGE_VALUE})
        elif m.external is not None:
            if not m.external.metric:
                return f"{where}: external.metric name is required"
            err = check_target(where, m.external.target,
                               {TARGET_VALUE, TARGET_AVERAGE_VALUE})
        else:
            return f"{where}: one of resource/pods/object/external required"
        if err:
            return err
    return None


# -- ResourceBinding: FederatedResourceQuota enforcement --------------------


def calculate_rb_usage(rb: ResourceBinding) -> Dict[str, int]:
    """helper.CalculateResourceUsage: scheduled replicas x per-replica
    request, in milli units.  Multi-component bindings count each
    component's replicas per scheduled set."""
    total = sum(tc.replicas for tc in rb.spec.clusters)
    usage: Dict[str, int] = {}
    if rb.spec.components:
        for comp in rb.spec.components:
            req = comp.replica_requirements
            if req is None:
                continue
            for name, qty in req.resource_request.items():
                usage[name] = usage.get(name, 0) + total * comp.replicas * qty.milli
        return usage
    req = rb.spec.replica_requirements
    if req is None:
        return usage
    for name, qty in req.resource_request.items():
        usage[name] = usage.get(name, 0) + total * qty.milli
    return usage


class QuotaEnforcer:
    """The FederatedQuotaEnforcement gate (validating.go:111-160).

    Denies a ResourceBinding write whose usage DELTA would push any
    namespace FederatedResourceQuota past spec.overall, and bumps
    status.overall_used on allowed writes.  Runs inside the store write
    lock, so check-and-bump is atomic with the persist.
    """

    def __init__(self, store, gates: Optional[FeatureGates] = None) -> None:
        self.store = store
        self.gates = gates or GATES

    def __call__(self, op, rb: ResourceBinding, old) -> Optional[str]:
        if not self.gates.enabled("FederatedQuotaEnforcement"):
            return None
        if op == OP_CREATE and not rb.spec.clusters:
            return None  # not yet scheduled
        new_usage = calculate_rb_usage(rb)
        old_usage = calculate_rb_usage(old) if old is not None else {}
        delta = {
            n: new_usage.get(n, 0) - old_usage.get(n, 0)
            for n in set(new_usage) | set(old_usage)
        }
        delta = {n: d for n, d in delta.items() if d != 0}
        if not delta:
            return None
        frqs = self.store.visit(FederatedResourceQuota.KIND,
                                rb.metadata.namespace)
        to_bump = []
        for frq in frqs:
            if not frq.spec.overall:
                continue
            if frq.spec.static_assignments:
                # static-split quotas are accounted from member-reported
                # ResourceQuota usage (extras.py aggregation path), which
                # would overwrite any bump made here — enforcement covers
                # overall-only quotas, same split as the reference
                continue
            relevant = {n: d for n, d in delta.items() if n in frq.spec.overall}
            if not relevant:
                continue
            for n, d in relevant.items():
                used = frq.status.overall_used.get(n, Quantity(0)).milli
                limit = frq.spec.overall[n].milli
                if used + d > limit:
                    return (
                        f"exceeds FederatedResourceQuota {frq.metadata.name}: "
                        f"{n} used {used}m + delta {d}m > limit {limit}m"
                    )
            to_bump.append((frq, relevant))
        for frq, relevant in to_bump:
            def bump(q, rel=relevant):
                for n, d in rel.items():
                    cur = q.status.overall_used.get(n, Quantity(0))
                    q.status.overall_used[n] = Quantity(cur.milli + d)
            self.store.mutate(
                FederatedResourceQuota.KIND, frq.metadata.namespace,
                frq.metadata.name, bump,
            )
        return None


def install_default_webhooks(
    registry: AdmissionRegistry, store, gates: Optional[FeatureGates] = None,
    default_toleration_seconds: Optional[int] = 300,
) -> None:
    defaulter = DefaultPropagationPolicy(default_toleration_seconds)
    for kind in (PropagationPolicy.KIND, ClusterPropagationPolicy.KIND):
        registry.register_mutating(kind, defaulter)
        registry.register_validating(kind, validate_propagation_policy)
    for kind in (OverridePolicy.KIND, ClusterOverridePolicy.KIND):
        registry.register_validating(kind, validate_override_policy)
    registry.register_validating(FederatedResourceQuota.KIND, validate_frq)
    registry.register_validating(ResourceBinding.KIND,
                                 QuotaEnforcer(store, gates))
    registry.register_validating(ResourceInterpreterWebhook.KIND,
                                 validate_interpreter_webhook)
    registry.register_validating(FederatedHPA.KIND, validate_federated_hpa)
