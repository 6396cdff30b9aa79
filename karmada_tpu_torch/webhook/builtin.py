"""Built-in admission plugins, mirroring the reference karmada-webhook set.

Counterpart of the part of the JAX package's ``webhook/builtin.py`` that
the propagation loop's kinds need (reference
pkg/webhook/<kind>/{mutating,validating}.go):
  * PropagationPolicy / ClusterPropagationPolicy -- placement validation
    (spread-constraint min<=max, static weights positive, toleration
    seconds non-negative, preemption enum) + defaulting, with the default
    not-ready / unreachable NoExecute tolerations.
  * OverridePolicy / ClusterOverridePolicy -- overrider plausibility.
  * ResourceInterpreterWebhook -- endpoint scheme and explicit rules.

The FederatedResourceQuota validator and its ResourceBinding enforcement
gate, and the FederatedHPA validator, wait for their models in the port.
"""

from __future__ import annotations

from typing import Optional

from karmada_tpu_torch.models.config import ResourceInterpreterWebhook
from karmada_tpu_torch.models.policy import (
    ClusterOverridePolicy,
    ClusterPropagationPolicy,
    OverridePolicy,
    PropagationPolicy,
    Toleration,
)
from karmada_tpu_torch.webhook.admission import AdmissionRegistry


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


def install_default_webhooks(
    registry: AdmissionRegistry,
    default_toleration_seconds: Optional[int] = 300,
) -> None:
    defaulter = DefaultPropagationPolicy(default_toleration_seconds)
    for kind in (PropagationPolicy.KIND, ClusterPropagationPolicy.KIND):
        registry.register_mutating(kind, defaulter)
        registry.register_validating(kind, validate_propagation_policy)
    for kind in (OverridePolicy.KIND, ClusterOverridePolicy.KIND):
        registry.register_validating(kind, validate_override_policy)
    registry.register_validating(ResourceInterpreterWebhook.KIND,
                                 validate_interpreter_webhook)
