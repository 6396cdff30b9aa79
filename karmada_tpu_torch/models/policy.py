"""Policy API types: PropagationPolicy / OverridePolicy and Placement.

Mirrors reference pkg/apis/policy/v1alpha1/propagation_types.go:
Placement (:470) = ClusterAffinity (:567) / ClusterAffinities (:590) /
ClusterTolerations / SpreadConstraints (:538) / ReplicaScheduling (:624),
plus cluster-affinity matching semantics from pkg/util/selector.go:96-205.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from karmada_tpu_torch.models.cluster import Cluster
from karmada_tpu_torch.models.meta import LabelSelector, ObjectMeta, TypedObject

# Spread constraint fields (propagation_types.go:538)
SPREAD_BY_FIELD_CLUSTER = "cluster"
SPREAD_BY_FIELD_REGION = "region"
SPREAD_BY_FIELD_ZONE = "zone"
SPREAD_BY_FIELD_PROVIDER = "provider"

# Replica scheduling (propagation_types.go:624)
REPLICA_SCHEDULING_DUPLICATED = "Duplicated"
REPLICA_SCHEDULING_DIVIDED = "Divided"
REPLICA_DIVISION_AGGREGATED = "Aggregated"
REPLICA_DIVISION_WEIGHTED = "Weighted"
DYNAMIC_WEIGHT_AVAILABLE_REPLICAS = "AvailableReplicas"

# Conflict resolution for member-cluster apply
CONFLICT_OVERWRITE = "Overwrite"
CONFLICT_ABORT = "Abort"

# ActivationPreference
LAZY_ACTIVATION = "Lazy"

# Cluster field-selector keys (pkg/util/selector.go)
PROVIDER_FIELD = "provider"
REGION_FIELD = "region"
ZONE_FIELD = "zone"


@dataclass
class ResourceSelector:
    """Which template objects a policy claims (propagation_types.go:69+)."""

    api_version: str = ""
    kind: str = ""
    namespace: str = ""
    name: str = ""
    label_selector: Optional[LabelSelector] = None


@dataclass
class FieldSelectorRequirement:
    key: str = ""  # provider | region | zone
    operator: str = "In"  # In | NotIn | Exists | DoesNotExist
    values: List[str] = field(default_factory=list)


@dataclass
class FieldSelector:
    match_expressions: List[FieldSelectorRequirement] = field(default_factory=list)


@dataclass
class ClusterAffinity:
    label_selector: Optional[LabelSelector] = None
    field_selector: Optional[FieldSelector] = None
    cluster_names: List[str] = field(default_factory=list)
    exclude_clusters: List[str] = field(default_factory=list)

    def matches(self, cluster: Cluster) -> bool:
        """Port of pkg/util/selector.go:96 ClusterMatches."""
        if cluster.name in self.exclude_clusters:
            return False
        if self.label_selector is not None and not self.label_selector.matches(
            cluster.metadata.labels
        ):
            return False
        if self.field_selector is not None:
            fields = {}
            if cluster.spec.provider:
                fields[PROVIDER_FIELD] = cluster.spec.provider
            if cluster.spec.region:
                fields[REGION_FIELD] = cluster.spec.region
            for req in self.field_selector.match_expressions:
                if req.key == ZONE_FIELD:
                    if not _match_zones(req, cluster.spec.zones):
                        return False
                    continue
                if not _match_field(req, fields.get(req.key)):
                    return False
        if self.cluster_names and cluster.name not in self.cluster_names:
            return False
        return True


def _match_zones(req: FieldSelectorRequirement, zones: List[str]) -> bool:
    """Port of pkg/util/selector.go:214 matchZones (In requires subset)."""
    if req.operator == "In":
        return bool(zones) and all(z in req.values for z in zones)
    if req.operator == "NotIn":
        return all(z not in req.values for z in zones)
    if req.operator == "Exists":
        return bool(zones)
    if req.operator == "DoesNotExist":
        return not zones
    return False


def _match_field(req: FieldSelectorRequirement, value: Optional[str]) -> bool:
    if req.operator == "In":
        return value is not None and value in req.values
    if req.operator == "NotIn":
        return value is None or value not in req.values
    if req.operator == "Exists":
        return value is not None
    if req.operator == "DoesNotExist":
        return value is None
    return False


@dataclass
class ClusterAffinityTerm:
    affinity_name: str = ""
    affinity: ClusterAffinity = field(default_factory=ClusterAffinity)


@dataclass
class Toleration:
    """Cluster-taint toleration (mirrors corev1.Toleration semantics)."""

    key: str = ""
    operator: str = "Equal"  # Equal | Exists
    value: str = ""
    effect: str = ""  # empty tolerates all effects
    toleration_seconds: Optional[int] = None

    def tolerates(self, taint) -> bool:
        if self.effect and self.effect != taint.effect:
            return False
        if self.operator == "Exists":
            return self.key == "" or self.key == taint.key
        # Equal: empty key with Equal means "match all keys AND values"? k8s:
        # empty key requires operator Exists; mirror k8s ToleratesTaint:
        return self.key == taint.key and self.value == taint.value


@dataclass
class SpreadConstraint:
    spread_by_field: str = ""  # cluster|region|zone|provider
    spread_by_label: str = ""
    min_groups: int = 0
    max_groups: int = 0


@dataclass
class StaticClusterWeight:
    target_cluster: ClusterAffinity = field(default_factory=ClusterAffinity)
    weight: int = 0


@dataclass
class ClusterPreferences:
    static_weight_list: List[StaticClusterWeight] = field(default_factory=list)
    dynamic_weight: str = ""  # "" or AvailableReplicas


@dataclass
class ReplicaSchedulingStrategy:
    replica_scheduling_type: str = REPLICA_SCHEDULING_DUPLICATED
    replica_division_preference: str = ""  # Aggregated | Weighted
    weight_preference: Optional[ClusterPreferences] = None


@dataclass
class Placement:
    cluster_affinity: Optional[ClusterAffinity] = None
    cluster_affinities: List[ClusterAffinityTerm] = field(default_factory=list)
    cluster_tolerations: List[Toleration] = field(default_factory=list)
    spread_constraints: List[SpreadConstraint] = field(default_factory=list)
    replica_scheduling: Optional[ReplicaSchedulingStrategy] = None

    def replica_scheduling_type(self) -> str:
        """Defaulting mirror of Placement.ReplicaSchedulingType()."""
        if self.replica_scheduling is None:
            return REPLICA_SCHEDULING_DUPLICATED
        return self.replica_scheduling.replica_scheduling_type or REPLICA_SCHEDULING_DUPLICATED


@dataclass
class StatePreservationRule:
    """One state-preservation extraction rule (propagation_types.go:385-420
    StatePreservation.Rules): pull `json_path` out of the failed cluster's
    collected status and re-inject it as label `alias_label_name` on the
    replacement cluster's rendered workload."""

    alias_label_name: str = ""
    json_path: str = ""


@dataclass
class FailoverBehavior:
    # application failover
    toleration_seconds: int = 300
    decision_conditions_toleration_seconds: Optional[int] = None
    purge_mode: str = "Graciously"  # Immediately | Graciously | Never
    grace_period_seconds: Optional[int] = None
    # StatefulFailoverInjection (alpha, gated): state data preserved across
    # failover events (propagation_types.go StatePreservation)
    state_preservation: List[StatePreservationRule] = field(default_factory=list)


@dataclass
class PropagationSpec:
    resource_selectors: List[ResourceSelector] = field(default_factory=list)
    placement: Placement = field(default_factory=Placement)
    propagate_deps: bool = False
    priority: int = 0
    preemption: str = "Never"  # Always | Never
    schedule_priority: Optional[int] = None
    activation_preference: str = ""  # "" | Lazy
    failover: Optional[FailoverBehavior] = None
    conflict_resolution: str = CONFLICT_ABORT
    suspension: Optional["Suspension"] = None


@dataclass
class Suspension:
    dispatching: bool = False
    scheduling: bool = False


@dataclass
class PropagationPolicy(TypedObject):
    KIND = "PropagationPolicy"
    API_VERSION = "policy.karmada.io/v1alpha1"

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PropagationSpec = field(default_factory=PropagationSpec)

    @property
    def cluster_scoped(self) -> bool:
        return not self.metadata.namespace


@dataclass
class ClusterPropagationPolicy(PropagationPolicy):
    KIND = "ClusterPropagationPolicy"

    @property
    def cluster_scoped(self) -> bool:
        return True


# ---------------------------------------------------------------------------
# Override policies (override_types.go) — JSON-patch style per-cluster edits
# ---------------------------------------------------------------------------


@dataclass
class PlaintextOverrider:
    path: str = ""  # dotted path into the manifest
    operator: str = "replace"  # add | remove | replace
    value: Any = None


@dataclass
class ImageOverrider:
    component: str = "Registry"  # Registry | Repository | Tag
    operator: str = "replace"  # add | remove | replace
    value: str = ""


@dataclass
class CommandArgsOverrider:
    container_name: str = ""
    operator: str = "add"  # add | remove
    value: List[str] = field(default_factory=list)


@dataclass
class LabelAnnotationOverrider:
    operator: str = "add"  # add | remove | replace
    value: Dict[str, str] = field(default_factory=dict)


@dataclass
class Overriders:
    plaintext: List[PlaintextOverrider] = field(default_factory=list)
    image_overrider: List[ImageOverrider] = field(default_factory=list)
    command_overrider: List[CommandArgsOverrider] = field(default_factory=list)
    args_overrider: List[CommandArgsOverrider] = field(default_factory=list)
    labels_overrider: List[LabelAnnotationOverrider] = field(default_factory=list)
    annotations_overrider: List[LabelAnnotationOverrider] = field(default_factory=list)


@dataclass
class RuleWithCluster:
    target_cluster: Optional[ClusterAffinity] = None
    overriders: Overriders = field(default_factory=Overriders)


@dataclass
class OverrideSpec:
    resource_selectors: List[ResourceSelector] = field(default_factory=list)
    override_rules: List[RuleWithCluster] = field(default_factory=list)


@dataclass
class OverridePolicy(TypedObject):
    KIND = "OverridePolicy"
    API_VERSION = "policy.karmada.io/v1alpha1"

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: OverrideSpec = field(default_factory=OverrideSpec)


@dataclass
class ClusterOverridePolicy(OverridePolicy):
    KIND = "ClusterOverridePolicy"
