"""Work API types: ResourceBinding (the scheduling unit) and Work.

Mirrors reference pkg/apis/work/v1alpha2/binding_types.go:59-409 and
work/v1alpha1/work_types.go:45-103.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from karmada_tpu_torch.models.meta import Condition, ObjectMeta, TypedObject
from karmada_tpu_torch.models.policy import Placement
from karmada_tpu_torch.utils.quantity import Quantity

# Binding condition types
COND_SCHEDULED = "Scheduled"
COND_FULLY_APPLIED = "FullyApplied"

# Work condition types
COND_WORK_APPLIED = "Applied"
COND_WORK_AVAILABLE = "Available"
COND_WORK_DEGRADED = "Degraded"


@dataclass
class ObjectReference:
    """Reference to the propagated template (binding_types.go Resource)."""

    api_version: str = ""
    kind: str = ""
    namespace: str = ""
    name: str = ""
    uid: str = ""
    resource_version: int = 0


@dataclass
class NodeClaim:
    """Node-level scheduling claims carried to the accurate estimator
    (pkg/estimator/pb/generated.proto NodeClaim)."""

    node_selector: Dict[str, str] = field(default_factory=dict)
    tolerations: List[Any] = field(default_factory=list)
    hard_node_affinity: Optional[Any] = None


@dataclass
class ReplicaRequirements:
    """Per-replica resource demand (binding_types.go:211)."""

    resource_request: Dict[str, Quantity] = field(default_factory=dict)
    node_claim: Optional[NodeClaim] = None
    namespace: str = ""
    priority_class_name: str = ""


@dataclass
class Component:
    """One pod template of a multi-template workload
    (binding_types.go:98, feature MultiplePodTemplatesScheduling)."""

    name: str = ""
    replicas: int = 0
    replica_requirements: Optional[ReplicaRequirements] = None


@dataclass
class TargetCluster:
    """Schedule result entry (binding_types.go .spec.clusters)."""

    name: str = ""
    replicas: int = 0


@dataclass
class BindingSnapshot:
    """RequiredBy entry: another binding's schedule result that this (attached)
    binding must follow (dependencies distribution)."""

    namespace: str = ""
    name: str = ""
    clusters: List[TargetCluster] = field(default_factory=list)


@dataclass
class GracefulEvictionTask:
    """binding_types.go:330-353."""

    from_cluster: str = ""
    replicas: int = 0
    reason: str = ""
    message: str = ""
    producer: str = ""
    grace_period_seconds: Optional[int] = None
    suppress_deletion: Optional[bool] = None
    creation_timestamp: float = 0.0
    # how the legacy application on from_cluster is purged; recorded so the
    # binding controller can decide whether preserved state may be injected
    # (binding/common.go:171-207: only Immediately/Directly tasks inject)
    purge_mode: str = ""
    # StatefulFailoverInjection payload (binding_types.go:330-353)
    clusters_before_failover: List[str] = field(default_factory=list)
    preserved_label_state: Dict[str, str] = field(default_factory=dict)


@dataclass
class BindingSuspension:
    scheduling: bool = False
    dispatching: bool = False
    dispatching_on_clusters: List[str] = field(default_factory=list)


@dataclass
class ResourceBindingSpec:
    resource: ObjectReference = field(default_factory=ObjectReference)
    replicas: int = 0
    replica_requirements: Optional[ReplicaRequirements] = None
    components: List[Component] = field(default_factory=list)
    placement: Optional[Placement] = None
    clusters: List[TargetCluster] = field(default_factory=list)
    required_by: List[BindingSnapshot] = field(default_factory=list)
    graceful_eviction_tasks: List[GracefulEvictionTask] = field(default_factory=list)
    reschedule_triggered_at: Optional[float] = None
    suspension: Optional[BindingSuspension] = None
    schedule_priority: Optional[int] = None
    conflict_resolution: str = "Abort"
    propagate_deps: bool = False
    failover: Optional[Any] = None

    def target_contains(self, cluster_name: str) -> bool:
        return any(tc.name == cluster_name for tc in self.clusters)

    def assigned_replicas_for_cluster(self, cluster_name: str) -> int:
        """binding_types.go AssignedReplicasForCluster."""
        for tc in self.clusters:
            if tc.name == cluster_name:
                return tc.replicas
        return 0

    def cluster_names(self) -> List[str]:
        return [tc.name for tc in self.clusters]


@dataclass
class AggregatedStatusItem:
    cluster_name: str = ""
    status: Optional[Dict[str, Any]] = None
    applied: bool = False
    applied_message: str = ""
    health: str = "Unknown"  # Healthy | Unhealthy | Unknown


@dataclass
class ResourceBindingStatus:
    scheduler_observed_generation: int = 0
    scheduler_observed_affinity_name: str = ""
    last_scheduled_time: Optional[float] = None
    conditions: List[Condition] = field(default_factory=list)
    aggregated_status: List[AggregatedStatusItem] = field(default_factory=list)


@dataclass
class ResourceBinding(TypedObject):
    KIND = "ResourceBinding"
    API_VERSION = "work.karmada.io/v1alpha2"

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: ResourceBindingSpec = field(default_factory=ResourceBindingSpec)
    status: ResourceBindingStatus = field(default_factory=ResourceBindingStatus)


@dataclass
class ClusterResourceBinding(ResourceBinding):
    KIND = "ClusterResourceBinding"


@dataclass
class ManifestStatus:
    identifier: Dict[str, Any] = field(default_factory=dict)
    status: Optional[Dict[str, Any]] = None
    health: str = "Unknown"


@dataclass
class WorkSpec:
    workload: List[Dict[str, Any]] = field(default_factory=list)  # raw manifests
    suspend_dispatching: bool = False


@dataclass
class WorkStatus:
    conditions: List[Condition] = field(default_factory=list)
    manifest_statuses: List[ManifestStatus] = field(default_factory=list)


@dataclass
class Work(TypedObject):
    KIND = "Work"
    API_VERSION = "work.karmada.io/v1alpha1"

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: WorkSpec = field(default_factory=WorkSpec)
    status: WorkStatus = field(default_factory=WorkStatus)


def get_sum_of_replicas(clusters: List[TargetCluster]) -> int:
    return sum(tc.replicas for tc in clusters)


def merge_target_clusters(
    old: List[TargetCluster], new: List[TargetCluster]
) -> List[TargetCluster]:
    """Port of util.MergeTargetClusters: sum replicas per cluster name,
    keeping clusters from both lists (old order first, then new-only)."""
    merged: Dict[str, int] = {}
    order: List[str] = []
    for tc in list(old) + list(new):
        if tc.name not in merged:
            merged[tc.name] = 0
            order.append(tc.name)
        merged[tc.name] += tc.replicas
    return [TargetCluster(name=n, replicas=merged[n]) for n in order]
