"""Auxiliary CRD-style APIs: rebalancer, taint policy, remedy, quota.

Counterpart of the JAX package's ``models/extras.py``.

Mirrors reference pkg/apis/{apps,policy,remedy}/v1alpha1:
WorkloadRebalancer (workloadrebalancer_types.go), ClusterTaintPolicy
(clustertaint_types.go), Remedy (remedy_types.go:29-39), and
FederatedResourceQuota (federatedresourcequota_types.go).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from karmada_tpu_torch.models.meta import ObjectMeta, TypedObject
from karmada_tpu_torch.utils.quantity import Quantity


# -- WorkloadRebalancer (apps/v1alpha1) -------------------------------------


@dataclass
class ObjectReferenceSpec:
    api_version: str = ""
    kind: str = ""
    namespace: str = ""
    name: str = ""


@dataclass
class WorkloadRebalancerSpec:
    workloads: List[ObjectReferenceSpec] = field(default_factory=list)
    ttl_seconds_after_finished: Optional[int] = None


@dataclass
class ObservedWorkload:
    workload: ObjectReferenceSpec = field(default_factory=ObjectReferenceSpec)
    result: str = ""  # Successful | Failed | NotFound
    reason: str = ""


@dataclass
class WorkloadRebalancerStatus:
    observed_workloads: List[ObservedWorkload] = field(default_factory=list)
    finish_time: Optional[float] = None


@dataclass
class WorkloadRebalancer(TypedObject):
    KIND = "WorkloadRebalancer"
    API_VERSION = "apps.karmada.io/v1alpha1"

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: WorkloadRebalancerSpec = field(default_factory=WorkloadRebalancerSpec)
    status: WorkloadRebalancerStatus = field(default_factory=WorkloadRebalancerStatus)


# -- ClusterTaintPolicy (policy/v1alpha1) -----------------------------------


@dataclass
class MatchCondition:
    condition_type: str = ""
    operator: str = "In"  # In | NotIn
    status_values: List[str] = field(default_factory=list)


@dataclass
class TaintSpec:
    key: str = ""
    value: str = ""
    effect: str = "NoSchedule"


@dataclass
class ClusterTaintPolicySpec:
    target_clusters: Optional[object] = None  # ClusterAffinity or None (all)
    add_on_conditions: List[MatchCondition] = field(default_factory=list)
    remove_on_conditions: List[MatchCondition] = field(default_factory=list)
    taints: List[TaintSpec] = field(default_factory=list)


@dataclass
class ClusterTaintPolicy(TypedObject):
    KIND = "ClusterTaintPolicy"
    API_VERSION = "policy.karmada.io/v1alpha1"

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: ClusterTaintPolicySpec = field(default_factory=ClusterTaintPolicySpec)


# -- Remedy (remedy/v1alpha1) -----------------------------------------------


@dataclass
class DecisionMatch:
    cluster_condition_type: str = ""
    cluster_condition_status: str = "True"


@dataclass
class RemedySpec:
    cluster_affinity: Optional[object] = None  # ClusterAffinity-ish (names)
    decision_matches: List[DecisionMatch] = field(default_factory=list)
    actions: List[str] = field(default_factory=list)  # e.g. TrafficControl


@dataclass
class Remedy(TypedObject):
    KIND = "Remedy"
    API_VERSION = "remedy.karmada.io/v1alpha1"

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: RemedySpec = field(default_factory=RemedySpec)


# -- FederatedResourceQuota (policy/v1alpha1) -------------------------------


@dataclass
class StaticClusterAssignment:
    cluster_name: str = ""
    hard: Dict[str, Quantity] = field(default_factory=dict)


@dataclass
class FederatedResourceQuotaSpec:
    overall: Dict[str, Quantity] = field(default_factory=dict)
    static_assignments: List[StaticClusterAssignment] = field(default_factory=list)


@dataclass
class ClusterQuotaStatus:
    cluster_name: str = ""
    hard: Dict[str, Quantity] = field(default_factory=dict)
    used: Dict[str, Quantity] = field(default_factory=dict)


@dataclass
class FederatedResourceQuotaStatus:
    overall: Dict[str, Quantity] = field(default_factory=dict)
    overall_used: Dict[str, Quantity] = field(default_factory=dict)
    aggregated_status: List[ClusterQuotaStatus] = field(default_factory=list)


@dataclass
class FederatedResourceQuota(TypedObject):
    KIND = "FederatedResourceQuota"
    API_VERSION = "policy.karmada.io/v1alpha1"

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: FederatedResourceQuotaSpec = field(default_factory=FederatedResourceQuotaSpec)
    status: FederatedResourceQuotaStatus = field(
        default_factory=FederatedResourceQuotaStatus
    )
