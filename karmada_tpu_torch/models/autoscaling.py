"""Autoscaling APIs: FederatedHPA + CronFederatedHPA.

Counterpart of the JAX package's ``models/autoscaling.py``.

Mirrors reference pkg/apis/autoscaling/v1alpha1
(federatedhpa_types.go, cronfederatedhpa_types.go): the k8s
autoscaling/v2 HPA surface (resource-metric targets, scaling behavior
rules) federated across member clusters, plus cron-driven scaling.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from karmada_tpu_torch.models.meta import Condition, ObjectMeta, TypedObject

# metric target types (autoscaling/v2)
TARGET_UTILIZATION = "Utilization"
TARGET_AVERAGE_VALUE = "AverageValue"
TARGET_VALUE = "Value"

# scaling policy types
POLICY_PODS = "Pods"
POLICY_PERCENT = "Percent"

SELECT_MAX = "Max"
SELECT_MIN = "Min"
SELECT_DISABLED = "Disabled"


@dataclass
class CrossVersionObjectReference:
    api_version: str = ""
    kind: str = ""
    name: str = ""


@dataclass
class MetricTarget:
    type: str = TARGET_UTILIZATION
    average_utilization: Optional[int] = None  # percent of request
    average_value: Optional[int] = None  # milli-units per pod
    value: Optional[int] = None  # absolute (Object/External Value targets)


@dataclass
class ResourceMetricSource:
    name: str = "cpu"  # resource name
    target: MetricTarget = field(default_factory=MetricTarget)


@dataclass
class PodsMetricSource:
    """custom.metrics.k8s.io per-pod series (autoscaling/v2 PodsMetricSource);
    served multi-cluster by the metrics adapter's custom provider."""

    metric: str = ""
    target: MetricTarget = field(default_factory=MetricTarget)  # AverageValue


@dataclass
class ObjectMetricSource:
    """A single object's custom metric (autoscaling/v2 ObjectMetricSource)."""

    described_object: CrossVersionObjectReference = field(
        default_factory=CrossVersionObjectReference)
    metric: str = ""
    target: MetricTarget = field(default_factory=MetricTarget)  # Value | AverageValue


@dataclass
class ExternalMetricSource:
    """external.metrics.k8s.io series (autoscaling/v2 ExternalMetricSource)."""

    metric: str = ""
    selector: Dict[str, str] = field(default_factory=dict)
    target: MetricTarget = field(default_factory=MetricTarget)  # Value | AverageValue


@dataclass
class MetricSpec:
    type: str = "Resource"  # Resource | Pods | Object | External
    resource: Optional[ResourceMetricSource] = None
    pods: Optional[PodsMetricSource] = None
    object: Optional[ObjectMetricSource] = None
    external: Optional[ExternalMetricSource] = None


@dataclass
class HPAScalingPolicy:
    type: str = POLICY_PODS  # Pods | Percent
    value: int = 0
    period_seconds: int = 60


@dataclass
class HPAScalingRules:
    stabilization_window_seconds: Optional[int] = None
    select_policy: str = SELECT_MAX
    policies: List[HPAScalingPolicy] = field(default_factory=list)


@dataclass
class HPABehavior:
    scale_up: Optional[HPAScalingRules] = None
    scale_down: Optional[HPAScalingRules] = None


@dataclass
class FederatedHPASpec:
    scale_target_ref: CrossVersionObjectReference = field(
        default_factory=CrossVersionObjectReference)
    min_replicas: int = 1
    max_replicas: int = 0
    metrics: List[MetricSpec] = field(default_factory=list)
    behavior: Optional[HPABehavior] = None


@dataclass
class MetricStatusValue:
    name: str = ""
    current_utilization: Optional[int] = None
    current_average_value: Optional[int] = None


@dataclass
class FederatedHPAStatus:
    current_replicas: int = 0
    desired_replicas: int = 0
    current_metrics: List[MetricStatusValue] = field(default_factory=list)
    last_scale_time: Optional[float] = None
    conditions: List[Condition] = field(default_factory=list)


@dataclass
class FederatedHPA(TypedObject):
    KIND = "FederatedHPA"
    API_VERSION = "autoscaling.karmada.io/v1alpha1"

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: FederatedHPASpec = field(default_factory=FederatedHPASpec)
    status: FederatedHPAStatus = field(default_factory=FederatedHPAStatus)


# -- CronFederatedHPA (cronfederatedhpa_types.go) ----------------------------


@dataclass
class CronFederatedHPARule:
    name: str = ""
    schedule: str = ""  # standard 5-field cron, evaluated each sync
    target_replicas: Optional[int] = None  # workload / FHPA replica target
    target_min_replicas: Optional[int] = None  # FHPA minReplicas
    target_max_replicas: Optional[int] = None  # FHPA maxReplicas
    suspend: bool = False


@dataclass
class CronFederatedHPASpec:
    scale_target_ref: CrossVersionObjectReference = field(
        default_factory=CrossVersionObjectReference)
    rules: List[CronFederatedHPARule] = field(default_factory=list)


@dataclass
class ExecutionHistory:
    rule_name: str = ""
    next_execution_time: Optional[float] = None
    last_execution_time: Optional[float] = None
    last_result: str = ""  # Succeed | Failed
    message: str = ""


@dataclass
class CronFederatedHPAStatus:
    execution_histories: List[ExecutionHistory] = field(default_factory=list)


@dataclass
class CronFederatedHPA(TypedObject):
    KIND = "CronFederatedHPA"
    API_VERSION = "autoscaling.karmada.io/v1alpha1"

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: CronFederatedHPASpec = field(default_factory=CronFederatedHPASpec)
    status: CronFederatedHPAStatus = field(default_factory=CronFederatedHPAStatus)
