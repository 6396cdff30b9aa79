"""Cluster API types.

Mirrors reference pkg/apis/cluster/v1alpha1/types.go:43-420 — SyncMode
(:259-264), taints, provider/region/zone(s), ResourceModels (:207),
Status.ResourceSummary (:346, Allocatable/Allocating/Allocated +
AllocatableModelings) which is the capacity-tensor source for the TPU solver.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from karmada_tpu_torch.models.meta import Condition, ObjectMeta, TypedObject, is_condition_true
from karmada_tpu_torch.utils.quantity import Quantity

SYNC_MODE_PUSH = "Push"
SYNC_MODE_PULL = "Pull"

EFFECT_NO_SCHEDULE = "NoSchedule"
EFFECT_NO_EXECUTE = "NoExecute"
EFFECT_PREFER_NO_SCHEDULE = "PreferNoSchedule"

COND_CLUSTER_READY = "Ready"
COND_COMPLETE_API_ENABLEMENTS = "CompleteAPIEnablements"

API_ENABLED = "Enabled"
API_DISABLED = "Disabled"
API_UNKNOWN = "Unknown"


@dataclass
class Taint:
    key: str = ""
    value: str = ""
    effect: str = EFFECT_NO_SCHEDULE
    time_added: Optional[float] = None


@dataclass
class ResourceModelRange:
    """[min, max) range of one resource for a model grade (types.go:207+)."""

    name: str = ""
    min: Quantity = field(default_factory=lambda: Quantity(0))
    max: Quantity = field(default_factory=lambda: Quantity(0))


@dataclass
class ResourceModel:
    grade: int = 0
    ranges: List[ResourceModelRange] = field(default_factory=list)


@dataclass
class AllocatableModeling:
    grade: int = 0
    count: int = 0


@dataclass
class NodeSummary:
    total_num: int = 0
    ready_num: int = 0


@dataclass
class ResourceSummary:
    """Cluster-wide capacity: available = allocatable - allocated - allocating.

    Reference cluster/v1alpha1/types.go:346 + estimator math
    pkg/estimator/client/general.go:294-334.
    """

    allocatable: Dict[str, Quantity] = field(default_factory=dict)
    allocating: Dict[str, Quantity] = field(default_factory=dict)
    allocated: Dict[str, Quantity] = field(default_factory=dict)
    allocatable_modelings: List[AllocatableModeling] = field(default_factory=list)


@dataclass
class APIEnablement:
    group_version: str = ""
    resources: List[str] = field(default_factory=list)  # kinds


@dataclass
class ClusterSpec:
    sync_mode: str = SYNC_MODE_PUSH
    api_endpoint: str = ""
    provider: str = ""
    region: str = ""
    zone: str = ""  # deprecated singular (still read by region grouping)
    zones: List[str] = field(default_factory=list)
    taints: List[Taint] = field(default_factory=list)
    resource_models: List[ResourceModel] = field(default_factory=list)


@dataclass
class ClusterStatus:
    kubernetes_version: str = ""
    api_enablements: List[APIEnablement] = field(default_factory=list)
    conditions: List[Condition] = field(default_factory=list)
    node_summary: Optional[NodeSummary] = None
    resource_summary: Optional[ResourceSummary] = None
    remedy_actions: List[str] = field(default_factory=list)


@dataclass
class Cluster(TypedObject):
    KIND = "Cluster"
    API_VERSION = "cluster.karmada.io/v1alpha1"

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: ClusterSpec = field(default_factory=ClusterSpec)
    status: ClusterStatus = field(default_factory=ClusterStatus)

    def api_enablement(self, api_version: str, kind: str) -> str:
        """Whether this cluster serves the given API
        (cluster_helper.go:46-67): Disabled is only certain when the
        CompleteAPIEnablements condition holds; otherwise Unknown."""
        for e in self.status.api_enablements:
            if e.group_version == api_version and kind in e.resources:
                return API_ENABLED
        if is_condition_true(self.status.conditions, COND_COMPLETE_API_ENABLEMENTS):
            return API_DISABLED
        return API_UNKNOWN

    @property
    def ready(self) -> bool:
        return is_condition_true(self.status.conditions, COND_CLUSTER_READY)

    def zones_effective(self) -> List[str]:
        """Zones for spread grouping; falls back to the singular field."""
        if self.spec.zones:
            return self.spec.zones
        return [self.spec.zone] if self.spec.zone else []
