"""L0 API data model.

Dataclass equivalents of the reference CRD types (SURVEY.md §2.2):
  meta     — ObjectMeta / conditions / label selectors
  cluster  — cluster.karmada.io/v1alpha1 (reference pkg/apis/cluster/v1alpha1/types.go)
  policy   — policy.karmada.io/v1alpha1 (propagation/override/quota/taint policies)
  work     — work.karmada.io/v1alpha1+v1alpha2 (ResourceBinding, Work)
  workload — plain workload templates (Deployment-like) used by the interpreter
"""

from karmada_tpu_torch.models.meta import (  # noqa: F401
    Condition,
    LabelSelector,
    ObjectMeta,
    TypedObject,
)
from karmada_tpu_torch.models.cluster import (  # noqa: F401
    AllocatableModeling,
    Cluster,
    ClusterSpec,
    ClusterStatus,
    NodeSummary,
    ResourceModel,
    ResourceModelRange,
    ResourceSummary,
    Taint,
    EFFECT_NO_EXECUTE,
    EFFECT_NO_SCHEDULE,
)
from karmada_tpu_torch.models.policy import (  # noqa: F401
    ClusterAffinity,
    ClusterAffinityTerm,
    OverridePolicy,
    Placement,
    PropagationPolicy,
    ReplicaSchedulingStrategy,
    ResourceSelector,
    SpreadConstraint,
    StaticClusterWeight,
    Toleration,
    SPREAD_BY_FIELD_CLUSTER,
    SPREAD_BY_FIELD_PROVIDER,
    SPREAD_BY_FIELD_REGION,
    SPREAD_BY_FIELD_ZONE,
)
from karmada_tpu_torch.models.work import (  # noqa: F401
    AggregatedStatusItem,
    BindingSnapshot,
    GracefulEvictionTask,
    ObjectReference,
    ReplicaRequirements,
    ResourceBinding,
    ResourceBindingSpec,
    ResourceBindingStatus,
    TargetCluster,
    Work,
    WorkSpec,
    WorkStatus,
)
