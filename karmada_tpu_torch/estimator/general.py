"""General (in-process) capacity estimator.

Faithful port of reference pkg/estimator/client/general.go: computes the
maximum deployable replicas per cluster from `cluster.status.resourceSummary`
(available = allocatable - allocated - allocating; CPU in milli-units, other
resources in whole units rounded up) or, when resource models are populated,
from the AllocatableModelings histogram (general.go:336-387).

This math is already tensor-shaped — the TPU path (ops/solver.py) evaluates
the identical formula over dense (clusters x resources) arrays.

`produce_allocatable_modelings` is the producer side: the cluster-status
controller fills a member's AllocatableModelings histogram with it.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from karmada_tpu_torch.models.cluster import (
    AllocatableModeling,
    Cluster,
    ResourceSummary,
)
from karmada_tpu_torch.models.work import ReplicaRequirements, TargetCluster
from karmada_tpu_torch.utils.quantity import (
    RESOURCE_CPU,
    RESOURCE_PODS,
    Quantity,
    resource_request_value,
)

# Sentinel meaning "this estimator cannot authenticate a value for the
# cluster" (client/interface.go:30); consumers skip it when min-merging.
UNAUTHENTIC_REPLICA = -1

MAX_INT32 = (1 << 31) - 1
MAX_INT64 = (1 << 63) - 1


def _available(summary: ResourceSummary, resource: str) -> int:
    """available milli-units of one resource (general.go:302-316)."""
    alloc = summary.allocatable.get(resource)
    if alloc is None:
        return -1  # missing allocatable: treated as "no capacity known"
    m = alloc.milli
    used = summary.allocated.get(resource)
    if used is not None:
        m -= used.milli
    ing = summary.allocating.get(resource)
    if ing is not None:
        m -= ing.milli
    return m


def produce_allocatable_modelings(member, resource_models):
    """The modeling PRODUCER (pkg/modeling/modeling.go:33-246
    AddToResourceSummary/getIndex): place each node's FREE capacity into
    the grade histogram.  A node's grade is the MINIMUM over the model's
    resource axes of the last grade whose lower bound the node still
    reaches (searchLastLessElement); nodes below grade 0 on any axis are
    dropped, exactly like the reference's index == -1 path.

    Uses the SAME _models_min_map (model-list order, Quantity units) the
    consumer indexes against, so producer and consumer cannot disagree on
    grade indices."""
    from karmada_tpu_torch.estimator.server import _node_free

    if not resource_models:
        return []
    min_map = _models_min_map(resource_models)
    counts = [0] * len(resource_models)
    for free in _node_free(member):
        index = None
        for name, mins in min_map.items():
            # _node_free units: milli for everything except the raw pod count
            have = (
                Quantity.from_units(free.get(name, 0))
                if name == RESOURCE_PODS
                else Quantity(free.get(name, 0))
            )
            last = -1
            for gi, lo in enumerate(mins):
                if have >= lo:
                    last = gi
            index = last if index is None else min(index, last)
        if index is None or index < 0:
            continue
        counts[index] += 1
    return [
        AllocatableModeling(grade=m.grade, count=counts[i])
        for i, m in enumerate(resource_models)
    ]


def allowed_pod_number(summary: ResourceSummary) -> int:
    """general.go:234-252."""
    allocatable = summary.allocatable.get(RESOURCE_PODS, Quantity(0)).value()
    allocated = summary.allocated.get(RESOURCE_PODS, Quantity(0)).value()
    allocating = summary.allocating.get(RESOURCE_PODS, Quantity(0)).value()
    allowed = allocatable - allocated - allocating
    return max(allowed, 0)


def max_replicas_from_summary(
    summary: ResourceSummary, requirements: Optional[ReplicaRequirements]
) -> int:
    """getMaximumReplicasBasedOnClusterSummary (general.go:294-334)."""
    maximum = MAX_INT64
    if requirements is None:
        return maximum
    for name, qty in requirements.resource_request.items():
        requested = resource_request_value(name, qty)
        if requested <= 0:
            continue
        avail_milli = _available(summary, name)
        if avail_milli < 0:
            return 0  # allocatable missing for a requested resource
        if name == RESOURCE_CPU:
            available = avail_milli
        else:
            available = -((-avail_milli) // 1000)  # Value(): ceil to units
        if available <= 0:
            return 0
        maximum = min(maximum, available // requested)
    return maximum


def _models_min_map(resource_models) -> Dict[str, List[Quantity]]:
    """convertToResourceModelsMinMap (general.go:254-262).  Model-LIST order:
    allocatable_modelings index positionally against this, so the producer
    below and the consumer share one mapping by construction."""
    out: Dict[str, List[Quantity]] = {}
    for model in resource_models:
        for rng in model.ranges:
            out.setdefault(rng.name, []).append(rng.min)
    return out


def _minimum_model_index(min_grades: List[Quantity], request: Quantity) -> int:
    """general.go:374-387: smallest grade whose min >= request."""
    for i, min_value in enumerate(min_grades):
        if min_value >= request:
            return i
    return -1


def _node_available_replicas(
    grade_index: int,
    requirements: ReplicaRequirements,
    min_map: Dict[str, List[Quantity]],
) -> int:
    """getNodeAvailableReplicas (general.go:270-292): how many replicas fit on
    one node of the given grade, assuming the node offers each resource at the
    grade's minimum boundary."""
    maximum_one_node = MAX_INT64
    for name, qty in requirements.resource_request.items():
        requested = resource_request_value(name, qty)
        if requested <= 0:
            continue
        grades = min_map.get(name)
        if grades is None or grade_index >= len(grades):
            continue
        available = resource_request_value(name, grades[grade_index])
        maximum_one_node = min(maximum_one_node, available // requested)
    # first suitable model counts as able to host at least one pod
    return 1 if maximum_one_node == 0 else maximum_one_node


def max_replicas_from_models(
    cluster: Cluster, requirements: ReplicaRequirements
) -> Optional[int]:
    """getMaximumReplicasBasedOnResourceModels (general.go:336-372).

    Returns None when models are inapplicable (missing resource) — caller
    falls back to summary math; returns an int otherwise.
    """
    min_map = _models_min_map(cluster.spec.resource_models)
    min_index = 0
    for name, qty in requirements.resource_request.items():
        if resource_request_value(name, qty) <= 0:
            continue
        grades = min_map.get(name)
        if grades is None:
            return None  # inapplicable: missing resource in models
        idx = _minimum_model_index(grades, qty)
        if idx == -1:
            return 0
        min_index = max(min_index, idx)

    summary = cluster.status.resource_summary
    total = 0
    for i in range(min_index, len(cluster.spec.resource_models)):
        modelings = summary.allocatable_modelings if summary else []
        count = modelings[i].count if i < len(modelings) else 0
        if count == 0:
            continue
        total += count * _node_available_replicas(i, requirements, min_map)
    return total


def per_set_requirement(components) -> Dict[str, int]:
    """perSetRequirement (general.go:181-195): aggregate demand of ONE set of
    components, in request units (cpu milli, others Value)."""
    out: Dict[str, int] = {}
    for c in components:
        rr = c.replica_requirements
        if rr is None or not rr.resource_request:
            continue
        for name, qty in rr.resource_request.items():
            out[name] = out.get(name, 0) + resource_request_value(name, qty) * c.replicas
    return out


def pods_in_set(components) -> int:
    """podsInSet (general.go:172-179)."""
    return sum(c.replicas for c in components)


def max_sets_from_models(cluster: Cluster, components) -> int:
    """getMaximumSetsBasedOnResourceModels (general.go:163-170): the
    reference leaves this as a placeholder that never reduces the bound."""
    return MAX_INT64


class GeneralEstimator:
    """Reference GeneralEstimator: pure math on cluster.status.resourceSummary."""

    def __init__(self, enable_resource_modeling: bool = True) -> None:
        self.enable_resource_modeling = enable_resource_modeling

    def max_available_replicas(
        self,
        clusters: List[Cluster],
        requirements: Optional[ReplicaRequirements],
    ) -> List[TargetCluster]:
        return [
            TargetCluster(name=c.name, replicas=self._max_for_cluster(c, requirements))
            for c in clusters
        ]

    def max_available_component_sets(
        self, clusters: List[Cluster], components
    ) -> List[TargetCluster]:
        """MaxAvailableComponentSets (general.go:96-104): how many full SETS
        of a multi-template workload's components fit per cluster."""
        return [
            TargetCluster(name=c.name, replicas=self._max_sets_for_cluster(c, components))
            for c in clusters
        ]

    def _max_sets_for_cluster(self, cluster: Cluster, components) -> int:
        """maxAvailableComponentSets (general.go:106-160)."""
        summary = cluster.status.resource_summary
        if summary is None:
            return 0
        allowed = allowed_pod_number(summary)
        if allowed <= 0:
            return 0
        pods_per_set = pods_in_set(components)
        if pods_per_set <= 0:
            return min(allowed, MAX_INT32)
        max_sets = allowed // pods_per_set
        per_set = per_set_requirement(components)
        if per_set and any(v > 0 for v in per_set.values()):
            for name, req in per_set.items():
                if req <= 0:
                    continue
                avail_milli = _available(summary, name)
                if name == RESOURCE_CPU:
                    available = avail_milli
                else:
                    available = -((-avail_milli) // 1000)
                if available <= 0:
                    return 0
                max_sets = min(max_sets, available // req)
        if self.enable_resource_modeling and summary.allocatable_modelings:
            max_sets = min(max_sets, max_sets_from_models(cluster, components))
        return min(max_sets, MAX_INT32)

    def _max_for_cluster(
        self, cluster: Cluster, requirements: Optional[ReplicaRequirements]
    ) -> int:
        """general.go:56-94 maxAvailableReplicas."""
        summary = cluster.status.resource_summary
        if summary is None:
            return 0
        maximum = allowed_pod_number(summary)
        if maximum <= 0:
            return 0
        if requirements is None:
            return min(maximum, MAX_INT32)
        if self.enable_resource_modeling and summary.allocatable_modelings:
            num = max_replicas_from_models(cluster, requirements)
            if num is not None:
                return min(min(num, maximum), MAX_INT32)
        num = max_replicas_from_summary(summary, requirements)
        return min(min(num, maximum), MAX_INT32)
