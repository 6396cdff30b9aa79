"""Serial golden scheduling pipeline — the control baseline.

A faithful Python re-implementation of the reference scheduler's algorithmic
core (pkg/scheduler/core/generic_scheduler.go:71-116):

    findClustersThatFit -> prioritizeClusters -> SelectClusters -> AssignReplicas

with the in-tree plugin set (pkg/scheduler/framework/plugins/registry.go:30-39),
spread-constraint group selection (pkg/scheduler/core/spreadconstraint/) and
the replica-division strategies (pkg/scheduler/core/assignment.go,
division_algorithm.go).

Every TPU kernel in ops/solver.py is golden-tested against this module.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from karmada_tpu_torch.models.cluster import (
    API_ENABLED,
    EFFECT_NO_EXECUTE,
    EFFECT_NO_SCHEDULE,
    Cluster,
)
from karmada_tpu_torch.models.policy import (
    REPLICA_DIVISION_AGGREGATED,
    REPLICA_DIVISION_WEIGHTED,
    REPLICA_SCHEDULING_DIVIDED,
    REPLICA_SCHEDULING_DUPLICATED,
    SPREAD_BY_FIELD_CLUSTER,
    SPREAD_BY_FIELD_PROVIDER,
    SPREAD_BY_FIELD_REGION,
    SPREAD_BY_FIELD_ZONE,
    ClusterAffinity,
    Placement,
    SpreadConstraint,
)
from karmada_tpu_torch.models.work import (
    ResourceBindingSpec,
    ResourceBindingStatus,
    TargetCluster,
    get_sum_of_replicas,
    merge_target_clusters,
)
from karmada_tpu_torch.ops.webster import dispense_by_weight

MIN_CLUSTER_SCORE = 0
MAX_CLUSTER_SCORE = 100
INVALID_REPLICAS = -1
MAX_INT32 = (1 << 31) - 1

# group-score weight unit (spreadconstraint/group_clusters.go:139)
WEIGHT_UNIT = 1000


class UnschedulableError(Exception):
    """framework.UnschedulableError — no capacity, retry later."""


class FitError(Exception):
    """No feasible cluster; carries per-cluster diagnosis."""

    def __init__(self, diagnosis: Dict[str, str]):
        super().__init__(f"0/{len(diagnosis)} clusters are available: {diagnosis}")
        self.diagnosis = diagnosis


class NoClusterAvailableError(Exception):
    """AssignReplicas with empty candidate set (core/common.go:44-46)."""


# ---------------------------------------------------------------------------
# Filter plugins (pkg/scheduler/framework/plugins/*)
# ---------------------------------------------------------------------------


def filter_api_enablement(
    spec: ResourceBindingSpec, status: ResourceBindingStatus, cluster: Cluster
) -> Optional[str]:
    if spec.target_contains(cluster.name):
        return None
    if cluster.api_enablement(spec.resource.api_version, spec.resource.kind) == API_ENABLED:
        return None
    return "cluster(s) did not have the API resource"


def filter_taint_toleration(
    spec: ResourceBindingSpec, status: ResourceBindingStatus, cluster: Cluster
) -> Optional[str]:
    if spec.target_contains(cluster.name):
        return None
    tolerations = spec.placement.cluster_tolerations if spec.placement else []
    for taint in cluster.spec.taints:
        if taint.effect not in (EFFECT_NO_SCHEDULE, EFFECT_NO_EXECUTE):
            continue
        if not any(t.tolerates(taint) for t in tolerations):
            return f"cluster(s) had untolerated taint {{{taint.key}={taint.value}:{taint.effect}}}"
    return None


def filter_cluster_affinity(
    spec: ResourceBindingSpec, status: ResourceBindingStatus, cluster: Cluster
) -> Optional[str]:
    affinity: Optional[ClusterAffinity] = None
    placement = spec.placement or Placement()
    if placement.cluster_affinity is not None:
        affinity = placement.cluster_affinity
    else:
        for term in placement.cluster_affinities:
            if term.affinity_name == status.scheduler_observed_affinity_name:
                affinity = term.affinity
                break
    if affinity is not None and not affinity.matches(cluster):
        return "cluster(s) did not match the placement cluster affinity constraint"
    return None


def filter_spread_constraint(
    spec: ResourceBindingSpec, status: ResourceBindingStatus, cluster: Cluster
) -> Optional[str]:
    placement = spec.placement or Placement()
    for sc in placement.spread_constraints:
        if sc.spread_by_field == SPREAD_BY_FIELD_PROVIDER and not cluster.spec.provider:
            return "cluster(s) did not have provider property"
        if sc.spread_by_field == SPREAD_BY_FIELD_REGION and not cluster.spec.region:
            return "cluster(s) did not have region property"
        if sc.spread_by_field == SPREAD_BY_FIELD_ZONE and not cluster.zones_effective():
            return "cluster(s) did not have zones property"
        if sc.spread_by_label and not cluster.metadata.labels.get(
            sc.spread_by_label
        ):
            return "cluster(s) did not have spread label " + sc.spread_by_label
    return None


def filter_cluster_eviction(
    spec: ResourceBindingSpec, status: ResourceBindingStatus, cluster: Cluster
) -> Optional[str]:
    if any(t.from_cluster == cluster.name for t in spec.graceful_eviction_tasks):
        return "cluster(s) is in the process of eviction"
    return None


FILTER_PLUGINS: List[Tuple[str, Callable]] = [
    ("APIEnablement", filter_api_enablement),
    ("TaintToleration", filter_taint_toleration),
    ("ClusterAffinity", filter_cluster_affinity),
    ("SpreadConstraint", filter_spread_constraint),
    ("ClusterEviction", filter_cluster_eviction),
]


def effective_placement(
    spec: ResourceBindingSpec, status: ResourceBindingStatus
) -> Placement:
    """Resolve ClusterAffinities terms to the scheduler-observed one; the
    single placement object out-of-tree plugins see on EVERY backend."""
    placement = spec.placement or Placement()
    if placement.cluster_affinity is not None or not placement.cluster_affinities:
        return placement
    affinity = None
    for term in placement.cluster_affinities:
        if term.affinity_name == status.scheduler_observed_affinity_name:
            affinity = term.affinity
            break
    return Placement(
        cluster_affinity=affinity,
        cluster_tolerations=placement.cluster_tolerations,
        spread_constraints=placement.spread_constraints,
        replica_scheduling=placement.replica_scheduling,
    )


def find_clusters_that_fit(
    spec: ResourceBindingSpec,
    status: ResourceBindingStatus,
    clusters: List[Cluster],
) -> Tuple[List[Cluster], Dict[str, str]]:
    """generic_scheduler.go:119-152 (deleting clusters skipped; unhealthy
    clusters are NOT filtered — users opt in via tolerations).  In-tree
    filters run first, then enabled out-of-tree registry filters
    (framework/runtime/registry.go), first rejection wins."""
    from karmada_tpu_torch.scheduler.plugins import REGISTRY, eval_filters

    feasible: List[Cluster] = []
    diagnosis: Dict[str, str] = {}
    extra = REGISTRY.enabled_filters()
    eff = effective_placement(spec, status) if extra else None
    for cluster in clusters:
        if cluster.metadata.deleting:
            continue
        reason = None
        for _, plugin in FILTER_PLUGINS:
            reason = plugin(spec, status, cluster)
            if reason is not None:
                break
        if reason is None and extra:
            reason = eval_filters(extra, eff, cluster)
        if reason is None:
            feasible.append(cluster)
        else:
            diagnosis[cluster.name] = reason
    return feasible, diagnosis


# ---------------------------------------------------------------------------
# Score plugins
# ---------------------------------------------------------------------------


def score_cluster_locality(spec: ResourceBindingSpec, cluster: Cluster) -> int:
    if not spec.clusters:
        return MIN_CLUSTER_SCORE
    if spec.target_contains(cluster.name):
        return MAX_CLUSTER_SCORE
    return MIN_CLUSTER_SCORE


def prioritize_clusters(
    spec: ResourceBindingSpec, clusters: List[Cluster],
    status: Optional[ResourceBindingStatus] = None,
) -> List[Tuple[Cluster, int]]:
    """Sum of score plugins per cluster (generic_scheduler.go:155-183).
    In-tree scorers: ClusterAffinity (always 0) + ClusterLocality; enabled
    out-of-tree registry scores add on top (clamped sum, see
    scheduler/plugins.py)."""
    from karmada_tpu_torch.scheduler.plugins import REGISTRY, eval_scores

    scorers = REGISTRY.enabled_scores()
    if not scorers:
        return [(c, MIN_CLUSTER_SCORE + score_cluster_locality(spec, c))
                for c in clusters]
    eff = effective_placement(spec, status or ResourceBindingStatus())
    return [
        (c, MIN_CLUSTER_SCORE + score_cluster_locality(spec, c)
         + eval_scores(scorers, eff, c))
        for c in clusters
    ]


# ---------------------------------------------------------------------------
# Spread-constraint grouping + selection (pkg/scheduler/core/spreadconstraint)
# ---------------------------------------------------------------------------


@dataclass
class ClusterDetailInfo:
    name: str
    score: int
    available_replicas: int  # includes already-assigned replicas
    allocatable_replicas: int  # estimator output alone
    cluster: Cluster


@dataclass
class GroupInfo:
    name: str
    score: int = 0
    available_replicas: int = 0
    clusters: List[ClusterDetailInfo] = field(default_factory=list)
    zones: set = field(default_factory=set)
    regions: set = field(default_factory=set)


@dataclass
class GroupClustersInfo:
    clusters: List[ClusterDetailInfo] = field(default_factory=list)
    providers: Dict[str, GroupInfo] = field(default_factory=dict)
    regions: Dict[str, GroupInfo] = field(default_factory=dict)
    zones: Dict[str, GroupInfo] = field(default_factory=dict)
    # spread-by-label groups (label VALUE -> group) for the placement's
    # first label constraint's key — this framework's extension beyond the
    # reference, whose scheduler never implemented SpreadByLabel
    # (select_clusters.go:55 fails it); group math mirrors regions
    labels: Dict[str, GroupInfo] = field(default_factory=dict)


def _sort_clusters(infos: List[ClusterDetailInfo]) -> None:
    """spreadconstraint/util.go sortClusters: score desc, available desc, name asc."""
    infos.sort(key=lambda c: (-c.score, -c.available_replicas, c.name))


def _label_constraint(placement: Placement) -> Optional[SpreadConstraint]:
    """First spread-by-label constraint — its key is the group axis
    (further label constraints filter only; ops/tensors.spread_axis_of)."""
    for sc in placement.spread_constraints:
        if sc.spread_by_label:
            return sc
    return None


def _spread_constraint(placement: Placement, by_field: str) -> Optional[SpreadConstraint]:
    for sc in placement.spread_constraints:
        if sc.spread_by_field == by_field:
            return sc
    return None


def should_ignore_spread_constraint(placement: Placement) -> bool:
    """select_clusters.go:57-69: static-weighted division ignores spread."""
    s = placement.replica_scheduling
    if (
        s is not None
        and s.replica_scheduling_type == REPLICA_SCHEDULING_DIVIDED
        and s.replica_division_preference == REPLICA_DIVISION_WEIGHTED
        and (
            s.weight_preference is None
            or (s.weight_preference.static_weight_list and not s.weight_preference.dynamic_weight)
        )
    ):
        return True
    return False


def should_ignore_available_resource(placement: Placement) -> bool:
    """select_clusters.go:71-80: Duplicated ignores capacity."""
    s = placement.replica_scheduling
    return s is None or s.replica_scheduling_type == REPLICA_SCHEDULING_DUPLICATED


def _is_topology_ignored(placement: Placement) -> bool:
    scs = placement.spread_constraints
    if not scs or (len(scs) == 1 and scs[0].spread_by_field == SPREAD_BY_FIELD_CLUSTER):
        return True
    return should_ignore_spread_constraint(placement)


def _calc_group_score_duplicate(
    clusters: List[ClusterDetailInfo], spec: ResourceBindingSpec
) -> int:
    """group_clusters.go:141-218."""
    target = spec.replicas
    valid = [c for c in clusters if c.available_replicas >= target]
    if not valid:
        return 0  # no valid cluster: validClusters==0 would divide by zero; score 0
    sum_valid_score = sum(c.score for c in valid)
    return len(valid) * WEIGHT_UNIT + sum_valid_score // len(valid)


def _calc_group_score(
    clusters: List[ClusterDetailInfo], spec: ResourceBindingSpec, min_groups: int
) -> int:
    """group_clusters.go:220-333."""
    placement = spec.placement
    if placement is None or placement.replica_scheduling_type() == REPLICA_SCHEDULING_DUPLICATED:
        return _calc_group_score_duplicate(clusters, spec)

    target = math.ceil(spec.replicas / float(min_groups)) if min_groups else spec.replicas
    cluster_min_groups = 0
    sc = _spread_constraint(placement, SPREAD_BY_FIELD_CLUSTER)
    if sc is not None:
        cluster_min_groups = sc.min_groups
    cluster_min_groups = max(cluster_min_groups, min_groups)

    sum_available = 0
    sum_score = 0
    valid = 0
    for c in clusters:  # clusters pre-sorted score desc
        sum_available += c.available_replicas
        sum_score += c.score
        valid += 1
        if valid >= cluster_min_groups and sum_available >= target:
            break
    if sum_available < target:
        return sum_available * WEIGHT_UNIT + sum_score // len(clusters)
    return target * WEIGHT_UNIT + sum_score // valid


def group_clusters_with_score(
    scored: List[Tuple[Cluster, int]],
    placement: Placement,
    spec: ResourceBindingSpec,
    cal_available: Callable[[List[Cluster], ResourceBindingSpec], List[TargetCluster]],
) -> GroupClustersInfo:
    """group_clusters.go:91-122 + generateClustersInfo/Zone/Region/Provider."""
    info = GroupClustersInfo()
    clusters = [c for c, _ in scored]
    replicas = cal_available(clusters, spec)
    for (cluster, score), tc in zip(scored, replicas):
        avail = tc.replicas + spec.assigned_replicas_for_cluster(tc.name)
        info.clusters.append(
            ClusterDetailInfo(
                name=cluster.name,
                score=score,
                available_replicas=avail,
                allocatable_replicas=tc.replicas,
                cluster=cluster,
            )
        )
    _sort_clusters(info.clusters)

    if _is_topology_ignored(placement):
        return info

    # zones
    if _spread_constraint(placement, SPREAD_BY_FIELD_ZONE) is not None:
        for ci in info.clusters:
            for zone in ci.cluster.zones_effective():
                g = info.zones.setdefault(zone, GroupInfo(name=zone))
                g.clusters.append(ci)
                g.available_replicas += ci.available_replicas
        mg = _spread_constraint(placement, SPREAD_BY_FIELD_ZONE).min_groups
        for g in info.zones.values():
            g.score = _calc_group_score(g.clusters, spec, mg)

    # regions
    if _spread_constraint(placement, SPREAD_BY_FIELD_REGION) is not None:
        for ci in info.clusters:
            region = ci.cluster.spec.region
            if not region:
                continue
            g = info.regions.setdefault(region, GroupInfo(name=region))
            if ci.cluster.spec.zone:
                g.zones.add(ci.cluster.spec.zone)
            g.clusters.append(ci)
            g.available_replicas += ci.available_replicas
        mg = _spread_constraint(placement, SPREAD_BY_FIELD_REGION).min_groups
        for g in info.regions.values():
            g.score = _calc_group_score(g.clusters, spec, mg)

    # label values (framework extension; group math mirrors regions)
    label_sc = _label_constraint(placement)
    if label_sc is not None:
        for ci in info.clusters:
            value = ci.cluster.metadata.labels.get(label_sc.spread_by_label)
            if not value:
                continue
            g = info.labels.setdefault(value, GroupInfo(name=value))
            g.clusters.append(ci)
            g.available_replicas += ci.available_replicas
        for g in info.labels.values():
            g.score = _calc_group_score(g.clusters, spec, label_sc.min_groups)

    # providers
    if _spread_constraint(placement, SPREAD_BY_FIELD_PROVIDER) is not None:
        for ci in info.clusters:
            provider = ci.cluster.spec.provider
            if not provider:
                continue
            g = info.providers.setdefault(provider, GroupInfo(name=provider))
            if ci.cluster.spec.zone:
                g.zones.add(ci.cluster.spec.zone)
            if ci.cluster.spec.region:
                g.regions.add(ci.cluster.spec.region)
            g.clusters.append(ci)
            g.available_replicas += ci.available_replicas
        mg = _spread_constraint(placement, SPREAD_BY_FIELD_PROVIDER).min_groups
        for g in info.providers.values():
            g.score = _calc_group_score(g.clusters, spec, mg)

    return info


# --- findFeasiblePaths DFS (select_groups.go:102-224) ----------------------


@dataclass
class _DfsGroup:
    name: str
    value: int  # e.g. number of clusters in the region
    weight: int  # group score


def select_groups(
    groups: List[_DfsGroup], min_constraint: int, max_constraint: int, target: int
) -> List[_DfsGroup]:
    """Port of selectGroups/findFeasiblePaths/prioritizePaths."""
    if not groups:
        return []
    groups = sorted(groups, key=lambda g: (g.value, -g.weight, g.name))

    paths: List[dict] = []  # {"id", "groups", "weight", "value"}
    current: List[_DfsGroup] = []
    counter = {"id": 0}

    def record() -> None:
        counter["id"] += 1
        gs = sorted(current, key=lambda g: (-g.weight, g.name))
        paths.append(
            {
                "id": counter["id"],
                "groups": gs,
                "weight": sum(g.weight for g in gs),
                "value": sum(g.value for g in gs),
            }
        )

    def dfs(total: int, begin: int) -> None:
        if total >= target and min_constraint <= len(current) <= max_constraint:
            record()
            return
        if len(current) >= max_constraint:
            return
        for i in range(begin, len(groups)):
            current.append(groups[i])
            dfs(total + groups[i].value, i + 1)
            if len(groups) == min_constraint:
                break
            current.pop()

    dfs(0, 0)
    if not paths:
        return []
    if len(paths) == 1:
        return paths[0]["groups"]

    paths.sort(key=lambda p: (-p["weight"], -p["value"], p["id"]))
    final = paths[0]

    def match_sub_path(path: dict, sub: dict) -> bool:
        if len(sub["groups"]) >= len(path["groups"]):
            return False
        return all(
            path["groups"][i].name == g.name for i, g in enumerate(sub["groups"])
        )

    for p in paths[1:]:
        if match_sub_path(final, p):
            final = p
    return final["groups"]


# --- SelectBestClusters (select_clusters*.go) -------------------------------


def select_best_clusters(
    placement: Placement, info: GroupClustersInfo, need_replicas: int
) -> List[ClusterDetailInfo]:
    if not placement.spread_constraints or should_ignore_spread_constraint(placement):
        return info.clusters
    if should_ignore_available_resource(placement):
        need_replicas = INVALID_REPLICAS
    sc_map = {sc.spread_by_field: sc for sc in placement.spread_constraints}
    if SPREAD_BY_FIELD_REGION in sc_map:
        return _select_by_region(sc_map, info)
    label_sc = _label_constraint(placement)
    if label_sc is not None:
        # framework extension: label-value groups select exactly like
        # regions (the reference fails SpreadByLabel outright)
        return _select_by_groups(
            label_sc,
            sc_map.get(SPREAD_BY_FIELD_CLUSTER, SpreadConstraint()),
            info.labels,
        )
    if SPREAD_BY_FIELD_CLUSTER in sc_map:
        return _select_by_cluster(sc_map[SPREAD_BY_FIELD_CLUSTER], info, need_replicas)
    raise UnschedulableError("just support cluster and region spread constraint")


def _select_by_cluster(
    sc: SpreadConstraint, info: GroupClustersInfo, need_replicas: int
) -> List[ClusterDetailInfo]:
    """select_clusters_by_cluster.go:25-105."""
    total = len(info.clusters)
    if total < sc.min_groups:
        raise UnschedulableError(
            "the number of feasible clusters is less than spreadConstraint.MinGroups"
        )
    # mirror select_clusters_by_cluster.go:32-35 exactly (MaxGroups is
    # validated >= MinGroups >= 1 upstream; 0 selects nothing, as in Go)
    need_cnt = sc.max_groups if total >= sc.max_groups else total
    if need_replicas == INVALID_REPLICAS:
        return info.clusters[:need_cnt]
    selected = _select_by_available_resource(list(info.clusters), need_cnt, need_replicas)
    if not selected:
        raise UnschedulableError(f"no enough resource when selecting {need_cnt} clusters")
    return selected


def _select_by_available_resource(
    candidates: List[ClusterDetailInfo], need_cnt: int, need_replicas: int
) -> List[ClusterDetailInfo]:
    ret = candidates[:need_cnt]
    rest = candidates[need_cnt:]

    def total_avail(cs: List[ClusterDetailInfo]) -> int:
        return sum(c.available_replicas for c in cs)

    update_id = len(ret) - 1
    while total_avail(ret) < need_replicas and update_id >= 0:
        # replace lowest-score retained cluster with the best remaining one
        best_id, best_avail = -1, ret[update_id].available_replicas
        for i, c in enumerate(rest):
            if c.available_replicas > best_avail:
                best_id, best_avail = i, c.available_replicas
        if best_id == -1:
            update_id -= 1
            continue
        ret[update_id], rest[best_id] = rest[best_id], ret[update_id]
        update_id -= 1
    if total_avail(ret) < need_replicas:
        return []
    return ret


def _select_by_region(
    sc_map: Dict[str, SpreadConstraint], info: GroupClustersInfo
) -> List[ClusterDetailInfo]:
    """select_clusters_by_region.go:27-118."""
    return _select_by_groups(
        sc_map[SPREAD_BY_FIELD_REGION],
        sc_map.get(SPREAD_BY_FIELD_CLUSTER, SpreadConstraint()),
        info.regions,
    )


def _select_by_groups(
    group_sc: SpreadConstraint,
    cluster_sc: SpreadConstraint,
    groups_map: Dict[str, GroupInfo],
) -> List[ClusterDetailInfo]:
    """select_clusters_by_region.go:27-118, generalized over any group map
    (regions, or label-value groups — the framework's SpreadByLabel
    extension reuses the identical selection)."""
    if len(groups_map) < group_sc.min_groups:
        raise UnschedulableError(
            "the number of feasible region is less than spreadConstraint.MinGroups"
        )
    groups = [
        _DfsGroup(name=g.name, value=len(g.clusters), weight=g.score)
        for g in groups_map.values()
    ]
    chosen = select_groups(
        groups, group_sc.min_groups, group_sc.max_groups, cluster_sc.min_groups
    )
    if not chosen:
        raise UnschedulableError(
            "the number of clusters is less than the cluster spreadConstraint.MinGroups"
        )
    picked = [groups_map[g.name] for g in chosen]
    selected: List[ClusterDetailInfo] = []
    candidates: List[ClusterDetailInfo] = []
    for r in picked:
        selected.append(r.clusters[0])
        candidates.extend(r.clusters[1:])
    need_cnt = len(candidates) + len(selected)
    # absent cluster constraint zero-values MaxGroups, capping extras to none
    # (select_clusters_by_region.go:49-52)
    if need_cnt > cluster_sc.max_groups:
        need_cnt = cluster_sc.max_groups
    rest_cnt = need_cnt - len(selected)
    if rest_cnt > 0:
        _sort_clusters(candidates)
        selected.extend(candidates[:rest_cnt])
    return selected


# ---------------------------------------------------------------------------
# Replica assignment (assignment.go + division_algorithm.go)
# ---------------------------------------------------------------------------

DUPLICATED = "Duplicated"
AGGREGATED = "Aggregated"
STATIC_WEIGHT = "StaticWeight"
DYNAMIC_WEIGHT = "DynamicWeight"

STEADY = "Steady"
FRESH = "Fresh"


def strategy_type(spec: ResourceBindingSpec) -> str:
    placement = spec.placement or Placement()
    if placement.replica_scheduling_type() == REPLICA_SCHEDULING_DUPLICATED:
        return DUPLICATED
    s = placement.replica_scheduling
    if s.replica_division_preference == REPLICA_DIVISION_AGGREGATED:
        return AGGREGATED
    if s.replica_division_preference == REPLICA_DIVISION_WEIGHTED:
        if s.weight_preference is not None and s.weight_preference.dynamic_weight:
            return DYNAMIC_WEIGHT
        return STATIC_WEIGHT
    return ""


def reschedule_required(spec: ResourceBindingSpec, status: ResourceBindingStatus) -> bool:
    """util.RescheduleRequired: a newer rescheduleTriggeredAt than the last
    schedule forces Fresh mode."""
    if spec.reschedule_triggered_at is None:
        return False
    if status.last_scheduled_time is None:
        return True
    return spec.reschedule_triggered_at > status.last_scheduled_time


@dataclass
class _AssignState:
    candidates: List[ClusterDetailInfo]
    spec: ResourceBindingSpec
    strategy: str
    mode: str
    scheduled: List[TargetCluster] = field(default_factory=list)
    assigned: int = 0
    available: List[TargetCluster] = field(default_factory=list)
    available_sum: int = 0
    target: int = 0

    def build_scheduled(self) -> None:
        names = {c.name for c in self.candidates}
        self.scheduled = [tc for tc in self.spec.clusters if tc.name in names]
        self.assigned = get_sum_of_replicas(self.scheduled)

    def resort_available(self) -> List[TargetCluster]:
        """assignment.go:145-172: previously scheduled clusters first."""
        prior = {tc.name for tc in self.scheduled if tc.replicas > 0}
        if not prior:
            return self.available
        prev = [tc for tc in self.available if tc.name in prior]
        left = [tc for tc in self.available if tc.name not in prior]
        self.available = prev + left
        return self.available


def _sort_by_replicas_desc(tcs: List[TargetCluster]) -> List[TargetCluster]:
    """TargetClustersList sort (division_algorithm.go:31-36). Stable on name
    for determinism where Go's unstable sort leaves ties unspecified."""
    return sorted(tcs, key=lambda tc: (-tc.replicas, tc.name))


def _static_weight_list(
    candidates: List[ClusterDetailInfo],
    weight_list,
) -> Dict[str, int]:
    """getStaticWeightInfoList (division_algorithm.go:38-72)."""
    weights: Dict[str, int] = {}
    for c in candidates:
        weight = 0
        for rule in weight_list:
            if rule.target_cluster.matches(c.cluster):
                weight = max(weight, rule.weight)
        if weight > 0:
            weights[c.name] = weight
    if sum(weights.values()) == 0:
        return {c.name: 1 for c in candidates}
    return weights


def _dynamic_divide(state: _AssignState) -> List[TargetCluster]:
    """dynamicDivideReplicas (division_algorithm.go:75-101)."""
    if state.available_sum < state.target:
        raise UnschedulableError(
            f"Clusters available replicas {state.available_sum} are not enough to schedule."
        )
    if state.strategy == AGGREGATED:
        state.available = state.resort_available()
        total = 0
        for i, tc in enumerate(state.available):
            total += tc.replicas
            if total >= state.target:
                state.available = state.available[: i + 1]
                break
    weights = {tc.name: tc.replicas for tc in state.available}
    result = dispense_by_weight(state.target, weights, None, state.spec.resource.uid)
    new = [TargetCluster(name=n, replicas=r) for n, r in sorted(result.items())]
    return merge_target_clusters(state.scheduled, new)


def assign_replicas(
    candidates: List[ClusterDetailInfo],
    spec: ResourceBindingSpec,
    status: ResourceBindingStatus,
) -> List[TargetCluster]:
    """AssignReplicas (core/common.go:40-78 + assignment.go strategies)."""
    if not candidates:
        raise NoClusterAvailableError("no clusters available to schedule")

    if not ((spec.replicas > 0 or spec.replica_requirements is not None) and len(spec.components) <= 1):
        # non-workloads & multi-component: propagate to all candidates
        return [TargetCluster(name=c.name, replicas=0) for c in candidates]

    strategy = strategy_type(spec)
    mode = FRESH if reschedule_required(spec, status) else STEADY
    state = _AssignState(candidates=candidates, spec=spec, strategy=strategy, mode=mode)

    if strategy == DUPLICATED:
        result = [TargetCluster(name=c.name, replicas=spec.replicas) for c in candidates]
    elif strategy == STATIC_WEIGHT:
        placement = spec.placement
        wp = placement.replica_scheduling.weight_preference
        weight_list = wp.static_weight_list if wp is not None else []
        if not weight_list:
            # defaulting: weight all candidates equally (assignment.go:196-198)
            weights = {c.name: 1 for c in candidates}
        else:
            weights = _static_weight_list(candidates, weight_list)
        result_map = dispense_by_weight(spec.replicas, weights, None, spec.resource.uid)
        result = [TargetCluster(name=n, replicas=r) for n, r in sorted(result_map.items())]
    elif strategy in (AGGREGATED, DYNAMIC_WEIGHT):
        result = _assign_dynamic(state)
    else:
        raise UnschedulableError(f"unsupported replica scheduling strategy: {strategy}")

    return [tc for tc in result if tc.replicas > 0]


def _assign_dynamic(state: _AssignState) -> List[TargetCluster]:
    """assignByDynamicStrategy (assignment.go:207-238)."""
    state.build_scheduled()
    spec = state.spec
    if state.mode == FRESH:
        return _dynamic_fresh_scale(state)
    if state.assigned > spec.replicas:
        return _dynamic_scale_down(state)
    if state.assigned < spec.replicas:
        return _dynamic_scale_up(state)
    return state.scheduled


def _dynamic_scale_down(state: _AssignState) -> List[TargetCluster]:
    """division_algorithm.go:103-119: previous result becomes the weights."""
    state.target = state.spec.replicas
    state.scheduled = []
    state.available = _sort_by_replicas_desc(list(state.spec.clusters))
    state.available_sum = get_sum_of_replicas(state.available)
    return _dynamic_divide(state)


def _dynamic_scale_up(state: _AssignState) -> List[TargetCluster]:
    """division_algorithm.go:121-136: weights = allocatable, merge with prior."""
    state.target = state.spec.replicas - state.assigned
    avail = [
        TargetCluster(name=c.name, replicas=c.allocatable_replicas)
        for c in state.candidates
    ]
    state.available = _sort_by_replicas_desc(avail)
    state.available_sum = get_sum_of_replicas(state.available)
    return _dynamic_divide(state)


def _dynamic_fresh_scale(state: _AssignState) -> List[TargetCluster]:
    """division_algorithm.go:139-166: allocatable + currently-assigned."""
    state.target = state.spec.replicas
    scheduled_by_name = {tc.name: tc.replicas for tc in state.scheduled}
    avail = [
        TargetCluster(
            name=c.name,
            replicas=c.allocatable_replicas + scheduled_by_name.get(c.name, 0),
        )
        for c in state.candidates
    ]
    state.available = _sort_by_replicas_desc(avail)
    state.available_sum = get_sum_of_replicas(state.available)
    state.scheduled = []
    return _dynamic_divide(state)


# ---------------------------------------------------------------------------
# Full pipeline
# ---------------------------------------------------------------------------


def is_multi_template_applicable(spec: ResourceBindingSpec) -> bool:
    """isMultiTemplateSchedulingApplicable (core/estimation.go:42-64): two or
    more components AND a Cluster spread constraint targeting exactly one
    cluster (MinGroups == MaxGroups == 1)."""
    if len(spec.components) < 2 or spec.placement is None:
        return False
    from karmada_tpu_torch.models.policy import SPREAD_BY_FIELD_CLUSTER

    for sc in spec.placement.spread_constraints:
        if (
            sc.spread_by_field == SPREAD_BY_FIELD_CLUSTER
            and sc.min_groups == 1
            and sc.max_groups == 1
        ):
            return True
    return False


def make_cal_available(estimators) -> Callable:
    """calAvailableReplicas (core/util.go:56-110): min across estimators,
    skipping UnauthenticReplica; non-workloads shortcut to MaxInt32.  Multi-
    template workloads (feature MultiplePodTemplatesScheduling) estimate
    whole component SETS instead (calculateMultiTemplateAvailableSets,
    estimation.go:66-103)."""

    def cal(clusters: List[Cluster], spec: ResourceBindingSpec) -> List[TargetCluster]:
        out = [TargetCluster(name=c.name, replicas=MAX_INT32) for c in clusters]
        if spec.replicas == 0 and not spec.components:
            return out
        multi_template = is_multi_template_applicable(spec)
        ests = list(estimators)
        if multi_template and not any(
            hasattr(e, "max_available_component_sets") for e in ests
        ):
            # never silently skip capacity checking: the reference registry
            # always contains the GeneralEstimator (which implements
            # MaxAvailableComponentSets); mirror that as a fallback when the
            # caller supplied only replica-style estimators
            from karmada_tpu_torch.estimator.general import GeneralEstimator

            ests.append(GeneralEstimator())
        for est in ests:
            if multi_template:
                if not hasattr(est, "max_available_component_sets"):
                    continue
                res = est.max_available_component_sets(clusters, spec.components)
            else:
                res = est.max_available_replicas(clusters, spec.replica_requirements)
            for i, tc in enumerate(res):
                if tc.replicas == -1:
                    continue
                if out[i].name == tc.name and out[i].replicas > tc.replicas:
                    out[i].replicas = tc.replicas
        # leftover MaxInt32 (no estimator authenticated a value) clamps to
        # spec.replicas to avoid overflow (core/util.go:104-109)
        for tc in out:
            if tc.replicas == MAX_INT32:
                tc.replicas = spec.replicas
        return out

    return cal


def schedule(
    spec: ResourceBindingSpec,
    status: ResourceBindingStatus,
    clusters: List[Cluster],
    cal_available: Callable[[List[Cluster], ResourceBindingSpec], List[TargetCluster]],
    *,
    enable_empty_workload_propagation: bool = False,
) -> List[TargetCluster]:
    """genericScheduler.Schedule (generic_scheduler.go:71-116)."""
    placement = spec.placement or Placement()
    feasible, diagnosis = find_clusters_that_fit(spec, status, clusters)
    if not feasible:
        raise FitError(diagnosis)
    scored = prioritize_clusters(spec, feasible, status)
    info = group_clusters_with_score(scored, placement, spec, cal_available)
    selected = select_best_clusters(placement, info, spec.replicas)
    result = assign_replicas(selected, spec, status)
    if enable_empty_workload_propagation:
        names = {tc.name for tc in result}
        result = result + [
            TargetCluster(name=c.name, replicas=0)
            for c in selected
            if c.name not in names
        ]
    return result
