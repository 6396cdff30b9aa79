"""Scenario builders shared by the tests/test_torch_*.py parity suites.

Every builder takes `M`, a namespace of one package's model classes
(`models_of("karmada_tpu")` or `models_of("karmada_tpu_torch")`), and a
`random.Random`: the same seed builds the same objects in both packages,
so the JAX reference and the PyTorch port see identical inputs.
"""

from __future__ import annotations

import dataclasses
import importlib
import random
from types import SimpleNamespace

import numpy as np

GVK = ("apps/v1", "Deployment")


def models_of(pkg: str) -> SimpleNamespace:
    ns = {}
    for mod in ("models.meta", "models.cluster", "models.policy",
                "models.work", "utils.quantity"):
        m = importlib.import_module(f"{pkg}.{mod}")
        ns.update({k: v for k, v in vars(m).items() if not k.startswith("_")})
    return SimpleNamespace(**ns)


# -- the randomized mix of tests/test_solver_batch.py -------------------------

def mk_cluster(M, rng, name):
    labels = {}
    if rng.random() < 0.5:
        labels["tier"] = rng.choice(["gold", "silver"])
    taints = []
    if rng.random() < 0.3:
        taints.append(M.Taint(key="dedicated", value="infra",
                              effect="NoSchedule"))
    summary = None
    models = []
    Q = M.Quantity
    if rng.random() < 0.9:
        summary = M.ResourceSummary(
            allocatable={
                "cpu": Q.from_milli(rng.randint(0, 64000)),
                "memory": Q.from_units(rng.randint(0, 256)),
                "pods": Q.from_units(rng.randint(0, 200)),
            },
            allocated={
                "cpu": Q.from_milli(rng.randint(0, 16000)),
                "memory": Q.from_units(rng.randint(0, 64)),
                "pods": Q.from_units(rng.randint(0, 50)),
            },
        )
        if rng.random() < 0.2:
            models = [
                M.ResourceModel(grade=0, ranges=[
                    M.ResourceModelRange("cpu", Q.from_milli(0),
                                         Q.from_milli(2000)),
                    M.ResourceModelRange("memory", Q.from_units(0),
                                         Q.from_units(8)),
                ]),
                M.ResourceModel(grade=1, ranges=[
                    M.ResourceModelRange("cpu", Q.from_milli(2000),
                                         Q.from_milli(64000)),
                    M.ResourceModelRange("memory", Q.from_units(8),
                                         Q.from_units(256)),
                ]),
            ]
            summary.allocatable_modelings = [
                M.AllocatableModeling(grade=0, count=rng.randint(0, 5)),
                M.AllocatableModeling(grade=1, count=rng.randint(0, 5)),
            ]
    enablements = ([M.APIEnablement(GVK[0], [GVK[1]])]
                   if rng.random() < 0.9 else [])
    meta = M.ObjectMeta(name=name, labels=labels)
    if rng.random() < 0.05:
        meta.deletion_timestamp = 1.0
    return M.Cluster(
        metadata=meta,
        spec=M.ClusterSpec(region=rng.choice(["us", "eu"]),
                           provider=rng.choice(["aws", ""]), taints=taints,
                           resource_models=models),
        status=M.ClusterStatus(api_enablements=enablements,
                               resource_summary=summary),
    )


def mk_placement(M, rng, names, spread_p: float = 0.4):
    affinity = None
    r = rng.random()
    if r < 0.3:
        affinity = M.ClusterAffinity(
            cluster_names=rng.sample(names, rng.randint(1, len(names))))
    elif r < 0.5:
        affinity = M.ClusterAffinity(
            label_selector=M.LabelSelector(match_labels={"tier": "gold"}))
    tolerations = []
    if rng.random() < 0.5:
        tolerations.append(M.Toleration(key="dedicated", operator="Exists"))
    spread = []
    if rng.random() < spread_p:
        mn = rng.randint(1, 3)
        spread.append(M.SpreadConstraint(
            spread_by_field=M.SPREAD_BY_FIELD_CLUSTER, min_groups=mn,
            max_groups=rng.randint(mn, 5)))
        if rng.random() < 0.3:
            spread.append(M.SpreadConstraint(
                spread_by_field=rng.choice([M.SPREAD_BY_FIELD_PROVIDER,
                                            M.SPREAD_BY_FIELD_ZONE]),
                min_groups=1, max_groups=rng.randint(1, 3)))
    strat = rng.choice(["dup", "static", "dynamic", "agg"])
    if strat == "dup":
        rs = M.ReplicaSchedulingStrategy(
            replica_scheduling_type=M.REPLICA_SCHEDULING_DUPLICATED)
    elif strat == "static":
        wl = []
        if rng.random() < 0.7:
            for nm in rng.sample(names, rng.randint(1, len(names))):
                wl.append(M.StaticClusterWeight(
                    target_cluster=M.ClusterAffinity(cluster_names=[nm]),
                    weight=rng.randint(0, 3)))
        rs = M.ReplicaSchedulingStrategy(
            replica_scheduling_type=M.REPLICA_SCHEDULING_DIVIDED,
            replica_division_preference=M.REPLICA_DIVISION_WEIGHTED,
            weight_preference=(M.ClusterPreferences(static_weight_list=wl)
                               if wl else None))
    elif strat == "dynamic":
        rs = M.ReplicaSchedulingStrategy(
            replica_scheduling_type=M.REPLICA_SCHEDULING_DIVIDED,
            replica_division_preference=M.REPLICA_DIVISION_WEIGHTED,
            weight_preference=M.ClusterPreferences(
                dynamic_weight=M.DYNAMIC_WEIGHT_AVAILABLE_REPLICAS))
    else:
        rs = M.ReplicaSchedulingStrategy(
            replica_scheduling_type=M.REPLICA_SCHEDULING_DIVIDED,
            replica_division_preference=M.REPLICA_DIVISION_AGGREGATED)
    return M.Placement(cluster_affinity=affinity,
                       cluster_tolerations=tolerations,
                       spread_constraints=spread, replica_scheduling=rs)


def mk_binding(M, rng, b, names, placements, replicas=(0, 1, 3, 10, 40)):
    reqs = None
    if rng.random() < 0.7:
        reqs = M.ReplicaRequirements(resource_request={
            "cpu": M.Quantity.from_milli(rng.choice([100, 250, 500, 1000])),
            "memory": M.Quantity.from_units(rng.choice([1, 2, 4])),
        })
    spec = M.ResourceBindingSpec(
        resource=M.ObjectReference(
            api_version=GVK[0], kind=GVK[1], namespace="default",
            name=f"app-{b}", uid=f"uid-{rng.randint(0, 10**9)}"),
        replicas=rng.choice(replicas),
        replica_requirements=reqs,
        placement=rng.choice(placements),
    )
    status = M.ResourceBindingStatus()
    if rng.random() < 0.4:
        prev = rng.sample(names, rng.randint(1, min(3, len(names))))
        spec.clusters = [M.TargetCluster(name=n, replicas=rng.randint(0, 20))
                         for n in prev]
        status.last_scheduled_time = 100.0
        if rng.random() < 0.3:
            spec.reschedule_triggered_at = 200.0
    if rng.random() < 0.15:
        spec.graceful_eviction_tasks = [
            M.GracefulEvictionTask(from_cluster=rng.choice(names))]
    return spec, status


def random_scenario(M, seed, n_clusters=11, n_bindings=24, n_placements=5,
                    spread_p=0.4):
    rng = random.Random(seed)
    names = [f"member-{i:03d}" for i in range(n_clusters)]
    clusters = [mk_cluster(M, rng, nm) for nm in names]
    placements = [mk_placement(M, rng, names, spread_p)
                  for _ in range(n_placements)]
    items = [mk_binding(M, rng, b, names, placements)
             for b in range(n_bindings)]
    return clusters, items


# -- the spread fixtures of tests/test_spread_device.py ----------------------

def mk_region_cluster(M, rng, name, region):
    c = mk_cluster(M, rng, name)
    c.spec.region = region
    if rng.random() < 0.5:
        c.spec.zones = [f"z{rng.randint(0, 2)}"]
    return c


def mk_spread_placement(M, rng, names):
    region_min = rng.randint(1, 2)
    scs = [M.SpreadConstraint(spread_by_field=M.SPREAD_BY_FIELD_REGION,
                              min_groups=region_min,
                              max_groups=rng.randint(region_min, 3))]
    if rng.random() < 0.7:
        cmin = rng.randint(1, 3)
        scs.append(M.SpreadConstraint(
            spread_by_field=M.SPREAD_BY_FIELD_CLUSTER,
            min_groups=cmin, max_groups=rng.randint(cmin, 6)))
    if rng.random() < 0.3:
        scs.append(M.SpreadConstraint(
            spread_by_field=rng.choice([M.SPREAD_BY_FIELD_PROVIDER,
                                        M.SPREAD_BY_FIELD_ZONE]),
            min_groups=1, max_groups=rng.randint(1, 3)))
    strat = rng.choice(["dup", "dynamic", "agg"])
    if strat == "dup":
        rs = M.ReplicaSchedulingStrategy(
            replica_scheduling_type=M.REPLICA_SCHEDULING_DUPLICATED)
    elif strat == "dynamic":
        rs = M.ReplicaSchedulingStrategy(
            replica_scheduling_type=M.REPLICA_SCHEDULING_DIVIDED,
            replica_division_preference=M.REPLICA_DIVISION_WEIGHTED,
            weight_preference=M.ClusterPreferences(
                dynamic_weight=M.DYNAMIC_WEIGHT_AVAILABLE_REPLICAS))
    else:
        rs = M.ReplicaSchedulingStrategy(
            replica_scheduling_type=M.REPLICA_SCHEDULING_DIVIDED,
            replica_division_preference=M.REPLICA_DIVISION_AGGREGATED)
    return M.Placement(spread_constraints=scs, replica_scheduling=rs)


RING = "topology.karmada.io/ring"


def mk_label_cluster(M, rng, name, value, key=RING):
    c = mk_cluster(M, rng, name)
    if value is not None:
        c.metadata.labels[key] = value
    return c


def mk_label_placement(M, rng, key=RING):
    gmin = rng.randint(1, 2)
    scs = [M.SpreadConstraint(spread_by_label=key, min_groups=gmin,
                              max_groups=rng.randint(gmin, 3))]
    if rng.random() < 0.7:
        cmin = rng.randint(1, 3)
        scs.append(M.SpreadConstraint(
            spread_by_field=M.SPREAD_BY_FIELD_CLUSTER,
            min_groups=cmin, max_groups=rng.randint(cmin, 6)))
    rs = M.ReplicaSchedulingStrategy(
        replica_scheduling_type=M.REPLICA_SCHEDULING_DIVIDED,
        replica_division_preference=M.REPLICA_DIVISION_WEIGHTED,
        weight_preference=M.ClusterPreferences(
            dynamic_weight=M.DYNAMIC_WEIGHT_AVAILABLE_REPLICAS),
    ) if rng.random() < 0.5 else M.ReplicaSchedulingStrategy(
        replica_scheduling_type=M.REPLICA_SCHEDULING_DUPLICATED)
    return M.Placement(spread_constraints=scs, replica_scheduling=rs)


def region_scenario(M, seed, n_clusters=13, n_bindings=16, n_regions=4):
    """test_spread_device.run_parity's default fleet and placements."""
    rng = random.Random(seed)
    names = [f"member-{i:02d}" for i in range(n_clusters)]
    regions = [f"region-{r}" for r in range(n_regions)]
    clusters = [mk_region_cluster(M, rng, nm, rng.choice(regions))
                for nm in names]
    placements = [mk_spread_placement(M, rng, names) for _ in range(4)]
    items = [mk_binding(M, rng, b, names, placements)
             for b in range(n_bindings)]
    return clusters, items


def one_cluster_regions_scenario(M, seed, n_bindings=10):
    """40 one-cluster regions (test_spread_device.py:147-156)."""
    rng = random.Random(400 + seed)
    names = [f"m-{i:02d}" for i in range(40)]
    clusters = [mk_region_cluster(M, rng, nm, f"r{i}")
                for i, nm in enumerate(names)]
    rng = random.Random(400 + seed)
    placements = [mk_spread_placement(M, rng, names) for _ in range(4)]
    items = [mk_binding(M, rng, b, names, placements)
             for b in range(n_bindings)]
    return clusters, items


def label_scenario(M, seed, n_bindings=12):
    """Spread by label over four ring values (test_spread_device.py
    :267-282)."""
    rng = random.Random(800 + seed)
    names = [f"m-{i:02d}" for i in range(14)]
    values = [f"ring-{v}" for v in range(4)]
    clusters = [
        mk_label_cluster(M, rng, nm,
                         rng.choice(values) if rng.random() < 0.85 else None)
        for nm in names]
    placements = [mk_label_placement(M, rng) for _ in range(3)]
    rng = random.Random(800 + seed)
    items = [mk_binding(M, rng, b, names, placements)
             for b in range(n_bindings)]
    return clusters, items


def spread_big_scenario(M, n=560, n_bindings=8):
    """Spread rows beyond the tier-1 caps (test_spread_device.py:170-213):
    cluster MaxGroups 100 and replicas above 64 on a 1,024-lane fleet."""
    rng = random.Random(7)
    names = [f"m-{i:03d}" for i in range(n)]
    clusters = [mk_region_cluster(M, rng, nm, f"r{i % 6}")
                for i, nm in enumerate(names)]
    dyn = M.ReplicaSchedulingStrategy(
        replica_scheduling_type=M.REPLICA_SCHEDULING_DIVIDED,
        replica_division_preference=M.REPLICA_DIVISION_WEIGHTED,
        weight_preference=M.ClusterPreferences(
            dynamic_weight=M.DYNAMIC_WEIGHT_AVAILABLE_REPLICAS))
    p_wide_sel = M.Placement(spread_constraints=[
        M.SpreadConstraint(spread_by_field=M.SPREAD_BY_FIELD_REGION,
                           min_groups=1, max_groups=3),
        M.SpreadConstraint(spread_by_field=M.SPREAD_BY_FIELD_CLUSTER,
                           min_groups=2, max_groups=100)],
        replica_scheduling=dyn)
    p_many_reps = M.Placement(spread_constraints=[
        M.SpreadConstraint(spread_by_field=M.SPREAD_BY_FIELD_REGION,
                           min_groups=1, max_groups=2),
        M.SpreadConstraint(spread_by_field=M.SPREAD_BY_FIELD_CLUSTER,
                           min_groups=2, max_groups=6)],
        replica_scheduling=M.ReplicaSchedulingStrategy(
            replica_scheduling_type=M.REPLICA_SCHEDULING_DIVIDED,
            replica_division_preference=M.REPLICA_DIVISION_AGGREGATED))
    items = [mk_binding(M, rng, b, names, [p_wide_sel, p_many_reps])
             for b in range(n_bindings)]
    for spec, _ in items:
        if spec.placement is p_many_reps:
            spec.replicas = 100 + rng.randint(0, 50)
    return clusters, items


# -- capacity-bound fixtures (after tests/test_contention.py) ----------------

def capacity_cluster(M, name, cpu_milli, region=""):
    Q = M.Quantity
    return M.Cluster(
        metadata=M.ObjectMeta(name=name),
        spec=M.ClusterSpec(region=region),
        status=M.ClusterStatus(
            api_enablements=[M.APIEnablement(GVK[0], [GVK[1]])],
            resource_summary=M.ResourceSummary(allocatable={
                "cpu": Q.from_milli(cpu_milli),
                "memory": Q.from_units(10**6),
                "pods": Q.from_units(10**6)})))


def capacity_binding(M, b, replicas, cpu_milli, placement=None):
    spec = M.ResourceBindingSpec(
        resource=M.ObjectReference(api_version=GVK[0], kind=GVK[1],
                                   namespace="default", name=f"app-{b}",
                                   uid=f"uid-{b}"),
        replicas=replicas,
        replica_requirements=M.ReplicaRequirements(resource_request={
            "cpu": M.Quantity.from_milli(cpu_milli),
            "memory": M.Quantity.from_units(0)}),
        placement=placement or M.Placement(replica_scheduling=_dynamic(M)))
    return spec, M.ResourceBindingStatus()


def region_spread_placement(M, region_max=1, cluster_max=1):
    return M.Placement(
        spread_constraints=[
            M.SpreadConstraint(spread_by_field=M.SPREAD_BY_FIELD_REGION,
                               min_groups=1, max_groups=region_max),
            M.SpreadConstraint(spread_by_field=M.SPREAD_BY_FIELD_CLUSTER,
                               min_groups=1, max_groups=cluster_max)],
        replica_scheduling=_dynamic(M))


def tight_region_scenario(M, n_bindings=11):
    """Six 2-core clusters in two regions and region-spread bindings that
    each take about one cluster's cores: which rows share a capacity wave
    decides who is placed."""
    clusters = [capacity_cluster(M, f"m{i}", 2000, f"r{i % 2}")
                for i in range(6)]
    pl = region_spread_placement(M, region_max=1, cluster_max=2)
    items = [capacity_binding(M, b, 4, 400 + 50 * (b % 3), pl)
             for b in range(n_bindings)]
    return clusters, items



# -- K5 / K6 edge cases: the branches of the spread kernels -------------------

#: spread_edge_scenario's cases, with their fleet sizes on the card and on
#: the CPU (where only the plain versions and the JAX program run)
SPREAD_EDGE_CASES = {
    "deep_walk": (600, 90),     # walks past the rounds and a sort chunk
    "exhausted": (48, 48),      # walks that run out: members, availability
    "duplicated": (200, 40),    # Duplicated rows: members fitting replicas
    "infeasible": (120, 30),    # a row with no feasible lane
    "label_many": (4100, 40),   # a label axis with G >= 4,096 (card)
    "wide_deep": (9000, 90),    # C > 8,192 lanes (card), deep walks
    "plugin_scores": (600, 90),  # deep walks, plugin scores up to 300
}


def _edge_placement(M, rng, region_min, cluster_min, cluster_max, strat,
                    label=None, names=None):
    by = (dict(spread_by_label=label) if label
          else dict(spread_by_field=M.SPREAD_BY_FIELD_REGION))
    scs = [M.SpreadConstraint(min_groups=region_min,
                              max_groups=region_min + rng.randint(0, 2),
                              **by),
           M.SpreadConstraint(spread_by_field=M.SPREAD_BY_FIELD_CLUSTER,
                              min_groups=cluster_min,
                              max_groups=cluster_max)]
    if strat == "dup":
        rs = M.ReplicaSchedulingStrategy(
            replica_scheduling_type=M.REPLICA_SCHEDULING_DUPLICATED)
    elif strat == "agg":
        rs = M.ReplicaSchedulingStrategy(
            replica_scheduling_type=M.REPLICA_SCHEDULING_DIVIDED,
            replica_division_preference=M.REPLICA_DIVISION_AGGREGATED)
    else:
        rs = _dynamic(M)
    affinity = (M.ClusterAffinity(cluster_names=names)
                if names is not None else None)
    return M.Placement(cluster_affinity=affinity, spread_constraints=scs,
                       replica_scheduling=rs)


def spread_edge_scenario(M, case, small=False):
    """A fleet and spread bindings that drive one branch of K5 / K6 (the
    fleet size of SPREAD_EDGE_CASES, the CPU one with `small`).  Clusters
    have 8 or 16 cores and bindings ask 1 core a replica, so many lanes
    share score and availability and name_rank decides their order; 40%
    of the bindings carry previous clusters (score 100, their replicas in
    the availability) and 15% an eviction task.
      deep_walk / wide_deep / plugin_scores: 3 regions, targets of
        3-2,500 replicas, so Divided walks run past the kernel's rounds
        and past a sort chunk; a target above a region's total exhausts
        it (plugin_scores adds spread_edge_scores);
      exhausted: 8 regions of ~6 clusters, cluster minimums of 4-9 and
        targets above a region's total;
      duplicated: Duplicated rows whose replicas some clusters fit;
      infeasible: rows whose affinity names no cluster (no feasible lane)
        beside ordinary rows;
      label_many: one distinct ring label value per cluster."""
    n = SPREAD_EDGE_CASES[case][1 if small else 0]
    rng = random.Random(900 + sorted(SPREAD_EDGE_CASES).index(case))
    names = [f"m-{i:05d}" for i in range(n)]
    n_regions = {"exhausted": 8, "duplicated": 4}.get(case, 3)
    clusters = []
    for i, nm in enumerate(names):
        c = capacity_cluster(M, nm, rng.choice([8000, 8000, 16000]),
                             f"region-{rng.randrange(n_regions)}")
        if case == "label_many":
            c.metadata.labels[RING] = f"ring-{i}"
        clusters.append(c)
    label = RING if case == "label_many" else None
    if case in ("deep_walk", "wide_deep", "plugin_scores"):
        pls = [_edge_placement(M, rng, rm, cm, 6, st)
               for rm, cm, st in ((1, 1, "dyn"), (1, 2, "agg"),
                                  (2, 1, "dyn"), (1, 3, "agg"))]
        reps = (3, 40, 200, 900, 2500)
    elif case == "exhausted":
        pls = [_edge_placement(M, rng, 1, cm, 12, st)
               for cm, st in ((4, "dyn"), (7, "agg"), (9, "dyn"))]
        reps = (5, 60, 400)
    elif case == "duplicated":
        pls = [_edge_placement(M, rng, 1, 1, 4, "dup"),
               _edge_placement(M, rng, 2, 2, 6, "dup"),
               _edge_placement(M, rng, 1, 2, 5, "dyn")]
        reps = (1, 8, 12, 20)
    elif case == "infeasible":
        pls = [_edge_placement(M, rng, 1, 1, 3, "dyn", names=["absent"]),
               _edge_placement(M, rng, 1, 2, 4, "agg")]
        reps = (1, 5, 30)
    else:
        pls = [_edge_placement(M, rng, 1, 1, 4, "dyn", label=label),
               _edge_placement(M, rng, 2, 2, 6, "agg", label=label),
               _edge_placement(M, rng, 1, 1, 3, "dup", label=label)]
        reps = (1, 4, 30)
    items = []
    for b in range(24):
        spec, status = capacity_binding(M, b, rng.choice(reps), 1000,
                                        rng.choice(pls))
        if rng.random() < 0.4:
            spec.clusters = [M.TargetCluster(name=nm,
                                             replicas=rng.randint(0, 20))
                             for nm in rng.sample(names, 3)]
            status.last_scheduled_time = 100.0
        if rng.random() < 0.15:
            spec.graceful_eviction_tasks = [
                M.GracefulEvictionTask(from_cluster=rng.choice(names))]
        items.append((spec, status))
    return clusters, items


def spread_edge_scores(case, shape):
    """The placements' plugin scores (pl_extra_score, `shape` [P, C]) a
    case sets on its encoded batch, else None: on plugin_scores 0-300
    from a seed, so lanes score above 100 and, with a previous cluster's
    100, above 200 -- where a spread key no longer holds its lane's
    score (K5's walk then reads the planes, not the keys)."""
    if case != "plugin_scores":
        return None
    return np.random.default_rng(31).integers(0, 301, shape).astype(np.int64)


def spread_edge_chosen(rng, B, G, n_groups):
    """Chosen groups and cluster caps for holding K6 on its branches: each
    row chooses about half of the groups that exist (at least one), and
    cluster_max cycles through 0, 1, more than any row's members, a
    random 2-8 (K6 selects in rounds) and a random 40-120 (K6's radix
    select, where the chosen groups hold more members)."""
    chosen = rng.random((B, G)) < 0.5
    chosen[:, n_groups:] = False
    chosen[np.arange(B), rng.integers(0, n_groups, B)] = True
    cmax = np.array([(0, 1, 1 << 40, int(rng.integers(2, 9)),
                      int(rng.integers(40, 121)))[i % 5]
                     for i in range(B)], np.int64)
    return chosen, cmax

# -- the big lane tier (tests/test_solver_batch.py:575-650) ------------------

def _dynamic(M):
    return M.ReplicaSchedulingStrategy(
        replica_scheduling_type=M.REPLICA_SCHEDULING_DIVIDED,
        replica_division_preference=M.REPLICA_DIVISION_WEIGHTED,
        weight_preference=M.ClusterPreferences(
            dynamic_weight=M.DYNAMIC_WEIGHT_AVAILABLE_REPLICAS))


def big_binding(M, rng, b, names, style):
    """One binding beyond the tier-1 compact caps: (0) a big replica
    count, (1) a wide cluster selection, (2) many previous clusters, (3)
    region spread with a wide cluster selection (ROUTE_DEVICE_SPREAD_BIG
    on a gather-lane fleet)."""
    ref = M.ObjectReference(api_version=GVK[0], kind=GVK[1], namespace="d",
                            name=f"a{b}", uid=f"u{b}")
    if style == 0:
        spec = M.ResourceBindingSpec(
            resource=ref, replicas=rng.randint(65, 400),
            placement=M.Placement(replica_scheduling=_dynamic(M)))
    elif style == 1:
        spec = M.ResourceBindingSpec(
            resource=ref, replicas=rng.randint(5, 60),
            placement=M.Placement(
                spread_constraints=[M.SpreadConstraint(
                    spread_by_field=M.SPREAD_BY_FIELD_CLUSTER,
                    min_groups=2, max_groups=rng.randint(65, 300))],
                replica_scheduling=M.ReplicaSchedulingStrategy(
                    replica_scheduling_type=M.REPLICA_SCHEDULING_DIVIDED,
                    replica_division_preference=(
                        M.REPLICA_DIVISION_AGGREGATED))))
    elif style == 2:
        spec = M.ResourceBindingSpec(
            resource=ref, replicas=rng.randint(30, 120),
            placement=M.Placement(replica_scheduling=_dynamic(M)),
            clusters=[M.TargetCluster(name=n, replicas=1)
                      for n in rng.sample(names, rng.randint(17, 100))])
    else:
        rmin = rng.randint(1, 3)
        spec = M.ResourceBindingSpec(
            resource=ref, replicas=rng.randint(5, 60),
            placement=M.Placement(
                spread_constraints=[
                    M.SpreadConstraint(
                        spread_by_field=M.SPREAD_BY_FIELD_REGION,
                        min_groups=rmin, max_groups=rng.randint(rmin, 3)),
                    M.SpreadConstraint(
                        spread_by_field=M.SPREAD_BY_FIELD_CLUSTER,
                        min_groups=2, max_groups=rng.randint(65, 300))],
                replica_scheduling=_dynamic(M)))
    if rng.random() < 0.4:
        spec.replica_requirements = M.ReplicaRequirements(resource_request={
            "cpu": M.Quantity.from_milli(rng.choice([100, 250]))})
    return spec, M.ResourceBindingStatus()


def big_scenario(M, seed, n_clusters=700, n_bindings=6, styles=3):
    """test_solver_batch.test_big_tier_parity's fixture: bindings of the
    first `styles` big styles in turn on a randomized fleet."""
    rng = random.Random(seed)
    names = [f"member-{i:03d}" for i in range(n_clusters)]
    clusters = [mk_cluster(M, rng, nm) for nm in names]
    items = [big_binding(M, rng, b, names, b % styles)
             for b in range(n_bindings)]
    return clusters, items


# -- the bench.py mix ----------------------------------------------------------

def build_fleet(M, rng, n_clusters):
    Q = M.Quantity
    out = []
    for i in range(n_clusters):
        out.append(M.Cluster(
            metadata=M.ObjectMeta(name=f"member-{i:05d}"),
            spec=M.ClusterSpec(region=f"r{i % 8}", provider=f"p{i % 3}"),
            status=M.ClusterStatus(
                api_enablements=[M.APIEnablement(GVK[0], [GVK[1]])],
                resource_summary=M.ResourceSummary(
                    allocatable={
                        "cpu": Q.from_milli(rng.randint(16000, 128000)),
                        "memory": Q.from_units(rng.randint(64, 512)),
                        "pods": Q.from_units(rng.randint(110, 256)),
                    },
                    allocated={
                        "cpu": Q.from_milli(rng.randint(0, 8000)),
                        "memory": Q.from_units(rng.randint(0, 32)),
                        "pods": Q.from_units(rng.randint(0, 40)),
                    },
                ),
            ),
        ))
    return out


def build_placements(M, rng, names):
    """bench.py's placement mix (bench.py:530-592): Duplicated,
    StaticWeight, DynamicWeight, Aggregated + cluster spread, and region
    spread + cluster spread on DynamicWeight (8 each)."""
    out = []

    def subset_affinity():
        k = rng.randint(3, min(24, len(names)))
        start = rng.randrange(len(names))
        return M.ClusterAffinity(
            cluster_names=[names[(start + j) % len(names)] for j in range(k)])

    for _ in range(8):
        out.append(M.Placement(
            cluster_affinity=subset_affinity(),
            replica_scheduling=M.ReplicaSchedulingStrategy(
                replica_scheduling_type=M.REPLICA_SCHEDULING_DUPLICATED)))
    for _ in range(8):
        out.append(M.Placement(
            cluster_affinity=subset_affinity(),
            replica_scheduling=M.ReplicaSchedulingStrategy(
                replica_scheduling_type=M.REPLICA_SCHEDULING_DIVIDED,
                replica_division_preference=M.REPLICA_DIVISION_WEIGHTED)))
    for _ in range(8):
        out.append(M.Placement(
            replica_scheduling=M.ReplicaSchedulingStrategy(
                replica_scheduling_type=M.REPLICA_SCHEDULING_DIVIDED,
                replica_division_preference=M.REPLICA_DIVISION_WEIGHTED,
                weight_preference=M.ClusterPreferences(
                    dynamic_weight=M.DYNAMIC_WEIGHT_AVAILABLE_REPLICAS))))
    for _ in range(8):
        out.append(M.Placement(
            spread_constraints=[M.SpreadConstraint(
                spread_by_field=M.SPREAD_BY_FIELD_CLUSTER, min_groups=2,
                max_groups=6)],
            replica_scheduling=M.ReplicaSchedulingStrategy(
                replica_scheduling_type=M.REPLICA_SCHEDULING_DIVIDED,
                replica_division_preference=M.REPLICA_DIVISION_AGGREGATED)))
    for _ in range(8):  # region spread (the device spread plane)
        rmin = rng.randint(1, 2)
        out.append(M.Placement(
            spread_constraints=[
                M.SpreadConstraint(spread_by_field=M.SPREAD_BY_FIELD_REGION,
                                   min_groups=rmin,
                                   max_groups=rng.randint(rmin, 3)),
                M.SpreadConstraint(spread_by_field=M.SPREAD_BY_FIELD_CLUSTER,
                                   min_groups=2, max_groups=6)],
            replica_scheduling=_dynamic(M)))
    return out


def build_bindings(M, rng, n_bindings, placements):
    Q = M.Quantity
    items = []
    for b in range(n_bindings):
        spec = M.ResourceBindingSpec(
            resource=M.ObjectReference(
                api_version=GVK[0], kind=GVK[1], namespace=f"ns-{b % 64}",
                name=f"app-{b}", uid=f"uid-{b}"),
            replicas=rng.choice([1, 2, 3, 5, 10, 20, 50]),
            replica_requirements=M.ReplicaRequirements(resource_request={
                "cpu": Q.from_milli(rng.choice([100, 250, 500])),
                "memory": Q.from_units(rng.choice([1, 2, 4])),
            }),
            placement=placements[b % len(placements)],
        )
        items.append((spec, M.ResourceBindingStatus()))
    return items


def build_rebalance_items(M, rng, items, names):
    """bench.py's second cycle: prev assignments plus a reschedule trigger
    on a third of the bindings (scale-up/down, steady and fresh modes)."""
    out = []
    for k, (spec, _status) in enumerate(items):
        prev_n = rng.randint(1, 4)
        start = rng.randrange(len(names))
        per = max(1, spec.replicas // prev_n)
        prev = [M.TargetCluster(name=names[(start + j) % len(names)],
                                replicas=per) for j in range(prev_n)]
        new_spec = dataclasses.replace(
            spec, clusters=prev,
            reschedule_triggered_at=(100.0 if k % 3 == 0 else None))
        out.append((new_spec, M.ResourceBindingStatus()))
    return out


def bench_scenario(M, seed, n_clusters, n_bindings):
    rng = random.Random(seed)
    clusters = build_fleet(M, rng, n_clusters)
    names = [c.name for c in clusters]
    placements = build_placements(M, rng, names)
    items = build_bindings(M, rng, n_bindings, placements)
    return clusters, items, rng, names


# -- the explain plane: every verdict stage (tests/test_explain.py:58-180) -----

def explain_cluster(M, name, cpu_milli=64_000, pods=100, labels=None,
                    taints=(), api=True, provider="aws", region="us",
                    deleting=False):
    meta = M.ObjectMeta(name=name, labels=dict(labels or {"tier": "gold"}))
    if deleting:
        meta.deletion_timestamp = 1.0
    Q = M.Quantity
    return M.Cluster(
        metadata=meta,
        spec=M.ClusterSpec(region=region, provider=provider,
                           taints=list(taints)),
        status=M.ClusterStatus(
            api_enablements=([M.APIEnablement(GVK[0], [GVK[1]])] if api
                             else []),
            resource_summary=M.ResourceSummary(
                allocatable={"cpu": Q.from_milli(cpu_milli),
                             "pods": Q.from_units(pods)},
                allocated={})))


def explain_spec(M, placement, name, replicas=5, evict_from=(),
                 prev=None, cpu_milli=100):
    return M.ResourceBindingSpec(
        resource=M.ObjectReference(api_version=GVK[0], kind=GVK[1],
                                   namespace="default", name=name,
                                   uid=f"uid-{name}"),
        replicas=replicas,
        replica_requirements=M.ReplicaRequirements(resource_request={
            "cpu": M.Quantity.from_milli(cpu_milli)}),
        placement=placement,
        clusters=[M.TargetCluster(name=n, replicas=r)
                  for n, r in (prev or [])],
        graceful_eviction_tasks=[M.GracefulEvictionTask(from_cluster=c)
                                 for c in evict_from])


PLUGIN_REJECTS = "m-plug"  # the cluster the tests' filter plugin rejects


def explain_scenario(M):
    """Clusters and bindings that together set all nine verdict bits: API
    enablement, toleration, affinity, spread property (provider),
    eviction, plugin filter (with the tests' plugin registered), capacity
    (an unschedulable binding and an empty cluster), not-selected
    (cluster MaxGroups 2 over more feasible clusters) and cluster-gone (a
    deleting cluster and the padding lanes); plus previous assignments
    (the locality score and the prev bypass) and a non-workload row."""
    clusters = [
        explain_cluster(M, "m-ok1"),
        explain_cluster(M, "m-ok2", cpu_milli=8_000),
        explain_cluster(M, "m-ok3", pods=3),
        explain_cluster(M, "m-noapi", api=False),
        explain_cluster(M, "m-taint", taints=[M.Taint(
            key="dedicated", value="infra", effect="NoSchedule")]),
        explain_cluster(M, "m-aff", labels={"tier": "silver"}),
        explain_cluster(M, "m-noprov", provider=""),
        explain_cluster(M, "m-evict"),
        explain_cluster(M, PLUGIN_REJECTS),
        explain_cluster(M, "m-del", deleting=True),
        explain_cluster(M, "m-empty", cpu_milli=0, pods=0),
    ]
    divided = M.ReplicaSchedulingStrategy(
        replica_scheduling_type=M.REPLICA_SCHEDULING_DIVIDED,
        replica_division_preference=M.REPLICA_DIVISION_WEIGHTED,
        weight_preference=M.ClusterPreferences(
            dynamic_weight=M.DYNAMIC_WEIGHT_AVAILABLE_REPLICAS))
    every_stage = M.Placement(
        cluster_affinity=M.ClusterAffinity(
            label_selector=M.LabelSelector(match_labels={"tier": "gold"})),
        spread_constraints=[
            M.SpreadConstraint(spread_by_field=M.SPREAD_BY_FIELD_CLUSTER,
                               min_groups=1, max_groups=2),
            M.SpreadConstraint(spread_by_field=M.SPREAD_BY_FIELD_PROVIDER,
                               min_groups=1, max_groups=2)],
        replica_scheduling=divided)
    cluster_spread = M.Placement(
        spread_constraints=[M.SpreadConstraint(
            spread_by_field=M.SPREAD_BY_FIELD_CLUSTER, min_groups=1,
            max_groups=2)],
        replica_scheduling=divided)
    plain = M.Placement(replica_scheduling=divided)
    dup = M.Placement(replica_scheduling=M.ReplicaSchedulingStrategy(
        replica_scheduling_type=M.REPLICA_SCHEDULING_DUPLICATED))
    st = M.ResourceBindingStatus
    items = [
        (explain_spec(M, every_stage, "every", evict_from=["m-evict"]), st()),
        (explain_spec(M, cluster_spread, "spread", replicas=6), st()),
        (explain_spec(M, plain, "too-big", replicas=100_000), st()),
        (explain_spec(M, plain, "prev", replicas=4,
                      prev=[("m-taint", 2), ("m-ok2", 1)]), st()),
        (explain_spec(M, dup, "dup", replicas=2), st()),
        (explain_spec(M, plain, "nw", replicas=0), st()),
        (explain_spec(M, cluster_spread, "evicting", replicas=3,
                      evict_from=["m-ok1", "m-ok2"]), st()),
        (explain_spec(M, plain, "heavy", replicas=30, cpu_milli=2_000),
         st()),
    ]
    return clusters, items


def explain_edge_scenario(M):
    """explain_scenario plus the rows K7's design branches on: a row whose
    four prev entries explain_edge_batch turns into duplicate lanes, an
    evict lane that is also a prev lane, a row it marks invalid, one it
    gives the non-workload shortcut, one on the class whose capacity it
    makes MAX_INT32, and a Duplicated row with prev lanes."""
    clusters, items = explain_scenario(M)
    plain = M.Placement(replica_scheduling=M.ReplicaSchedulingStrategy(
        replica_scheduling_type=M.REPLICA_SCHEDULING_DIVIDED,
        replica_division_preference=M.REPLICA_DIVISION_WEIGHTED,
        weight_preference=M.ClusterPreferences(
            dynamic_weight=M.DYNAMIC_WEIGHT_AVAILABLE_REPLICAS)))
    dup = M.Placement(replica_scheduling=M.ReplicaSchedulingStrategy(
        replica_scheduling_type=M.REPLICA_SCHEDULING_DUPLICATED))
    st = M.ResourceBindingStatus
    items += [
        (explain_spec(M, plain, "dups", replicas=4, prev=[
            ("m-ok1", 1), ("m-ok2", 2), ("m-ok3", 1), ("m-taint", 1)]), st()),
        (explain_spec(M, plain, "evprev", replicas=3,
                      prev=[("m-ok1", 2), ("m-noapi", 1)],
                      evict_from=["m-ok1"]), st()),
        (explain_spec(M, plain, "invalid", replicas=2), st()),
        (explain_spec(M, plain, "shortcut", replicas=2), st()),
        (explain_spec(M, plain, "free", replicas=3, cpu_milli=700), st()),
        (explain_spec(M, dup, "dup-prev", replicas=2,
                      prev=[("m-ok1", 2), ("m-noapi", 2)]), st()),
    ]
    return clusters, items


def explain_edge_batch(M, T, estimator):
    """explain_edge_scenario encoded by package T (explain=True), then
    shaped alike for either package: the "dups" row's four prev entries
    name two lanes twice each (m-ok1, m-ok2); the "invalid" row has
    b_valid False; the "shortcut" row nw_shortcut True; the "free" row's
    class (its own: 700 milli CPU) requests nothing and two clusters
    allow 2^40 pods, so its est there is MAX_INT32 (avail_cal becomes the
    row's replicas).  "evprev" keeps m-ok1 as both a prev and an evict
    lane, and explain_scenario's "too-big" row comes out UNSCHEDULABLE."""
    clusters, items = explain_edge_scenario(M)
    cindex = T.ClusterIndex.build(clusters)
    b = T.encode_batch(items, cindex, estimator, explain=True)
    row = {it[0].resource.name: i for i, it in enumerate(items)}
    lane = cindex.index

    def edit(f, fn):
        a = np.array(getattr(b, f))
        fn(a)
        setattr(b, f, a)

    def dups(a):
        a[row["dups"]] = [lane["m-ok1"], lane["m-ok1"], lane["m-ok2"],
                          lane["m-ok2"]]

    def free_class(a):
        a[b.class_id[row["free"]]] = 0

    def pods(a):
        a[[lane["m-ok1"], lane["m-ok3"]]] = 1 << 40

    edit("prev_idx", dups)
    edit("b_valid", lambda a: a.__setitem__(row["invalid"], False))
    edit("nw_shortcut", lambda a: a.__setitem__(row["shortcut"], True))
    edit("req_milli", free_class)
    edit("req_pods", free_class)
    edit("pods_allowed", pods)
    return b, row, lane


def spread_explain_edge_batch(M, T, estimator):
    """region_scenario(M, 3) encoded by package T (explain=True), shaped
    alike for either package for K7's spread flavour: row 1's two prev
    entries name one lane twice, row 3's first prev lane is also its
    evict lane, row 4 takes the non-workload shortcut, and row 10's class
    requests nothing while two clusters allow 2^40 pods (est MAX_INT32
    there)."""
    clusters, items = region_scenario(M, 3)
    b = T.encode_batch(items, T.ClusterIndex.build(clusters), estimator,
                       explain=True)

    def edit(f, fn):
        a = np.array(getattr(b, f))
        fn(a)
        setattr(b, f, a)

    def prev(a):
        a[1, 1] = a[1, 0]

    def evict(a):
        a[3, 0] = b.prev_idx[3, 0]

    def free_class(a):
        a[b.class_id[10]] = 0

    edit("prev_idx", prev)
    edit("evict_idx", evict)
    edit("nw_shortcut", lambda a: a.__setitem__(4, True))
    edit("req_milli", free_class)
    edit("req_pods", free_class)
    edit("pods_allowed", lambda a: a.__setitem__([0, 5], 1 << 40))
    return b, items


def plugin_filter(placement, cluster):
    """The filter plugin explain_scenario's tests register in both
    packages: rejects one cluster by name."""
    return ("plugin rejected this cluster"
            if cluster.metadata.name == PLUGIN_REJECTS else None)


# -- the shortlist plane (tests/test_shortlist.py) -----------------------------

def affinity_placements(M, rng, names, n=12, lo=3, hi=16):
    """Device-routed strategy mix over affinity subsets (the shape whose
    eligible sets a small k covers): Duplicated, StaticWeight, and
    DynamicWeight-Divided, all restricted to [lo, hi] clusters."""
    out = []
    for j in range(n):
        k = rng.randint(lo, min(hi, len(names)))
        start = rng.randrange(len(names))
        picked = [names[(start + i) % len(names)] for i in range(k)]
        aff = M.ClusterAffinity(cluster_names=picked)
        if j % 3 == 0:
            rs = M.ReplicaSchedulingStrategy(
                replica_scheduling_type="Duplicated")
        elif j % 3 == 1:
            rs = M.ReplicaSchedulingStrategy(
                replica_scheduling_type=M.REPLICA_SCHEDULING_DIVIDED,
                replica_division_preference=M.REPLICA_DIVISION_WEIGHTED)
        else:
            rs = _dynamic(M)
        out.append(M.Placement(cluster_affinity=aff, replica_scheduling=rs))
    return out


def shortlist_items(M, rng, n, placements, prev_of=None):
    items = build_bindings(M, rng, n, placements)
    for b, targets in (prev_of or {}).items():
        items[b][0].clusters = [M.TargetCluster(name=nm, replicas=rep)
                                for nm, rep in targets]
    return items


def build_megafleet(M, rng, n_clusters, n_regions):
    """bench.py build_megafleet: `n_clusters` clusters round-robined into
    `n_regions` regions, and one Divided/DynamicWeight placement per
    region whose affinity names exactly that region's clusters."""
    clusters = build_fleet(M, rng, n_clusters)
    for i, c in enumerate(clusters):
        c.spec.region = f"r{i % n_regions}"
    by_region = {}
    for c in clusters:
        by_region.setdefault(c.spec.region, []).append(c.metadata.name)
    placements = [
        M.Placement(cluster_affinity=M.ClusterAffinity(
            cluster_names=by_region[r]), replica_scheduling=_dynamic(M))
        for r in sorted(by_region, key=lambda s: int(s[1:]))]
    return clusters, placements


def build_mega_bindings(M, rng, n, placements, block):
    """bench.py build_mega_bindings: 9 shared request classes, replicas
    1-3, the placement advancing every `block` bindings."""
    Q = M.Quantity
    reqs = [M.ReplicaRequirements(resource_request={
        "cpu": Q.from_milli(cpu), "memory": Q.from_units(mem)})
        for cpu in (100, 250, 500) for mem in (1, 2, 4)]
    status = M.ResourceBindingStatus()
    items = []
    for b in range(n):
        pl = placements[(b // max(block, 1)) % len(placements)]
        spec = M.ResourceBindingSpec(
            resource=M.ObjectReference(
                api_version=GVK[0], kind=GVK[1], namespace=f"ns-{b % 64}",
                name=f"mega-{b}", uid=f"uid-mega-{b}"),
            replicas=rng.choice([1, 2, 3]),
            replica_requirements=reqs[rng.randrange(len(reqs))],
            placement=pl)
        items.append((spec, status))
    return items


# -- the incremental roster of tests/test_incremental_solve.py ---------------

def as_bindings(M, items, tag=""):
    """ResourceBinding objects around (spec, status) items, resourceVersion
    1: the incremental roster is binding-addressed (keys, rvs, in-place
    write-back)."""
    return [M.ResourceBinding(
        metadata=M.ObjectMeta(namespace=spec.resource.namespace,
                              name=f"{tag}{spec.resource.name}",
                              resource_version=1),
        spec=spec, status=status) for spec, status in items]


def churn(CycleDeltas, rng, clusters, bindings, n_rows, n_caps=0):
    """One watch window (test_incremental_solve._churn): bump n_rows
    bindings' replica targets and n_caps clusters' reported pod capacity;
    returns the CycleDeltas of the touched bindings (cluster churn rides
    the resident plane's own rv sweep)."""
    touched = []
    for pos in rng.sample(range(len(bindings)), n_rows):
        rb = bindings[pos]
        rb.spec.replicas = max(1, rb.spec.replicas + rng.choice((-1, 1)))
        rb.metadata.resource_version += 1
        touched.append((rb.namespace, rb.name))
    for c in rng.sample(clusters, n_caps):
        q = c.status.resource_summary.allocatable["pods"]
        c.status.resource_summary.allocatable["pods"] = (
            type(q).from_units(max(8, int(q.value()) + rng.choice(
                (-4, 4)))))
        c.metadata.resource_version += 1
    return CycleDeltas(bindings_touched=touched)


def slot_store(rng, cap, Kp, Ke, C, P=16):
    """A random binding-row slot store (the resident plane's
    GATHER_FIELDS, numpy) from a numpy Generator: every route, -1 padded
    prev/evict lanes, and nonzero prev values under -1 lanes (the sub
    gather must zero those)."""
    return {
        "placement_id": rng.integers(0, P, cap).astype("int32"),
        "gvk_id": rng.integers(0, 3, cap).astype("int32"),
        "class_id": rng.integers(-1, 5, cap).astype("int32"),
        "replicas": rng.integers(0, 12, cap).astype("int64"),
        "uid_desc": rng.random(cap) < 0.5,
        "fresh": rng.random(cap) < 0.3,
        "non_workload": rng.random(cap) < 0.1,
        "nw_shortcut": rng.random(cap) < 0.1,
        "route": rng.choice([0, 0, 0, 6, 8, 1], cap).astype("int32"),
        "prev_idx": rng.integers(-1, C, (cap, Kp)).astype("int32"),
        "prev_val": rng.integers(0, 6, (cap, Kp)).astype("int32"),
        "evict_idx": rng.integers(-1, C, (cap, Ke)).astype("int32"),
    }


# -- the control plane and the rebalance loop ----------------------------------

class FakeClock:
    """An injectable clock (the queue's, the plane's, the eviction
    controller's): time moves only when a test advances it."""

    def __init__(self, t=1_000.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, s):
        self.t += s


def pods_cluster(M, name, pods, cpu_milli=512_000, region="r0"):
    """A cluster whose binding constraint is its pod count (nothing
    allocated): the rebalance detect's capacity is exactly `pods`."""
    Q = M.Quantity
    return M.Cluster(
        metadata=M.ObjectMeta(name=name),
        spec=M.ClusterSpec(region=region),
        status=M.ClusterStatus(
            api_enablements=[M.APIEnablement(GVK[0], [GVK[1]])],
            resource_summary=M.ResourceSummary(
                allocatable={"cpu": Q.from_milli(cpu_milli),
                             "memory": Q.from_units(4096),
                             "pods": Q.from_units(pods)},
                allocated={})))


def control_fleet(M, rng, n_clusters, pods=(300, 600)):
    return [pods_cluster(M, f"m{i:03d}", rng.randint(*pods),
                         region=f"r{i % 3}") for i in range(n_clusters)]


def control_placements(M, rng, names):
    """The mix a control-plane run schedules: DynamicWeight, Aggregated
    and StaticWeight Divided placements (the rebalance plane drains
    these), Duplicated on a subset (never drained), a region spread, and
    a two-term ClusterAffinities placement whose first term names a
    cluster that does not exist (the affinity-failover loop)."""
    k = max(2, len(names) // 3)
    sub = sorted(rng.sample(names, k))
    return [
        M.Placement(replica_scheduling=_dynamic(M)),
        M.Placement(replica_scheduling=M.ReplicaSchedulingStrategy(
            replica_scheduling_type=M.REPLICA_SCHEDULING_DIVIDED,
            replica_division_preference=M.REPLICA_DIVISION_AGGREGATED)),
        M.Placement(cluster_affinity=M.ClusterAffinity(cluster_names=sub),
                    replica_scheduling=M.ReplicaSchedulingStrategy(
                        replica_scheduling_type=M.REPLICA_SCHEDULING_DIVIDED,
                        replica_division_preference=(
                            M.REPLICA_DIVISION_WEIGHTED))),
        M.Placement(cluster_affinity=M.ClusterAffinity(
            cluster_names=sub[:2]),
            replica_scheduling=M.ReplicaSchedulingStrategy(
                replica_scheduling_type=M.REPLICA_SCHEDULING_DUPLICATED)),
        region_spread_placement(M, region_max=2, cluster_max=4),
        M.Placement(
            cluster_affinities=[
                M.ClusterAffinityTerm(
                    affinity_name="primary",
                    affinity=M.ClusterAffinity(cluster_names=["gone"])),
                M.ClusterAffinityTerm(
                    affinity_name="backup",
                    affinity=M.ClusterAffinity(cluster_names=sub))],
            replica_scheduling=_dynamic(M)),
    ]


def control_bindings(M, rng, n, placements, replicas=(1, 2, 3, 5, 8, 13)):
    """ResourceBindings (namespace/name keyed, as a store holds them)
    over `placements` round-robin, with schedule priorities 0-2."""
    out = []
    for b in range(n):
        spec = M.ResourceBindingSpec(
            resource=M.ObjectReference(
                api_version=GVK[0], kind=GVK[1], namespace=f"ns{b % 4}",
                name=f"app-{b:04d}", uid=f"uid-{b}"),
            replicas=rng.choice(replicas),
            replica_requirements=M.ReplicaRequirements(resource_request={
                "cpu": M.Quantity.from_milli(rng.choice([100, 250, 500])),
                "memory": M.Quantity.from_units(rng.choice([1, 2]))}),
            placement=placements[b % len(placements)],
            schedule_priority=rng.choice([None, 0, 1, 2]))
        out.append(M.ResourceBinding(
            metadata=M.ObjectMeta(namespace=spec.resource.namespace,
                                  name=spec.resource.name),
            spec=spec))
    return out


def crush(M, store, name, held, share_milli=600):
    """Cut a cluster's allocatable pods to share_milli/1000 of the
    replicas it holds, its member reporting those replicas' pods as
    allocated (a capacity flap that overcommits it and leaves the
    estimator no room there)."""
    pods = held * share_milli // 1000

    def fn(c):
        s = c.status.resource_summary
        s.allocatable["pods"] = M.Quantity.from_units(pods)
        s.allocated["pods"] = M.Quantity.from_units(held)
    store.mutate(M.Cluster.KIND, "", name, fn)
    return pods


def committed_by_cluster(bindings):
    out = {}
    for rb in bindings:
        for t in rb.spec.clusters:
            out[t.name] = out.get(t.name, 0) + t.replicas
    return out


def report_allocated(M, store):
    """A member-status refresh: every cluster reports the replicas its
    bindings place there as allocated pods (one update per cluster whose
    report changes)."""
    held = committed_by_cluster(store.list(M.ResourceBinding.KIND))
    for c in store.list(M.Cluster.KIND):
        s = c.status.resource_summary
        cur = s.allocated.get("pods")
        want = held.get(c.name, 0)
        if cur is not None and int(cur.value()) == want:
            continue

        def fn(obj, want=want):
            obj.status.resource_summary.allocated["pods"] = (
                M.Quantity.from_units(want))
        store.mutate(M.Cluster.KIND, "", c.name, fn)


def placements_of(store, kind="ResourceBinding"):
    """Per binding key: targets, Scheduled conditions (type, status,
    reason), generation, observed generation and observed affinity."""
    return {(rb.namespace, rb.name): (
        [(t.name, t.replicas) for t in rb.spec.clusters],
        [(c.type, c.status, c.reason) for c in rb.status.conditions],
        rb.metadata.generation, rb.status.scheduler_observed_generation,
        rb.status.scheduler_observed_affinity_name)
        for rb in store.list(kind)}


# -- the fused mirror-sync scatter (ops/resident_update.scatter_fields) -------

#: scatter_case names: mixed dtypes and layouts, one lane list shared by
#: twelve fields, duplicate lanes with equal values, more entries than one
#: K10 table holds (16), and the two mirror syncs' own shapes
SCATTER_CASES = ("mixed", "shared_lanes", "duplicates", "split",
                 "slot_store", "cluster_side")


def _scatter_values(g, dtype, shape):
    import numpy as np

    if dtype is np.bool_:
        return g.random(shape) < 0.5
    return g.integers(-(1 << 40) if dtype is np.int64 else -999, 1 << 20,
                      shape).astype(dtype)


def scatter_entry(g, dtype, mode, D, L, other=3, lanes=None):
    """One (dst, lanes, values, mode) scatter from a numpy Generator: a
    numpy destination ([D] or [D, other] rows, [other, D] columns) and L
    distinct sorted int64 lanes (or `lanes`) with new values."""
    import numpy as np

    if mode == "rows":
        shape = (D,) if other == 0 else (D, other)
    else:
        shape = (other, D)
    dst = _scatter_values(g, dtype, shape)
    if lanes is None:
        lanes = np.sort(g.choice(D, L, replace=False)).astype(np.int64)
    vshape = ((len(lanes),) + shape[1:] if mode == "rows"
              else (other, len(lanes)))
    return dst, lanes, _scatter_values(g, dtype, vshape), mode


def scatter_case(name, g):
    """The (dst, lanes, values, mode) items of one SCATTER_CASES case."""
    import numpy as np

    b, i32, i64 = np.bool_, np.int32, np.int64
    if name == "mixed":
        # every dtype in both layouts, a lane list each; L = 1 and L not a
        # power of two among them
        spec = [(b, "rows", 1, 1), (i32, "rows", 7, 2), (i64, "rows", 13, 3),
                (b, "cols", 5, 4), (i32, "cols", 1, 1), (i64, "cols", 24, 2),
                (i64, "rows", 3, 0)]
        return [scatter_entry(g, dt, mode, 64 + 8 * k, L, other=o)
                for k, (dt, mode, L, o) in enumerate(spec)]
    if name == "shared_lanes":
        lanes = np.sort(g.choice(256, 37, replace=False)).astype(np.int64)
        return [scatter_entry(g, (b, i32, i64)[k % 3], "rows", 256, 0,
                              other=(0, 4, 2)[k % 3], lanes=lanes)
                for k in range(12)]
    if name == "duplicates":
        out = []
        for dt, mode in ((i64, "rows"), (b, "cols"), (i32, "rows")):
            dst, lanes, vals, _ = scatter_entry(g, dt, mode, 40, 6)
            dup = [0, 3, 3]
            vals = (np.concatenate([vals, vals[dup]]) if mode == "rows"
                    else np.concatenate([vals, vals[:, dup]], axis=1))
            out.append((dst, np.concatenate([lanes, lanes[dup]]), vals, mode))
        return out
    if name == "split":
        return [scatter_entry(g, (b, i32, i64)[k % 3], ("rows", "cols")[k % 2],
                              50, 1 + k, other=2) for k in range(20)]
    if name == "slot_store":
        # the slot store's twelve fields at 1,024 churned slots of 16,384
        store = slot_store(g, 1 << 14, 4, 4, 10_000)
        lanes = np.sort(g.choice(1 << 14, 1024, replace=False)).astype(i64)
        out = []
        for arr in store.values():
            new = slot_store(g, len(lanes), 4, 4, 10_000)
            vals = next(v for v in new.values() if v.dtype == arr.dtype
                        and v.shape[1:] == arr.shape[1:])
            out.append((arr, lanes, vals, "rows"))
        return out
    assert name == "cluster_side", name
    # the cluster-side sync's scatterable fields at 64 churned lanes of a
    # 10,000-lane fleet (4 resources, 9 request classes, 3 GVKs)
    C = 10_000
    lanes = np.sort(g.choice(C, 64, replace=False)).astype(np.int64)
    spec = [(b, "rows", 0), (b, "rows", 0), (i64, "rows", 0),
            (i64, "rows", 0), (b, "rows", 0), (i64, "rows", 4),
            (b, "rows", 4), (i64, "cols", 9), (b, "cols", 3)]
    return [scatter_entry(g, dt, mode, C, 0, other=o, lanes=lanes)
            for dt, mode, o in spec]


def fused_plane_syncs(M, device, n_windows=4):
    """A fused resident plane of the port on `device` under its
    incremental solver (300 clusters, 384 bindings, the shortlist armed):
    adopt, then `n_windows` churn windows of bindings and cluster
    capacity, the last with a forced audit that must be "ok".  After every
    cycle each slot-store and cluster-side mirror must equal a fresh
    place_slot of its master.  Returns, per mirror sync, (the sync's
    class name, its deltas of resident_gather.COUNTS and of K10's launch
    counter)."""
    import torch

    from karmada_tpu_torch.estimator.general import GeneralEstimator
    from karmada_tpu_torch.ops import kernels
    from karmada_tpu_torch.ops import resident_gather as RG
    from karmada_tpu_torch.ops import shortlist as SL
    from karmada_tpu_torch.resident import ResidentState
    from karmada_tpu_torch.resident import state as ST
    from karmada_tpu_torch.resident.deltas import CycleDeltas
    from karmada_tpu_torch.scheduler.incremental import IncrementalSolver

    SL.reset_for_tests()
    rng = random.Random(5)
    clusters, pls = build_megafleet(M, rng, 300, 12)
    bindings = as_bindings(M, build_mega_bindings(M, rng, 384, pls, 128))
    state = ResidentState(audit_interval=0, fused=True, device=device)
    solver = IncrementalSolver(state, GeneralEstimator(), chunk=128,
                               audit_every=0,
                               shortlist=SL.ShortlistConfig(k=32,
                                                            min_cells=0))
    per_sync = []

    def spied(cls, orig):
        def sync(self, *a):
            c0, k0 = dict(RG.COUNTS), kernels.LAUNCHES["scatter_lanes"]
            out = orig(self, *a)
            per_sync.append((cls.__name__,
                             {k: RG.COUNTS[k] - c0[k] for k in c0},
                             kernels.LAUNCHES["scatter_lanes"] - k0))
            return out
        return sync

    origs = {cls: cls.sync for cls in (ST._DeviceRows, ST._DevicePlane)}
    for cls, orig in origs.items():
        cls.sync = spied(cls, orig)
    try:
        solver.adopt(clusters, bindings)
        solver.write_back()
        for window in range(n_windows):
            deltas = churn(CycleDeltas, rng, clusters, bindings, 9,
                           n_caps=window % 3)
            rep = solver.cycle(clusters, bindings, deltas,
                               force_audit=window == n_windows - 1)
            solver.write_back()
            p = state.plane
            assert state.stats()["fused"]["rows_synced"]
            for f in ST.DEVICE_SLOT_FIELDS:
                assert torch.equal(state.device_rows.mirrors[f].cpu(),
                                   RG.place_slot(getattr(p, f), "cpu")), f
            for f in ST.CLUSTER_SIDE_FIELDS:
                assert state.device_mirrors.np_refs[f] is getattr(p, f)
                assert torch.equal(state.device_mirrors.mirrors[f].cpu(),
                                   RG.place_slot(getattr(p, f), "cpu")), f
        assert rep.audit_outcome == "ok"
    finally:
        for cls, orig in origs.items():
            cls.sync = orig
    return per_sync


# -- K3 compact and K2 std's gather select (test_torch_select_compact.py) ---

#: K3 cases: name -> (B, C)
COMPACT_CASES = {"empty": (8, 1024), "full": (6, 700), "odd_tail": (7, 5000),
                 "one_row": (1, 9000), "non_workload": (12, 600),
                 "mixed": (40, 1536)}


def compact_case(name, seed=0, shape=None):
    """K3's operands (rep int64 [B, C], sel bool [B, C], status int32 [B],
    non_workload bool [B]) as numpy, from a seed: `empty` wants nothing
    (nnz 0 whatever keep_sel), `full` every lane (rep > 0 everywhere),
    `odd_tail` C = 5,000 with B*C a multiple of neither K3's tile (4,096)
    nor a warp's span (512), `one_row` one row, `non_workload` every other
    row wholly non-workload (a selection and no replicas), `mixed` random;
    `shape` overrides the case's (B, C)."""
    B, C = shape or COMPACT_CASES[name]
    g = np.random.default_rng(seed)
    rep = np.where(g.random((B, C)) < 0.1, g.integers(1, 60, (B, C)), 0)
    sel = g.random((B, C)) < 0.3
    nw = g.random(B) < 0.25
    if name == "empty":
        rep[:] = 0
        sel[:] = False
    elif name == "full":
        rep = g.integers(1, 60, (B, C))
    elif name == "non_workload":
        nw[:] = False
        nw[::2] = True
        rep[nw] = 0
    status = g.integers(0, 4, B).astype(np.int32)
    return rep.astype(np.int64), sel, status, nw


#: K2 std gather-path cases (select_case)
SELECT_CASES = ("c529", "c700", "extra", "short_groups", "overflow",
                "prev_evict_uid")

#: a batch's lane-axis fields: [C], [C, R] and [X, C]
_LANES_1D = ("cluster_valid", "deleting", "name_rank", "pods_allowed",
             "has_summary", "region_id")
_LANES_ROWS = ("avail_milli", "has_alloc")
_LANES_COLS = ("api_ok", "est_override", "pl_mask", "pl_tol_bypass",
               "pl_static_w", "pl_extra_score", "pl_fail_bits")


def narrow_lanes(batch, C):
    """The batch on its first C lanes (n_clusters <= C: only padding lanes
    go): a lane count that the encoder, which pads to a power of two,
    never makes."""
    assert batch.n_clusters <= C <= batch.C
    kw = {"C": C}
    for f in _LANES_1D + _LANES_ROWS:
        if getattr(batch, f, None) is not None:
            kw[f] = getattr(batch, f)[:C]
    for f in _LANES_COLS:
        if getattr(batch, f, None) is not None:
            kw[f] = getattr(batch, f)[:, :C]
    return dataclasses.replace(batch, **kw)


def overflow_scenario(M, n_clusters=700, n_bindings=24):
    """Lanes whose gather keys share their high bits: identical clusters
    but two far larger ones, StaticWeight placements with equal weights
    (in one, a weight past the keys' 2^34 clamp on one cluster), so a
    group's boundary bucket holds more candidates than K2 std's
    shared-memory room (256) digit after digit."""
    names = [f"member-{i:04d}" for i in range(n_clusters)]
    big = {n_clusters // 7, n_clusters // 2}
    clusters = [capacity_cluster(M, nm, 10**9 if i in big else 64_000)
                for i, nm in enumerate(names)]

    def static(weights):
        return M.ReplicaSchedulingStrategy(
            replica_scheduling_type=M.REPLICA_SCHEDULING_DIVIDED,
            replica_division_preference=M.REPLICA_DIVISION_WEIGHTED,
            weight_preference=M.ClusterPreferences(static_weight_list=[
                M.StaticClusterWeight(
                    target_cluster=M.ClusterAffinity(cluster_names=[nm]),
                    weight=w) for nm, w in zip(names, weights)]))

    placements = [
        M.Placement(replica_scheduling=static([5] * n_clusters)),
        M.Placement(replica_scheduling=static(
            [1 << 36 if i == 3 else 5 for i in range(n_clusters)])),
        M.Placement(replica_scheduling=_dynamic(M)),
        M.Placement(replica_scheduling=M.ReplicaSchedulingStrategy(
            replica_scheduling_type=M.REPLICA_SCHEDULING_DIVIDED,
            replica_division_preference=M.REPLICA_DIVISION_AGGREGATED)),
    ]
    items = [capacity_binding(M, b, (1, 7, 40, 300)[b % 4], 500,
                              placements[b % len(placements)])
             for b in range(n_bindings)]
    return clusters, items


def select_case(M, name):
    """(clusters, items, lanes, extra_seed) of one K2 std gather case:
    `lanes` cuts the encoded batch to that many lanes (narrow_lanes; None
    keeps the encoder's), `extra_seed` (None: none) draws plugin scores,
    which add the fifth gather group.  c529: C just above DIRECT_MAX;
    c700: bench.py's rebalance mix (prev lanes, scale up / down) on a C
    that is no power of two; extra: five groups; short_groups: affinity
    subsets of 3-100 clusters, so groups hold fewer eligible lanes than k
    and take -1 lanes; overflow: overflow_scenario; prev_evict_uid: the
    randomized mix's prev lanes, eviction lanes and uid_desc rows."""
    if name == "c529":
        return (*random_scenario(M, 1, n_clusters=529, n_bindings=24),
                529, None)
    if name == "c700":
        clusters, items, rng, names = bench_scenario(M, 2, 700, 32)
        return clusters, build_rebalance_items(M, rng, items, names), 700, None
    if name == "extra":
        return (*random_scenario(M, 3, n_clusters=600, n_bindings=24),
                600, 3)
    if name == "short_groups":
        rng = random.Random(4)
        clusters = build_fleet(M, rng, 700)
        names = [c.name for c in clusters]
        pls = affinity_placements(M, rng, names, n=6, lo=3, hi=100)
        return clusters, build_bindings(M, rng, 24, pls), None, None
    if name == "overflow":
        return (*overflow_scenario(M), None, None)
    if name == "prev_evict_uid":
        return (*random_scenario(M, 5, n_clusters=900, n_bindings=32),
                900, None)
    raise KeyError(name)


#: K2-big gather-path cases (big_select_case): SELECT_CASES' counterparts
#: on the big tier (direct up to 4,224 lanes; k = 128 prev, 1,024 others)
BIG_SELECT_CASES = ("c4225", "extra", "short_groups", "overflow",
                    "prev_evict_uid")


def big_select_case(M, name):
    """(clusters, items, lanes, extra_seed) of one K2-big gather case, as
    select_case's: c4225: C just above the big tier's DIRECT_MAX; extra:
    five groups (plugin scores); short_groups: affinity subsets of 3-1,000
    clusters, so groups hold fewer eligible lanes than k = 1,024 and take
    -1 lanes; overflow: overflow_scenario on 4,300 clusters, boundary
    buckets of more than 256 candidates digit after digit; prev_evict_uid:
    the randomized mix's prev lanes, eviction lanes and uid_desc rows, one
    row with 300 previous clusters (the prev group selects its 128)."""
    if name == "c4225":
        return (*random_scenario(M, 21, n_clusters=4225, n_bindings=16),
                4225, None)
    if name == "extra":
        return (*random_scenario(M, 23, n_clusters=4400, n_bindings=16),
                4400, 23)
    if name == "short_groups":
        rng = random.Random(24)
        clusters = build_fleet(M, rng, 4300)
        names = [c.name for c in clusters]
        pls = affinity_placements(M, rng, names, n=6, lo=3, hi=1000)
        return clusters, build_bindings(M, rng, 16, pls), None, None
    if name == "overflow":
        return (*overflow_scenario(M, n_clusters=4300, n_bindings=16), None,
                None)
    if name == "prev_evict_uid":
        clusters, items = random_scenario(M, 25, n_clusters=4500,
                                          n_bindings=24)
        names = [c.metadata.name for c in clusters]
        spec = next(sp for sp, _st in items
                    if not sp.placement.spread_constraints)
        spec.clusters = [M.TargetCluster(name=n, replicas=1)
                         for n in names[::15]]
        return clusters, items, 4500, None
    raise KeyError(name)


def shape_big_select_batch(batch, lanes, extra_seed, T):
    """shape_select_batch for a big_select_case batch, with every real row
    the encoder routes to the device (T.ROUTE_DEVICE or
    T.ROUTE_DEVICE_BIG; T: the package's tensors module) valid, and the
    rows beyond every compact cap (T.ROUTE_COMPACT_CAP: more than 128
    previous clusters, which the cycle solves on the host) too: the dense
    big-tier solve takes them all, the prev group selecting its 128."""
    batch = shape_select_batch(batch, lanes, extra_seed)
    n = batch.n_bindings
    batch.b_valid[:n] = np.isin(batch.route[:n], (
        T.ROUTE_DEVICE, T.ROUTE_DEVICE_BIG, T.ROUTE_COMPACT_CAP))
    return batch


def shape_select_batch(batch, lanes, extra_seed):
    """select_case's batch as the case asks: cut to `lanes`, plugin
    scores from `extra_seed` (numpy arrays; either package's batch)."""
    if lanes is not None:
        batch = narrow_lanes(batch, lanes)
    if extra_seed is not None:
        rng = np.random.default_rng(extra_seed)
        batch = dataclasses.replace(batch, pl_extra_score=rng.integers(
            0, 101, batch.pl_mask.shape))
    return batch


# -- K4 webster_batch problems --------------------------------------------------

#: K4 cases: the main path's shapes (std: 656 lanes, n <= 64, s0 = 0; big:
#: 5,248 lanes, n <= 512), a row wider than the kernel's shared memory,
#: and the contract's edges
WEBSTER_CASES = ("std", "big", "scratch", "caps", "s0_cap", "equal",
                 "w1_many_seats", "inactive", "ranks")


def webster_case(name, seed=0, small=False):
    """(n, w, s0, active, rank) numpy int64/bool [B], [B, L] of one K4
    case.  `small` shrinks the main-path shapes for the CPU tests.  Rows
    carry K2's layout where it applies: lanes at or beyond a row's U
    inactive, ranks a permutation of the row's lanes."""
    g = np.random.default_rng(seed + sum(map(ord, name)))
    shapes = {"std": (512, 656), "big": (64, 5248), "scratch": (4, 9000)}
    B, L = shapes.get(name, (48, 40))
    if small:
        B, L = min(B, 24), min(L, 96)
    rank = np.stack([g.permutation(L) for _ in range(B)]).astype(np.int64)
    s0 = np.zeros((B, L), np.int64)
    if name in ("std", "big", "scratch"):
        U = g.integers(0, L + 1, B)
        U[: B // 8] = L
        active = np.arange(L)[None, :] < U[:, None]
        w = np.where(g.random((B, L)) < 0.8, g.integers(0, 5000, (B, L)), 0)
        n = g.integers(0, {"std": 65, "big": 513, "scratch": 300}[name], B)
        n[::5] = 0
        if name == "std":
            w[1::6] = 7  # equal weights: a full tie block
    else:
        active = g.random((B, L)) < 0.85
        w = g.integers(0, 10_000, (B, L))
        n = g.integers(0, 400, B)
    if name == "caps":
        w = g.choice([(1 << 34) - 1, 1 << 36, -5, 0, 3, 1 << 20], (B, L))
        n = g.choice([(1 << 25) - 1, 1 << 30, -7, 0, 5, 1000], B)
        s0 = g.choice([0, 1, (1 << 25) - 1, 1 << 27, -3], (B, L))
    elif name == "s0_cap":
        s0 = g.integers(0, 1 << 25, (B, L))
        s0[::3] = (1 << 25) - 1
        n = g.integers(0, 1 << 25, B)
        w = g.integers(1, (1 << 34) - 1, (B, L))
    elif name == "equal":
        w = np.full((B, L), 12, np.int64)
        n = g.integers(1, 5 * L, B)
    elif name == "w1_many_seats":
        w = np.ones((B, L), np.int64)
        n = g.integers(L << 14, L << 16, B)  # many seats a lane share a q
        s0 = g.integers(0, 3, (B, L))
    elif name == "inactive":
        active[::2] = False
        n[1::4] = 0
        w[3::8] = 0
    elif name == "ranks":
        rank = np.stack([g.permutation(10 * L)[:L] for _ in range(B)]).astype(
            np.int64) - 3 * L
    return (np.asarray(n, np.int64), np.asarray(w, np.int64),
            np.asarray(s0, np.int64), np.asarray(active, bool), rank)
