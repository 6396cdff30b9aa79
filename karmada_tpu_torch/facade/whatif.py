"""What-if capacity planning: hypothetical solves, zero live mutation.

Counterpart of the JAX package's ``facade/whatif.py``.  Every query runs the scheduler's DETACHED solve (Scheduler.solve_batch
with ``detached=True`` — the unchanged pipelined solver minus every
live-state hook; on backend "device" a detached device cycle on the
card) against a copy of the member-cluster view: the resident plane's
cluster snapshot when that plane is armed (``ResidentState.
fork_clusters``), the store's deep-copied list otherwise.  Nothing here
calls ``store.mutate`` / ``_apply_result``, so a what-if query mid-run
leaves live placements bit-identical.

Query payload shapes (WhatIfResponse.result):

  placement     {"replicas", "assignments": [{"cluster", "replicas"}],
                 "outcome", "message"}
  cluster-loss  {"ranking": [{"cluster", "bindings", "replicas",
                 "stranded_bindings", "stranded_replicas", "truncated"}],
                 "worst": <cluster name or "">}
  headroom      {"max_replicas", "probes", "assignments"}
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, List, Optional, Tuple

from karmada_tpu_torch.estimator.wire import AssignReplicasRequest
from karmada_tpu_torch.facade.messages import (
    QUERIES,
    QUERY_CLUSTER_LOSS,
    QUERY_PLACEMENT,
    WhatIfRequest,
    WhatIfResponse,
)
from karmada_tpu_torch.models.cluster import Cluster
from karmada_tpu_torch.models.policy import (
    ClusterAffinity,
    Placement,
    REPLICA_DIVISION_AGGREGATED,
    REPLICA_SCHEDULING_DIVIDED,
    REPLICA_SCHEDULING_DUPLICATED,
    ReplicaSchedulingStrategy,
)
from karmada_tpu_torch.models.work import (
    ObjectReference,
    ReplicaRequirements,
    ResourceBinding,
    ResourceBindingSpec,
)
from karmada_tpu_torch.scheduler.core import ClusterView
from karmada_tpu_torch.utils.quantity import Quantity

WHATIF_NS = "whatif"


@lru_cache(maxsize=4096)
def _parse_qty(s: str) -> Quantity:
    """Quantity is frozen, so identical request strings (the common
    facade shape: thousands of callers asking for "500m") share one
    parsed instance instead of re-running the regex per call."""
    return Quantity.parse(s)

#: headroom search: doubling probes + bisection steps are each bounded,
#: so one query costs at most ~2 * HEADROOM_MAX_PROBES detached solves
HEADROOM_MAX_PROBES = 24


def synthesize_binding(req: AssignReplicasRequest) -> ResourceBinding:
    """A hypothetical ResourceBinding from a facade request — never
    created in any store, so names need only be unique per batch."""
    rb = ResourceBinding()
    rb.metadata.namespace = req.namespace or WHATIF_NS
    rb.metadata.name = req.name or "whatif"
    rr = None
    if req.resource_request:
        rr = ReplicaRequirements(resource_request={
            k: _parse_qty(str(v)) for k, v in req.resource_request.items()})
    if req.divided:
        strategy = ReplicaSchedulingStrategy(
            replica_scheduling_type=REPLICA_SCHEDULING_DIVIDED,
            replica_division_preference=REPLICA_DIVISION_AGGREGATED)
    else:
        strategy = ReplicaSchedulingStrategy(
            replica_scheduling_type=REPLICA_SCHEDULING_DUPLICATED)
    rb.spec = ResourceBindingSpec(
        resource=ObjectReference(
            api_version="apps/v1", kind="Deployment",
            namespace=rb.metadata.namespace, name=rb.metadata.name,
            uid=f"uid-{rb.metadata.namespace}-{rb.metadata.name}"),
        replicas=max(int(req.replicas), 0),
        replica_requirements=rr,
        placement=Placement(
            cluster_affinity=(
                ClusterAffinity(cluster_names=list(req.cluster_names))
                if req.cluster_names else None),
            replica_scheduling=strategy),
    )
    return rb


def fork_clusters(scheduler, store) -> Tuple[List[Cluster], str]:
    """The copy-on-write fork every hypothetical solve runs against:
    the resident plane's cluster view when armed (and populated), the
    store's deep-copied snapshot otherwise.  Either way the returned
    objects share nothing mutable with live state.

    Concurrency contract (the fork bookkeeping has NO lock of its own):
    every fork is CALL-LOCAL -- this module keeps zero shared mutable
    state across queries, so concurrent run_query callers each hold a
    private fork and never observe each other.  The only shared
    resource is the detached solver itself, serialized by the caller's
    ``solve_lock`` (FacadeService._solve_lock)."""
    state = getattr(scheduler, "_resident", None)
    if state is not None:
        forked = state.fork_clusters()
        if forked:
            return forked, "resident"
    return store.list(Cluster.KIND), "store"


def _solve_one(scheduler, rb: ResourceBinding, view: ClusterView) -> object:
    results, _ = scheduler.solve_batch([rb], view.clusters, detached=True,
                                       view=view)
    return results.get(0)


def _placement_result(res: object) -> Dict:
    if isinstance(res, Exception):
        return {"assignments": [], "outcome": "unschedulable",
                "message": str(res)}
    targets = res or []
    return {"assignments": [{"cluster": t.name, "replicas": t.replicas}
                            for t in targets],
            "outcome": "scheduled", "message": ""}


def run_query(scheduler, store, req: WhatIfRequest,
              solve_lock=None) -> WhatIfResponse:
    """Answer one what-if query.  ``solve_lock`` (the FacadeService's)
    serializes detached solves among facade callers; a bare None runs
    unserialized (single-threaded tests)."""
    if req.query not in QUERIES:
        raise ValueError(
            f"unknown what-if query {req.query!r}; available: "
            f"{', '.join(QUERIES)}")
    clusters, source = fork_clusters(scheduler, store)
    lock = solve_lock if solve_lock is not None else _NULL_LOCK
    with lock:
        if req.query == QUERY_PLACEMENT:
            result = _query_placement(scheduler, ClusterView(clusters), req)
        elif req.query == QUERY_CLUSTER_LOSS:
            result = _query_cluster_loss(scheduler, store, clusters, req)
        else:
            # one view of the fork for every probe of the search
            result = _query_headroom(scheduler, ClusterView(clusters), req)
    return WhatIfResponse(query=req.query, source=source, result=result)


class _NullLock:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_LOCK = _NullLock()


def _query_placement(scheduler, view: ClusterView,
                     req: WhatIfRequest) -> Dict:
    rb = synthesize_binding(AssignReplicasRequest(
        namespace=WHATIF_NS, name="placement",
        replicas=req.replicas, resource_request=req.resource_request,
        divided=req.divided))
    out = _placement_result(_solve_one(scheduler, rb, view))
    out["replicas"] = req.replicas
    return out


def _query_cluster_loss(scheduler, store, clusters: List[Cluster],
                        req: WhatIfRequest) -> Dict:
    """For each candidate cluster: re-solve the bindings it currently
    hosts against the forked fleet WITHOUT it; whatever no longer
    schedules is stranded by that loss.  The re-solve strips the old
    placement (spec.clusters / observed affinity state) so the solver
    prices the survivors fresh."""
    import copy

    live = store.visit(ResourceBinding.KIND)  # read only: probes are copies
    by_cluster: Dict[str, List[ResourceBinding]] = {}
    for rb in live:
        for t in rb.spec.clusters:
            by_cluster.setdefault(t.name, []).append(rb)
    names = ([req.cluster] if req.cluster
             else sorted(by_cluster, key=lambda n: -len(by_cluster[n])))
    ranking = []
    for name in names:
        hosted = by_cluster.get(name, [])
        if not hosted and not req.cluster:
            continue
        victims = hosted[:max(req.limit, 0)]
        survivors = [c for c in clusters if c.name != name]
        stranded_b = 0
        stranded_r = 0
        if victims:
            probes = []
            for rb in victims:
                probe = copy.deepcopy(rb)
                probe.spec.clusters = []
                probe.status.scheduler_observed_affinity_name = ""
                probes.append(probe)
            results, _ = scheduler.solve_batch(probes, survivors,
                                               detached=True)
            for i, rb in enumerate(victims):
                res = results.get(i)
                if isinstance(res, Exception) or res is None:
                    stranded_b += 1
                    stranded_r += sum(t.replicas for t in rb.spec.clusters
                                      if t.name == name)
        ranking.append({
            "cluster": name,
            "bindings": len(hosted),
            "replicas": sum(t.replicas for rb in hosted
                            for t in rb.spec.clusters if t.name == name),
            "stranded_bindings": stranded_b,
            "stranded_replicas": stranded_r,
            "truncated": len(hosted) - len(victims),
        })
    ranking.sort(key=lambda r: (-r["stranded_replicas"],
                                -r["stranded_bindings"], r["cluster"]))
    return {"ranking": ranking,
            "worst": ranking[0]["cluster"] if ranking else ""}


def _query_headroom(scheduler, view: ClusterView,
                    req: WhatIfRequest) -> Dict:
    """Largest replica count of the request class that still FULLY
    schedules (every replica placed): doubling to find an infeasible
    upper bound, then bisection.  Each probe is one detached solve."""
    probes = 0

    def fits(n: int) -> Optional[List]:
        nonlocal probes
        probes += 1
        rb = synthesize_binding(AssignReplicasRequest(
            namespace=WHATIF_NS, name=f"headroom-{n}",
            replicas=n, resource_request=req.resource_request,
            divided=True))
        res = _solve_one(scheduler, rb, view)
        if isinstance(res, Exception) or res is None:
            return None
        placed = sum(t.replicas for t in res)
        return list(res) if placed >= n else None

    lo = max(int(req.replicas), 1)
    best = fits(lo)
    if best is None:
        return {"max_replicas": 0, "probes": probes, "assignments": []}
    hi = lo * 2
    while probes < HEADROOM_MAX_PROBES:
        targets = fits(hi)
        if targets is None:
            break
        best, lo = targets, hi
        hi *= 2
    # invariant: lo fits (best is its assignment), hi does not
    while hi - lo > 1 and probes < 2 * HEADROOM_MAX_PROBES:
        mid = (lo + hi) // 2
        targets = fits(mid)
        if targets is None:
            hi = mid
        else:
            best, lo = targets, mid
    return {"max_replicas": lo, "probes": probes,
            "assignments": [{"cluster": t.name, "replicas": t.replicas}
                            for t in best]}
