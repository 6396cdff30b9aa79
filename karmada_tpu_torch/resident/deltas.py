"""Classes of cluster change for the resident plane.

Counterpart of the JAX package's ``resident/deltas.py`` (its DeltaTracker,
which consumes the store's watch events, waits for the port's control
plane).  The update cost of a cluster change differs by orders of
magnitude with its kind:

  capacity    status-only churn (ResourceSummary, deletion timestamp):
              the churned cluster's capacity lanes and estimator-override
              column are rewritten in place -- the steady-state path.
  api         status.api_enablements changed: that cluster's api_ok
              column is recomputed for every resident GVK.
  structural  membership, spec or labels changed: lanes, name ranks,
              placement predicates, routes and the region vocabulary may
              all move, so the plane rebuilds from one full encode
              (resident/state.py ResidentState._reset).

A cycle's changes coalesce per cluster, the strongest class winning.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

CAPACITY = "capacity"
API = "api"
STRUCTURAL = "structural"
#: coalescing order: a stronger class absorbs a weaker one for a cluster
_RANK = {CAPACITY: 0, API: 1, STRUCTURAL: 2}


@dataclass
class CycleDeltas:
    """One cycle's coalesced change set."""

    structural: bool = False
    structural_reason: str = ""
    # cluster name -> strongest observed class (capacity | api); a
    # structural change is the `structural` flag instead (the whole plane
    # rebuilds)
    clusters: Dict[str, str] = field(default_factory=dict)
    binding_events: int = 0
    bindings_deleted: List[Tuple[str, str]] = field(default_factory=list)
    # (namespace, name) of bindings written this window: the incremental
    # solve marks their rows dirty (scheduler/incremental.py)
    bindings_touched: List[Tuple[str, str]] = field(default_factory=list)

    def empty(self) -> bool:
        return (not self.structural and not self.clusters
                and not self.bindings_deleted and not self.bindings_touched)


def classify_change(old, new) -> Tuple[str, str]:
    """(class, reason) of one observed cluster old -> new transition."""
    if new.spec != old.spec:
        # taints, region, provider, zone: placement predicates, name-rank
        # neighbours and the region vocabulary can all move
        return STRUCTURAL, "cluster-spec"
    if new.metadata.labels != old.metadata.labels:
        # labels drive placement label selectors and spread-by-label axes
        return STRUCTURAL, "cluster-labels"
    if new.status.api_enablements != old.status.api_enablements:
        return API, "api-enablement"
    return CAPACITY, "status"
