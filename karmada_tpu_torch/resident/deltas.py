"""Classes of cluster change for the resident plane.

Counterpart of the JAX package's ``resident/deltas.py``: the DeltaTracker
taps the store's watch bus (store/store.py) and coalesces one scheduling
cycle's events into a CycleDeltas.  The update cost of a cluster change differs by orders of
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

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from karmada_tpu_torch.models.cluster import Cluster
from karmada_tpu_torch.models.work import ResourceBinding
from karmada_tpu_torch.store.store import DELETED, Event

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


def classify_cluster_event(event: Event) -> Tuple[str, str]:
    """(class, reason) for one Cluster event -- see module docstring."""
    if event.type == DELETED or event.old is None:
        return STRUCTURAL, "membership"
    return classify_change(event.old, event.obj)


class DeltaTracker:
    """Subscribes to the store's watch bus and coalesces events per
    scheduling cycle.  drain() hands the accumulated set to the resident
    plane and resets the window; thread-safe (publisher threads write,
    the scheduler's cycle drains)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._clusters: Dict[str, str] = {}
        self._structural: Optional[str] = None
        self._binding_events = 0
        self._bindings_deleted: List[Tuple[str, str]] = []
        self._bindings_touched: List[Tuple[str, str]] = []

    def on_event(self, event: Event) -> None:
        kind = event.kind
        if kind == Cluster.KIND:
            cls, reason = classify_cluster_event(event)
            with self._lock:
                if cls == STRUCTURAL:
                    if self._structural is None:
                        self._structural = reason
                    return
                name = event.obj.metadata.name
                prev = self._clusters.get(name)
                if prev is None or _RANK[cls] > _RANK[prev]:
                    self._clusters[name] = cls
        elif kind == ResourceBinding.KIND:
            with self._lock:
                self._binding_events += 1
                m = event.obj.metadata
                if event.type == DELETED:
                    self._bindings_deleted.append((m.namespace, m.name))
                else:
                    self._bindings_touched.append((m.namespace, m.name))

    def drain(self) -> CycleDeltas:
        """The coalesced window since the previous drain (resets it)."""
        with self._lock:
            out = CycleDeltas(
                structural=self._structural is not None,
                structural_reason=self._structural or "",
                clusters=self._clusters,
                binding_events=self._binding_events,
                bindings_deleted=self._bindings_deleted,
                bindings_touched=self._bindings_touched,
            )
            self._clusters = {}
            self._structural = None
            self._binding_events = 0
            self._bindings_deleted = []
            self._bindings_touched = []
        return out
