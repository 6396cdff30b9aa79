"""Descheduler: move replicas stuck unschedulable in their member cluster.

Counterpart of the JAX package's ``controllers/descheduler.py``.
Mirrors reference pkg/descheduler/descheduler.go:80-330: every
descheduling interval, for Divided+Dynamic bindings, query per-cluster
unschedulable replicas (the estimator's GetUnschedulableReplicas; here
the member simulator's admission plan behind an AccurateEstimatorServer),
subtract them from the binding's target (core/helper.go
SchedulingResultHelper.TargetToUnschedulableReplicas), and let the
scheduler top the lost replicas back up elsewhere (steady mode).  The
bindings are read without copying (ObjectStore.visit); `shrinks` counts
the (binding, cluster) shrinks written and `denied` those the shared
budget refused.
"""

from __future__ import annotations

from typing import Dict

from karmada_tpu_torch.members.member import FakeMemberCluster
from karmada_tpu_torch.models.policy import (
    DYNAMIC_WEIGHT_AVAILABLE_REPLICAS,
    REPLICA_DIVISION_AGGREGATED,
    REPLICA_SCHEDULING_DIVIDED,
)
from karmada_tpu_torch.models.work import ResourceBinding, TargetCluster
from karmada_tpu_torch.store.store import ObjectStore
from karmada_tpu_torch.store.worker import Runtime


class Descheduler:
    """Shares the scheduler's estimator tier: unschedulable counts come from
    the per-member estimator servers over the wire protocol
    (descheduler.go:141 -> GetUnschedulableReplicas gRPC), exactly the path
    the reference runs.  `members` remains only as a health gate and as a
    fallback when no estimator client is wired (unit-test harnesses)."""

    def __init__(
        self,
        store: ObjectStore,
        runtime: Runtime,
        members: Dict[str, FakeMemberCluster],
        estimator=None,  # AccurateEstimatorClient (wire path) or None
        # shared eviction-pacing ledger (rebalance/pacing.EvictionBudget):
        # the stuck-replica mover and the rebalance plane's drains draw
        # from the SAME per-cluster budget, so the two evictors cannot
        # stampede one cluster in the same interval.  None = unpaced
        # (the pre-budget behavior; unit-test harnesses).
        budget=None,
    ) -> None:
        self.store = store
        self.members = members
        self.estimator = estimator
        self.budget = budget
        #: (binding, cluster) shrinks written, and those the budget denied
        self.shrinks = 0
        self.denied = 0
        runtime.register_periodic(self.run_once, name="descheduler")

    def _stuck_replicas(self, cluster: str, resource) -> int:
        if self.estimator is not None:
            n = self.estimator.unschedulable_replicas(
                cluster, resource.kind, resource.namespace, resource.name
            )
            return max(n, 0)  # UNAUTHENTIC_REPLICA (-1) == unknown: skip
        member = self.members.get(cluster)
        if member is None:
            return 0
        return member.unschedulable_replicas(
            resource.kind, resource.namespace, resource.name
        )

    def _eligible(self, rb: ResourceBinding) -> bool:
        """descheduler.go:197-214: Divided + dynamic-weight or aggregated."""
        placement = rb.spec.placement
        if placement is None or placement.replica_scheduling is None:
            return False
        s = placement.replica_scheduling
        if s.replica_scheduling_type != REPLICA_SCHEDULING_DIVIDED:
            return False
        if s.replica_division_preference == REPLICA_DIVISION_AGGREGATED:
            return True
        return (
            s.weight_preference is not None
            and s.weight_preference.dynamic_weight == DYNAMIC_WEIGHT_AVAILABLE_REPLICAS
        )

    def run_once(self) -> None:
        for rb in self.store.visit(ResourceBinding.KIND):
            if not self._eligible(rb) or not rb.spec.clusters:
                continue
            resource = rb.spec.resource
            shrink: Dict[str, int] = {}
            for target in rb.spec.clusters:
                member = self.members.get(target.name)
                if member is None or not member.healthy:
                    continue
                stuck = self._stuck_replicas(target.name, resource)
                if stuck <= 0:
                    continue
                # shared pacing: one token per (binding, cluster) shrink,
                # drawn from the same per-cluster ledger the rebalance
                # plane drains against — a cluster that already absorbed
                # its interval's evictions is skipped until the window
                # rolls (the skipped shrink re-detects next round)
                if (self.budget is not None
                        and not self.budget.try_acquire(
                            target.name, consumer="descheduler")):
                    self.denied += 1
                    continue
                shrink[target.name] = min(stuck, target.replicas)
            if not shrink:
                continue

            def update(obj: ResourceBinding) -> None:
                new = []
                for t in obj.spec.clusters:
                    n = t.replicas - shrink.get(t.name, 0)
                    if n > 0:
                        new.append(TargetCluster(name=t.name, replicas=n))
                obj.spec.clusters = new

            self.shrinks += len(shrink)
            self.store.mutate(ResourceBinding.KIND, rb.namespace, rb.name,
                              update)
