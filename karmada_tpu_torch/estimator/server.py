"""Accurate estimator server: node-level capacity math per member cluster.

Counterpart of the JAX package's ``estimator/server.py``.  Mirrors
reference pkg/estimator/server (server.go:92, estimate.go:31-93,
replica/replica.go:43, nodes/filter.go:35-74): per node,
maxAvailableReplicas = min over requested resources of
(allocatable - requested) / request, summed over nodes passing the node
selector; plus the unschedulable-replica count the descheduler consumes
(members/member.FakeMemberCluster.unschedulable_replicas).  The plugin
split (noderesource / resourcequota, server/framework/plugins/
registry.go:26-30) maps to the `plugins` hooks; resourcequota sits
behind the port's utils/features gate ResourceQuotaEstimate.

The server answers the wire methods of estimator/wire.py and also ships
its whole free-capacity table (CapacitySnapshot) so a caller can price
any request class without per-binding RPCs.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

from karmada_tpu_torch.estimator.wire import (
    CapacitySnapshotResponse,
    MaxAvailableReplicasRequest,
    MaxAvailableReplicasResponse,
    UnschedulableReplicasRequest,
    UnschedulableReplicasResponse,
    replicas_on_node,
)
from karmada_tpu_torch.members.member import FakeMemberCluster
from karmada_tpu_torch.models.work import ReplicaRequirements

MAX_INT32 = (1 << 31) - 1


def _node_free(member: FakeMemberCluster) -> List[Dict[str, int]]:
    """Free (allocatable - admitted) capacity per node.

    The greedy admission plan charges nodes in order, mirroring how the
    reference estimator sees already-placed pods via its pod informer.
    """
    nodes = member.effective_nodes()
    free = [
        {"cpu": n.cpu_milli, "memory": n.memory_milli, "pods": n.pods,
         **n.extra_milli}
        for n in nodes
    ]
    # charge admitted workloads against nodes first-fit, like the plan
    plan = member.admission_plan()
    for (kind, ns, name), admitted in sorted(plan.items()):
        obj = member.get(kind, ns, name)
        if obj is None:
            continue
        req = member._workload_request(obj.manifest)  # noqa: SLF001
        for _ in range(admitted):
            for f in free:
                if f["pods"] > 0 and all(
                    f.get(r, 0) >= v for r, v in req.items()
                ):
                    for r, v in req.items():
                        if r in f:
                            f[r] -= v
                    f["pods"] -= 1
                    break
    return free


def resource_quota_plugin(member: FakeMemberCluster, gates=None):
    """The resourcequota estimator plugin
    (server/framework/plugins/resourcequota/resourcequota.go:95-130, behind
    the ResourceQuotaEstimate feature gate): replicas are additionally
    capped by the member namespace's ResourceQuota headroom
    floor((hard - used) / per-replica request), min over quotas."""
    from karmada_tpu_torch.utils.features import GATES
    from karmada_tpu_torch.models.meta import deep_get
    from karmada_tpu_torch.utils.quantity import Quantity

    gates = gates or GATES

    def _headroom(rq_manifest, requirements: ReplicaRequirements) -> int:
        hard = deep_get(rq_manifest, "spec.hard", {}) or {}
        used = deep_get(rq_manifest, "status.used", {}) or {}
        allowed = MAX_INT32
        for name, qty in requirements.resource_request.items():
            req = qty.milli
            if req <= 0:
                continue
            raw = hard.get(name, hard.get(f"requests.{name}"))
            if raw is None:
                continue
            used_raw = used.get(name, used.get(f"requests.{name}", 0))
            free = Quantity.parse(raw).milli - Quantity.parse(used_raw).milli
            allowed = min(allowed, max(free, 0) // req)
        return allowed

    def plugin(requirements: Optional[ReplicaRequirements], estimate: int) -> int:
        if not gates.enabled("ResourceQuotaEstimate"):
            return estimate
        if requirements is None or not requirements.namespace:
            return estimate
        for rq in member.store.list("ResourceQuota", requirements.namespace):
            manifest = getattr(rq, "manifest", None)
            if manifest is None:
                continue
            estimate = min(estimate, _headroom(manifest, requirements))
        return estimate

    return plugin


class AccurateEstimatorServer:
    """One server per member cluster (cmd/scheduler-estimator)."""

    def __init__(self, member: FakeMemberCluster, gates=None) -> None:
        self.member = member
        # plugin hooks: each may cap the estimate; the in-tree set mirrors
        # server/framework/plugins/registry.go:26-30 (noderesource is the
        # base estimate; resourcequota caps it behind its feature gate)
        self.plugins: List[Callable[[Optional[ReplicaRequirements], int], int]] = [
            resource_quota_plugin(member, gates)
        ]

    # -- service methods ----------------------------------------------------
    def max_available_replicas(
        self, requirements: Optional[ReplicaRequirements]
    ) -> int:
        nodes = self.member.effective_nodes()
        free = _node_free(self.member)
        total = 0
        for node, f in zip(nodes, free):
            total += replicas_on_node(f, node.labels, requirements)
        total = min(total, MAX_INT32)
        for plugin in self.plugins:
            total = min(total, plugin(requirements, total))
        return total

    def max_available_component_sets(self, components) -> int:
        """Whole component SETS that fit this member's free capacity
        (wire.max_sets_from_free_table), capped by the quota-style plugins
        the reference runs (estimate.go:70-90).  Plugins see ONE SET's
        aggregate demand as the per-"replica" requirement, so quota
        headroom caps whole sets exactly like single-template replicas."""
        from karmada_tpu_torch.estimator.wire import max_sets_from_free_table
        from karmada_tpu_torch.estimator.general import per_set_requirement
        from karmada_tpu_torch.utils.quantity import RESOURCE_CPU, Quantity

        total = max_sets_from_free_table(_node_free(self.member), components)
        namespace = next(
            (c.replica_requirements.namespace for c in components
             if c.replica_requirements is not None
             and c.replica_requirements.namespace),
            "",
        )
        # per_set_requirement units: cpu in milli, everything else in Value
        per_set = ReplicaRequirements(
            resource_request={
                name: (
                    Quantity.from_milli(v)
                    if name == RESOURCE_CPU
                    else Quantity.from_units(v)
                )
                for name, v in per_set_requirement(components).items()
            },
            namespace=namespace,
        )
        for plugin in self.plugins:
            total = min(total, plugin(per_set, total))
        return min(total, MAX_INT32)

    def unschedulable_replicas(self, kind: str, namespace: str, name: str) -> int:
        return self.member.unschedulable_replicas(kind, namespace, name)

    def capacity_snapshot(self) -> CapacitySnapshotResponse:
        return CapacitySnapshotResponse(
            cluster=self.member.name,
            node_free=_node_free(self.member),
            node_labels=[dict(n.labels) for n in self.member.effective_nodes()],
        )

    # -- wire dispatch -------------------------------------------------------
    def handle(self, method: str, body: dict) -> dict:
        if method == "MaxAvailableReplicas":
            req = MaxAvailableReplicasRequest.from_json(body)
            n = self.max_available_replicas(req.requirements())
            return MaxAvailableReplicasResponse(max_replicas=n).to_json()
        if method == "MaxAvailableComponentSets":
            from karmada_tpu_torch.estimator.wire import (
                MaxAvailableComponentSetsRequest,
                MaxAvailableComponentSetsResponse,
            )

            req = MaxAvailableComponentSetsRequest.from_json(body)
            n = self.max_available_component_sets(req.typed_components())
            return MaxAvailableComponentSetsResponse(max_sets=n).to_json()
        if method == "GetUnschedulableReplicas":
            req = UnschedulableReplicasRequest.from_json(body)
            n = self.unschedulable_replicas(req.resource_kind, req.namespace, req.name)
            return UnschedulableReplicasResponse(unschedulable_replicas=n).to_json()
        if method == "CapacitySnapshot":
            return self.capacity_snapshot().to_json()
        raise ValueError(f"unknown method {method!r}")
