"""Cluster lease heartbeats + staleness monitor.

Counterpart of the JAX package's ``controllers/lease.py``.  Reference:
the cluster-status controller renews a coordination.k8s.io Lease per
cluster in the karmada-cluster namespace (cluster_status_controller.go:399
initLeaseController), and the control plane monitors lease freshness --
conditions tell you the MEMBER's health, the lease tells you the
COLLECTOR's liveness (a dead karmada-agent or status controller must not
leave a stale "Ready" cluster schedulable forever).

When a lease goes stale past `grace_multiplier x lease_duration`, the
monitor flips the cluster's Ready condition to Unknown
(ClusterStatusUnknown), which the condition-driven taint machinery
(controllers/failover.py ClusterTaintController) turns into a NoExecute
not-ready taint exactly as for an observed failure.

`renew_cluster_lease` carries the chaos seam `lease.heartbeat` (drop: the
renewal is skipped, so the lease ages as a dead collector's would).  Left
out of the port: the monitor's ClusterStatusUnknown event (its `recorder`
argument), which waits with the loop's events.  The monitor reads the stored objects without copying (ObjectStore.peek /
visit).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable

from karmada_tpu_torch.models.cluster import COND_CLUSTER_READY, Cluster
from karmada_tpu_torch.models.meta import (
    Condition,
    ObjectMeta,
    TypedObject,
    get_condition,
    set_condition,
)
from karmada_tpu_torch.store.store import NotFoundError, ObjectStore

LEASE_NAMESPACE = "karmada-cluster"


@dataclass
class Lease(TypedObject):
    """coordination.k8s.io/v1 Lease, trimmed to the fields the cluster
    heartbeat uses."""

    KIND = "Lease"
    API_VERSION = "coordination.k8s.io/v1"

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    holder: str = ""
    renew_time: float = 0.0
    lease_duration_s: float = 10.0


def renew_cluster_lease(
    store: ObjectStore,
    cluster_name: str,
    holder: str = "cluster-status-controller",
    lease_duration_s: float = 10.0,
    clock: Callable[[], float] = time.time,
) -> None:
    """Create-or-renew the cluster's lease (the collector's heartbeat)."""
    from karmada_tpu_torch import chaos

    if chaos.armed():
        f = chaos.fire(chaos.SITE_LEASE_HEARTBEAT, cluster=cluster_name)
        if f is not None and f.mode == "drop":
            # a suppressed heartbeat is indistinguishable from a dead
            # collector: the lease ages out, the monitor flips Ready to
            # Unknown, and the taint / eviction chain takes over
            return
    now = clock()
    lease = store.peek(Lease.KIND, LEASE_NAMESPACE, cluster_name)
    if lease is not None and (lease.holder, lease.renew_time,
                              lease.lease_duration_s) == (
                                  holder, now, lease_duration_s):
        return  # renewed at this instant already: the write is a no-op
    try:
        def bump(lease: Lease) -> None:
            lease.holder = holder
            lease.renew_time = now
            lease.lease_duration_s = lease_duration_s
        store.mutate(Lease.KIND, LEASE_NAMESPACE, cluster_name, bump)
    except NotFoundError:
        store.create(Lease(
            metadata=ObjectMeta(namespace=LEASE_NAMESPACE, name=cluster_name),
            holder=holder,
            renew_time=now,
            lease_duration_s=lease_duration_s,
        ))


class ClusterLeaseMonitor:
    """Periodic staleness check: no renewal within grace -> Ready Unknown.

    Mirrors the reference's clusterMonitorGracePeriod behavior: the monitor
    only DEGRADES (Ready -> Unknown); recovery is owned by the status
    collector's next successful heartbeat, which also renews the lease."""

    def __init__(
        self,
        store: ObjectStore,
        runtime,
        grace_multiplier: float = 4.0,
        clock: Callable[[], float] = time.time,
    ) -> None:
        self.store = store
        self.runtime = runtime
        self.grace_multiplier = grace_multiplier
        self.clock = clock
        runtime.register_periodic(self.check_all, name="cluster-lease")

    def check_all(self) -> None:
        now = self.clock()
        # renewals happen once per periodic round: a sync period longer
        # than the lease duration must widen the grace window, or a slow
        # but healthy collector would flap its clusters to Unknown
        interval = getattr(self.runtime, "_periodic_interval_s", 0.0)
        for cluster in self.store.visit(Cluster.KIND):
            name = cluster.metadata.name
            lease = self.store.peek(Lease.KIND, LEASE_NAMESPACE, name)
            if lease is None:
                continue  # no collector has ever reported; nothing to age out
            window = self.grace_multiplier * max(lease.lease_duration_s,
                                                 interval)
            if now - lease.renew_time <= window:
                continue
            cond = get_condition(cluster.status.conditions,
                                 COND_CLUSTER_READY)
            if cond is not None and cond.status == "Unknown":
                continue

            def degrade(c: Cluster) -> None:
                set_condition(c.status.conditions, Condition(
                    type=COND_CLUSTER_READY,
                    status="Unknown",
                    reason="ClusterStatusUnknown",
                    message="cluster status collector stopped heartbeating",
                ))
            try:
                self.store.mutate(Cluster.KIND, "", name, degrade)
            except NotFoundError:
                continue
