"""karmada-agent: the PULL-mode member runtime.

Counterpart of the JAX package's ``agent.py``.  Left out of the port: the
agent's endpointslice collection (it waits with the port's multi-cluster
services, ``controllers/mcs.py``).  Its `recorder` is the control plane's
events recorder, handed to the agent's execution and status controllers.

Reference: cmd/agent/app/agent.go:140-145 — in pull mode the member
cluster is unreachable from the control plane; an agent INSIDE the member
watches the karmada control plane instead and runs, locally:
clusterStatus, execution (apply Works), and workStatus (reflect status)
controllers, plus certificate rotation for its own credentials.

This module composes the framework's controllers scoped to exactly one
member (each controller acts only on clusters in its `members` dict, so a
per-member instance is the agent): the control-plane push controllers
skip Pull clusters entirely (they could not reach them), and the agent's
scoped instances drive the same Work/status machinery from the member's
side.  The data flow is identical either way — SURVEY §2.9: push vs pull
only inverts who drives the member-cluster writes.

The agent owns TWO liveness loops of its own, like the reference binary:
* its scoped ClusterStatusController renews the cluster Lease every
  collection round (cluster_status_controller.go:399 initLeaseController
  — the lease is the AGENT's heartbeat; controllers/lease.py's monitor
  degrades the cluster to Ready=Unknown when it goes stale), and
* a cert-rotation loop scoped to its OWN ClusterCredential
  (cert_rotation_controller.go:89 runs inside the agent, not the
  control-plane manager).
"""

from __future__ import annotations

import time
from typing import Optional

from karmada_tpu_torch.controllers.certificates import CertRotationController
from karmada_tpu_torch.controllers.execution import ExecutionController
from karmada_tpu_torch.controllers.status import (
    ClusterStatusController,
    WorkStatusController,
)
from karmada_tpu_torch.interpreter import ResourceInterpreter
from karmada_tpu_torch.members.member import FakeMemberCluster
from karmada_tpu_torch.store.store import ObjectStore
from karmada_tpu_torch.store.worker import Runtime


class KarmadaAgent:
    """One agent per pull-mode member cluster."""

    def __init__(
        self,
        control_store: ObjectStore,
        member: FakeMemberCluster,
        runtime: Runtime,
        interpreter: Optional[ResourceInterpreter] = None,
        recorder=None,
        clock=None,
    ) -> None:
        self.member = member
        scoped = {member.name: member}
        clock = clock if clock is not None else time.time
        # the same controller implementations the push plane runs, scoped
        # to this one member — agent.go registers the identical set.  The
        # agent is its own binary in the reference with its own controller
        # flag, so the control plane's --controllers list must not govern
        # these registrations.
        with runtime.ungoverned():
            self.execution = ExecutionController(
                control_store, runtime, scoped, interpreter, recorder=recorder)
            self.work_status = WorkStatusController(
                control_store, runtime, scoped, interpreter
            )
            self.cluster_status = ClusterStatusController(
                control_store, runtime, scoped, recorder=recorder)
            # the agent rotates ITS OWN credential (the reference runs the
            # rotation controller inside the agent binary)
            self.cert_rotation = CertRotationController(
                control_store, runtime, cluster=member.name,
                clock=clock)
        self._control_store = control_store
        self._runtime = runtime

    @property
    def cluster_name(self) -> str:
        return self.member.name

    def stop(self) -> None:
        """Full teardown on unregister: workers, periodics, and control-
        plane bus subscriptions all unwind (a long-lived plane repeatedly
        joining/unjoining pull members must not accumulate dead wiring)."""
        self._runtime.unregister(self.execution.worker)
        self._runtime.unregister(self.work_status.worker)
        self._runtime.unregister_periodic(self.cluster_status.collect_all)
        self._runtime.unregister_periodic(self.cert_rotation.run_once)
        self._control_store.bus.unsubscribe(self.execution._on_event)  # noqa: SLF001
        self._control_store.bus.unsubscribe(self.execution._on_cluster_event)  # noqa: SLF001
        self.execution.members.pop(self.member.name, None)
        self.work_status.members.pop(self.member.name, None)
        self.cluster_status.members.pop(self.member.name, None)
