"""Agent CSR auto-approval + certificate rotation.

Counterpart of the JAX package's ``controllers/certificates.py``.

Reference: pkg/controllers/certificate/agent_csr_approving.go:59 (approve
CSRs whose signer/subject match the karmada-agent identity) and
cert_rotation_controller.go:89 (renew a credential once the remaining
lifetime falls below --certificate-rotation-threshold, default 0.8 of the
ttl elapsed).
"""

from __future__ import annotations

import time
from typing import Callable, Optional

from karmada_tpu_torch.models.certs import (
    AGENT_SIGNER,
    AGENT_USER_PREFIX,
    CertificateSigningRequest,
    ClusterCredential,
)
from karmada_tpu_torch.models.cluster import Cluster
from karmada_tpu_torch.store.store import AlreadyExistsError, Event, ObjectStore
from karmada_tpu_torch.store.worker import AsyncWorker, Runtime


class AgentCsrApprover:
    """Auto-approve agent bootstrap CSRs; issue the 'certificate' and
    materialize/refresh the cluster's credential."""

    def __init__(self, store: ObjectStore, runtime: Runtime,
                 clock: Callable[[], float] = time.time) -> None:
        self.store = store
        self.clock = clock
        self.worker = runtime.register(AsyncWorker("csr-approver", self._reconcile))
        store.bus.subscribe(self._on_event, kind=CertificateSigningRequest.KIND)

    def _on_event(self, event: Event) -> None:
        self.worker.enqueue(event.obj.name)

    def _reconcile(self, name: str) -> None:
        csr = self.store.try_get(CertificateSigningRequest.KIND, "", name)
        if csr is None or csr.status.approved or csr.status.denied_reason:
            return
        expected_user = AGENT_USER_PREFIX + csr.spec.cluster

        def decide(c: CertificateSigningRequest) -> None:
            if (
                c.spec.signer_name != AGENT_SIGNER
                or c.spec.username != expected_user
                or not c.spec.cluster
            ):
                c.status.denied_reason = (
                    "subject does not match the karmada-agent identity"
                )
                return
            now = self.clock()
            c.status.approved = True
            c.status.issued_at = now
            c.status.expires_at = now + c.spec.ttl_seconds
        approved = self.store.mutate(CertificateSigningRequest.KIND, "", name, decide)
        if not approved.status.approved:
            return

        cred_name = csr.spec.cluster
        cred = self.store.try_get(ClusterCredential.KIND, "", cred_name)
        if cred is None:
            cred = ClusterCredential()
            cred.metadata.name = cred_name
            cred.status.issued_at = approved.status.issued_at
            cred.status.expires_at = approved.status.expires_at
            try:
                self.store.create(cred)
            except AlreadyExistsError:
                pass
            return

        def refresh(c: ClusterCredential) -> None:
            c.status.issued_at = approved.status.issued_at
            c.status.expires_at = approved.status.expires_at
            c.status.rotations += 1
        self.store.mutate(ClusterCredential.KIND, "", cred_name, refresh)


class CertRotationController:
    """Renew credentials approaching expiry by posting a fresh agent CSR
    (which the approver then honors).

    In the reference this loop runs INSIDE each karmada-agent for its own
    credential (cmd/agent/app/agent.go registers
    cert_rotation_controller.go); pass `cluster` to scope an instance to
    one agent's identity — KarmadaAgent does."""

    def __init__(self, store: ObjectStore, runtime: Runtime,
                 rotation_threshold: float = 0.8,
                 ttl_seconds: int = 30 * 24 * 3600,
                 clock: Callable[[], float] = time.time,
                 cluster: Optional[str] = None) -> None:
        self.store = store
        self.threshold = rotation_threshold
        self.ttl_seconds = ttl_seconds
        self.clock = clock
        self.cluster = cluster
        self._seq = 0
        runtime.register_periodic(self.run_once, name="cert-rotation")

    def run_once(self) -> None:
        now = self.clock()
        if self.cluster is not None:
            # agent-scoped: fetch only its own identity (N agents must not
            # each scan all N credentials every round)
            cred = self.store.try_get(ClusterCredential.KIND, "", self.cluster)
            creds = [cred] if cred is not None else []
        else:
            creds = self.store.visit(ClusterCredential.KIND)
        for cred in creds:
            issued = cred.status.issued_at or now
            expires = cred.status.expires_at
            if expires is None:
                continue
            lifetime = max(expires - issued, 1.0)
            if (now - issued) / lifetime < self.threshold:
                continue
            if self.store.try_get(Cluster.KIND, "", cred.metadata.name) is None:
                continue  # unjoined cluster: nothing to rotate for
            self._seq += 1
            csr = CertificateSigningRequest()
            csr.metadata.name = f"rotate-{cred.metadata.name}-{self._seq}"
            csr.spec.cluster = cred.metadata.name
            csr.spec.username = AGENT_USER_PREFIX + cred.metadata.name
            csr.spec.ttl_seconds = self.ttl_seconds
            try:
                self.store.create(csr)
            except AlreadyExistsError:
                pass


def bootstrap_agent_csr(store: ObjectStore, cluster: str,
                        ttl_seconds: int = 30 * 24 * 3600) -> None:
    """The agent's register step (karmadactl register): post the initial
    bootstrap CSR for its identity."""
    csr = CertificateSigningRequest()
    csr.metadata.name = f"bootstrap-{cluster}"
    csr.spec.cluster = cluster
    csr.spec.username = AGENT_USER_PREFIX + cluster
    csr.spec.ttl_seconds = ttl_seconds
    try:
        store.create(csr)
    except AlreadyExistsError:
        pass
