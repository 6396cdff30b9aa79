"""Certificate plumbing types (agent bootstrap + rotation).

Counterpart of the JAX package's ``models/certs.py``.

Reference: pull-mode agents bootstrap kubeadm-style — they post a
CertificateSigningRequest which karmada auto-approves
(pkg/controllers/certificate/agent_csr_approving.go:59), and the rotation
controller renews credentials before expiry
(pkg/controllers/certificate/cert_rotation_controller.go:89).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from karmada_tpu_torch.models.meta import ObjectMeta, TypedObject

AGENT_SIGNER = "karmada.io/agent"
AGENT_USER_PREFIX = "system:karmada:agent:"


@dataclass
class CertificateSigningRequestSpec:
    signer_name: str = AGENT_SIGNER
    username: str = ""  # system:karmada:agent:<cluster>
    cluster: str = ""
    ttl_seconds: int = 30 * 24 * 3600


@dataclass
class CertificateSigningRequestStatus:
    approved: bool = False
    denied_reason: str = ""
    # the "certificate": issue + expiry timestamps (the simulator's stand-in
    # for x509 NotBefore/NotAfter)
    issued_at: Optional[float] = None
    expires_at: Optional[float] = None


@dataclass
class CertificateSigningRequest(TypedObject):
    KIND = "CertificateSigningRequest"
    API_VERSION = "certificates.karmada.io/v1alpha1"

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: CertificateSigningRequestSpec = field(
        default_factory=CertificateSigningRequestSpec
    )
    status: CertificateSigningRequestStatus = field(
        default_factory=CertificateSigningRequestStatus
    )


@dataclass
class ClusterCredentialStatus:
    issued_at: Optional[float] = None
    expires_at: Optional[float] = None
    rotations: int = 0


@dataclass
class ClusterCredential(TypedObject):
    """The live credential a cluster connection uses (the reference keeps
    these in Secrets; typed here so expiry is first-class)."""

    KIND = "ClusterCredential"
    API_VERSION = "certificates.karmada.io/v1alpha1"

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    status: ClusterCredentialStatus = field(default_factory=ClusterCredentialStatus)
