"""Admission for the port's store: the chain (admission.py) and the
built-in plugins the propagation loop's kinds need (builtin.py).

Counterpart of the JAX package's ``karmada_tpu/webhook``.
"""

from karmada_tpu_torch.webhook.admission import (
    OP_CREATE,
    OP_DELETE,
    OP_UPDATE,
    AdmissionDenied,
    AdmissionRegistry,
)
from karmada_tpu_torch.webhook.builtin import install_default_webhooks

__all__ = [
    "OP_CREATE",
    "OP_DELETE",
    "OP_UPDATE",
    "AdmissionDenied",
    "AdmissionRegistry",
    "install_default_webhooks",
]
