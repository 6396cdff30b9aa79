"""Admission framework: mutate/validate every store write.

Counterpart of the JAX package's ``webhook/admission.py``.

The reference runs a dedicated karmada-webhook binary serving mutating +
validating admission for each policy CRD (cmd/webhook/app/webhook.go:186-232,
pkg/webhook/).  Here admission is an in-process chain the ObjectStore invokes
synchronously inside its write path — the same semantics (reject before
persist, mutate before validate) without the HTTPS hop.

Plugins are plain callables:

    mutator(op, obj, old)  -> None        (modify obj in place)
    validator(op, obj, old) -> Optional[str]  (non-None message == denial)

registered per kind.  `AdmissionDenied` raised from a write carries the
first denial message.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

OP_CREATE = "CREATE"
OP_UPDATE = "UPDATE"
OP_DELETE = "DELETE"

Mutator = Callable[[str, object, Optional[object]], None]
Validator = Callable[[str, object, Optional[object]], Optional[str]]


class AdmissionDenied(Exception):
    """A validating webhook rejected the write (admission.Denied)."""


class AdmissionRegistry:
    def __init__(self) -> None:
        self._mutators: Dict[str, List[Mutator]] = {}
        self._validators: Dict[str, List[Validator]] = {}

    def register_mutating(self, kind: str, fn: Mutator) -> None:
        self._mutators.setdefault(kind, []).append(fn)

    def register_validating(self, kind: str, fn: Validator) -> None:
        self._validators.setdefault(kind, []).append(fn)

    def admit(self, op: str, obj, old=None) -> None:
        """Mutators first (in registration order), then validators.

        Raises AdmissionDenied on the first validator returning a message.
        Runs inside the store's write lock: plugins may read the store
        (re-entrant lock) but must keep writes to non-hooked kinds to avoid
        unbounded recursion.
        """
        kind = obj.KIND
        for m in self._mutators.get(kind, []):
            m(op, obj, old)
        for v in self._validators.get(kind, []):
            msg = v(op, obj, old)
            if msg:
                raise AdmissionDenied(f"{kind} {obj.metadata.name}: {msg}")
