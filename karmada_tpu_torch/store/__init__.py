"""The port's control-plane substrate.

  store.py    ObjectStore -- apiserver semantics in process (rv,
              generation, watch events, finalizer-gated deletion,
              admission) and its read paths that do not copy
  worker.py   AsyncWorker + Runtime -- de-duplicating reconcile queues,
              pumped deterministically (tick/pump) or served on threads
  persistence.py  snapshot + write-ahead log under a directory, restart
              by load and resync (ControlPlane(persist_dir=...))

Counterpart of the JAX package's ``karmada_tpu/store``.
"""

from __future__ import annotations

from karmada_tpu_torch.store.store import (  # noqa: F401
    ADDED,
    DELETED,
    MODIFIED,
    AlreadyExistsError,
    ConflictError,
    Event,
    NotFoundError,
    ObjectStore,
    WatchBus,
)
from karmada_tpu_torch.store.worker import AsyncWorker, Runtime  # noqa: F401
