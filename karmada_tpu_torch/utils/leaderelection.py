"""Leader election over a store-backed Lease.

Counterpart of the JAX package's ``utils/leaderelection.py``.  Every
karmada binary runs controller-runtime leader election (a
coordination.k8s.io Lease in karmada-system) so only one replica of the
controller-manager / scheduler acts while standbys wait.  Here the Lease
is a typed object in the ObjectStore, acquired and renewed with
optimistic concurrency: the store's resourceVersion conflict check is the
election's atomicity.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from karmada_tpu_torch.models.meta import ObjectMeta, TypedObject
from karmada_tpu_torch.store.store import (
    AlreadyExistsError,
    ConflictError,
    NotFoundError,
    ObjectStore,
)

LEASE_NAMESPACE = "karmada-system"


@dataclass
class LeaseSpec:
    holder_identity: str = ""
    lease_duration_seconds: float = 15.0
    acquire_time: float = 0.0
    renew_time: float = 0.0


@dataclass
class Lease(TypedObject):
    KIND = "Lease"
    API_VERSION = "coordination.k8s.io/v1"

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: LeaseSpec = field(default_factory=LeaseSpec)


class LeaderElector:
    """Campaign for one named lease; call `tick()` periodically (it renews
    held leadership and takes over expired leases)."""

    def __init__(
        self,
        store: ObjectStore,
        lease_name: str,
        identity: str,
        lease_duration_s: float = 15.0,
        clock: Callable[[], float] = time.time,
        on_started_leading: Optional[Callable[[], None]] = None,
        on_stopped_leading: Optional[Callable[[], None]] = None,
    ) -> None:
        self.store = store
        self.lease_name = lease_name
        self.identity = identity
        self.lease_duration_s = lease_duration_s
        self.clock = clock
        self.on_started_leading = on_started_leading
        self.on_stopped_leading = on_stopped_leading
        self._leading = False

    def is_leader(self) -> bool:
        return self._leading

    def _set_leading(self, leading: bool) -> None:
        if leading and not self._leading:
            self._leading = True
            if self.on_started_leading:
                self.on_started_leading()
        elif not leading and self._leading:
            self._leading = False
            if self.on_stopped_leading:
                self.on_stopped_leading()

    def tick(self) -> bool:
        """One election round; returns current leadership."""
        now = self.clock()
        lease = self.store.try_get(Lease.KIND, LEASE_NAMESPACE,
                                   self.lease_name)
        if lease is None:
            lease = Lease(metadata=ObjectMeta(
                name=self.lease_name, namespace=LEASE_NAMESPACE))
            lease.spec = LeaseSpec(
                holder_identity=self.identity,
                lease_duration_seconds=self.lease_duration_s,
                acquire_time=now, renew_time=now,
            )
            try:
                self.store.create(lease)
                self._set_leading(True)
                return True
            except AlreadyExistsError:
                lease = self.store.try_get(
                    Lease.KIND, LEASE_NAMESPACE, self.lease_name)
                if lease is None:
                    return self._leading

        held_by_me = lease.spec.holder_identity == self.identity
        expired = (now - lease.spec.renew_time
                   > lease.spec.lease_duration_seconds)
        if not held_by_me and not expired:
            self._set_leading(False)
            return False
        # held and recently renewed: no store write (controller-runtime
        # renews every ~duration/3, not every probe)
        if held_by_me and \
                now - lease.spec.renew_time < self.lease_duration_s / 3:
            self._set_leading(True)
            return True

        # renew (held) or take over (expired) by optimistic concurrency: a
        # racing standby loses on the resourceVersion conflict
        lease.spec.holder_identity = self.identity
        lease.spec.renew_time = now
        lease.spec.lease_duration_seconds = self.lease_duration_s
        if not held_by_me:
            lease.spec.acquire_time = now
        try:
            self.store.update(lease)
            self._set_leading(True)
            return True
        except (ConflictError, NotFoundError):
            self._set_leading(False)
            return False

    def release(self) -> None:
        """Graceful handoff: expire the lease now so standbys take over
        without waiting out the duration."""
        if not self._leading:
            return

        def expire(obj: Lease) -> None:
            if obj.spec.holder_identity == self.identity:
                obj.spec.renew_time = 0.0
        try:
            self.store.mutate(Lease.KIND, LEASE_NAMESPACE, self.lease_name,
                              expire)
        except NotFoundError:
            pass
        self._set_leading(False)
