"""In-process object store with apiserver semantics.

Counterpart of the JAX package's ``store/store.py``: typed objects keyed
by (kind, namespace, name), a monotonically increasing resourceVersion,
generation bumps on spec change, watch subscriptions with
ADDED/MODIFIED/DELETED events and finalizer-gated deletion.  Every read
and write deep-copies, so no caller shares an object with the store.

Thread-safe; watch delivery is synchronous, in resourceVersion order, so
a deterministic pump and a threaded runtime share the machinery.
Persistence and admission webhooks are not part of the port yet.
"""

from __future__ import annotations

import copy
import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from karmada_tpu_torch.models.meta import TypedObject, new_uid, now

ADDED = "ADDED"
MODIFIED = "MODIFIED"
DELETED = "DELETED"


@dataclass
class Event:
    type: str  # ADDED | MODIFIED | DELETED
    obj: TypedObject
    old: Optional[TypedObject] = None

    @property
    def kind(self) -> str:
        return self.obj.KIND


def _spec_view(obj: TypedObject):
    """Generation-relevant content; objects may provide spec_view()."""
    fn = getattr(obj, "spec_view", None)
    if callable(fn):
        return fn()
    return getattr(obj, "spec", None)


class ConflictError(Exception):
    """resourceVersion mismatch on update (optimistic concurrency)."""


class NotFoundError(KeyError):
    pass


class AlreadyExistsError(Exception):
    pass


class WatchBus:
    """Fan-out of store events to subscribers: each subscriber is a
    callable invoked under no lock with each Event (of its kind, or of
    every kind)."""

    def __init__(self) -> None:
        self._subs: List[Tuple[Optional[str], Callable[[Event], None]]] = []
        self._lock = threading.Lock()

    def subscribe(self, handler: Callable[[Event], None],
                  kind: Optional[str] = None) -> None:
        with self._lock:
            self._subs.append((kind, handler))

    def publish(self, event: Event) -> None:
        with self._lock:
            subs = list(self._subs)
        for kind, handler in subs:
            if kind is None or kind == event.kind:
                handler(event)


class ObjectStore:
    def __init__(self, bus: Optional[WatchBus] = None) -> None:
        self._objects: Dict[Tuple[str, str, str], TypedObject] = {}
        self._rv = 0
        self._lock = threading.RLock()
        self.bus = bus or WatchBus()
        # Events are enqueued under _lock (in resourceVersion order) and
        # drained under _pub_lock, so concurrent writers never deliver a
        # newer rv before an older one.  A subscriber callback that writes
        # to the store enqueues and returns; the outer drain delivers it.
        self._pending_events: List[Event] = []
        self._pub_lock = threading.Lock()
        self._draining: Optional[int] = None  # thread id of active drainer

    def _drain(self) -> None:
        me = threading.get_ident()
        if self._draining == me:
            return  # re-entrant write from a subscriber callback
        with self._pub_lock:
            self._draining = me
            try:
                while True:
                    # pop one at a time: if a subscriber raises, events not
                    # yet popped stay queued for the next writer's drain
                    with self._lock:
                        if not self._pending_events:
                            break
                        ev = self._pending_events.pop(0)
                    self.bus.publish(ev)
            finally:
                self._draining = None

    @staticmethod
    def _key(obj: TypedObject) -> Tuple[str, str, str]:
        return (obj.KIND, obj.metadata.namespace, obj.metadata.name)

    def _next_rv(self) -> int:
        self._rv += 1
        return self._rv

    # -- API ---------------------------------------------------------------
    def create(self, obj: TypedObject) -> TypedObject:
        with self._lock:
            key = self._key(obj)
            if key in self._objects:
                raise AlreadyExistsError(f"{key} already exists")
            obj = copy.deepcopy(obj)
            if not obj.metadata.uid:
                obj.metadata.uid = new_uid()
            obj.metadata.creation_timestamp = now()
            obj.metadata.generation = 1
            obj.metadata.resource_version = self._next_rv()
            self._objects[key] = obj
            stored = copy.deepcopy(obj)
            self._pending_events.append(Event(ADDED, stored))
        self._drain()
        return stored

    def get(self, kind: str, namespace: str, name: str) -> TypedObject:
        with self._lock:
            key = (kind, namespace, name)
            if key not in self._objects:
                raise NotFoundError(f"{key} not found")
            return copy.deepcopy(self._objects[key])

    def try_get(self, kind: str, namespace: str,
                name: str) -> Optional[TypedObject]:
        try:
            return self.get(kind, namespace, name)
        except NotFoundError:
            return None

    def list(self, kind: str,
             namespace: Optional[str] = None) -> List[TypedObject]:
        """Copies of every object of `kind`, sorted by (namespace, name)."""
        with self._lock:
            return [
                copy.deepcopy(o)
                for (k, ns, _), o in sorted(self._objects.items())
                if k == kind and (namespace is None or ns == namespace)
            ]

    def update(self, obj: TypedObject, *,
               spec_changed: Optional[bool] = None) -> TypedObject:
        """Optimistic-concurrency update.  Bumps generation when the spec
        changed (the caller may force it with spec_changed); content equal
        to the stored object is a no-op (same rv, no event)."""
        with self._lock:
            key = self._key(obj)
            if key not in self._objects:
                raise NotFoundError(f"{key} not found")
            old = self._objects[key]
            rv = obj.metadata.resource_version
            if rv and rv != old.metadata.resource_version:
                raise ConflictError(
                    f"{key}: rv {rv} != {old.metadata.resource_version}")
            obj = copy.deepcopy(obj)
            obj.metadata.uid = old.metadata.uid
            obj.metadata.creation_timestamp = old.metadata.creation_timestamp
            obj.metadata.resource_version = old.metadata.resource_version
            obj.metadata.generation = old.metadata.generation
            if obj == old:
                # the loop-breaker that lets controller chains converge
                return copy.deepcopy(old)
            if spec_changed is None:
                spec_changed = _spec_view(obj) != _spec_view(old)
            obj.metadata.generation = (old.metadata.generation
                                       + (1 if spec_changed else 0))
            obj.metadata.resource_version = self._next_rv()
            # deletion in progress + finalizers drained -> actually delete
            if (obj.metadata.deletion_timestamp is not None
                    and not obj.metadata.finalizers):
                del self._objects[key]
                etype = DELETED
            else:
                self._objects[key] = obj
                etype = MODIFIED
            stored = copy.deepcopy(obj)
            self._pending_events.append(
                Event(etype, stored, copy.deepcopy(old)))
        self._drain()
        return stored

    def mutate(self, kind: str, namespace: str, name: str,
               fn: Callable[[TypedObject], None],
               retries: int = 8) -> TypedObject:
        """Get-mutate-update with conflict retry (controller patch helper)."""
        for _ in range(retries):
            obj = self.get(kind, namespace, name)
            fn(obj)
            try:
                return self.update(obj)
            except ConflictError:
                continue
        raise ConflictError(
            f"mutate {kind}/{namespace}/{name}: too many conflicts")

    def delete(self, kind: str, namespace: str, name: str) -> None:
        """Finalizer-aware delete: marks deletionTimestamp; removal happens
        once finalizers drain (or immediately when none)."""
        with self._lock:
            key = (kind, namespace, name)
            if key not in self._objects:
                raise NotFoundError(f"{key} not found")
            obj = self._objects[key]
            if obj.metadata.finalizers:
                if obj.metadata.deletion_timestamp is not None:
                    return
                obj.metadata.deletion_timestamp = now()
                obj.metadata.resource_version = self._next_rv()
                event = Event(MODIFIED, copy.deepcopy(obj))
            else:
                del self._objects[key]
                obj.metadata.deletion_timestamp = (
                    obj.metadata.deletion_timestamp or now())
                event = Event(DELETED, copy.deepcopy(obj))
            self._pending_events.append(event)
        self._drain()

    def counts_by_kind(self) -> Dict[str, int]:
        """Object tally per kind without copying any values."""
        with self._lock:
            counts: Dict[str, int] = {}
            for kind, _, _ in self._objects:
                counts[kind] = counts.get(kind, 0) + 1
            return counts

    def __len__(self) -> int:
        with self._lock:
            return len(self._objects)
