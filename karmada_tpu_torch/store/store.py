"""In-process object store with apiserver semantics.

Counterpart of the JAX package's ``store/store.py``: typed objects keyed
by (kind, namespace, name), a monotonically increasing resourceVersion,
generation bumps on spec change, watch subscriptions with
ADDED/MODIFIED/DELETED events, finalizer-gated deletion and an optional
admission chain (webhook.AdmissionRegistry: mutate, then validate, inside
create and update, before the write).  Every read and write deep-copies,
so no caller shares an object with the store -- except `visit` and
`visit_all`, the read-only scans that hand out the stored objects
themselves for callers that only look.

Objects are also indexed by kind and namespace, so a list of one kind
costs that kind's objects, not the whole store's, and copied by `_clone`,
a deep copy that builds the models' dataclasses directly (3-4x quicker
than copy.deepcopy on the loop's objects) and shares their immutable
Quantities.

Thread-safe; watch delivery is synchronous, in resourceVersion order, so
a deterministic pump and a threaded runtime share the machinery.
Persistence is not part of the port yet.
"""

from __future__ import annotations

import copy
import threading
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Optional, Tuple

from karmada_tpu_torch.models.meta import TypedObject, new_uid, now

_ATOMIC = frozenset({str, int, float, bool, type(None), bytes})


def _clone(v):
    """A deep copy of a model object: dicts, lists and (unfrozen)
    dataclasses are rebuilt, atoms and frozen dataclasses shared; any
    other type goes through copy.deepcopy."""
    t = type(v)
    if t in _ATOMIC:
        return v
    if t is dict:
        return {k: _clone(x) for k, x in v.items()}
    if t is list:
        return [_clone(x) for x in v]
    params = getattr(t, "__dataclass_params__", None)
    if params is not None and hasattr(v, "__dict__"):
        if params.frozen:
            return v
        new = object.__new__(t)
        new.__dict__.update({k: _clone(x) for k, x in v.__dict__.items()})
        return new
    if t is tuple:
        return tuple(_clone(x) for x in v)
    return copy.deepcopy(v)


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

    def unsubscribe(self, handler: Callable[[Event], None]) -> None:
        """Remove every subscription of `handler` (a plane torn down)."""
        with self._lock:
            self._subs = [(k, h) for (k, h) in self._subs if h != handler]

    def publish(self, event: Event) -> None:
        with self._lock:
            subs = list(self._subs)
        for kind, handler in subs:
            if kind is None or kind == event.kind:
                handler(event)


class ObjectStore:
    def __init__(self, bus: Optional[WatchBus] = None,
                 admission=None) -> None:
        # insertion-ordered, as items() / visit_all() walk it
        self._objects: Dict[Tuple[str, str, str], TypedObject] = {}
        # kind -> namespace -> name -> the same stored object
        self._index: Dict[str, Dict[str, Dict[str, TypedObject]]] = {}
        self._rv = 0
        self._lock = threading.RLock()
        self.bus = bus or WatchBus()
        # optional webhook.AdmissionRegistry: mutate/validate inside the
        # write path, before the write
        self.admission = admission
        # Events are enqueued under _lock (in resourceVersion order) and
        # drained under _pub_lock, so concurrent writers never deliver a
        # newer rv before an older one.  A subscriber callback that writes
        # to the store enqueues and returns; the outer drain delivers it.
        self._pending_events: List[Event] = []
        self._pub_lock = threading.Lock()
        self._draining: Optional[int] = None  # thread id of active drainer
        # nested-write depth per thread: an admission plugin writing to the
        # store runs inside the outer write's lock; its _drain defers to
        # the outermost write (blocking on _pub_lock there can deadlock
        # against a drainer's subscriber taking _lock)
        self._wd = threading.local()

    def _begin_write(self) -> None:
        self._wd.depth = getattr(self._wd, "depth", 0) + 1

    def _end_write(self) -> None:
        self._wd.depth -= 1

    def _drain(self) -> None:
        if getattr(self._wd, "depth", 0) > 0:
            return  # nested write: the outermost writer drains
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

    def _put(self, key: Tuple[str, str, str], obj: TypedObject) -> None:
        self._objects[key] = obj
        kind, ns, name = key
        self._index.setdefault(kind, {}).setdefault(ns, {})[name] = obj

    def _drop(self, key: Tuple[str, str, str]) -> None:
        del self._objects[key]
        kind, ns, name = key
        by_ns = self._index[kind]
        del by_ns[ns][name]
        if not by_ns[ns]:
            del by_ns[ns]

    def _scan(self, kind: str,
              namespace: Optional[str]) -> List[TypedObject]:
        """The stored objects of `kind` sorted by (namespace, name); call
        under _lock."""
        by_ns = self._index.get(kind)
        if not by_ns:
            return []
        out: List[TypedObject] = []
        for ns in ([namespace] if namespace is not None else sorted(by_ns)):
            names = by_ns.get(ns)
            if names:
                out.extend(names[n] for n in sorted(names))
        return out

    @property
    def revision(self) -> int:
        """The newest resourceVersion handed out (moves on every write
        that changed something)."""
        with self._lock:
            return self._rv

    # -- API ---------------------------------------------------------------
    def create(self, obj: TypedObject) -> TypedObject:
        self._begin_write()
        try:
            with self._lock:
                key = self._key(obj)
                if key in self._objects:
                    raise AlreadyExistsError(f"{key} already exists")
                obj = _clone(obj)
                if self.admission is not None:
                    self.admission.admit("CREATE", obj, None)
                if not obj.metadata.uid:
                    obj.metadata.uid = new_uid()
                obj.metadata.creation_timestamp = now()
                obj.metadata.generation = 1
                obj.metadata.resource_version = self._next_rv()
                self._put(key, obj)
                stored = _clone(obj)
                self._pending_events.append(Event(ADDED, stored))
        finally:
            self._end_write()
        self._drain()
        return stored

    def get(self, kind: str, namespace: str, name: str) -> TypedObject:
        with self._lock:
            key = (kind, namespace, name)
            if key not in self._objects:
                raise NotFoundError(f"{key} not found")
            return _clone(self._objects[key])

    def try_get(self, kind: str, namespace: str,
                name: str) -> Optional[TypedObject]:
        try:
            return self.get(kind, namespace, name)
        except NotFoundError:
            return None

    def peek(self, kind: str, namespace: str,
             name: str) -> Optional[TypedObject]:
        """The stored object itself (or None), without copying: visit()'s
        read-only rules."""
        with self._lock:
            return self._objects.get((kind, namespace, name))

    def list(self, kind: str,
             namespace: Optional[str] = None) -> List[TypedObject]:
        """Copies of every object of `kind`, sorted by (namespace, name)."""
        with self._lock:
            return [_clone(o) for o in self._scan(kind, namespace)]

    def visit(self, kind: str,
              namespace: Optional[str] = None) -> List[TypedObject]:
        """The stored objects of `kind` themselves, in list()'s order,
        without copying: for read-only callers.  The caller must not
        mutate them nor keep them past its own call (a later write
        replaces the stored object; a finalizer-gated delete marks it in
        place)."""
        with self._lock:
            return self._scan(kind, namespace)

    def visit_all(self) -> List[TypedObject]:
        """Every stored object itself, in items()'s order, without
        copying; the same rules as visit()."""
        with self._lock:
            return list(self._objects.values())

    def items(self) -> Iterator[TypedObject]:
        """Copies of every stored object, in insertion order."""
        with self._lock:
            snapshot = [_clone(o) for o in self._objects.values()]
        return iter(snapshot)

    def update(self, obj: TypedObject, *,
               spec_changed: Optional[bool] = None) -> TypedObject:
        """Optimistic-concurrency update.  Bumps generation when the spec
        changed (the caller may force it with spec_changed); content equal
        to the stored object is a no-op (same rv, no event)."""
        return self._update(obj, spec_changed, owned=False)

    def _update(self, obj: TypedObject, spec_changed: Optional[bool],
                owned: bool) -> TypedObject:
        self._begin_write()
        try:
            stored = self._update_inner(obj, spec_changed, owned)
        finally:
            self._end_write()
        self._drain()
        return stored

    def _update_inner(self, obj: TypedObject, spec_changed: Optional[bool],
                      owned: bool) -> TypedObject:
        """`owned`: obj is the caller's private copy (mutate's), compared
        as it is and copied only when it is written -- it may hold
        references the caller keeps.  The replaced object leaves the store,
        so the event carries it as `old` without a copy."""
        with self._lock:
            key = self._key(obj)
            if key not in self._objects:
                raise NotFoundError(f"{key} not found")
            old = self._objects[key]
            rv = obj.metadata.resource_version
            if rv and rv != old.metadata.resource_version:
                raise ConflictError(
                    f"{key}: rv {rv} != {old.metadata.resource_version}")
            if not owned:
                obj = _clone(obj)
            if self.admission is not None:
                self.admission.admit("UPDATE", obj, _clone(old))
            obj.metadata.uid = old.metadata.uid
            obj.metadata.creation_timestamp = old.metadata.creation_timestamp
            obj.metadata.resource_version = old.metadata.resource_version
            obj.metadata.generation = old.metadata.generation
            if obj == old:
                # the loop-breaker that lets controller chains converge; obj
                # is a private copy equal to the stored object
                return obj
            if owned:
                obj = _clone(obj)
            if spec_changed is None:
                spec_changed = _spec_view(obj) != _spec_view(old)
            obj.metadata.generation = (old.metadata.generation
                                       + (1 if spec_changed else 0))
            obj.metadata.resource_version = self._next_rv()
            # deletion in progress + finalizers drained -> actually delete
            if (obj.metadata.deletion_timestamp is not None
                    and not obj.metadata.finalizers):
                self._drop(key)
                etype = DELETED
            else:
                self._put(key, obj)
                etype = MODIFIED
            stored = _clone(obj)
            self._pending_events.append(Event(etype, stored, old))
        return stored

    def mutate(self, kind: str, namespace: str, name: str,
               fn: Callable[[TypedObject], None],
               retries: int = 8) -> TypedObject:
        """Get-mutate-update with conflict retry (controller patch helper)."""
        for _ in range(retries):
            obj = self.get(kind, namespace, name)
            fn(obj)
            try:
                return self._update(obj, None, owned=True)
            except ConflictError:
                continue
        raise ConflictError(
            f"mutate {kind}/{namespace}/{name}: too many conflicts")

    def delete(self, kind: str, namespace: str, name: str) -> None:
        """Finalizer-aware delete: marks deletionTimestamp; removal happens
        once finalizers drain (or immediately when none)."""
        self._begin_write()
        try:
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
                    event = Event(MODIFIED, _clone(obj))
                else:
                    self._drop(key)
                    obj.metadata.deletion_timestamp = (
                        obj.metadata.deletion_timestamp or now())
                    event = Event(DELETED, _clone(obj))
                self._pending_events.append(event)
        finally:
            self._end_write()
        self._drain()

    def counts_by_kind(self) -> Dict[str, int]:
        """Object tally per kind without copying any values."""
        with self._lock:
            counts: Dict[str, int] = {}
            for kind, by_ns in self._index.items():
                n = sum(len(names) for names in by_ns.values())
                if n:
                    counts[kind] = n
            return counts

    def __len__(self) -> int:
        with self._lock:
            return len(self._objects)
