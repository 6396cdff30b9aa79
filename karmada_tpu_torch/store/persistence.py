"""Store persistence: snapshot + write-ahead log, restart via resync.

Counterpart of the JAX package's ``store/persistence.py``.  The reference
keeps all control-plane state in etcd behind the karmada-apiserver;
components are stateless and resume by informer resync + leader election.
Here the ObjectStore is the apiserver, so durability lives at its layer:

  * every committed write (the copied object the watch bus delivers)
    appends to a length-prefixed WAL, flushed and fsynced;
  * `snapshot()` writes the full object set and truncates the WAL;
  * `load_store()` rebuilds a store from snapshot + WAL replay, then
    rotates (fresh snapshot, empty WAL) so logs never grow across
    restarts.

A restored ControlPlane re-publishes one synthetic ADDED event per object
(`resync`), and every reconcile is idempotent.
"""

from __future__ import annotations

import os
import pickle
import struct
import threading
from typing import Optional

from karmada_tpu_torch.store.store import ADDED, DELETED, Event, ObjectStore

_LEN = struct.Struct("<I")

SNAPSHOT_FILE = "store.snapshot"
WAL_FILE = "store.wal"


class FilePersistence:
    """Attach to an ObjectStore; every bus event lands in the WAL."""

    def __init__(self, directory: str) -> None:
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self._lock = threading.Lock()
        self._wal = open(os.path.join(directory, WAL_FILE), "ab")
        self._store: Optional[ObjectStore] = None
        self._paused = False

    def attach(self, store: ObjectStore) -> None:
        self._store = store
        store.bus.subscribe(self._on_event)

    def pause(self) -> None:
        """Skip WAL appends (the resync's republication of durable state;
        only around single-threaded startup, or real writes drop)."""
        self._paused = True

    def resume(self) -> None:
        self._paused = False

    def _on_event(self, event: Event) -> None:
        if self._paused:
            return
        record = (event.type, pickle.dumps(event.obj, pickle.HIGHEST_PROTOCOL))
        payload = pickle.dumps(record, pickle.HIGHEST_PROTOCOL)
        with self._lock:
            self._wal.write(_LEN.pack(len(payload)))
            self._wal.write(payload)
            self._wal.flush()
            os.fsync(self._wal.fileno())

    def snapshot(self) -> None:
        """Write the full object set and truncate the WAL (atomic rename).

        self._lock is held across the store cut and the rotation: a write
        committed after the cut lands in the new WAL, never truncated out
        of the old one.  Lock order is persistence._lock -> store._lock;
        appenders take persistence._lock alone, and the store publishes
        its events after releasing its lock."""
        assert self._store is not None
        with self._lock:
            with self._store._lock:  # noqa: SLF001 — a consistent cut
                objects = list(self._store._objects.values())  # noqa: SLF001
                rv = self._store._rv  # noqa: SLF001
            tmp = os.path.join(self.directory, SNAPSHOT_FILE + ".tmp")
            with open(tmp, "wb") as f:
                pickle.dump({"rv": rv, "objects": objects}, f,
                            pickle.HIGHEST_PROTOCOL)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, os.path.join(self.directory, SNAPSHOT_FILE))
            self._wal.close()
            self._wal = open(os.path.join(self.directory, WAL_FILE), "wb")

    def close(self) -> None:
        with self._lock:
            self._wal.close()


def load_store(directory: str, admission=None) -> ObjectStore:
    """Rebuild an ObjectStore from snapshot + WAL, attach fresh persistence
    (rotating the log) and return it.  Missing files: an empty store."""
    store = ObjectStore(admission=admission)
    snap_path = os.path.join(directory, SNAPSHOT_FILE)
    rv = 0
    if os.path.exists(snap_path):
        with open(snap_path, "rb") as f:
            snap = pickle.load(f)
        rv = snap["rv"]
        for obj in snap["objects"]:
            store._put(store._key(obj), obj)  # noqa: SLF001 — no events
    wal_path = os.path.join(directory, WAL_FILE)
    if os.path.exists(wal_path):
        with open(wal_path, "rb") as f:
            data = f.read()
        off = 0
        while off + _LEN.size <= len(data):
            (n,) = _LEN.unpack_from(data, off)
            off += _LEN.size
            if off + n > len(data):
                break  # a torn tail write: discarded
            etype, blob = pickle.loads(data[off:off + n])
            off += n
            obj = pickle.loads(blob)
            key = store._key(obj)  # noqa: SLF001
            if etype == DELETED:
                if key in store._objects:  # noqa: SLF001
                    store._drop(key)  # noqa: SLF001
            else:
                store._put(key, obj)  # noqa: SLF001
            rv = max(rv, obj.metadata.resource_version or 0)
    store._rv = rv  # noqa: SLF001
    persistence = FilePersistence(directory)
    persistence.attach(store)
    persistence.snapshot()
    store.persistence = persistence
    return store


def resync(store: ObjectStore) -> None:
    """Informer-style resync: re-publish every object as a synthetic ADDED
    event so freshly wired controllers reconcile the restored state.  WAL
    appends pause meanwhile (the objects are already durable)."""
    persistence = getattr(store, "persistence", None)
    if persistence is not None:
        persistence.pause()
    try:
        for obj in store.items():
            store.bus.publish(Event(ADDED, obj))
    finally:
        if persistence is not None:
            persistence.resume()
