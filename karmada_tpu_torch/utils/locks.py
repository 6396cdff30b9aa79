"""Armed runtime lock instrumentation (counterpart of the JAX package's
``utils/locks.py``, with its names, families and payload).

``VetLock`` is a drop-in proxy over ``threading.Lock``/``RLock`` that
shares the one arming flag with analysis/guards (``serve
--check-invariants`` / KARMADA_CHECK_INVARIANTS=1).  Disarmed, every
acquire/release is one list read plus delegation to the wrapped stdlib
lock — cheap enough to live on the production serve paths.  Armed, it
records:

  * per-thread OWNERSHIP — ``require_held()`` raises
    guards.InvariantViolation when `guarded-by:`-annotated state is
    touched off-lock;
  * ACQUISITION ORDER — first-seen lock-pair edges; observing B-then-A
    after A-then-B is a runtime order inversion, counted in
    ``karmada_lock_order_inversions_total{pair}`` and fired as the
    incident plane's ``lock-inversion`` trigger;
  * HOLD TIME — ``karmada_lock_hold_seconds{lock}`` observed at release,
    and a ``LockWatchdog`` that trips
    ``karmada_lock_watchdog_trips_total{lock}`` once per over-threshold
    hold (a wedged thread surfaces as a counter, not a silent hang).

``OwnerThread`` is the zero-lock variant for planes that are
single-threaded BY CONTRACT (scheduler/incremental): first toucher wins,
any other thread raises.  ``state_payload()`` feeds the ``locks`` block
of ``/debug/state`` (utils/httpserve) and of the incident bundles.

Bookkeeping uses a PLAIN ``threading.Lock`` registry lock and plain
thread-locals: the detector must never instrument itself (a VetLock
inside the edge table would recurse).  Known limitation: arming or
disarming while locks are held strands per-thread stack entries —
toggle only from quiescent code (tests arm before spawning threads).
"""

from __future__ import annotations

import threading
import time
import weakref
from collections import deque
from typing import Dict, List, Optional, Tuple

from karmada_tpu_torch.analysis import guards
from karmada_tpu_torch.utils.metrics import REGISTRY

#: injectable clock (tests stall the watchdog deterministically)
_CLOCK = [time.monotonic]


def set_clock(fn=None) -> None:
    """Swap the module clock (None restores time.monotonic)."""
    _CLOCK[0] = fn if fn is not None else time.monotonic


_HOLD = REGISTRY.histogram(
    "karmada_lock_hold_seconds",
    "Lock hold time observed at release while the runtime race "
    "detector is armed (utils/locks.VetLock)",
    ("lock",))
_INVERSIONS = REGISTRY.counter(
    "karmada_lock_order_inversions_total",
    "Runtime lock-acquisition order inversions: the armed detector saw "
    "pair A-then-B and later B-then-A (pair label is the sorted lock "
    "names joined with '|')",
    ("pair",))
_TRIPS = REGISTRY.counter(
    "karmada_lock_watchdog_trips_total",
    "Deadlock-watchdog trips: a lock held longer than the watchdog "
    "threshold (once per over-threshold hold)",
    ("lock",))

# detector bookkeeping — PLAIN lock, never a VetLock (no self-tracing)
_REG_LOCK = threading.Lock()
_ALL: "weakref.WeakSet[VetLock]" = weakref.WeakSet()  # guarded-by: _REG_LOCK
_EDGES: Dict[Tuple[str, str], int] = {}  # guarded-by: _REG_LOCK
_INV_DETAILS: deque = deque(maxlen=32)  # guarded-by: _REG_LOCK
_OWNERS: "weakref.WeakSet[OwnerThread]" = weakref.WeakSet()  # guarded-by: _REG_LOCK

_TLS = threading.local()


def _held_stack() -> list:
    stack = getattr(_TLS, "held", None)
    if stack is None:
        stack = _TLS.held = []
    return stack


def _note_edge(first: str, then: str, thread_name: str) -> None:
    """Record first-seen order edge (first held when `then` acquired);
    count an inversion when the reverse edge was seen earlier."""
    inv = None
    with _REG_LOCK:
        if (then, first) in _EDGES and (first, then) not in _EDGES:
            pair = "|".join(sorted((first, then)))
            _INVERSIONS.inc(pair=pair)
            inv = {
                "pair": pair, "held": first, "acquired": then,
                "thread": thread_name,
            }
            _INV_DETAILS.append(inv)
        _EDGES[(first, then)] = _EDGES.get((first, then), 0) + 1
    if inv is not None:
        # incident trigger AFTER _REG_LOCK releases: the bundle capture
        # reads state_payload() (which takes _REG_LOCK) — firing under
        # it would deadlock.  Lazy import: utils must not pull obs at
        # module load.
        from karmada_tpu_torch.obs import incidents as obs_incidents

        obs_incidents.trigger(
            obs_incidents.TRIGGER_LOCK_INVERSION,
            f"lock order inversion: {inv['acquired']} acquired while "
            f"{inv['held']} held", detail=inv)


class VetLock:
    """Drop-in lock proxy: ``with lock:`` / acquire / release, plus armed
    ownership + order + hold-time recording.  Not reentrant unless
    constructed with reentrant=True (then wraps an RLock)."""

    def __init__(self, name: str, reentrant: bool = False) -> None:
        self.name = name
        self.reentrant = reentrant
        self._lock = threading.RLock() if reentrant else threading.Lock()
        self._owner: Optional[int] = None       # thread ident while held
        self._owner_name: str = ""
        self._acquired_at: Optional[float] = None
        self._trip_mark: Optional[float] = None  # watchdog: once per hold
        with _REG_LOCK:
            _ALL.add(self)

    # -- the lock protocol --------------------------------------------

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._lock.acquire(blocking, timeout)
        if ok and guards._ARMED[0]:  # noqa: SLF001 — the one arming flag
            self._on_acquire()
        return ok

    def release(self) -> None:
        if guards._ARMED[0]:  # noqa: SLF001
            self._on_release()
        self._lock.release()

    def __enter__(self) -> "VetLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._lock.locked() if hasattr(self._lock, "locked") \
            else self._owner is not None

    # -- armed bookkeeping --------------------------------------------

    def _on_acquire(self) -> None:
        now = _CLOCK[0]()
        me = threading.current_thread()
        stack = _held_stack()
        if not any(entry[0] is self for entry in stack):
            for other, _t0 in stack:
                if other is not self:
                    _note_edge(other.name, self.name, me.name)
            # outermost acquire starts the hold clock
            self._acquired_at = now
            self._trip_mark = None
        stack.append((self, now))
        self._owner = me.ident
        self._owner_name = me.name

    def _on_release(self) -> None:
        now = _CLOCK[0]()
        stack = _held_stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i][0] is self:
                del stack[i]
                break
        else:
            # released by a thread that never recorded the acquire
            # (cross-thread release, or armed mid-hold): clear and move on
            self._owner = None
            self._acquired_at = None
            return
        if not any(entry[0] is self for entry in stack):
            t0 = self._acquired_at
            self._owner = None
            self._acquired_at = None
            if t0 is not None:
                _HOLD.observe(now - t0, lock=self.name)

    # -- the enforcement surface --------------------------------------

    def held_by_me(self) -> bool:
        return self._owner == threading.get_ident()

    def require_held(self, what: str = "") -> None:
        """Armed: raise unless the CURRENT thread holds this lock — the
        runtime teeth for `guarded-by:` state.  Disarmed: one list read."""
        if not guards._ARMED[0]:  # noqa: SLF001
            return
        if self._owner != threading.get_ident():
            raise guards.InvariantViolation(
                f"{what or 'guarded state'} touched without holding "
                f"`{self.name}` (owner: "
                f"{self._owner_name if self._owner is not None else 'nobody'}"
                f", this thread: {threading.current_thread().name})")


def make_lock(name: str) -> VetLock:
    """Module-global VetLock constructor the static lock-order pass
    recognizes by name."""
    return VetLock(name)


def make_rlock(name: str) -> VetLock:
    return VetLock(name, reentrant=True)


class OwnerThread:
    """Single-thread-ownership assertion for planes that are
    single-threaded by contract: the first thread to call check() owns
    the plane; any other thread raises (armed only).  reset() hands
    ownership to the next toucher (tests, plane rebuilds)."""

    def __init__(self, name: str) -> None:
        self.name = name
        self._ident: Optional[int] = None
        self._thread_name: str = ""
        with _REG_LOCK:
            _OWNERS.add(self)

    def check(self, what: str = "") -> None:
        if not guards._ARMED[0]:  # noqa: SLF001 — one list read disarmed
            return
        me = threading.current_thread()
        if self._ident is None:
            self._ident = me.ident
            self._thread_name = me.name
            return
        if me.ident != self._ident:
            raise guards.InvariantViolation(
                f"`{self.name}` is single-threaded by contract (owned by "
                f"thread {self._thread_name}); {what or 'entry'} called "
                f"from thread {me.name}")

    def reset(self) -> None:
        self._ident = None
        self._thread_name = ""


class LockWatchdog:
    """Periodic scan for over-threshold holds.  check() is the
    deterministic single-scan entry (tests drive it with an injected
    clock); start() runs it on a daemon thread for serve processes."""

    def __init__(self, threshold_s: float = 5.0,
                 poll_s: float = 1.0) -> None:
        self.threshold_s = threshold_s
        self.poll_s = poll_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def check(self) -> List[dict]:
        """One scan: trip (once per hold) every armed VetLock held
        longer than threshold_s; returns the trip records."""
        if not guards.armed():
            return []
        now = _CLOCK[0]()
        trips: List[dict] = []
        with _REG_LOCK:
            locks = list(_ALL)
        for lock in locks:
            t0 = lock._acquired_at  # noqa: SLF001 — racy read is fine:
            # a stale value costs one late/early trip, never a crash
            if t0 is None or now - t0 < self.threshold_s:
                continue
            if lock._trip_mark == t0:  # noqa: SLF001
                continue  # already tripped for this hold
            lock._trip_mark = t0  # noqa: SLF001
            _TRIPS.inc(lock=lock.name)
            trips.append({"lock": lock.name, "held_s": now - t0,
                          "owner": lock._owner_name})  # noqa: SLF001
        if trips:
            # _REG_LOCK is NOT held here (released after the _ALL copy);
            # the capture re-takes it for the locks block
            from karmada_tpu_torch.obs import incidents as obs_incidents

            obs_incidents.trigger(
                obs_incidents.TRIGGER_LOCK_WATCHDOG,
                f"{len(trips)} lock(s) held over {self.threshold_s:g}s",
                detail={"threshold_s": self.threshold_s, "trips": trips})
        return trips

    def start(self) -> "LockWatchdog":
        if self._thread is None:
            t = threading.Thread(target=self._run, daemon=True,
                                 name="lock-watchdog")
            self._thread = t
            t.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            try:
                self.check()
            except Exception:  # vet: ignore[exception-hygiene] watchdog must outlive any scan hiccup; trips are its only output
                pass

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None


_WATCHDOG: List[Optional[LockWatchdog]] = [None]


def start_watchdog(threshold_s: float = 5.0,
                   poll_s: float = 1.0) -> LockWatchdog:
    """The serve-process singleton (serve --check-invariants)."""
    if _WATCHDOG[0] is None:
        _WATCHDOG[0] = LockWatchdog(threshold_s, poll_s).start()
    return _WATCHDOG[0]


def stop_watchdog() -> None:
    if _WATCHDOG[0] is not None:
        _WATCHDOG[0].stop()
        _WATCHDOG[0] = None


def state_payload() -> dict:
    """The `locks` block of /debug/state (utils/httpserve)."""
    with _REG_LOCK:
        locks = sorted(_ALL, key=lambda lk: lk.name)[:64]
        edges = len(_EDGES)
        details = list(_INV_DETAILS)
        owners = sorted(_OWNERS, key=lambda o: o.name)[:32]
    now = _CLOCK[0]()
    rows = []
    for lk in locks:
        t0 = lk._acquired_at  # noqa: SLF001 — racy snapshot by design
        rows.append({
            "name": lk.name,
            "kind": "rlock" if lk.reentrant else "lock",
            "owner": lk._owner_name if t0 is not None else None,  # noqa: SLF001
            "held_for_s": (now - t0) if t0 is not None else None,
        })
    wd = _WATCHDOG[0]
    return {
        "armed": guards.armed(),
        "locks": rows,
        "owner_threads": [
            {"name": o.name,
             "owner": o._thread_name or None}  # noqa: SLF001
            for o in owners],
        "order_edges": edges,
        "inversions": {
            "total": _INVERSIONS.total(),
            "recent": details,
        },
        "watchdog": {
            "running": wd is not None,
            "threshold_s": wd.threshold_s if wd is not None else None,
            "trips_total": _TRIPS.total(),
        },
    }


def reset_for_tests() -> None:
    """Clear the order-edge table and inversion details (metric counters
    are cumulative; tests assert deltas)."""
    with _REG_LOCK:
        _EDGES.clear()
        _INV_DETAILS.clear()
