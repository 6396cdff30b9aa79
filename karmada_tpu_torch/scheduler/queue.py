"""Three-queue scheduling queue: active / backoff / unschedulable.

Counterpart of the JAX package's ``scheduler/queue.py``, which mirrors the
reference's priority scheduling queue (pkg/scheduler/internal/queue/
scheduling_queue.go:127-372, active_queue.go:40, types.go Less):

  * activeQ       -- priority heap (priority desc, enqueue timestamp asc,
                     then push order) of bindings ready to schedule now;
  * backoffQ      -- heap ordered by backoff expiry; failed attempts wait
                     out an exponential backoff (1s doubling to 10s)
                     before re-entering activeQ;
  * unschedulable -- bindings whose last attempt found no capacity; they
                     re-enter activeQ on a cluster event
                     (move_all_to_active_or_backoff) or after the leftover
                     flush interval (default 5 min).

Failure routing (the scheduler's handleErr): UnschedulableError ->
unschedulable map; any other scheduling error (FitError included) ->
backoffQ.  Success -> forget.  pop_ready drains a batch; the queue runs
tick-driven on an injectable clock; an optional bounded-resident
admission gate (`max_resident`) sheds by priority.  Every decision is
counted in the JAX package's ADMISSION family
(karmada_scheduler_admission_total{decision}); external pushes, sheds and
displacements land on the lifecycle ledger (obs/events.py).
"""

from __future__ import annotations

import heapq
import itertools
import time as _time
from dataclasses import dataclass
from typing import Callable, Dict, Hashable, List, Optional, Tuple

from karmada_tpu_torch.obs import events as obs_events
from karmada_tpu_torch.scheduler import metrics as sched_metrics


DEFAULT_INITIAL_BACKOFF_S = 1.0
DEFAULT_MAX_BACKOFF_S = 10.0
DEFAULT_MAX_IN_UNSCHEDULABLE_S = 300.0

# admission decisions (karmada_scheduler_admission_total{decision}):
# every Push resolves to exactly one of ADMITTED / SHED, so
# admitted + shed == total Push calls (the accounting-exactness
# invariant the soak tests assert); DISPLACED counts evicted residents
# (a separate axis: each displacement also admits the newcomer)
ADMIT_ADMITTED = "admitted"
ADMIT_SHED = "shed"
ADMIT_DISPLACED = "displaced"


@dataclass
class QueuedBindingInfo:
    """types.go QueuedBindingInfo: key + priority + queue bookkeeping."""

    key: Hashable
    priority: int = 0
    timestamp: float = 0.0  # last time added to a queue
    attempts: int = 0
    initial_attempt_timestamp: Optional[float] = None
    # which queue this entry sat in before (re-)entering activeQ — the
    # dwell counters bucket by it ("active": fresh external push,
    # "backoff"/"unschedulable": a flush re-admitted it)
    origin: str = "active"

    def _active_sort_key(self, seq: int) -> Tuple:
        # Less (types.go:182): priority desc, then timestamp asc
        return (-self.priority, self.timestamp, seq)


class SchedulingQueue:
    def __init__(
        self,
        initial_backoff_s: float = DEFAULT_INITIAL_BACKOFF_S,
        max_backoff_s: float = DEFAULT_MAX_BACKOFF_S,
        max_in_unschedulable_s: float = DEFAULT_MAX_IN_UNSCHEDULABLE_S,
        now: Callable[[], float] = _time.time,
        # bounded-resident admission gate: Push never grows the tracked
        # population (all three queues) beyond this; None disables
        # (unbounded, the pre-admission behavior).  Internal moves
        # between queues never consume a new slot, so the bound holds
        # across flushes.  Precise guarantee: the gate bounds ADMISSION
        # only — a cycle's failure re-adds (push_backoff/unschedulable_
        # if_not_present) and its gate-exempt result-patch echo pushes
        # re-enter unconditionally (entries popped before concurrent
        # pushes refilled their slots; the reference's retry semantics),
        # so the hard ceiling is max_resident + one in-flight batch
        # (<= batch_window).
        max_resident: Optional[int] = None,
    ) -> None:
        self.initial_backoff_s = initial_backoff_s
        self.max_backoff_s = max_backoff_s
        self.max_in_unschedulable_s = max_in_unschedulable_s
        self.max_resident = max_resident
        self.now = now
        self._seq = itertools.count()
        # heaps hold (sort_key..., key); staleness is resolved against the
        # authoritative _where map (lazy deletion)
        self._active_heap: List[Tuple] = []
        self._backoff_heap: List[Tuple] = []
        self._info: Dict[Hashable, QueuedBindingInfo] = {}
        # key -> active|backoff|unschedulable; mutate ONLY through
        # _set_where so the O(1) depth counters can never drift —
        # depths() runs per cycle AND per publisher-thread admission
        # check, and an O(n) scan there would hold _queue_lock for the
        # whole resident population on the hot path
        self._where: Dict[Hashable, str] = {}
        self._depths: Dict[str, int] = {"active": 0, "backoff": 0,
                                        "unschedulable": 0}
        # per-queue (entry-timestamp, key) min-heaps backing the oldest-
        # resident lookups (lazy deletion like _backoff_heap/_prio_heap):
        # oldest_ages()/oldest_active_age() run per cycle AND per 0.5s
        # tick, and an O(n) resident scan there would hold _queue_lock
        # against every publisher push.  Timestamps are monotone, so
        # stale entries surface at the head and the every-tick peek
        # cleans them promptly; _set_where compacts as a backstop.
        self._entry_heaps: Dict[str, List[Tuple]] = {
            "active": [], "backoff": [], "unschedulable": []}
        # lowest-priority-first heap over active residents (lazy deletion,
        # same discipline as _active_heap) — the shed victim lookup must
        # not scan the whole resident map on every overloaded Push
        self._prio_heap: List[Tuple] = []
        # the expiry of the CURRENT backoff residence; a heap entry whose
        # expiry differs is stale (the key left and re-entered backoff)
        self._backoff_expiry: Dict[Hashable, float] = {}
        # dominant unschedulable reason per resident unschedulable key
        # (explain plane / classify_unschedulable taxonomy); dropped when
        # the key leaves the unschedulable map
        self._unsched_reason: Dict[Hashable, str] = {}

    # -- internals -----------------------------------------------------------
    def _set_where(self, key: Hashable, state: Optional[str]) -> None:
        """The single _where mutation point, keeping the depth counters
        exact and the oldest-entry heaps fed (state None removes the
        key; callers store the entry's _info BEFORE transitioning so
        the heap records the current residence timestamp)."""
        old = self._where.get(key)
        if old is not None:
            self._depths[old] -= 1
        if state is None:
            self._where.pop(key, None)
        else:
            self._where[key] = state
            self._depths[state] += 1
            heap = self._entry_heaps[state]
            if len(heap) > 4 * max(len(self._where), 64):
                heap = [(self._info[k].timestamp, k)
                        for k, w in self._where.items() if w == state]
                heapq.heapify(heap)
                self._entry_heaps[state] = heap
            heapq.heappush(heap, (self._info[key].timestamp, key))

    def _oldest_entry_age(self, qname: str, now: float) -> float:
        """Age of `qname`'s oldest resident via its lazy entry heap —
        stale heads (key left the queue or re-entered with a newer
        timestamp) are popped on the way."""
        heap = self._entry_heaps[qname]
        while heap:
            ts, key = heap[0]
            info = self._info.get(key)
            if (self._where.get(key) != qname or info is None
                    or info.timestamp != ts):
                heapq.heappop(heap)  # stale entry
                continue
            return max(0.0, now - ts)
        return 0.0

    def _move_to_active(self, info: QueuedBindingInfo,
                        origin: str = "active") -> None:
        """moveToActiveQ (scheduling_queue.go:330): also removes the key from
        backoff/unschedulable (lazily, via _where).  `origin` names the
        queue the entry came from — pop_ready buckets its dwell by it."""
        info.origin = origin
        self._info[info.key] = info
        self._set_where(info.key, "active")
        self._backoff_expiry.pop(info.key, None)
        self._unsched_reason.pop(info.key, None)
        heapq.heappush(
            self._active_heap, info._active_sort_key(next(self._seq)) + (info.key,)
        )
        if self.max_resident is not None:
            # victim-lookup heap only exists while the gate is armed (an
            # unbounded queue never displaces); compaction below bounds
            # the stale entries lazy deletion leaves behind
            if len(self._prio_heap) > 4 * max(len(self._where), 64):
                self._prio_heap = [
                    (self._info[k].priority, i, k)
                    for i, (k, w) in enumerate(self._where.items())
                    if w == "active"
                ]
                heapq.heapify(self._prio_heap)
            heapq.heappush(self._prio_heap,
                           (info.priority, next(self._seq), info.key))

    def _lowest_priority_active(self) -> Optional[Hashable]:
        """The active resident with the lowest priority (oldest wins ties),
        via the lazy prio heap — the candidate a higher-priority arrival
        may displace under the admission gate."""
        while self._prio_heap:
            prio, _, key = self._prio_heap[0]
            info = self._info.get(key)
            if (self._where.get(key) != "active" or info is None
                    or info.priority != prio):
                heapq.heappop(self._prio_heap)  # stale entry
                continue
            return key
        return None

    def _backoff_duration(self, info: QueuedBindingInfo) -> float:
        """calculateBackoffDuration (:225): 0 for first attempt, then initial
        doubling per prior attempt, saturating at max."""
        if info.attempts == 0:
            return 0.0
        d = self.initial_backoff_s
        for _ in range(1, info.attempts):
            if d > self.max_backoff_s - d:
                return self.max_backoff_s
            d += d
        return d

    # -- producer side -------------------------------------------------------
    def push(self, key: Hashable, priority: int = 0,
             gate_exempt: bool = False, origin: str = "active") -> str:
        """Push (:276): external event -> activeQ, superseding any backoff /
        unschedulable residence.  Returns the admission decision:
        ADMIT_ADMITTED or ADMIT_SHED (the gate refused a NEW key; resident
        keys always re-admit — they already hold a slot).  A successful
        displacement admits the newcomer after forgetting the lowest-
        priority active resident (counted separately as ADMIT_DISPLACED).

        `gate_exempt` bypasses the admission check for a key whose slot
        was freed moments ago by its own pop in the CURRENT scheduling
        cycle (the scheduler's result-patch events re-push every
        scheduled binding): that bookkeeping echo must neither consume a
        fresh slot nor displace a genuinely-waiting resident.

        `origin` names the plane that produced this push ("active" for a
        plain external event; "rebalance"/"hpa" for the rebalance plane's
        drains and the FederatedHPA fast path) — pop_ready buckets the
        entry's queue dwell by it, so re-place latency is attributable."""
        prev = self._info.get(key)
        if (not gate_exempt
                and self.max_resident is not None and key not in self._where
                and len(self._where) >= self.max_resident):
            victim = self._lowest_priority_active()
            if victim is None or self._info[victim].priority >= priority:
                # per-priority shedding: a newcomer that does not outrank
                # the weakest resident is the one shed (equal priority
                # keeps the resident — no displacement thrash)
                sched_metrics.ADMISSION.inc(decision=ADMIT_SHED)
                obs_events.emit_key(
                    key, obs_events.TYPE_WARNING,
                    obs_events.REASON_BINDING_SHED,
                    f"admission gate full ({self.max_resident} resident): "
                    "shed without a queue slot", origin=origin)
                return ADMIT_SHED
            self.forget(victim)
            sched_metrics.ADMISSION.inc(decision=ADMIT_DISPLACED)
            obs_events.emit_key(
                victim, obs_events.TYPE_WARNING,
                obs_events.REASON_BINDING_DISPLACED,
                "displaced from the admission gate by a higher-priority "
                "arrival", origin=origin)
        info = QueuedBindingInfo(
            key=key, priority=priority, timestamp=self.now(),
            attempts=prev.attempts if prev else 0,
            initial_attempt_timestamp=(
                prev.initial_attempt_timestamp if prev else None
            ),
        )
        self._move_to_active(info, origin=origin)
        sched_metrics.ADMISSION.inc(decision=ADMIT_ADMITTED)
        if not gate_exempt:
            # every EXTERNAL push lands one (coalescing) timeline entry;
            # the scheduler's own result-patch echoes stay silent
            obs_events.emit_key(
                key, obs_events.TYPE_NORMAL,
                obs_events.REASON_BINDING_ENQUEUED,
                f"enqueued to the active queue (origin={origin})",
                origin=origin)
        return ADMIT_ADMITTED

    def push_unschedulable_if_not_present(self, info: QueuedBindingInfo,
                                          reason: str = "") -> None:
        """:288 — no-op when the key already waits in active/backoff.
        `reason` is the dominant unschedulable reason (explain-plane /
        classify_unschedulable taxonomy); the map keeps it so operators
        can see WHY each resident binding is parked."""
        if self._where.get(info.key) in ("active", "backoff"):
            return
        info.timestamp = self.now()
        self._info[info.key] = info
        self._set_where(info.key, "unschedulable")
        if reason:
            self._unsched_reason[info.key] = reason

    def push_backoff_if_not_present(self, info: QueuedBindingInfo) -> None:
        """:301 — no-op when the key already waits in active/unschedulable."""
        if self._where.get(info.key) in ("active", "unschedulable"):
            return
        info.timestamp = self.now()
        self._info[info.key] = info
        self._set_where(info.key, "backoff")
        expiry = info.timestamp + self._backoff_duration(info)
        self._backoff_expiry[info.key] = expiry
        heapq.heappush(self._backoff_heap, (expiry, next(self._seq), info.key))

    def forget(self, key: Hashable) -> None:
        """:322 — scheduling finished (success or permanent); drop tracking."""
        self._info.pop(key, None)
        self._set_where(key, None)
        self._backoff_expiry.pop(key, None)
        self._unsched_reason.pop(key, None)

    # -- consumer side -------------------------------------------------------
    def pop_ready(self, max_n: Optional[int] = None) -> List[QueuedBindingInfo]:
        """Drain up to max_n activeQ entries in (priority desc, ts asc) order.

        The batched analogue of ActiveQueue.Pop; popped entries leave the
        queue entirely (the cycle calls forget / push_* per result, which is
        the Done() of this tick-driven design).
        """
        out: List[QueuedBindingInfo] = []
        now = self.now()
        while self._active_heap and (max_n is None or len(out) < max_n):
            entry = heapq.heappop(self._active_heap)
            key = entry[-1]
            if self._where.get(key) != "active":
                continue  # stale heap entry
            info = self._info.pop(key)
            self._set_where(key, None)
            if info.initial_attempt_timestamp is None:
                info.initial_attempt_timestamp = now
            # dwell since the entry's current residence, by the queue it
            # came from
            sched_metrics.QUEUE_DWELL.observe(
                max(0.0, now - info.timestamp), queue=info.origin)
            out.append(info)
        return out

    # -- periodic flushes ----------------------------------------------------
    def flush_backoff(self) -> int:
        """flushBackoffQCompleted (:195): expired backoff -> activeQ."""
        moved = 0
        now = self.now()
        while self._backoff_heap and self._backoff_heap[0][0] <= now:
            expiry, _, key = heapq.heappop(self._backoff_heap)
            if self._where.get(key) != "backoff":
                continue
            if expiry != self._backoff_expiry.get(key):
                continue  # stale entry from an earlier backoff residence
            self._move_to_active(self._info[key], origin="backoff")
            moved += 1
        return moved

    def flush_unschedulable_leftover(self) -> int:
        """flushUnschedulableBindingsLeftover (:252): entries older than
        max_in_unschedulable_s -> activeQ."""
        now = self.now()
        stale = [
            k for k, w in self._where.items()
            if w == "unschedulable"
            and now - self._info[k].timestamp > self.max_in_unschedulable_s
        ]
        for k in stale:
            self._move_to_active(self._info[k], origin="unschedulable")
        return len(stale)

    def move_all_to_active_or_backoff(self) -> int:
        """MoveAllToActiveOrBackoffQueue semantics: a cluster event may make
        unschedulable bindings schedulable; still-backing-off entries wait
        out their timer, others go active."""
        moved = 0
        for k in [k for k, w in self._where.items() if w == "unschedulable"]:
            info = self._info[k]
            expiry = info.timestamp + self._backoff_duration(info)
            if self.now() < expiry:
                self._set_where(k, "backoff")
                self._backoff_expiry[k] = expiry
                self._unsched_reason.pop(k, None)
                heapq.heappush(self._backoff_heap, (expiry, next(self._seq), k))
            else:
                self._move_to_active(info, origin="unschedulable")
            moved += 1
        return moved

    # -- introspection -------------------------------------------------------
    def depths(self) -> Dict[str, int]:
        """O(1): the incrementally-maintained per-queue counters (every
        _where transition goes through _set_where)."""
        return dict(self._depths)

    def oldest_active_age(self) -> float:
        """Age (seconds on the injected clock) of the oldest activeQ
        resident — the batch-formation deadline input: the cycle cuts when
        this exceeds the deadline even if the batch is not yet full.
        O(log n) amortized via the lazy entry heap, never a resident
        scan (this runs under _queue_lock on the cycle hot path)."""
        return self._oldest_entry_age("active", self.now())

    def oldest_ages(self) -> Dict[str, float]:
        """Per-queue oldest-resident age (starvation shows here before
        any report runs).  Same lazy-heap cost profile as
        oldest_active_age."""
        now = self.now()
        return {q: self._oldest_entry_age(q, now)
                for q in ("active", "backoff", "unschedulable")}

    def has(self, key: Hashable) -> bool:
        return key in self._where

    def unschedulable_reasons(self) -> Dict[str, int]:
        """Resident unschedulable keys bucketed by dominant reason (keys
        parked before reason accounting landed count as "unknown")."""
        counts: Dict[str, int] = {}
        for k, w in self._where.items():
            if w != "unschedulable":
                continue
            r = self._unsched_reason.get(k, "unknown")
            counts[r] = counts.get(r, 0) + 1
        return counts
