"""Lifecycle ledger: causal per-object event timelines across every plane.

Counterpart of the JAX package's ``obs/events.py``, with the same
reasons, coalescing and eviction; the port has no HTTP surface yet, so
the payload functions below are read in-process (the loadgen report).

The reference control plane answers "what happened to this object" with
Kubernetes Events — reasons enumerated in pkg/events/events.go, recorded
by every controller and surfaced via `kubectl describe`.  This module is
that journal grown into a first-class plane: a bounded, coalescing,
thread-safe ledger with a per-object timeline index, where every event
carries ``{type, reason, message, origin, cycle_id, trace_id,
decision_id}`` so an event is one click from its trace waterfall
(/debug/traces/{trace_id}) and its explain verdict
(/debug/explain/{ns}/{name}).

Emitters:

  * ``EventRecorder`` — the controllers' classic surface
    (``recorder.event(obj, type_, reason, message)``).  A bare
    ``EventRecorder()`` binds the PROCESS ledger, so every controller's
    events land on one unified timeline; constructing it with explicit
    ``capacity``/``now`` yields a private ledger (test isolation).
  * ``emit(ref, ...)`` / ``emit_key(key, ...)`` — module-level hot-path
    emitters for planes with no recorder handle (the admission gate, the
    chaos plane, the rebalance drain).  Disarmed cost is one list read
    (the chaos-seam contract); the ledger is ARMED by default — events
    are the reference's always-on surface, and the ledger is bounded.

Coalescing is per-timeline-tail: re-recording the tail event's exact
(type, reason, message) bumps its count/last_timestamp instead of
appending, so a hot repeated event cannot flood the ring while the
timeline stays gap-free and causally ordered.  Eviction is
globally-oldest-first, which prunes timeline HEADS — the newest history
always survives.

The clock is injectable (``set_clock``): compressed loadgen soaks point
it at their VirtualClock (loadgen/driver._install), the same way the
telemetry ring samples on the queue clock, so event timestamps order
correctly against the virtual timeline instead of wall time.

Every ``reason`` at a ``record``/``emit`` call site is one of the
``REASON_*`` constants below.
"""

from __future__ import annotations

import time
from collections import Counter as _Counter
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from karmada_tpu_torch.utils.locks import VetLock
from karmada_tpu_torch.utils.metrics import REGISTRY

TYPE_NORMAL = "Normal"
TYPE_WARNING = "Warning"

# -- the reason taxonomy ------------------------------------------------------
# pkg/events/events.go reasons used by this framework's controllers
REASON_SCHEDULE_BINDING_SUCCEED = "ScheduleBindingSucceed"
REASON_SCHEDULE_BINDING_FAILED = "ScheduleBindingFailed"
REASON_SYNC_WORKLOAD_SUCCEED = "SyncSucceed"
REASON_SYNC_WORKLOAD_FAILED = "SyncFailed"
REASON_WORK_DISPATCHING = "WorkDispatching"
REASON_TAINT_CLUSTER_SUCCEED = "TaintClusterSucceed"
REASON_UNTAINT_CLUSTER_SUCCEED = "UntaintClusterSucceed"
REASON_EVICT_WORKLOAD_FROM_CLUSTER = "EvictWorkloadFromCluster"
REASON_APPLY_POLICY_SUCCEED = "ApplyPolicySucceed"
REASON_REFLECT_STATUS_FAILED = "ReflectStatusFailed"
REASON_CLUSTER_NOT_READY = "ClusterNotReady"
REASON_CLUSTER_READY = "ClusterReady"
REASON_CLUSTER_STATUS_UNKNOWN = "ClusterStatusUnknown"
# admission gate (scheduler/queue.py)
REASON_BINDING_ENQUEUED = "BindingEnqueued"
REASON_BINDING_SHED = "BindingShed"
REASON_BINDING_DISPLACED = "BindingDisplaced"
# batch formation / overload / backend lifecycle (scheduler/service.py)
REASON_BATCH_FORMED = "BatchFormed"
REASON_OVERLOAD_ENTERED = "OverloadEntered"
REASON_OVERLOAD_EXITED = "OverloadExited"
REASON_BACKEND_DEGRADED = "BackendDegraded"
REASON_BACKEND_REARMED = "BackendRearmed"
REASON_CYCLE_FAULT = "CycleFaultContained"
# graceful eviction chain (controllers/failover.py)
REASON_EVICTION_PENDING = "EvictionPending"
REASON_EVICTION_DEFERRED = "EvictionDeferred"
REASON_EVICTION_TASK_DRAINED = "EvictionTaskDrained"
# rebalance plane (rebalance/)
REASON_REBALANCE_EVICTED = "RebalanceEvicted"
REASON_EVICTION_BUDGET_DENIED = "EvictionBudgetDenied"
# FederatedHPA fast path (e2e.ControlPlane._hpa_fast_path)
REASON_HPA_FAST_PATH = "HpaFastPathPush"
# chaos plane (the JAX package's chaos/)
REASON_CHAOS_FAULT_INJECTED = "ChaosFaultInjected"
# chaos safety auditor (chaos/audit.py) — keyed by violated invariant
REASON_SAFETY_VIOLATION = "SafetyViolation"
# incident plane (obs/incidents.py)
REASON_INCIDENT_CAPTURED = "IncidentCaptured"

REASON_SHORTLIST_FALLBACK = "ShortlistFallback"
REASON_SHORTLIST_TRUNCATE = "ShortlistTruncate"

# incremental steady-state solve (scheduler/incremental.py)
REASON_INCREMENTAL_FULL_SOLVE = "IncrementalFullSolve"
REASON_INCREMENTAL_AUDIT_MISMATCH = "IncrementalAuditMismatch"

# facade plane (facade/): per-caller outcome events, stamped
# with the coalesced batch id so a caller's timeline names the shared
# device dispatch it rode
REASON_FACADE_ASSIGNED = "FacadeAssigned"
REASON_FACADE_REJECTED = "FacadeRejected"

EVENTS_TOTAL = REGISTRY.counter(
    "karmada_events_total",
    "Lifecycle-ledger events recorded (coalesced repeats count each "
    "occurrence), by event type and reason",
    ("type", "reason"),
)

EVENTS_DROPPED = REGISTRY.counter(
    "karmada_events_dropped_total",
    "Lifecycle-ledger events evicted by the capacity bound (globally "
    "oldest first — timeline heads prune, the newest history survives)",
)


@dataclass
class ObjectRef:
    kind: str = ""
    namespace: str = ""
    name: str = ""


#: the scheduler's own (cycle-level) timeline: batch formation, overload
#: transitions, backend degrade/re-arm, contained cycle faults
SCHEDULER_REF = ObjectRef(kind="Scheduler", namespace="", name="scheduler")


@dataclass
class LedgerEvent:
    """One coalesced event.  Field names keep the classic RecordedEvent
    surface (type/reason/message/count/first_timestamp/last_timestamp)
    plus the lifecycle-ledger causal links."""

    id: int
    ref: ObjectRef
    type: str = TYPE_NORMAL
    reason: str = ""
    message: str = ""
    origin: str = ""
    cycle_id: Optional[int] = None
    trace_id: Optional[str] = None
    decision_id: Optional[int] = None
    count: int = 1
    first_timestamp: float = 0.0
    last_timestamp: float = 0.0
    # monotone ACTIVITY sequence, bumped on every record touching this
    # event (coalesced repeats included) — the `?since=` watch cursor
    # filters on this, not `id`, so a storm coalescing onto one tail
    # event still surfaces in `karmadactl events --watch`
    last_seq: int = 0

    def to_dict(self) -> dict:
        return {
            "id": self.id,
            "kind": self.ref.kind,
            "namespace": self.ref.namespace,
            "name": self.ref.name,
            "type": self.type,
            "reason": self.reason,
            "message": self.message,
            "origin": self.origin,
            "cycle_id": self.cycle_id,
            "trace_id": self.trace_id,
            "decision_id": self.decision_id,
            "count": self.count,
            "first_timestamp": round(self.first_timestamp, 6),
            "last_timestamp": round(self.last_timestamp, 6),
            "last_seq": self.last_seq,
        }


def _ambient_trace_id() -> Optional[str]:
    """The enclosing flight-recorder trace id, if tracing is armed —
    the event -> waterfall link costs one contextvar read when armed,
    one attribute read when not."""
    from karmada_tpu_torch import obs

    if not obs.TRACER.enabled:
        return None
    sp = obs.TRACER.current()
    return sp.trace.trace_id if sp is not None else None


class EventLedger:
    """Bounded, coalescing, thread-safe journal with a per-object
    timeline index."""

    def __init__(self, capacity: int = 16384,
                 now: Callable[[], float] = time.time,
                 export_metrics: bool = False) -> None:
        # only the PROCESS ledger exports karmada_events_* (configure()
        # passes True): a private recorder's traffic — bench harnesses,
        # test isolation — must not pollute the scrape surface
        self.capacity = max(1, int(capacity))
        self.now = now
        self.export_metrics = bool(export_metrics)
        self._lock = VetLock("obs.events")
        # guarded-by: _lock; mutators: record,link_decision
        self._events: Dict[int, LedgerEvent] = {}
        # guarded-by: _lock — global FIFO of event ids (eviction order)
        self._order: deque = deque()
        # guarded-by: _lock — (kind, ns, name) -> deque of event ids in
        # record order (ids ascend within a timeline)
        self._timelines: Dict[Tuple[str, str, str], deque] = {}
        self._seq = 0           # guarded-by: _lock — event ids
        self._act_seq = 0       # guarded-by: _lock — activity cursor
        self._recorded = 0      # guarded-by: _lock — record() occurrences
        self._coalesced = 0     # guarded-by: _lock — tail bumps
        self._evicted = 0       # guarded-by: _lock — capacity evictions
        self._by_reason: _Counter = _Counter()  # guarded-by: _lock

    def set_clock(self, now: Callable[[], float]) -> Callable[[], float]:
        """Repoint the ledger clock (compressed soaks pass their
        VirtualClock); returns the previous clock so callers restore."""
        prev = self.now
        self.now = now
        return prev

    # -- record --------------------------------------------------------------
    def record(self, ref, type_: str, reason: str, message: str,
               origin: str = "", cycle_id: Optional[int] = None,
               trace_id: Optional[str] = None,
               decision_id: Optional[int] = None) -> int:
        """Record one event for ``ref`` (an ObjectRef or any typed store
        object exposing KIND/namespace/name); returns the event id (the
        coalesced tail's id when the record was a repeat)."""
        if not isinstance(ref, ObjectRef):
            ref = ObjectRef(kind=ref.KIND, namespace=ref.namespace,
                            name=ref.name)
        if trace_id is None:
            trace_id = _ambient_trace_id()
        ts = self.now()
        tlkey = (ref.kind, ref.namespace, ref.name)
        with self._lock:
            self._recorded += 1
            self._act_seq += 1
            self._by_reason[reason] += 1
            timeline = self._timelines.get(tlkey)
            if timeline:
                tail = self._events[timeline[-1]]
                if (tail.type == type_ and tail.reason == reason
                        and tail.message == message):
                    # coalesce at the timeline tail: repeats bump the
                    # count, ordering stays gap-free
                    tail.count += 1
                    tail.last_timestamp = ts
                    tail.last_seq = self._act_seq
                    if cycle_id is not None:
                        tail.cycle_id = cycle_id
                    if trace_id is not None:
                        tail.trace_id = trace_id
                    self._coalesced += 1
                    eid = tail.id
                    if self.export_metrics:
                        EVENTS_TOTAL.inc(type=type_, reason=reason)
                    return eid
            self._seq += 1
            eid = self._seq
            ev = LedgerEvent(id=eid, ref=ref, type=type_, reason=reason,
                             message=message, origin=origin,
                             cycle_id=cycle_id, trace_id=trace_id,
                             decision_id=decision_id,
                             first_timestamp=ts, last_timestamp=ts,
                             last_seq=self._act_seq)
            self._events[eid] = ev
            self._order.append(eid)
            if timeline is None:
                timeline = deque()
                self._timelines[tlkey] = timeline
            timeline.append(eid)
            evicted = 0
            while len(self._order) > self.capacity:
                old_id = self._order.popleft()
                old = self._events.pop(old_id, None)
                evicted += 1
                if old is None:
                    continue
                okey = (old.ref.kind, old.ref.namespace, old.ref.name)
                tl = self._timelines.get(okey)
                if tl:
                    # ids ascend within a timeline and eviction is
                    # globally-oldest-first, so the victim is the head
                    if tl[0] == old_id:
                        tl.popleft()
                    else:  # pragma: no cover — defensive
                        try:
                            tl.remove(old_id)
                        except ValueError:
                            pass
                    if not tl:
                        self._timelines.pop(okey, None)
            self._evicted += evicted
        if self.export_metrics:
            EVENTS_TOTAL.inc(type=type_, reason=reason)
            if evicted:
                EVENTS_DROPPED.inc(evicted)
        return eid

    def link_decision(self, event_id: int, decision_id: int) -> None:
        """Stamp the explain-plane decision id onto an event (the
        scheduled/unschedulable outcome events cross-reference their
        Decision record; obs/decisions stamps the event id back)."""
        with self._lock:
            ev = self._events.get(event_id)
            if ev is not None:
                ev.decision_id = decision_id

    # -- read ----------------------------------------------------------------
    def list(self, kind: Optional[str] = None, namespace: Optional[str] = None,
             name: Optional[str] = None) -> List[LedgerEvent]:
        """Filtered events in record order (the classic recorder list)."""
        with self._lock:
            return [
                self._events[i] for i in self._order
                if (kind is None or self._events[i].ref.kind == kind)
                and (namespace is None
                     or self._events[i].ref.namespace == namespace)
                and (name is None or self._events[i].ref.name == name)
            ]

    def timeline(self, kind: str, namespace: str, name: str) -> List[dict]:
        """One object's ordered event timeline as dicts."""
        with self._lock:
            ids = list(self._timelines.get((kind, namespace, name), ()))
            return [self._events[i].to_dict() for i in ids
                    if i in self._events]

    def recent(self, n: int = 64, since: Optional[int] = None) -> List[dict]:
        """The most recent ``n`` events (record order), optionally only
        those with ACTIVITY after ``since`` (`last_seq > since` — the
        `karmadactl events --watch` cursor; a coalesced repeat bumps the
        tail event's last_seq, so a storm collapsing onto one entry
        still surfaces on every poll).  With a cursor, the OLDEST ``n``
        matches return (the client pages forward by advancing its
        cursor — returning the newest slice would skip everything the
        bound cut off, permanently); without one, the newest ``n``.
        n=0 really means zero events (the MetricRing.samples contract),
        never the whole-ring [-0:] surprise."""
        with self._lock:
            out = []
            for i in self._order:
                ev = self._events.get(i)
                if ev is None:
                    continue
                if since is not None and ev.last_seq <= since:
                    continue
                out.append(ev.to_dict())
        n = max(0, int(n))
        if n == 0:
            return []
        return out[:n] if since is not None else out[-n:]

    def counters(self) -> dict:
        """Lifetime tallies (the /debug/state `events` section and the
        soak reports' delta baseline)."""
        with self._lock:
            return {
                "recorded": self._recorded,
                "coalesced": self._coalesced,
                "evicted": self._evicted,
                # the activity cursor (last_seq high-water mark): soak
                # baselines use it to scope timeline walks to ONE run
                "seq": self._act_seq,
                "retained": len(self._order),
                "objects": len(self._timelines),
                "capacity": self.capacity,
                "by_reason": dict(self._by_reason),
            }


class EventRecorder:
    """The framework's record.EventRecorder equivalent.

    A bare ``EventRecorder()`` is a view over the PROCESS ledger (every
    controller's events land on one unified timeline and respect the
    global arm state); passing ``capacity``/``now``/``ledger`` binds a
    private ledger that always records (test isolation)."""

    def __init__(self, capacity: Optional[int] = None,
                 now: Optional[Callable[[], float]] = None,
                 ledger: Optional[EventLedger] = None) -> None:
        if ledger is not None:
            self._ledger: Optional[EventLedger] = ledger
        elif capacity is not None or now is not None:
            self._ledger = EventLedger(capacity=capacity or 16384,
                                       now=now or time.time)
        else:
            self._ledger = None  # resolve the process ledger per call

    @property
    def private(self) -> bool:
        return self._ledger is not None

    def _resolve(self) -> EventLedger:
        return self._ledger if self._ledger is not None else ledger()

    def event(self, obj, type_: str, reason: str, message: str,
              origin: str = "", cycle_id: Optional[int] = None,
              trace_id: Optional[str] = None,
              decision_id: Optional[int] = None) -> Optional[int]:
        """Record one event; returns its ledger id (None when the
        process ledger is disarmed and this recorder is the global
        view)."""
        if self._ledger is None and not _ARMED[0]:
            return None
        return self._resolve().record(
            obj, type_, reason, message, origin=origin, cycle_id=cycle_id,
            trace_id=trace_id, decision_id=decision_id)

    def link_decision(self, event_id: Optional[int],
                      decision_id: Optional[int]) -> None:
        if event_id is None or decision_id is None:
            return
        self._resolve().link_decision(event_id, decision_id)

    def list(self, kind: Optional[str] = None, namespace: Optional[str] = None,
             name: Optional[str] = None) -> List[LedgerEvent]:
        return self._resolve().list(kind=kind, namespace=namespace, name=name)


# -- the process ledger -------------------------------------------------------
# guarded by convention, not a lock: configure()/disarm() happen at test
# setup / bench install; emitters read one list cell (the chaos-plane
# pattern), so the disarmed hot path pays a single global read
_ARMED = [True]
_LEDGER: List[EventLedger] = [EventLedger(export_metrics=True)]


def ledger() -> EventLedger:
    return _LEDGER[0]


def armed() -> bool:
    return _ARMED[0]


def arm() -> None:
    _ARMED[0] = True


def disarm() -> None:
    """Stop recording through the process-ledger emitters (perf bench
    legs; private recorders are unaffected).  The retained journal stays
    readable."""
    _ARMED[0] = False


def configure(capacity: int = 16384,
              now: Callable[[], float] = time.time) -> EventLedger:
    """Install a fresh process ledger (tests wanting isolation; serve
    keeps the default).  Re-arms recording."""
    led = EventLedger(capacity=capacity, now=now, export_metrics=True)
    _LEDGER[0] = led
    _ARMED[0] = True
    return led


def set_clock(now: Callable[[], float]) -> Callable[[], float]:
    """Repoint the process ledger's clock; returns the previous clock.
    Compressed loadgen soaks pass their VirtualClock here (the same
    plumbing obs_timeseries.maybe_sample gets via the queue clock) so
    event timestamps order against the virtual timeline."""
    return _LEDGER[0].set_clock(now)


def emit(ref, type_: str, reason: str, message: str, **kw) -> Optional[int]:
    """Module-level emitter for planes with no recorder handle.  One
    list read when disarmed."""
    if not _ARMED[0]:
        return None
    return _LEDGER[0].record(ref, type_, reason, message, **kw)


def emit_key(key, type_: str, reason: str, message: str,
             **kw) -> Optional[int]:
    """``emit`` keyed by the scheduler queues' ``(namespace, name)``
    binding key."""
    if not _ARMED[0]:
        return None
    if isinstance(key, tuple) and len(key) == 2:
        ref = ObjectRef(kind="ResourceBinding", namespace=str(key[0]),
                        name=str(key[1]))
    else:
        ref = ObjectRef(kind="Object", namespace="", name=str(key))
    return _LEDGER[0].record(ref, type_, reason, message, **kw)


def state_payload(n: int = 64, since: Optional[int] = None) -> dict:
    """/debug/events: counters + per-reason tallies + the recent ring."""
    led = _LEDGER[0]
    counters = led.counters()
    return {
        "enabled": True,
        "armed": _ARMED[0],
        "stats": counters,
        "recent": led.recent(n=n, since=since),
    }


def timeline_payload(namespace: str, name: str,
                     kind: str = "ResourceBinding") -> dict:
    """/debug/events/{ns}/{name}: one object's gap-free timeline."""
    led = _LEDGER[0]
    events = led.timeline(kind, namespace, name)
    return {
        "key": f"{namespace}/{name}",
        "kind": kind,
        "events": events,
        "count": len(events),
    }
