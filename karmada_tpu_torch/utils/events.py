"""Event recorder: the framework's record.EventRecorder equivalent.

Counterpart of the JAX package's ``utils/events.py``.  Grown into the
lifecycle ledger (obs/events.py): a bounded,
coalescing, thread-safe journal with a per-object timeline index, where
every event carries {type, reason, message, origin, cycle_id, trace_id,
decision_id}.  This module re-exports the whole surface so the classic
``from karmada_tpu_torch.utils import events as ev`` import sites keep
working; see obs/events for the ledger itself and its reason catalog.

A bare ``EventRecorder()`` binds the PROCESS ledger — every controller
shares one unified per-binding timeline; explicit capacity/now yields a
private ledger (test isolation, the pre-ledger semantics).
"""

from karmada_tpu_torch.obs.events import (  # noqa: F401 — the public surface
    EVENTS_DROPPED,
    EVENTS_TOTAL,
    REASON_APPLY_POLICY_SUCCEED,
    REASON_BACKEND_DEGRADED,
    REASON_BACKEND_REARMED,
    REASON_BATCH_FORMED,
    REASON_BINDING_DISPLACED,
    REASON_BINDING_ENQUEUED,
    REASON_BINDING_SHED,
    REASON_CHAOS_FAULT_INJECTED,
    REASON_CLUSTER_NOT_READY,
    REASON_CLUSTER_READY,
    REASON_CLUSTER_STATUS_UNKNOWN,
    REASON_CYCLE_FAULT,
    REASON_EVICT_WORKLOAD_FROM_CLUSTER,
    REASON_EVICTION_BUDGET_DENIED,
    REASON_EVICTION_DEFERRED,
    REASON_EVICTION_PENDING,
    REASON_EVICTION_TASK_DRAINED,
    REASON_HPA_FAST_PATH,
    REASON_OVERLOAD_ENTERED,
    REASON_OVERLOAD_EXITED,
    REASON_REBALANCE_EVICTED,
    REASON_REFLECT_STATUS_FAILED,
    REASON_SCHEDULE_BINDING_FAILED,
    REASON_SCHEDULE_BINDING_SUCCEED,
    REASON_SYNC_WORKLOAD_FAILED,
    REASON_SYNC_WORKLOAD_SUCCEED,
    REASON_TAINT_CLUSTER_SUCCEED,
    REASON_UNTAINT_CLUSTER_SUCCEED,
    REASON_WORK_DISPATCHING,
    SCHEDULER_REF,
    TYPE_NORMAL,
    TYPE_WARNING,
    EventLedger,
    EventRecorder,
    LedgerEvent,
    ObjectRef,
    arm,
    armed,
    configure,
    disarm,
    emit,
    emit_key,
    ledger,
    set_clock,
    state_payload,
    timeline_payload,
)

#: compat alias — callers that type-annotated the old dataclass
RecordedEvent = LedgerEvent
