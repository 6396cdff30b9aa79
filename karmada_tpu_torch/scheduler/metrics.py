"""Scheduler metrics (pkg/scheduler/metrics/metrics.go:60-142 equivalents;
the JAX package's ``scheduler/metrics.py``).

Same metric names and label shapes as the reference so dashboards/alerts
port over; per-step latency covers the batched pipeline's real stages
(Encode / Solve / Decode on the device path, Serial on the host path).
"""

from __future__ import annotations

from karmada_tpu_torch.utils.metrics import REGISTRY, exponential_buckets

RESULT_SCHEDULED = "scheduled"
RESULT_ERROR = "error"
RESULT_UNSCHEDULABLE = "unschedulable"
SCHEDULE_TYPE_RECONCILE = "reconcile"

STEP_ENCODE = "Encode"
STEP_H2D = "H2D"      # host->device transfer + async launch (dispatch)
STEP_SOLVE = "Solve"  # device execution wait
STEP_D2H = "D2H"      # device->host result copy (+ rare nnz escalation)
STEP_DECODE = "Decode"
STEP_SERIAL = "Serial"

SCHEDULE_ATTEMPTS = REGISTRY.counter(
    "karmada_scheduler_schedule_attempts_total",
    "Number of attempts to schedule a ResourceBinding",
    ("result", "schedule_type"),
)

E2E_LATENCY = REGISTRY.histogram(
    "karmada_scheduler_e2e_scheduling_duration_seconds",
    "E2e scheduling latency in seconds",
    ("result", "schedule_type"),
    buckets=exponential_buckets(0.001, 2, 15),
)

STEP_LATENCY = REGISTRY.histogram(
    "karmada_scheduler_scheduling_algorithm_duration_seconds",
    "Scheduling algorithm latency in seconds by pipeline step",
    ("schedule_step",),
    buckets=exponential_buckets(0.001, 2, 15),
)

BACKEND_DEGRADED = REGISTRY.counter(
    "karmada_scheduler_backend_degraded_total",
    "Times the device backend was abandoned mid-serve (hung cycle) and "
    "the scheduler degraded to a host backend",
    ("to",),
)

BACKEND_REARMED = REGISTRY.counter(
    "karmada_scheduler_backend_rearmed_total",
    "Times a degraded scheduler re-armed the device backend after its "
    "cooldown re-probe (device_recover_cycles) — degrade is no longer "
    "one-way for transient faults",
    ("backend",),
)

# cycle fault containment: a schedule_batch that RAISES must not lose its
# popped bindings — they route to the backoff queue and the fault is
# counted here by exception class (chaos device faults land here too)
CYCLE_FAULTS = REGISTRY.counter(
    "karmada_scheduler_cycle_faults_total",
    "Scheduling cycles whose batch solve raised; the popped bindings "
    "were re-queued to backoff instead of being lost, by exception class",
    ("kind",),
)

QUEUE_INCOMING = REGISTRY.counter(
    "karmada_scheduler_queue_incoming_bindings_total",
    "Bindings added to scheduling queues by event type",
    ("event",),
)

QUEUE_DEPTH = REGISTRY.gauge(
    "karmada_scheduler_queue_depth",
    "Current scheduling queue depths",
    ("queue",),
)

# queue dwell (sustained-traffic serve harness): how long a binding waited
# before pop_ready drained it, bucketed by the queue it came from —
# "active" is a fresh external push, "backoff"/"unschedulable" entries
# include their parked wait.  The loadgen soak report derives its dwell
# quantiles from the same clock (scheduler/queue.py pop_ready).
QUEUE_DWELL = REGISTRY.histogram(
    "karmada_scheduler_queue_dwell_seconds",
    "Seconds a binding waited in the scheduling queue before being "
    "drained into a cycle, by queue of origin",
    ("queue",),
    buckets=exponential_buckets(0.001, 2, 18),
)

QUEUE_OLDEST_AGE = REGISTRY.gauge(
    "karmada_scheduler_queue_oldest_age_seconds",
    "Age of the oldest resident entry per scheduling queue (starvation "
    "early warning; refreshed each cycle and periodic flush)",
    ("queue",),
)

# bounded-queue admission gate (scheduler/queue.py push): every Push is
# exactly one of admitted/shed, so admitted + shed == total pushes;
# displaced counts residents evicted to make room for a higher-priority
# newcomer (each displacement also admits that newcomer)
ADMISSION = REGISTRY.counter(
    "karmada_scheduler_admission_total",
    "Scheduling-queue admission decisions under the bounded-resident "
    "gate, by decision (admitted/shed/displaced)",
    ("decision",),
)

# priority pushes (Scheduler.promote): the rebalance plane re-placing a
# drained binding and the FederatedHPA fast path pushing a refreshed
# binding straight into the queue, bypassing no gate but jumping the
# detector round-trip — autoscale/rebalance -> re-place is one cycle
PRIORITY_PUSHES = REGISTRY.counter(
    "karmada_scheduler_priority_pushes_total",
    "Bindings pushed straight into the active queue by a control-loop "
    "fast path, by origin (rebalance / hpa)",
    ("origin",),
)

OVERLOAD_MODE = REGISTRY.gauge(
    "karmada_scheduler_overload_mode",
    "1 while the scheduler is in overload degradation (measured queue "
    "dwell exceeded the batch deadline): explain sampling suppressed, "
    "batch-formation deadline widened",
)

# unschedulable-reason accounting (explain plane, obs/decisions taxonomy):
# every binding routed to the unschedulable queue counts under its
# dominant rejection reason — kube-scheduler's "0/5 clusters available"
# breakdown as a time series
UNSCHEDULABLE = REGISTRY.counter(
    "karmada_schedule_unschedulable_total",
    "Bindings routed to the unschedulable queue, by dominant reason",
    ("reason",),
)

# pipelined chunk executor spans (scheduler/pipeline.py): "own" is the
# chunk's own work (encode span + finalize/decode span), "wall" its
# submit-to-result time — under pipelining wall also contains the
# interleaved work of neighboring chunks, so own ~= wall means the
# pipeline degenerated to serial while wall >> own means deep overlap
PIPELINE_CHUNK_SPAN = "own"
PIPELINE_CHUNK_WALL = "wall"

PIPELINE_CHUNK_LATENCY = REGISTRY.histogram(
    "karmada_scheduler_pipeline_chunk_duration_seconds",
    "Per-chunk latency of the pipelined executor by span kind",
    ("span",),
    buckets=exponential_buckets(0.001, 2, 15),
)

PIPELINE_CHUNKS = REGISTRY.counter(
    "karmada_scheduler_pipeline_chunks_total",
    "Chunks finalized by the pipelined executor",
    ("carry",),
)

BATCH_SIZE = REGISTRY.histogram(
    "karmada_scheduler_batch_size",
    "Bindings drained into one batched solver cycle",
    (),
    buckets=[1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192],
)
