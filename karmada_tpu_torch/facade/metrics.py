"""Facade-plane metrics (karmada_facade_*; counterpart of the JAX
package's ``facade/metrics.py``).

The coalescing story is the whole point of the plane, so the metric set
is built to prove it: calls vs batches gives the coalesce ratio, the
batch-size histogram shows how full the shared dispatches run, and the
per-call latency includes the admission wait (the price a caller pays
for riding a shared device dispatch).
"""

from __future__ import annotations

from karmada_tpu_torch.utils.metrics import REGISTRY, exponential_buckets

FACADE_CALLS = REGISTRY.counter(
    "karmada_facade_calls_total",
    "Facade RPCs served, by method (AssignReplicas / SelectClusters / "
    "WhatIf) and result (scheduled / unschedulable / error)",
    ("method", "result"),
)

FACADE_BATCHES = REGISTRY.counter(
    "karmada_facade_batches_total",
    "Coalesced facade solve cycles dispatched (calls_total / "
    "batches_total is the coalesce ratio)",
)

FACADE_BATCH_SIZE = REGISTRY.histogram(
    "karmada_facade_batch_size",
    "Concurrent AssignReplicas callers coalesced into one detached solve "
    "dispatch",
    buckets=exponential_buckets(1, 2, 12),
)

FACADE_CALL_LATENCY = REGISTRY.histogram(
    "karmada_facade_call_duration_seconds",
    "Per-caller facade latency (admission wait + shared solve + demux), "
    "by method",
    ("method",),
    buckets=exponential_buckets(0.0005, 2, 16),
)

FACADE_WHATIF = REGISTRY.counter(
    "karmada_facade_whatif_total",
    "What-if capacity-planning queries answered, by query kind "
    "(placement / cluster-loss / headroom)",
    ("query",),
)
