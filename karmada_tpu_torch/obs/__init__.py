"""Observability of the port: the flight recorder (trace, recorder,
export), the lifecycle ledger (events), the explain plane's Decision
records (decisions) and the device's cost ledger, memory attribution and
profiler capture (devprof).

The flight recorder is the JAX package's ``obs/`` counterpart:

  trace.py     Span / SpanContext (contextvars) / Tracer -- the core
  recorder.py  bounded ring of finished traces + slowest-N shelf +
               a drop counter so truncation is never silent
  export.py    JSON dump, text waterfall, per-stage aggregates

Everything instruments against the ONE process-wide `TRACER`, disabled
by default (call sites get the no-op span singleton, and no span adds a
device synchronisation: a stage span times what the host sees).  It is
armed by `python -m karmada_tpu_torch.cli serve --trace-buffer N` and by
a compressed loadgen soak (loadgen/driver.py), whose report reads it.

Span-name vocabulary (SPAN_*): the JAX package's names, so span trees and
stage timelines of the two packages key on the same strings.
"""

from karmada_tpu_torch.obs.trace import (  # noqa: F401 — the public surface
    FROM_CONTEXT,
    NOOP_SPAN,
    NoopSpan,
    Span,
    Trace,
    Tracer,
)

# the process-wide tracer every call site instruments against
TRACER = Tracer()

# -- span-name vocabulary ----------------------------------------------------
# scheduler/service.py
SPAN_CYCLE = "scheduler.cycle"            # one batched scheduling cycle
SPAN_SERIAL = "scheduler.serial"          # host-serial fallback rows
# scheduler/pipeline.py (the pipelined chunk executor)
SPAN_PIPELINE = "pipeline.cycle"          # one run_pipeline call
SPAN_CHUNK = "pipeline.chunk"             # submit-to-result wall span
SPAN_ENCODE = "pipeline.encode"           # host encode of the chunk
SPAN_DISPATCH = "pipeline.dispatch"       # H2D + async device launch
SPAN_SPREAD = "pipeline.spread"           # spread sub-solves (finalize)
SPAN_BIG = "pipeline.big"                 # big-tier sub-solve (finalize)
SPAN_WAIT = "pipeline.solve_wait"         # device execution wait
SPAN_D2H = "pipeline.d2h"                 # sparse result copy (+ escalation)
SPAN_DECODE = "pipeline.decode"           # COO decode to per-binding results
# ops/aotcache.py (AOT executable plane)
SPAN_WARMUP = "solver.warmup"             # AOT pre-compile of warm shapes
# estimator/client.py
SPAN_ESTIMATOR_RPC = "estimator.rpc"      # one per-cluster estimator call
# resident/ (the device-resident state plane)
SPAN_RESIDENT_APPLY = "resident.apply"    # delta apply / structural rebuild
SPAN_RESIDENT_ENCODE = "resident.encode"  # gather + miss-subset re-encode
SPAN_RESIDENT_AUDIT = "resident.audit"    # bit-exact parity audit
# rebalance/ (the drain-and-re-place plane)
SPAN_REBALANCE_CYCLE = "rebalance.cycle"    # one detect->drain->audit pass
SPAN_REBALANCE_DETECT = "rebalance.detect"  # tensor assembly + jit score
SPAN_REBALANCE_DRAIN = "rebalance.drain"    # paced graceful evictions
# facade/ (scheduler-as-a-service)
SPAN_FACADE_CYCLE = "facade.cycle"          # one coalesced facade dispatch
SPAN_FACADE_WHATIF = "facade.whatif"        # one what-if hypothetical solve
# controllers
SPAN_BINDING_RENDER = "binding.ensure_works"
SPAN_DETECTOR_MATCH = "detector.match_policy"
# store/worker.py: every reconcile is spanned "reconcile.<worker name>"
SPAN_RECONCILE_PREFIX = "reconcile."

SPAN_NAMES = (
    SPAN_CYCLE, SPAN_SERIAL, SPAN_PIPELINE, SPAN_CHUNK, SPAN_ENCODE,
    SPAN_DISPATCH, SPAN_SPREAD, SPAN_BIG, SPAN_WAIT, SPAN_D2H, SPAN_DECODE,
    SPAN_ESTIMATOR_RPC, SPAN_RESIDENT_APPLY, SPAN_RESIDENT_ENCODE,
    SPAN_RESIDENT_AUDIT, SPAN_BINDING_RENDER, SPAN_DETECTOR_MATCH,
    SPAN_WARMUP, SPAN_REBALANCE_CYCLE, SPAN_REBALANCE_DETECT,
    SPAN_REBALANCE_DRAIN, SPAN_FACADE_CYCLE, SPAN_FACADE_WHATIF,
)

# every pipeline stage a healthy device chunk must traverse (the tier-1
# serve smoke asserts a trace covers all of them)
PIPELINE_STAGE_SPANS = (
    SPAN_ENCODE, SPAN_DISPATCH, SPAN_WAIT, SPAN_D2H, SPAN_DECODE,
)
