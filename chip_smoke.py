#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (karmada_tpu_torch) on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's kernels from ops/csrc/ with nvcc (sm_90a) and its
native host paths from native/ with gcc / g++, then drives the device
scheduling cycle at the synthetic-stress size of BASELINE config 5
(bench.py's mix: 100,000 bindings x 5,000 clusters, region spread
included; chunk 4096, 8 waves, carry on).  Every cycle encodes and
decodes through the C paths (encode_fast.c, decode_fast.c); phases 3, 4,
6-9, 12b, 14b and 14c log the bindings the C encode filled, its
encode_one misses, the rows each decoder built and the garbage
collector's collections and pauses in the cycle, and fail if any binding was encoded through
native=False (phases 3 and 8 also if no row went through decode_coo):

  1. device and build: the card's name and power limit, nvcc's register /
     shared-memory report per kernel source, the three native builds with
     the compilers' walls;
  2. kernel vs plain: each kernel against its plain PyTorch version,
     bit-exact, with CUDA-event times, the plain version's time, the least
     time the card could take (bound) and, for the COO extraction, a
     yardstick that computes the same function (the mask from rep, sel
     and non_workload, torch.nonzero and a gather) -- K1-K4 on the first
     chunk of the forward cycle (4096 x 8192 lanes), K5 spread_group_info
     and K6 spread_pick on that chunk's spread sub-batch, K2 on the big
     tier (and its K4 problems) on the first wide chunk's big sub-batch;
     K2's wave 0 (one C call a launch slice) split into its kernels'
     device time (prepare, K4, finish) and into host enqueue and device
     time, on both tiers, and wave 0 with its K1 (enqueued by K2's first
     launch) with K1's device time in it; a census of the big rows K2-big
     gets (each gather group's eligible lanes against k, the select's
     histogram passes, U, strategy, has_sc); the chunk's bound (its 8
     waves' K1 + K2 + K4 bounds and K3's); K1 alone's host / device
     split; a census of K4's problems over the chunk's 8 waves and the
     big sub-batch (n_eff, positive and kept lanes, t* = 0,
     r > 0, both designs' bisection steps, the brackets checked against
     the plain bisection), and K4's host / device split on each tier's
     wave 0; a census of K5's and K6's sub-batch (spread_census: feasible
     lanes, members a group, the Divided walks' members walked and the
     exhausted groups, Duplicated rows, the chosen groups, the lanes in
     them and rest), their host / device split, and their bounds by the
     function's need beside the sort-based figure of earlier designs;
  3. forward cycle through scheduler.core.schedule_items, launch counters
     reset just before and read just after;
  4. rebalance cycle (prev assignments, reschedule triggers) the same way;
  5. chunk parity: one chunk of every cycle through solve_compact on the
     card and on the CPU (COO, status, nnz and the carry accumulators),
     and through schedule_items on the card and on the CPU, row by row (main, spread
     and big-tier rows), plus result invariants over every binding;
  6. the wide cycle: 16,384 bindings over the same fleet, every eighth
     beyond the tier-1 compact caps (ROUTE_DEVICE_BIG and
     ROUTE_DEVICE_SPREAD_BIG), so all four device routes run;
  7. the explain cycle: EXPLAIN_BINDINGS of phase 6's bindings (main, region-spread
     and big rows; every sixteenth asks for more CPU than any cluster
     has), chunk 1,024, explain armed with a DecisionRecorder -- one
     Decision per binding, full verdict tables for main and spread rows,
     a reason on every unschedulable one, K7 explain_rows after every
     wave;
  8. the megafleet cycle: bench.py's --megafleet shape at the scale of
     MEGAFLEET_r01.json -- 10,000 clusters in 200 regions, one
     DynamicWeight placement per region, MEGAFLEET_BINDINGS bindings --
     with the two-tier shortlist armed (K8 shortlist_topk, which computes
     the lanes' capacity itself, over each chunk's profiles, K9
     group_sums, the solver over the candidate union): every chunk
     shortlisted, no fallback;
  9. the incremental steady state (bench.py --incremental's legs) on
     phase 8's fleet shape with INCREMENTAL_BINDINGS bindings: a fused
     resident plane (slot store and cluster tensors kept on the card, K10
     scatter_lanes, K11 gather_rows) under the incremental solver (K12
     dirty_codes, the shortlist armed), adopt -> write-back -> settle ->
     cluster-status catch-up -> STEADY_CYCLES cycles at 0.1% churn -> a
     capacity flap -> a forced dense audit that must come out "ok"; the
     steady cycles upload no binding field;
 10. the rebalance loop on the port's control plane (store, runtime,
     scheduling queue, Scheduler, graceful eviction, rebalance plane):
     config 5's fleet and its first REBALANCE_PARITY_BINDINGS forward
     bindings restored into an ObjectStore with phase 3's placements, as
     after a restart on a converged fleet (members report what they run
     as allocated pods, and at least that as allocatable pods), then the
     8 clusters with the most Divided replicas among those no Duplicated
     or StaticWeight affinity names crushed to 60% of the pods they hold;
     a Scheduler (chunk 4096, 8 waves, rebalance every 30 s, threshold
     1000 milli, spread report-only, at most 512 evictions a cycle, 128
     per cluster a minute) and a GracefulEvictionController (600 s grace)
     on one fake clock; advance 30 s and tick until the plane converges
     (at most 40 rounds), then past the grace period until every drain
     settled -- on the card and on the CPU: converged, equal per-cycle
     snapshots, eviction tasks, promotions and final placements; then the
     recipe as first specified (configured pods kept, the 8 clusters with
     the most Divided replicas crushed) for REBALANCE_AS_STATED_ROUNDS
     rounds on the card, with a census of the placements against the
     configured pods.  (The loop at config 5's fleet width, through the
     member model, is phase 14b.)
 11. the native host paths: (a) encode_batch on phase 3's first chunk
     (4,096 x 5,000), on a megafleet chunk (4,096 x 10,000) and on phase
     4's first chunk (every binding with previous clusters: all C misses),
     the C path against native=False in turns (Python, C, C, Python;
     TURN_ROUNDS rounds; medians, and the garbage collector's pauses
     inside the calls), every field and route equal, then decode_compact on each
     chunk's card COO the same way, outputs equal; (b) the C++ serial
     control (native.schedule_batch_native) over config 5's first
     --native-bindings forward bindings: walls, bindings/s, statuses,
     STATUS_UNSUPPORTED rows, and a stride sample of 256 equal to
     ops/serial.schedule; (c) a Scheduler(backend="native") on phase 10a's
     store recipe (REBALANCE_PARITY_BINDINGS bindings created unscheduled,
     no rebalance) ticked until every binding carries a Scheduled
     condition: no contained fault, a stride sample of 128 as
     ops/serial.schedule says;
 12. the propagation loop: the port's ControlPlane (admission, detector,
     the Scheduler's device cycle, binding -> Work, execution into the
     member simulators, Work / binding / cluster status, the failover
     controllers, leases and lifecycle) on a fake clock only the phase
     moves, driven as a user drives it -- members joined with config 5's
     fleet (allocatable cpu, memory in Gi, pods, region, provider;
     nothing running) and ticked once, one ClusterPropagationPolicy per
     config-5 placement selecting its Deployments by label, an image
     override on LOOP_OVERRIDDEN's placements for members in two regions,
     config 5's bindings applied as Deployments -- and ticked until a tick
     changes nothing (at most LOOP_TICKS), one line a tick with the host
     seconds by controller, the scheduler cycles' stages, the
     Cluster-event scans and the collector's pauses.  12a:
     LOOP_PARITY_MEMBERS members and LOOP_PARITY_TEMPLATES templates (the
     placements drawn over their names) on the card against
     device="cpu": equal snapshots (every object of the plane and of each
     member; uids from a counter, resourceVersions and times cleared).
     12b: all 5,000 members with the pods config 5 gives them and
     --loop-templates (LOOP_TEMPLATES) templates on the card, the
     rebalance plane armed (phase 10's config; a detect's drains
     printed): quiescent, every binding
     scheduled or failing on the serial path too (a sample), each
     binding's targets running on its members, the templates'
     readyReplicas the members', no contained fault or failed sync, K1-K4
     launched; phase 14b and 14c continue on this plane;
 13. the device lifecycle on config 5's fleet: (a) resolve_backend
     ("device") through the real probe subprocess -- K14 probe_mm on
     every visible card, its launch count reported back -- answering
     ok, gpu, the visible cards and a positive bytes_limit each; K14's
     SASS (cuobjdump -sass) holding wgmma (HGMMA), TMA loads (UTMALDG)
     and mbarriers (SYNCS); K14 held against its plain version bit for
     bit on seeded {-1, 0, 1} bf16 matrices and within a stated
     tolerance on normal(0, 1) ones at 128, 1,000 and 1,024, a
     ValueError at 100 (n % 8 != 0), and at 128 and 1,024 its
     back-to-back and one-launch event times beside torch.mm's; (b)
     capture_profile(1.0) (a 4 s window on the card) with the counts
     reset just before: ok, a chrome trace holding a device kernel
     event of K15's kernel marker_affine_i64, K15 held against its plain
     version on 128, 2^20 and 2^20 + 3 int64 elements, each also as an
     8-byte-offset view (torch.add timed beside it at 128 and 2^20), and
     memory_stats_payload() against torch.cuda.memory_stats; (c)
     warm_executables over the fleet, warm_shapes(4096, 4096) x the
     variants phase 3's cycle dispatches (plain, carry): every label
     done with its seconds and device ms, a second call already-warm
     for every label, then one forward 4,096-binding chunk beside phase
     3's first (timed alone just before phase 3); (d) phase 12a's
     members and placements with GUARD_TEMPLATES templates under the
     mid-serve guard (a timeout shorter than any device
     cycle, device_recover_cycles=1): the real device cycle is
     abandoned, the plane degrades to native with every binding of
     that cycle given its outcome, the harness raises the timeout, the
     next cycle re-arms on the card; quiescent, 1 degrade and 1 re-arm,
     the zombie cancelled with nothing recorded, and a snapshot equal
     to an unguarded run's that takes the same backend per cycle; then
     again with the zombie held right after its chunk's dispatch (its
     waves queued on the card) through every later cycle, released
     after the loop, with the same checks;
 14. failover and rebalance on the member model (run after phase 12a and
     12b, before 13): (a) phase 12a's recipe with the rebalance plane
     armed, on the card and with device="cpu": built and quiescent;
     FAILOVER_FAILED members (the most replicas) unhealthy; the clock
     past the 300 s toleration, then 30 s a round, to quiescence with no
     eviction queued or waiting and every eviction task drained (the
     eviction queue at the ControlPlane's default 100 a second, drained
     a second at a time as the time passes: pass_time); the members recovered; room for the capacity-blind
     placements through the member model (give_room); FAILOVER_CRUSHED
     members crushed to 60% of the pods they hold, 30 s a tick until the
     rebalance plane converged and every drain settled -- equal
     snapshots card vs CPU after each step, every step quiescent with no
     contained fault, every cycle on backend "device".  (b) phase 10b
     through the member model on phase 12b's plane, after 12b's checks:
     give_room (logging the members the capacity-blind replicas alone
     put over their configured pods), then MEMBER_CRUSHED members (the
     most Divided replicas among those no Duplicated or StaticWeight
     affinity names) crushed to 60% of the pods they hold,
     so the collector reports them; 30 s a tick to convergence and past
     the 600 s grace until every drain settled: converged with every
     cluster within its capacity, no conservation violation, no pending
     drain, every evicted binding re-placed, no contained fault, K13 once
     per detect cycle, K1-K4 launched.  (c) a regional outage on the same
     plane (phase_outage), one line a tick with the taint manager's and
     the eviction queue's seconds.  Launch counters are reset just before
     14b and 14c and read just after each.
 15. the estimator tier, the descheduler and the facade ((a) right
     after 14a, (b) and (c) right after 14c): (a) phase 12a's members
     and placements with FACADE_PARITY_TEMPLATES templates under
     ControlPlane(enable_descheduler=True), ticked to quiescence,
     DESCHED_PARITY_SQUEEZED members squeezed through the member model
     and the descheduler settled, then one FacadeService a plane
     answering FACADE_PARITY_REQUESTS AssignReplicas and the three
     what-if queries -- card against device="cpu": equal snapshots and
     answers, shrinks with no estimator error, no write by the facade;
     (b) on phase 12b's plane after 14c, FACADE_REQUESTS AssignReplicas
     drawn from config 5's mix, FACADE_THREADS client threads over
     TcpTransport, window FACADE_WINDOW, deadline FACADE_DEADLINE_S:
     every answer equal to a device="cpu" Scheduler's detached solve of
     its batch, a stride sample of FACADE_SAMPLE answered alone equal to
     ops/serial.schedule, the placement, headroom and cluster-loss
     queries equal card vs CPU, no non-Lease write; the batches, the
     coalesce ratio, the callers' arrival spread, a call's latency and
     each query's wall printed; (c) a Descheduler attached to the same
     plane over its estimator client and shared budget, DESCHED_SQUEEZED
     members squeezed, ticked to quiescence: every eligible binding
     keeps its replica total (but at most DESCHED_SHORT_MAX, each short
     by no more than the descheduler shrank of it, Unschedulable and
     unplaceable by ops/serial), none stuck on a squeezed member, the
     budget's denials printed, no contained fault or failed sync, K1-K4
     launched.  Launch counters are reset just before 15b and 15c and
     read just after each.

 16. sustained traffic (run in this process after 12a, 14a and 15a,
     beside the loop child): (a) the compressed loadgen soaks
     SOAK_SCENARIOS (steady, storm, churn, whatif, megafleet) on
     ServeSlice(backend="device") on the card, seed SOAK_SEED, the
     Scheduler's host clock held still and its deferred-cut timers held
     back (tools/soak_hold: a binding's e2e sample is floored at its
     cycle's wall seconds, which would tie it to the host's load), each
     replayed
     with device="cpu" in CpuRefs: SOAK payloads equal but for wall_s and
     stage_utilization's seconds (its span names and counts kept), final
     placements and what-if answers equal, scheduled == injected for
     steady, whatif and megafleet, megafleet shortlisted with no
     fallback, whatif's placements equal a control run without its
     queries, no contained fault; (b) megafleet-heavy (20,000 bindings,
     512 clusters in 32 regions, k = 32, window 512, Divided x 5) and
     storm-heavy (5,000 x 16) on the card, an event pair around every
     kernel launch of the run: one JSON line a run with the virtual
     latency and dwell percentiles, the cycles and batch sizes, admission,
     each pipeline stage's share of the cycle spans, the wall, the
     kernels' device seconds and the idle share they imply; scheduled +
     shed == injected, no fallback, no fault, every megafleet-heavy
     placement 5 replicas inside its binding's region, every
     RESOLVE_EVERY-th cycle's input (as the Scheduler's solve saw it)
     re-solved on ops/serial one wave at a time and equal, storm-heavy
     whole against its CPU replay as in (a); (c) on a thread started
     beside phases 3-11 (the loop child's start) and joined after (b),
     the port CLI in subprocesses on a temporary plane: init,
     CLI_MEMBERS joins, apply -f of a Deployment and its
     PropagationPolicy, tick --backend device, get ResourceBinding
     showing the placement; then serve --backend device --facade :0
     --loadgen steady --loadgen-rate 10 --trace-buffer 256
     --metrics-port 0 --resident --rebalance 2 --explain 1 --telemetry
     256 --check-invariants for at least SERVE_SECONDS, estimate
     --facade-addr against it; against its debug server
     (utils/httpserve): a PROFILE_SECONDS /debug/profile window on the
     card naming K15 and a serving kernel (SERVING_KERNELS) while a
     second capture answers 409, every route's status and payload shape,
     a /whatif placement query moving no placement, each verb that reads
     the server (events, describe, explain, trace, resident, rebalance,
     whatif, incidents, loadgen --endpoint, profile) exit 0, 0 lock
     inversions and 0 watchdog trips; SIGINT: exit 0, the banner's
     backend=device, the checkpoint reloading with every loadgen binding
     scheduled (and web-deployment where /whatif found it when the
     rebalance plane evicted nothing).  Launch counts are reset just before
     each soak's driver run and read just after it (soak_run), and
     summed over the soaks of (a) and of (b) (the what-if control run
     not counted).
 17. faults on the card (after 16c joined: the chaos, SLO, time-series
     and incident planes are process-wide, and no other Scheduler runs
     in this process then; all four are disarmed after it, raise or
     not): (a) the catalog `chaos` soak, uncut, on ServeSlice(backend=
     "device", resident=True, resident_audit_interval=0,
     device_cycle_timeout_s=2.0, device_recover_cycles=2) -- the checks
     of the JAX package's chaos soak test (no violation, one fire each at
     device.cycle / device.dispatch / resident.mirror and estimator.rpc
     fires, the circuit open -> half-open -> closed, degrade and re-arm
     ending on the device, a contained cycle fault, one resident audit
     mismatch, conservation, an empty residual queue, > 300 injected and
     scheduled, the plane disarmed after) and equal to its CPU replay
     (CpuRefs) but for the fire log's wall-clock stamps; (b) the catalog
     `hotspot` soak, uncut and unwarmed, on the JAX package's hotspot
     soak test's plane (HOTSPOT_PLANE: placed by ops/serial, scored on
     the card): K13 runs, rebalance.plan:skip fires once and
     is accounted, no conservation violation, converged inside the
     threshold, every drain settled, equal to its CPU replay; (c) 16b's
     megafleet-heavy shape with the chaos scenario's fault events
     (dataclasses.replace), resident plane and shortlist tier both
     armed, with obs/slo, obs/timeseries and obs/incidents armed (the
     bundles under a temporary directory): no violation, 17a's fires, a
     K8 / K9 dispatch, backend-degrade and cycle-fault bundles, the SLO
     verdicts, incident kinds, ring samples, wall and the kernels'
     CUDA-event device seconds printed; (d) device.d2h:poison#1 on a
     two-cluster device slice: the poisoned copy of K3's index plane
     raises InvariantViolation through analysis/guards.check_d2h, the
     cycle fault is contained and the binding re-queued and scheduled.
     17a runs with the JAX chaos soak test's race-detector leg:
     analysis/guards armed and a utils/locks LockWatchdog polling, 0
     order inversions and 0 watchdog trips.
     Launch counts are reset just before each soak's driver run (after
     its warm-up) and just before (d)'s cycles, and read just after.

Two other processes run beside the main one.  The device="cpu" halves
of phases 5, 12a, 14a, 15a and 16a-b run in one spawned child process
(CpuRefs: niced, CPU_CHILD_THREADS torch threads, its lines prefixed
"[cpu reference]"), started after phase 3's forward cycle and read where
each card half is done; the child is stopped before the report.  The
loop's plane phases -- 12b, 14b, 14c, 15b and 15c, on one plane --
run in a second process on the same card (LoopChild: `chip_smoke.py
--loop-child`, its lines prefixed "[loop]"), started right after phase
2's kernel timings, beside phases 3-11 and the loop's parity phases
(12a, 14a, 15a, run here after phase 11), and joined before phase 13,
whose timings and guard then have the card to themselves; each of its
phases resets and reads the launch counts in that process, and its
counts come back on its last line into the report.  So phases 3-11's
host walls and the K10-K13 timings are taken with that process beside
them.  --only-loop runs phases 1, 12, 14 and 15 alone in one process
(no kernel report, no result line).

Phase 2 also holds K7 (on the first forward chunk's wave 0 as
schedule_core launches it -- the chunk's workspace, the batch's
use_extra -- and on its spread sub-batch, each with its host / device
split), K8 (on a megafleet chunk's profile rows, its host / device
split and torch.topk over its key plane beside it, and on the same rows
over twice and 128 times the lanes, the latter in its device-memory pair
scratch) and K9 (on the 10k fleet, and with more
groups than one shared-memory tile; each beside torch.zeros + index_add_)
against their plain versions, and,
after phase 9 on its plane, K10 (cluster rows, cluster columns,
slot-store rows, and the two mirror syncs whole: twelve slot-store
fields at 1,024 slots and nine cluster-side fields at 64 lanes in one
fused launch each, against one index_copy_ per field and timed as sync
walls), K11 (both flavours, each with its host / device split, and
through dispatch_gather / dispatch_sub_gather from host slots, their
staged uploads included) and K12, and,
after phase 5, K13 (on config 5's 5,000 lanes committed from phase 3's
placements and on 16,384 random lanes, negatives, zero capacity with
load and invalid lanes mixed in, four threshold settings); phase 5
also compares one phase-7 chunk's explain planes and decisions, and one
shortlisted megafleet chunk, card against CPU, the first 2,048 megafleet
bindings shortlisted against dense on the card, and the resident plane
(fused and host, every batch audited) against plain cycles over two
churn windows of config 5's first 16,384 bindings.

With --parent TREE (the parent commit's karmada_tpu_torch/ unpacked in
TREE) phase 2 also times the parent's port against this one on the same
card, in turns (old, new, new, old; TURN_ROUNDS rounds): K3 and K2 std's
wave 0 (with the parent's K2 split) on the first forward chunk, K2-big's
wave 0 (K4 inside) on the first wide chunk's big rows, the forward
chunk's dispatch (8 waves + K3; each side's host enqueue and device time
by kernel beside it), K1 alone
and K2 std's wave 0 with its K1 (launched from Python in the parent),
tier 1 on the megafleet chunk's profile rows at 16,384 and 32,768 lanes
(the parent's K1 + K8 against the fused K8), K4 on
wave 0's problems of both tiers, K5 and K6 on the chunk's spread
sub-batch (each side's host / device split beside them), K7 on the
forward chunk's wave 0 and on its spread phase B (each as its tree's
main path calls it, each side's host / device split beside it), and,
after phase 9, K10 on one field,
both mirror syncs kernel side and as walls, K9, and K11 (both flavours
on card slots, and dispatch_gather and dispatch_sub_gather from host
slots, each side's host / device split beside them), and, in phase
13, K14 at 128 and 1,024 (13a) and K15 at 128 and 2^20 (13b), each
side's one-launch device time beside them.  Before the JSON
lines the run checks that neither K2 tier allocated a key scratch.

Device times ("split", "device") come from CUDA events: split_ms and
kernel_device_ms put an event pair around each of the port's launches
(or, for a call that runs library kernels of its own, around the whole
call with the stream drained first), the stream held busy while the
calls are enqueued so that no host time falls inside a pair.
torch.profiler's figure rides beside them as profiler_ms, and a reading
where it falls under 0.8 x the events less their pairs' floor
(event_floor_ms) is logged as "profiler lost records" (a process that
has profiled before loses device records).

Any mismatch or exception exits non-zero.  Without a CUDA card it exits 2
before printing any result.  The second-to-last line is the per-kernel
JSON report (K14's launches are the probe subprocess's own count; K15's
the capture's); the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import atexit
import dataclasses
import gc
import inspect
import json
import math
import os
import pickle
import random
import subprocess
import sys
import tempfile
import threading
import time
from typing import Optional

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (data sheet)
SCALAR_OPS_PER_S = 67e12   # H100 SXM fp32 outside the tensor cores
BF16_OPS_PER_S = 989e12    # H100 SXM bf16 tensor cores, dense (data sheet)
WIDE_BINDINGS = 16_384     # phase 6's cycle
EXPLAIN_BINDINGS = 512     # phase 7's cycle (2,048 until phase 12, 1,024
                           # until phase 14 took the time)
EXPLAIN_CHUNK = 1_024      # the JAX Scheduler's default pipeline_chunk
MEGAFLEET_BINDINGS = 1_000_000  # phase 8's cycle (MEGAFLEET_r01.json's scale)
MEGA_CLUSTERS = 10_000
MEGA_REGIONS = 200
MEGA_K = 64
RECALL_BINDINGS = 2_048    # phase 5's shortlisted-vs-dense sample
RESIDENT_BINDINGS = 16_384  # phase 5's resident-plane sample
INCREMENTAL_BINDINGS = 1_000_000  # phase 9's roster (MEGAFLEET_r02.json's)
TURN_ROUNDS = 3            # old-vs-new rounds (with --parent)
INCREMENTAL_CHURN = 1_000  # bindings churned per steady cycle (0.1%)
STEADY_CYCLES = 4


class GcClock:
    """Collections and pause seconds of the interpreter's cyclic garbage
    collector (gc.callbacks), since the last reset; armed by main()."""

    def __init__(self) -> None:
        self.start = None
        self.count = [0, 0, 0]
        self.seconds = 0.0

    def arm(self) -> None:
        gc.callbacks.append(self._event)

    def _event(self, phase, info) -> None:
        if phase == "start":
            self.start = time.perf_counter()
        elif self.start is not None:
            self.seconds += time.perf_counter() - self.start
            self.count[info["generation"]] += 1
            self.start = None

    def reset(self) -> None:
        self.count, self.seconds = [0, 0, 0], 0.0

    def line(self) -> str:
        return (f"gc {sum(self.count)} collections (gen2 {self.count[2]}) "
                f"{self.seconds:.3f} s")


GC = GcClock()


_PRINT = threading.Lock()  # log() and LoopChild's relay, one line at a time


def log(msg: str) -> None:
    with _PRINT:
        print(f"[cpu reference] {msg}" if IN_CPU_CHILD else msg, flush=True)


# -- the CPU halves of the card-vs-CPU comparisons, in a child process --------

IN_CPU_CHILD = False
CPU_CHILD_THREADS = 4   # the child's torch threads; the rest of the cores
                        # stay with this process's host work
CPU_CHILD_NICE = 10


def _run_pickled(blob: bytes):
    fn, args = pickle.loads(blob)
    return fn(*args)


def _cpu_child_init() -> None:
    global IN_CPU_CHILD
    IN_CPU_CHILD = True
    os.nice(CPU_CHILD_NICE)
    torch.set_num_threads(CPU_CHILD_THREADS)


class CpuRefs:
    """The device="cpu" halves of phases 5, 12a, 14a, 15a and 16 in one
    spawned child process (niced, CPU_CHILD_THREADS torch threads) while
    this process goes on with the card: each is submitted once its inputs
    exist and read where its card half is done, and compared there as
    before.  A job is a module-level function of picklable arguments
    returning picklable results; its wall is the child's."""

    def __init__(self) -> None:
        import concurrent.futures
        import multiprocessing

        self.pool = concurrent.futures.ProcessPoolExecutor(
            max_workers=1, mp_context=multiprocessing.get_context("spawn"),
            initializer=_cpu_child_init)
        self.jobs = {}
        self.cpu5 = {}  # phase 5's results, by label

    def submit(self, key, fn, *args) -> None:
        """fn(*args) in the child, on the arguments as they are now."""
        self.jobs[key] = self.pool.submit(_run_pickled,
                                          pickle.dumps((fn, args)))

    def result(self, key):
        return self.jobs.pop(key).result()

    def close(self) -> None:
        """Stop the child: queued jobs cancelled, a running one waited
        for."""
        self.pool.shutdown(wait=True, cancel_futures=True)


# -- the plane phases (12b, 14b-c, 15b-c) in a second process on the card ----

LOOP_CHILD_PREFIX = "[loop] "
LOOP_CHILD_RESULT = "loop child result: "


class LoopChild:
    """Phases 12b, 14b, 14c, 15b and 15c -- the loop's plane at config 5's
    width -- run by `chip_smoke.py --loop-child` in a second process on
    the same card, started once phase 2's kernel timings are taken and
    joined before phase 13, while this process goes on with phases 3-11
    and the loop's parity phases (12a, 14a, 15a).  The child rebuilds
    config 5's workload from the same seed, loads the kernels this process
    built, resets each phase's launch counts in its own process and sends
    them back on its last line; its other lines are relayed here prefixed
    LOOP_CHILD_PREFIX.  Its own process group, killed at exit if it is
    still running."""

    def __init__(self, args) -> None:
        cmd = [sys.executable, os.path.abspath(__file__), "--loop-child",
               "--seed", str(args.seed), "--bindings", str(args.bindings),
               "--clusters", str(args.clusters),
               "--loop-templates", str(args.loop_templates)]
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True,
                                     bufsize=1, start_new_session=True)
        self.payload = None
        self.relay = threading.Thread(target=self._relay, daemon=True)
        self.relay.start()
        atexit.register(self.stop)

    def _relay(self) -> None:
        for line in self.proc.stdout:
            line = line.rstrip("\n")
            if line.startswith(LOOP_CHILD_RESULT):
                self.payload = json.loads(line[len(LOOP_CHILD_RESULT):])
                continue
            with _PRINT:
                print(LOOP_CHILD_PREFIX + line, flush=True)

    def result(self) -> dict:
        """Wait for the child; its launch counts and remap calls.  Raises
        if it failed or sent nothing."""
        t0 = time.perf_counter()
        rc = self.proc.wait()
        self.relay.join()
        log(f"loop child: exit {rc}, {time.perf_counter() - self.t0:.1f} s "
            f"after its start, waited for {time.perf_counter() - t0:.1f} s")
        if rc != 0 or self.payload is None:
            raise AssertionError(f"the loop child (phases 12b, 14b-c, "
                                 f"15b-c) failed: exit {rc}")
        return self.payload

    def stop(self) -> None:
        if self.proc.poll() is None:
            import signal

            os.killpg(self.proc.pid, signal.SIGKILL)
            self.proc.wait()


# -- the bench.py workload mix, written against the port's models --------------

GVK = ("apps/v1", "Deployment")


def build_fleet(M, rng, n_clusters):
    Q = M.Quantity
    return [M.Cluster(
        metadata=M.ObjectMeta(name=f"member-{i:05d}"),
        spec=M.ClusterSpec(region=f"r{i % 8}", provider=f"p{i % 3}"),
        status=M.ClusterStatus(
            api_enablements=[M.APIEnablement(GVK[0], [GVK[1]])],
            resource_summary=M.ResourceSummary(
                allocatable={
                    "cpu": Q.from_milli(rng.randint(16000, 128000)),
                    "memory": Q.from_units(rng.randint(64, 512)),
                    "pods": Q.from_units(rng.randint(110, 256)),
                },
                allocated={
                    "cpu": Q.from_milli(rng.randint(0, 8000)),
                    "memory": Q.from_units(rng.randint(0, 32)),
                    "pods": Q.from_units(rng.randint(0, 40)),
                },
            ),
        ),
    ) for i in range(n_clusters)]


def build_placements(M, rng, names):
    out = []

    def subset_affinity():
        k = rng.randint(3, min(24, len(names)))
        start = rng.randrange(len(names))
        return M.ClusterAffinity(
            cluster_names=[names[(start + j) % len(names)] for j in range(k)])

    divided = M.REPLICA_SCHEDULING_DIVIDED
    for _ in range(8):  # Duplicated across an affinity subset
        out.append(M.Placement(
            cluster_affinity=subset_affinity(),
            replica_scheduling=M.ReplicaSchedulingStrategy(
                replica_scheduling_type=M.REPLICA_SCHEDULING_DUPLICATED)))
    for _ in range(8):  # StaticWeight split
        out.append(M.Placement(
            cluster_affinity=subset_affinity(),
            replica_scheduling=M.ReplicaSchedulingStrategy(
                replica_scheduling_type=divided,
                replica_division_preference=M.REPLICA_DIVISION_WEIGHTED)))
    for _ in range(8):  # DynamicWeight over the whole fleet
        out.append(M.Placement(
            replica_scheduling=M.ReplicaSchedulingStrategy(
                replica_scheduling_type=divided,
                replica_division_preference=M.REPLICA_DIVISION_WEIGHTED,
                weight_preference=M.ClusterPreferences(
                    dynamic_weight=M.DYNAMIC_WEIGHT_AVAILABLE_REPLICAS))))
    for _ in range(8):  # Aggregated with a cluster spread constraint
        out.append(M.Placement(
            spread_constraints=[M.SpreadConstraint(
                spread_by_field=M.SPREAD_BY_FIELD_CLUSTER, min_groups=2,
                max_groups=6)],
            replica_scheduling=M.ReplicaSchedulingStrategy(
                replica_scheduling_type=divided,
                replica_division_preference=M.REPLICA_DIVISION_AGGREGATED)))
    for _ in range(8):  # region topology spread (the device spread plane)
        rmin = rng.randint(1, 2)
        out.append(M.Placement(
            spread_constraints=[
                M.SpreadConstraint(spread_by_field=M.SPREAD_BY_FIELD_REGION,
                                   min_groups=rmin,
                                   max_groups=rng.randint(rmin, 3)),
                M.SpreadConstraint(spread_by_field=M.SPREAD_BY_FIELD_CLUSTER,
                                   min_groups=2, max_groups=6)],
            replica_scheduling=dynamic(M)))
    return out


def dynamic(M):
    return M.ReplicaSchedulingStrategy(
        replica_scheduling_type=M.REPLICA_SCHEDULING_DIVIDED,
        replica_division_preference=M.REPLICA_DIVISION_WEIGHTED,
        weight_preference=M.ClusterPreferences(
            dynamic_weight=M.DYNAMIC_WEIGHT_AVAILABLE_REPLICAS))


def big_binding(M, rng, b, names, style):
    """A binding beyond the tier-1 compact caps (after
    tests/test_solver_batch.py:584-627 and tests/test_spread_device.py
    :179-207): (0) DynamicWeight with 65-400 replicas, (1) Aggregated with
    cluster MaxGroups 65-300, (2) DynamicWeight with 17-100 previous
    clusters, (3) region spread over 1-3 regions with cluster MaxGroups
    65-300 (ROUTE_DEVICE_SPREAD_BIG); the others route ROUTE_DEVICE_BIG."""
    Q = M.Quantity
    spec = M.ResourceBindingSpec(
        resource=M.ObjectReference(
            api_version=GVK[0], kind=GVK[1], namespace=f"ns-{b % 64}",
            name=f"app-{b}", uid=f"uid-{b}"),
        replica_requirements=M.ReplicaRequirements(resource_request={
            "cpu": Q.from_milli(rng.choice([100, 250, 500])),
            "memory": Q.from_units(rng.choice([1, 2, 4]))}))
    if style == 0:
        spec.replicas = rng.randint(65, 400)
        spec.placement = M.Placement(replica_scheduling=dynamic(M))
    elif style == 1:
        spec.replicas = rng.randint(5, 60)
        spec.placement = M.Placement(
            spread_constraints=[M.SpreadConstraint(
                spread_by_field=M.SPREAD_BY_FIELD_CLUSTER, min_groups=2,
                max_groups=rng.randint(65, 300))],
            replica_scheduling=M.ReplicaSchedulingStrategy(
                replica_scheduling_type=M.REPLICA_SCHEDULING_DIVIDED,
                replica_division_preference=M.REPLICA_DIVISION_AGGREGATED))
    elif style == 2:
        spec.replicas = rng.randint(30, 120)
        spec.placement = M.Placement(replica_scheduling=dynamic(M))
        spec.clusters = [M.TargetCluster(name=n, replicas=1)
                         for n in rng.sample(names, rng.randint(17, 100))]
    else:
        rmin = rng.randint(1, 3)
        spec.replicas = rng.randint(5, 60)
        spec.placement = M.Placement(
            spread_constraints=[
                M.SpreadConstraint(spread_by_field=M.SPREAD_BY_FIELD_REGION,
                                   min_groups=rmin,
                                   max_groups=rng.randint(rmin, 3)),
                M.SpreadConstraint(spread_by_field=M.SPREAD_BY_FIELD_CLUSTER,
                                   min_groups=2,
                                   max_groups=rng.randint(65, 300))],
            replica_scheduling=dynamic(M))
    return spec, M.ResourceBindingStatus()


def build_wide_items(M, rng, n_bindings, placements, names):
    """Seven bindings in eight from bench.py's placements, every eighth one
    of the four big styles in turn."""
    items = build_bindings(M, rng, n_bindings, placements)
    for b in range(7, n_bindings, 8):
        items[b] = big_binding(M, rng, b, names, (b // 8) % 4)
    return items


def starve_items(M, items, every=16):
    """`items` with every `every`-th binding (from the sixth on, never a
    big-style one) asking for more CPU per replica than any cluster has,
    so that the explain cycle meets unschedulable rows."""
    huge = M.ReplicaRequirements(resource_request={
        "cpu": M.Quantity.from_milli(10**9),
        "memory": M.Quantity.from_units(1)})
    return [(dataclasses.replace(spec, replica_requirements=huge), status)
            if b % every == 5 else (spec, status)
            for b, (spec, status) in enumerate(items)]


def build_bindings(M, rng, n_bindings, placements):
    Q = M.Quantity
    items = []
    for b in range(n_bindings):
        spec = M.ResourceBindingSpec(
            resource=M.ObjectReference(
                api_version=GVK[0], kind=GVK[1], namespace=f"ns-{b % 64}",
                name=f"app-{b}", uid=f"uid-{b}"),
            replicas=rng.choice([1, 2, 3, 5, 10, 20, 50]),
            replica_requirements=M.ReplicaRequirements(resource_request={
                "cpu": Q.from_milli(rng.choice([100, 250, 500])),
                "memory": Q.from_units(rng.choice([1, 2, 4])),
            }),
            placement=placements[b % len(placements)],
        )
        items.append((spec, M.ResourceBindingStatus()))
    return items


def build_rebalance_items(M, rng, items, names):
    out = []
    for k, (spec, _status) in enumerate(items):
        prev_n = rng.randint(1, 4)
        start = rng.randrange(len(names))
        per = max(1, spec.replicas // prev_n)
        prev = [M.TargetCluster(name=names[(start + j) % len(names)],
                                replicas=per) for j in range(prev_n)]
        out.append((dataclasses.replace(
            spec, clusters=prev,
            reschedule_triggered_at=(100.0 if k % 3 == 0 else None)),
            M.ResourceBindingStatus()))
    return out


def build_megafleet(M, rng, n_clusters, n_regions):
    """bench.py build_megafleet: clusters round-robined into regions, one
    Divided/DynamicWeight placement per region whose affinity names
    exactly that region's clusters."""
    clusters = build_fleet(M, rng, n_clusters)
    for i, c in enumerate(clusters):
        c.spec.region = f"r{i % n_regions}"
    by_region = {}
    for c in clusters:
        by_region.setdefault(c.spec.region, []).append(c.metadata.name)
    return clusters, [
        M.Placement(cluster_affinity=M.ClusterAffinity(
            cluster_names=by_region[r]), replica_scheduling=dynamic(M))
        for r in sorted(by_region, key=lambda s: int(s[1:]))]


def build_mega_bindings(M, rng, n, placements, block):
    """bench.py build_mega_bindings: 9 shared request classes, replicas
    1-3, the placement advancing every `block` bindings."""
    Q = M.Quantity
    reqs = [M.ReplicaRequirements(resource_request={
        "cpu": Q.from_milli(cpu), "memory": Q.from_units(mem)})
        for cpu in (100, 250, 500) for mem in (1, 2, 4)]
    status = M.ResourceBindingStatus()
    items = []
    for b in range(n):
        spec = M.ResourceBindingSpec(
            resource=M.ObjectReference(
                api_version=GVK[0], kind=GVK[1], namespace=f"ns-{b % 64}",
                name=f"mega-{b}", uid=f"uid-mega-{b}"),
            replicas=rng.choice([1, 2, 3]),
            replica_requirements=reqs[rng.randrange(len(reqs))],
            placement=placements[(b // max(block, 1)) % len(placements)])
        items.append((spec, status))
    return items


#: _CarryChain._device_remap calls (PERF.md's row 15) while "on": main()
#: turns it on around the main-path phases (3, 4, 6-9, 10b, 12b)
REMAPS = {"on": False, "calls": 0}


def count_remaps() -> None:
    """Wrap _CarryChain._device_remap to count its calls into REMAPS."""
    from karmada_tpu_torch.scheduler.pipeline import _CarryChain

    inner = _CarryChain._device_remap

    def remap(used, from_batch, to_batch):
        REMAPS["calls"] += REMAPS["on"]
        return inner(used, from_batch, to_batch)

    _CarryChain._device_remap = staticmethod(remap)


def models():
    from types import SimpleNamespace

    from karmada_tpu_torch.models import cluster, meta, policy, work
    from karmada_tpu_torch.utils import quantity

    ns = {}
    for m in (meta, cluster, policy, work, quantity):
        ns.update({k: v for k, v in vars(m).items() if not k.startswith("_")})
    return SimpleNamespace(**ns)


# -- measurement helpers ------------------------------------------------------

def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over `reps` calls after one warm-up,
    between CUDA events."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


#: kernels modules whose launches the event readers time: this port's,
#: and the parent's once load_parent has built it
KMODS: list = []
#: the card's cycles a millisecond for torch.cuda._sleep (H100 SXM boost,
#: 1.98 GHz; at a lower clock a hold only lasts longer)
CYCLES_PER_MS = 1.98e6
#: split_ms / kernel_device_ms readings, and those where torch.profiler
#: read under PROFILER_LOST_BELOW x the events less their pairs' floor
PROFILER_CHECKS = {"readings": 0, "lost": 0}
PROFILER_LOST_BELOW = 0.8
#: an event pair's floor (event_floor_ms), measured once
EVENT_FLOOR: dict = {}


def _kmods() -> list:
    if not KMODS:
        from karmada_tpu_torch.ops import kernels
        KMODS.append(kernels)
    return KMODS


def hold_stream(ms: float) -> None:
    """Keep the current stream busy for about `ms` (torch.cuda._sleep), so
    that what the host enqueues meanwhile runs back to back, with no host
    time between an event pair."""
    torch.cuda._sleep(max(1, int(ms * CYCLES_PER_MS)))


def event_floor_ms() -> float:
    """An event pair's floor on this card: the median pair around the
    smallest launch (torch.cuda._sleep(0)) on a held stream, measured
    once and logged beside the median pair around nothing.  A pair around
    a launch reads at least this much more than the kernel's own
    duration in a profiler trace."""
    if "ms" not in EVENT_FLOOR:
        torch.cuda.synchronize()
        marks = {"a launch": [], "nothing": []}
        hold_stream(10.0)
        for _ in range(200):
            for what, pairs in marks.items():
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                if what == "a launch":
                    torch.cuda._sleep(0)
                e1.record()
                pairs.append((e0, e1))
        torch.cuda.synchronize()
        med = {k: float(np.median([a.elapsed_time(b) for a, b in v]))
               for k, v in marks.items()}
        EVENT_FLOOR["ms"] = med["a launch"]
        log(f"event pair floor: {med['a launch']:.5f} ms around the "
            f"smallest launch, {med['nothing']:.5f} ms around nothing "
            "(medians of 200 pairs on a held stream)")
    return EVENT_FLOOR["ms"]


def launch_events(fn, reps: int, lead_ms: float) -> tuple:
    """Each call's CUDA-event milliseconds by C entry, over `reps` calls
    after one warm-up: an event pair on the stream just before and just
    after each launch the call makes through a kernels module's launch
    (_kmods), summed per entry, the stream held busy for `lead_ms` first.
    ([{entry: ms}, ...] one dict a call, event pairs a call)."""
    fn()
    torch.cuda.synchronize()
    mods = _kmods()
    origs = [m.launch for m in mods]
    calls: list = []

    def timed(orig):
        def launch(source, args, entry=None, count=None, device=None):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            orig(source, args, entry, count, device)
            e1.record()
            calls[-1].append((entry or source, e0, e1))
        return launch

    for m, o in zip(mods, origs):
        m.launch = timed(o)
    try:
        hold_stream(lead_ms)
        for _ in range(reps):
            calls.append([])
            fn()
    finally:
        for m, o in zip(mods, origs):
            m.launch = o
    torch.cuda.synchronize()
    out = []
    for marks in calls:
        d: dict = {}
        for name, e0, e1 in marks:
            d[name] = d.get(name, 0.0) + e0.elapsed_time(e1)
        out.append(d)
    return out, sum(len(m) for m in calls) / max(1, reps)


def call_events(fn, reps: int, lead_ms: float) -> list:
    """CUDA-event milliseconds of each of `reps` whole calls after one
    warm-up, each with the stream drained first and then held busy for
    `lead_ms`: for a call that also runs library kernels of its own.  A
    call that synchronises inside spans its own host gaps too."""
    fn()
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        hold_stream(lead_ms)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        out.append(e0.elapsed_time(e1))
    return out


def profiler_ms(fn, reps: int):
    """torch.profiler's device milliseconds per call over `reps` calls:
    (their sum, {kernel symbol: ms}, device records a call); (None, {},
    0) when it recorded none.  Kept only beside the events' figures: a
    window in a process that has profiled before may lose its device
    records."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages()
           if getattr(e, "device_time_total", 0) > 0]
    by = {e.key: e.device_time_total / reps / 1e3 for e in dev}
    return ((sum(by.values()) if by else None), by,
            sum(e.count for e in dev) / reps)


def _check_profiler(events: Optional[float], prof: Optional[float],
                    pairs: float, records: float) -> None:
    """Count a reading; log it as "profiler lost records" where the
    profiler read under PROFILER_LOST_BELOW x the events less their pairs'
    floor (event_floor_ms) -- with its device records a call beside the
    event pairs a call: fewer records than pairs is a loss, as many is a
    call whose pair also spans host gaps inside it."""
    PROFILER_CHECKS["readings"] += 1
    if not events:
        return
    net = events - pairs * event_floor_ms()
    if prof is None or prof < PROFILER_LOST_BELOW * net:
        PROFILER_CHECKS["lost"] += 1
        at = sys._getframe(2)
        log(f"  profiler lost records ({at.f_code.co_name}:{at.f_lineno}):"
            f" profiler_ms {prof if prof is None else round(prof, 4)}, "
            f"events {events:.4f} ms less {pairs:g} pair floors "
            f"{net:.4f}; device records a call {records:g}, event pairs "
            f"{pairs:g}")


class Split(tuple):
    """split_ms's reading, (host, device) ms per call; `profiler_ms` the
    profiler's device figure over the same calls, beside the events'."""

    def __new__(cls, host, device, prof):
        s = super().__new__(cls, (host, device))
        s.profiler_ms = prof
        return s

    def __repr__(self) -> str:
        d = "not measured" if self[1] is None else f"{self[1]:.4f}"
        p = "none" if self.profiler_ms is None else f"{self.profiler_ms:.4f}"
        return f"(host {self[0]:.4f}, device {d} ms; profiler_ms {p})"


def split_ms(fn, reps: int, whole: bool = False) -> Split:
    """Where one call's time goes: (host, device) milliseconds per call --
    the host clock over `reps` calls enqueued back to back (nothing waits
    inside), and the device time by CUDA events: an event pair around each
    of the port's launches the call makes, summed per call (None when it
    launches none), or with `whole` a pair around the whole call with the
    stream drained first (a call that also runs library kernels of its
    own, such as K12's wrapper's torch.sort; the median call).  The
    stream is held busy while the calls are enqueued, so no host time
    falls inside a pair; a pair still reads event_floor_ms more than a
    kernel's own duration.
    torch.profiler's figure rides along as `.profiler_ms`.  A kernel
    whose cuda_ms is near its host time is held back by its launch
    path."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    if whole:
        device = float(np.median(call_events(fn, reps, 2 * host + 0.05)))
        pairs = 1.0
    else:
        per, pairs = launch_events(fn, reps, reps * (2 * host + 0.05))
        device = (float(np.mean([sum(d.values()) for d in per]))
                  if any(per) else None)
    prof, _by, records = profiler_ms(fn, reps)
    _check_profiler(device, prof, pairs, records)
    return Split(host, device, prof)


def wall_ms(fn, reps: int) -> float:
    """Mean host-clock milliseconds of one call of `fn` ended by
    torch.cuda.synchronize(), over `reps` calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


class ByEntry(dict):
    """kernel_device_ms's reading: CUDA-event ms per call by C entry;
    `profiler_ms` torch.profiler's ms per call by kernel symbol beside it
    (the only split of a C call that runs several kernels)."""

    profiler_ms: dict


def kernel_device_ms(fn, reps: int) -> ByEntry:
    """CUDA-event device milliseconds per call of `fn` by C entry (an
    event pair around each launch through a kernels module's launch, the
    stream held busy while they are enqueued), over `reps` calls after
    one warm-up; torch.profiler's by kernel symbol beside them."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host = (time.perf_counter() - t0) * 1e3
    per, pairs = launch_events(fn, reps, reps * (2 * host + 0.05))
    out = ByEntry()
    for d in per:
        for k, v in d.items():
            out[k] = out.get(k, 0.0) + v / reps
    prof, out.profiler_ms, records = profiler_ms(fn, reps)
    _check_profiler(sum(out.values()) or None, prof, pairs, records)
    return out


def by_text(by: ByEntry) -> str:
    """A kernel_device_ms reading as text: the events by C entry, then the
    profiler's by kernel beside them."""
    ev = ", ".join(f"{k} {v:.4f}" for k, v in by.items()) or "no launch"
    pr = ", ".join(f"{k.split('(')[0].strip()[:60]} {v:.4f}" for k, v in
                   sorted(by.profiler_ms.items(), key=lambda x: -x[1]))
    return (f"events by C entry {ev} ms (sum {sum(by.values()):.4f}); "
            f"profiler_ms by kernel {pr or 'none'}")


def fills_est(S) -> bool:
    """True for a tree whose K2 wrapper enqueues the wave's K1 itself
    (schedule_rows(..., fill_est=True)); the parent's launches K1 from
    Python before every wave."""
    return "fill_est" in inspect.signature(S.schedule_rows).parameters


def fused_k8(SL) -> bool:
    """True for a tree whose K8 computes its own capacity
    (shortlist_topk(db, group_pref, k)); the parent's takes K1's est."""
    return "est" not in inspect.signature(SL.shortlist_topk).parameters


def wave_call(S, db, used, out, use_extra, tier, fill):
    """Wave 0 of `db` on lane tier `tier` as the tree's schedule_core runs
    it: its K1 (from Python, or enqueued by K2's first launch) and K2
    with K4 inside, charging into `used`."""
    B = db.B
    Bw = B // S._effective_waves(B, 8)
    Q = db.req_milli.shape[0]
    if fill:
        est = torch.empty((Q + 1, db.C), dtype=torch.int64,
                          device=db.req_milli.device)
        return lambda: S.schedule_rows(db, 0, Bw, est, *used, *out,
                                       use_extra=use_extra, charge=True,
                                       tier=tier, fill_est=True)

    def wave():
        est = S.capacity(db.req_milli, db.req_is_cpu, db.req_pods,
                         db.avail_milli, used[0], db.has_alloc,
                         db.pods_allowed, used[1], db.has_summary,
                         db.est_override, used[2])
        S.schedule_rows(db, 0, Bw, est, *used, *out, use_extra=use_extra,
                        charge=True, tier=tier)
    return wave


def tile_lanes(S, db, times=2):
    """db's rows over `times` copies of its cluster lanes, name ranks
    shifted per copy: the same profile rows on a wider fleet."""
    C = db.C
    t = dict(db.t)
    for f in ("cluster_valid", "deleting", "pods_allowed", "has_summary",
              "avail_milli", "has_alloc"):
        t[f] = torch.cat([db.t[f]] * times).contiguous()
    t["name_rank"] = torch.cat([db.name_rank + i * C for i in range(times)])
    for f in ("api_ok", "pl_mask", "pl_tol_bypass", "est_override"):
        t[f] = torch.cat([db.t[f]] * times, dim=1).contiguous()
    return S.DeviceBatch(B=db.B, C=times * C, device=db.device, t=t)


def tier1_call(S, SL, db, pref, k):
    """The tree's tier-1 device work for db's profile rows, as _t1_rows
    runs it: the parent's K1 on a zero used triple then K8, or the fused
    K8 alone."""
    if fused_k8(SL):
        return lambda: SL.shortlist_topk(db, pref, k)

    def pair():
        z = S._zeros_used(db)
        est = S.capacity(db.req_milli, db.req_is_cpu, db.req_pods,
                         db.avail_milli, z[0], db.has_alloc, db.pods_allowed,
                         z[1], db.has_summary, db.est_override, z[2])
        return SL.shortlist_topk(db, est, pref, k)
    return pair


def max_abs_err(pairs) -> float:
    err = 0.0
    for a, b in pairs:
        if a.shape != b.shape:
            raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
        if a.numel():
            d = (a.to(torch.float64) - b.to(torch.float64)).abs().max()
            err = max(err, float(d))
    return err


def bound_ms(nbytes: float, ops: float, ops_per_s: float = SCALAR_OPS_PER_S):
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / ops_per_s * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# -- phases --------------------------------------------------------------------

def phase_device() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    line = out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""
    log(line if line else "nvidia-smi: no reading")
    return line


def phase_build() -> None:
    from karmada_tpu_torch import native
    from karmada_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    kernels.build(verbose=True)  # prints nvcc -Xptxas -v per source
    dt = time.perf_counter() - t0
    log(f"phase 1 build: {len(kernels.SOURCES)} sources ({len(kernels.KERNELS)} "
        f"kernels) in {dt:.1f} s "
        f"(sources {kernels.CSRC})")
    t0 = time.perf_counter()
    paths = native.build(verbose=True)  # gcc / g++, one each, in parallel
    dt = time.perf_counter() - t0
    log(f"phase 1 native build: {len(paths)} libraries in {dt:.2f} s "
        f"(compiler walls {native.BUILD_SECONDS}; {native.COUNTS['builds']} "
        f"built, into {native.build_dir()})")
    for name, path in paths.items():
        if "karmada_tpu_torch/native/_build" not in str(path):
            raise AssertionError(f"native {name} loaded from {path}")


def native_line(label: str, counts: dict) -> str:
    """One phase's use of the native host paths (native.COUNTS)."""
    enc = counts["encode_c"] + counts["encode_miss"]
    return (f"phase {label} native: encode C {counts['encode_c']} of "
            f"{enc} bindings ({counts['encode_miss']} encode_one misses, "
            f"{100.0 * counts['encode_c'] / max(enc, 1):.1f}% hits), "
            f"Python loop {counts['encode_py']}; decode rows decode_coo "
            f"{counts['decode_coo']}, decode_fast {counts['decode_fast']}, "
            f"Python {counts['decode_py']}, re-routes "
            f"{counts['decode_reroute']}")


def check_native(label: str, counts: dict, need_coo: bool) -> None:
    """A main-path cycle encodes through the C path only (nothing in the
    port asks for native=False); phases 3 and 8 decode through
    decode_coo."""
    if counts["encode_py"]:
        raise AssertionError(f"phase {label}: {counts['encode_py']} "
                             "bindings encoded through native=False")
    if need_coo and counts["decode_coo"] <= 0:
        raise AssertionError(f"phase {label}: no row decoded by decode_coo")


def hold_rows(db, waves: int, use_extra: bool, tier: str, dev, reps: int):
    """K2 (with K4 inside) on tier `tier` over a whole batch, wave by wave,
    kernel path (each wave's K1 enqueued by its first K2 launch, as in
    schedule_core) and plain path (capacity_plain, schedule_rows_plain)
    from the same zero carry; then one wave's launch timed on wave 0's
    inputs, and wave 0 with its K1 split into host enqueue and device
    time by kernel.  Returns (max_abs_err, ms, plain_ms, bound, every
    wave's K4 operands, the kernel path's outputs)."""
    from karmada_tpu_torch.ops import solver as S

    B, C = db.B, db.C
    Q = db.req_milli.shape[0]
    waves = S._effective_waves(B, waves)
    Bw = B // waves
    zeros = S._zeros_used(db)
    cap_in = (db.req_milli, db.req_is_cpu, db.req_pods, db.avail_milli,
              zeros[0], db.has_alloc, db.pods_allowed, zeros[1],
              db.has_summary, db.est_override, zeros[2])

    def run(kernel, problems=None):
        used = tuple(u.clone() for u in zeros)
        rep = torch.empty((B, C), dtype=torch.int64, device=dev)
        sel = torch.empty((B, C), dtype=torch.bool, device=dev)
        st = torch.empty((B,), dtype=torch.int32, device=dev)
        est = torch.empty((Q + 1, C), dtype=torch.int64, device=dev)
        for wv in range(waves):
            rows = (wv * Bw, (wv + 1) * Bw)
            if kernel:
                cap = {}
                S.schedule_rows(db, *rows, est, *used, rep, sel, st,
                                use_extra=use_extra, charge=True, tier=tier,
                                fill_est=True, capture=cap)
                problems.append(cap["webster"])
            else:
                est = S.capacity_plain(
                    db.req_milli, db.req_is_cpu, db.req_pods, db.avail_milli,
                    used[0], db.has_alloc, db.pods_allowed, used[1],
                    db.has_summary, db.est_override, used[2])
                S.schedule_rows_plain(db, *rows, est, *used, rep, sel, st,
                                      use_extra=use_extra, charge=True,
                                      tier=tier)
        return rep, sel, st, used

    problems = []
    got = run(True, problems)
    want = run(False)
    err = max_abs_err(list(zip(got[:3], want[:3]))
                      + list(zip(got[3], want[3])))
    est0 = S.capacity(*cap_in)
    out = (torch.empty((B, C), dtype=torch.int64, device=dev),
           torch.empty((B, C), dtype=torch.bool, device=dev),
           torch.empty((B,), dtype=torch.int32, device=dev))
    # the wave charges its rows into a carry; est0 stays wave 0's, so a
    # carry reused across timed calls changes no call's work
    used = tuple(u.clone() for u in zeros)

    def wave(fn):
        return lambda: fn(db, 0, Bw, est0, *used, *out,
                          use_extra=use_extra, charge=True, tier=tier)

    ms = cuda_ms(wave(S.schedule_rows), reps)
    by = kernel_device_ms(wave(S.schedule_rows), reps)
    host, device = split_ms(wave(S.schedule_rows), reps)
    log(f"phase 2 K2 split ({tier}, wave 0: {Bw} x {C}): " + by_text(by)
        + f"; split_ms host enqueue {host:.4f} ms, device "
        + (f"{device:.4f} ms" if device is not None else "not measured")
        + f"; key scratch allocated so far {S.KEY_SCRATCH_BYTES[tier]} B")
    # wave 0 as schedule_core runs it: K1 enqueued by K2's first launch
    whole = wave_call(S, db, used, out, use_extra, tier, True)
    by = kernel_device_ms(whole, reps)
    host, _d = split_ms(whole, reps)
    log(f"phase 2 K1 in the wave ({tier}, wave 0 with its K1): CUDA events "
        f"{cuda_ms(whole, reps):.4f} ms, host enqueue {host:.4f} ms, device "
        f"{sum(by.values()):.4f} ms, of which capacity_kernel (profiler_ms) "
        f"{sum(v for k, v in by.profiler_ms.items() if 'capacity' in k):.4f}"
        f" ms; {by_text(by)}")
    plain_ms = cuda_ms(wave(S.schedule_rows_plain), 2)
    row_in = nbytes(est0, db.pl_mask, db.pl_tol_bypass, db.pl_static_w,
                    db.pl_extra_score, db.api_ok, db.cluster_valid,
                    db.deleting, db.name_rank) + sum(
        nbytes(db.t[f][:Bw]) for f in S._BINDING_FIELDS)
    row_out = Bw * C * (8 + 1) + Bw * 4 + 2 * nbytes(*zeros)
    return err, ms, plain_ms, bound_ms(row_in + row_out, Bw * C), \
        problems, got


def sort_ops(rows: int, C: int) -> float:
    """Comparisons of a comparison sort of each row's C lanes."""
    return rows * C * max(1.0, math.log2(C))


def bisect_steps(lo, hi, pred, live):
    """A `while hi - lo > 1` bisection per row (rows where `live`), with
    pred(mid) moving hi down: (iterations, final hi) per row."""
    steps = torch.zeros_like(lo)
    lo, hi = lo.clone(), hi.clone()
    while True:
        go = live & (hi - lo > 1)
        if not bool(go.any()):
            return steps, hi
        mid = (lo + hi) >> 1
        p = pred(mid)
        lo = torch.where(go & ~p, mid, lo)
        hi = torch.where(go & p, mid, hi)
        steps += go


def webster_census(problems) -> dict:
    """Facts of K4 problems (a list of (n, w, s0, active, rank) batches),
    from webster_plain's arithmetic: per row n_eff, the lanes of positive
    weight P, whether the threshold t* is 0, whether a tie block is
    awarded (r > 0), its candidate lanes (the lanes whose rank the
    function reads), and the bisection steps of the parent's design
    (threshold over (0, max wq], tie keys over (0, 2^27 L])."""
    from karmada_tpu_torch.ops import solver as S

    cols = {k: [] for k in ("n_eff", "P", "t0", "r", "tie_lanes",
                            "thr_old", "tie_old")}
    for n, w, s0, active, rank in problems:
        L = w.shape[1]
        z = torch.zeros((), dtype=torch.int64, device=w.device)
        zr = torch.zeros_like(n)
        w = torch.where(active, w.clamp(0, S._W_CAP), z)
        s0 = torch.where(active, s0.clamp(0, S._N_CAP), z)
        pos = active & (w > 0)
        P = pos.sum(1)
        n_eff = torch.where(P > 0, n.clamp(0, S._N_CAP), zr)
        live = n_eff > 0
        wq = w << S.PRIORITY_QBITS

        def lanes(t, wq=wq, s0=s0, pos=pos, n_eff=n_eff, z=z):
            m = (S._floordiv(wq, (t + 1)[:, None]) + 1) >> 1
            return torch.where(pos, torch.minimum(
                (m - s0).clamp(min=0), n_eff[:, None]), z)

        def fits(t, lanes=lanes, n_eff=n_eff):
            return lanes(t).sum(1) <= n_eff

        thr_old, hi = bisect_steps(zr, wq.max(1).values.clamp(min=1), fits,
                                   live)
        t0 = fits(zr)
        t_star = torch.where(t0, zr, hi)
        full = lanes(t_star)
        r = n_eff - full.sum(1)
        k = torch.where((t_star > 0)[:, None],
                        lanes((t_star - 1).clamp(min=0)) - full, z)
        base = s0 + full
        tie = live & (r > 0)

        def reach(K, rank=rank, L=L, base=base, k=k, r=r):
            c = S._floordiv(K[:, None] - 1 - rank, L) - base + 1
            return torch.minimum(c.clamp(min=0), k).sum(1) >= r

        tie_old, _ = bisect_steps(
            zr, torch.full_like(n, (1 << 27) * L), reach, tie)
        tie_lanes = torch.where(tie, (k > 0).sum(1), zr)
        for name, v in (("n_eff", n_eff), ("P", P), ("t0", t0),
                        ("r", r > 0), ("tie_lanes", tie_lanes),
                        ("thr_old", thr_old), ("tie_old", tie_old)):
            cols[name].append(v.cpu().numpy())
    return {k: np.concatenate(v) for k, v in cols.items()}


def k4_census_line(tier: str, c: dict) -> str:
    """One log line of webster_census over a tier's problems."""
    live = c["n_eff"] > 0
    rows = len(live)

    def q(v, among=live):
        v = v[among]
        if not v.size:
            return "-"
        return (f"p50 {np.percentile(v, 50):.0f} "
                f"p90 {np.percentile(v, 90):.0f} max {v.max()}")

    def st(name, among):
        v = c[name][among]
        return (f"mean {v.mean():.1f} max {v.max()}" if v.size else "-")

    tie = live & c["r"]
    return (f"phase 2 K4 census ({tier}): {rows} rows, n_eff = 0 in "
            f"{np.mean(~live):.3f}; of the rest n_eff {q(c['n_eff'])}, "
            f"positive lanes P {q(c['P'])}, "
            f"t* = 0 in {np.mean(c['t0'][live]) if live.any() else 0:.3f}, "
            f"r > 0 in {np.mean(c['r'][live]) if live.any() else 0:.3f} "
            f"with tie-block lanes {q(c['tie_lanes'], tie)}; steps of the "
            f"parent's design: threshold {st('thr_old', live)}, tie "
            f"{st('tie_old', tie)}")


def spread_census(gi, pk) -> dict:
    """Facts of a spread sub-batch from the plain arithmetic of K5 and K6
    (spread.py's planes and key) on their operands `gi` (K5's, as
    solve_spread handed them) and `pk` (K6's): per phase-A row its
    feasible lanes and its groups' members; per Divided group with
    members its walk -- the members taken in key order until the running
    count reaches cmin and the running availability the target -- or
    that it is exhausted, and whether a count below cmin, or a total
    availability below the target with no negative member availability,
    decides that without a walk; the Duplicated rows; per phase-B row its
    chosen groups that hold members, the lanes inside them and rest."""
    from karmada_tpu_torch.ops import solver as S
    from karmada_tpu_torch.ops import spread as SP

    db, est, gid, rmin, cmin, dup, G = gi
    f, av, sc = SP._planes(db, est)
    B, C = f.shape
    seg = torch.where(f & (gid >= 0)[None, :], gid.long()[None, :], G)
    key = SP._sort_key(sc, av, db.name_rank[None, :], f)
    o1 = torch.sort(key, dim=1, stable=True).indices
    order = o1.gather(1, torch.sort(seg.gather(1, o1), dim=1,
                                    stable=True).indices)
    s = seg.gather(1, order)
    mem = s < G
    a = torch.where(mem, av.gather(1, order), 0)
    pos = torch.arange(C, device=f.device).expand(B, C)
    bnd = torch.ones_like(mem)
    bnd[:, 1:] = s[:, 1:] != s[:, :-1]
    start = torch.cummax(torch.where(bnd, pos, 0), dim=1).values
    cnt = pos - start + 1
    ca = torch.cumsum(a, 1)
    cum_av = ca - ca.gather(1, start) + a.gather(1, start)
    reps = db.replicas
    target = torch.where(rmin > 0, -S._floordiv(-reps, rmin.clamp(min=1)),
                         reps)
    cm = torch.maximum(cmin, rmin)
    ok = mem & (cnt >= cm[:, None]) & (cum_av >= target[:, None])
    big = torch.full((B, G + 1), C + 1, dtype=torch.int64, device=f.device)
    walked = big.scatter_reduce(1, s, torch.where(ok, cnt, C + 1),
                                reduce="amin")[:, :G]
    zero = torch.zeros((B, G + 1), dtype=torch.int64, device=f.device)
    value = zero.scatter_add(1, s, mem.long())[:, :G]
    tot_av = zero.scatter_add(1, s, a)[:, :G]
    neg = zero.scatter_add(1, s, (mem & (a < 0)).long())[:, :G] > 0
    div = (value > 0) & ~dup[:, None]
    exh = div & (walked > C)
    short = exh & ((value < cm[:, None])
                   | ((tot_av < target[:, None]) & ~neg))
    rows, est6, gid6, chosen, cmax = pk[:5]
    f6, av6, sc6 = SP._planes(rows, est6)
    seg6 = torch.where(f6 & (gid6 >= 0)[None, :], gid6.long()[None, :], G)
    ext = torch.cat([chosen, torch.zeros_like(chosen[:, :1])], 1)
    inch = ext.gather(1, seg6)
    z6 = torch.zeros((rows.B, G + 1), dtype=torch.int64, device=f.device)
    per_g = z6.scatter_add(1, seg6, inch.long())[:, :G]
    total = inch.sum(1)
    n_sel = (per_g > 0).sum(1)
    rest = (torch.minimum(total, cmax) - n_sel).clamp(min=0)

    def np_(t):
        return t.cpu().numpy()

    walk_steps = int(walked[div & ~exh].sum()) + int(value[exh & ~short].sum())
    return dict(rows=B, C=C, G=G, feasible=np_(f.sum(1)),
                walk_steps=walk_steps,
                pick_steps=int((rest + n_sel).sum()),
                members=np_(value[value > 0]), walked=np_(walked[div & ~exh]),
                divided_groups=int(div.sum()), exhausted=int(exh.sum()),
                exhausted_short=int(short.sum()),
                duplicated_rows=int(dup.sum()), pick_rows=rows.B,
                chosen=np_(n_sel), in_chosen=np_(total), rest=np_(rest))


def spread_census_line(label: str, c: dict) -> str:
    """One log line of spread_census."""
    def q(v):
        if not v.size:
            return "-"
        return (f"p50 {np.percentile(v, 50):.0f} "
                f"p90 {np.percentile(v, 90):.0f} max {v.max()}")

    return (f"spread census ({label}): phase A {c['rows']} rows x "
            f"{c['C']} lanes, G = {c['G']}: feasible lanes {q(c['feasible'])}"
            f"; members a group {q(c['members'])}; {c['duplicated_rows']} "
            f"Duplicated rows; {c['divided_groups']} Divided groups with "
            f"members, members walked until the walk qualifies "
            f"{q(c['walked'])}, exhausted {c['exhausted']} (decided without "
            f"a walk {c['exhausted_short']}), {c['walk_steps']} walk steps in "
            f"all; phase B {c['pick_rows']} rows:"
            f" chosen groups with members {q(c['chosen'])}, lanes in them "
            f"{q(c['in_chosen'])}, rest {q(c['rest'])}")


def spread_operands(batch, part, dev, waves) -> dict:
    """K5's and K6's operands as solve_spread hands them, for each (axis,
    tier) group of the chunk `part` (encoded as `batch`)."""
    from karmada_tpu_torch.ops import spread as SP
    from karmada_tpu_torch.ops import tensors as T

    out = {}
    for (axis, tier), idxs in T.spread_groups(batch, part).items():
        cap = {}
        SP.solve_spread(batch, part, idxs, waves=waves, axis=axis,
                        tier=tier, device=dev, capture=cap)
        if "pick" in cap:
            out[(axis, tier)] = (cap["group_info"], cap["pick"])
    return out


def spread_need_bytes(db, est, use_extra: bool, per_row: int) -> int:
    """The bytes a spread kernel's function needs on a sub-batch `db`:
    the distinct operand rows its rows read, each once -- the est rows of
    their classes (8 B a lane), the pl_mask and pl_tol_bypass rows of
    their placements (2 B) and, with use_extra, their pl_extra_score rows
    (8 B; without, they are known to be 0), the api_ok rows of their GVKs
    (1 B) -- the cluster vectors (cluster_valid, deleting, name_rank,
    group_id: 14 B a lane), each row's valid COO entries (prev 8 B, evict
    4 B), and `per_row` bytes a row of row scalars and outputs."""
    C = db.C
    Q = est.shape[0] - 1
    cid = db.class_id.long()
    n_est = torch.unique(torch.where(cid >= 0, cid, Q)).numel()
    n_pl = torch.unique(db.placement_id).numel()
    n_gvk = torch.unique(db.gvk_id).numel()
    coo = (int((db.prev_idx >= 0).sum()) * 8
           + int((db.evict_idx >= 0).sum()) * 4)
    return (n_est * C * 8 + n_pl * C * (10 if use_extra else 2)
            + n_gvk * C + C * 14 + coo + db.B * per_row)


def gather_keys(S, db, r0, r1, est, use_extra):
    """The gather keys of rows [r0, r1) on est, as the plain path makes
    them (JAX _gather_lanes): [groups, rows, C] int64, -1 ineligible."""
    pid, _cid, prev_rep, pp, avail_cal, feas, _ev = S._row_inputs(
        db, r0, r1, est)
    C = db.C
    nr = db.name_rank[None, :].expand(r1 - r0, C)
    uid = db.uid_desc[r0:r1][:, None]
    rank_eff = torch.where(uid, C - 1 - nr, nr)
    avail_sel = avail_cal + prev_rep * pp
    static = db.pl_strategy[pid].long() == 1
    wg = torch.where(static[:, None], db.pl_static_w[pid], avail_sel)
    cap, mask = (1 << 34) - 1, (1 << 21) - 1
    wq = torch.clamp(wg, 0, cap) << 21
    aq = torch.clamp(avail_sel, 0, cap) << 21
    neg = torch.full((), -1, dtype=torch.int64, device=db.device)
    keys = [torch.where(pp, mask - nr, neg),
            torch.where(feas, wq | (mask - rank_eff), neg),
            torch.where(feas, wq | (mask - nr), neg),
            torch.where(feas, aq | (mask - nr), neg)]
    if use_extra:
        has_prev = pp.any(1, keepdim=True)
        score = torch.where(has_prev & pp, 100, 0) + db.pl_extra_score[pid]
        keys.append(torch.where(
            feas, (torch.clamp(score, 0, 255) << 55) | aq | (mask - nr), neg))
    return torch.stack(keys)


def select_passes(keys, k, share=256):
    """The histogram passes K2's select (schedule_rows.cu select_lanes)
    makes on one group's keys (numpy int64, -1 ineligible) to find its
    k-th largest: 0 when the eligible keys number at most k or their
    boundary bucket is already within `share`."""
    ks = keys[keys >= 0].astype(np.uint64)
    if ks.size <= k:
        return 0
    kor = np.bitwise_or.reduce(ks)
    kand = np.bitwise_and.reduce(ks)
    sh = int(kor ^ kand).bit_length()
    if ks.size <= share or sh == 0:
        return 0
    rem, n = k, 0
    while True:
        n += 1
        lo = max(sh - 8, 0)
        dig = ((ks >> np.uint64(lo)) & np.uint64((1 << (sh - lo)) - 1)
               ).astype(np.int64)
        cnt = np.bincount(dig, minlength=256)
        above = 0
        for d in range(255, -1, -1):
            if above + cnt[d] >= rem:
                break
            above += cnt[d]
        rem -= above
        ks = ks[dig == d]
        sh = lo
        if ks.size <= share or lo == 0:
            return n


def union_size(keys, ks):
    """The gathered lane count of one row: the union over its groups
    (keys [groups, C], -1 ineligible) of each group's k largest keys, a
    group short of k filled with its lowest-index -1 lanes."""
    members = np.zeros(keys.shape[1], bool)
    for g, k in zip(keys, ks):
        elig = g >= 0
        n = int(elig.sum())
        if n > k:
            members |= g >= np.sort(g[elig])[-k]
        else:
            members |= elig
            members[np.flatnonzero(~elig)[:k - n]] = True
    return int(members.sum())


def big_census(S, db, r0, r1, est, use_extra) -> dict:
    """What one K2-big launch on rows [r0, r1) of db gets, on est: the
    valid rows' strategy and has_sc and, on the gather path (C >
    DIRECT_MAX), each gather group's eligible lanes, the select's
    histogram passes (select_passes) and the union's size U."""
    g_prev, g_topk, direct_max = S.TIERS["big"]
    valid = db.b_valid[r0:r1].cpu().numpy()
    pid = db.placement_id[r0:r1].long()
    out = dict(rows=r1 - r0, valid=int(valid.sum()), C=db.C,
               direct=db.C <= direct_max,
               strat=db.pl_strategy[pid].cpu().numpy()[valid].tolist(),
               has_sc=db.pl_has_cluster_sc[pid].cpu().numpy()[valid]
               .tolist(), elig=[], passes=[], U=[])
    if out["direct"]:
        return out
    ks = (g_prev,) + (g_topk,) * 4
    keys = gather_keys(S, db, r0, r1, est, use_extra).cpu().numpy()
    for i in np.flatnonzero(valid):
        row = keys[:, i]
        out["elig"].append([int((g >= 0).sum()) for g in row])
        out["passes"].append([select_passes(g, k) for g, k in zip(row, ks)])
        out["U"].append(union_size(row, ks))
    return out


def big_census_lines(label, calls) -> list:
    """big_census over launches `calls`, as log lines."""
    if not calls:
        return [f"K2-big census, {label}: no launch"]
    rows = np.array([c["valid"] for c in calls])
    strat = np.concatenate([c["strat"] for c in calls]).astype(int)
    sc = np.concatenate([c["has_sc"] for c in calls]).astype(bool)
    out = [f"K2-big census, {label}: {len(calls)} launches; rows a launch "
           f"{sorted({c['rows'] for c in calls})} (valid p50 "
           f"{np.percentile(rows, 50):.0f} max {rows.max()}); C "
           f"{sorted({c['C'] for c in calls})}; gather path in "
           f"{sum(not c['direct'] for c in calls)}; {strat.size} valid "
           f"rows, strategy (0 Duplicated, 1 Static, 2 Dynamic, 3 "
           f"Aggregated) {np.bincount(strat, minlength=4).tolist()}, "
           f"has_sc {int(sc.sum())}"]
    el = [e for c in calls for e in c["elig"]]
    if el:
        ng = max(len(e) for e in el)
        el = np.array([e + [0] * (ng - len(e)) for e in el])
        ps = np.array([p + [0] * (ng - len(p))
                       for c in calls for p in c["passes"]])
        U = np.concatenate([c["U"] for c in calls])
        for g, k in enumerate((128, 1024, 1024, 1024, 1024)[:ng]):
            e = el[:, g]
            out.append(f"K2-big census, {label}, group {g} (k {k}): eligible "
                       f"p50 {np.percentile(e, 50):.0f} min {e.min()} max "
                       f"{e.max()}; select (> k) {int((e > k).sum())}, fill "
                       f"(< k) {int((e < k).sum())} of {e.size} rows; rows "
                       f"by histogram passes "
                       f"{np.bincount(ps[:, g]).tolist()}")
        out.append(f"K2-big census, {label}: U p50 "
                   f"{np.percentile(U, 50):.0f} max {int(U.max())}")
    return out


def big_subbatch(wide, fleet):
    """The ROUTE_DEVICE_BIG rows of the bindings `wide` as solve_big
    encodes them: (their SolverBatch, the row count)."""
    from karmada_tpu_torch.estimator.general import GeneralEstimator
    from karmada_tpu_torch.ops import tensors as T

    cindex = T.ClusterIndex.build(fleet)
    wb = T.encode_batch(wide, cindex, GeneralEstimator())
    big_idx = [i for i in range(len(wide))
               if wb.route[i] == T.ROUTE_DEVICE_BIG]
    sub = T.encode_batch([wide[i] for i in big_idx], cindex,
                         GeneralEstimator())
    sub.b_valid[:len(big_idx)] = sub.route == T.ROUTE_DEVICE_BIG
    return sub, len(big_idx)


def phase_kernels(batch, items, wide_items, fleet, args, dev,
                  reps: int, parent=None) -> list:
    """Each kernel vs its plain version on the same card inputs."""
    from karmada_tpu_torch.ops import solver as S
    from karmada_tpu_torch.ops import spread as SP
    from karmada_tpu_torch.ops import tensors as T

    waves = args.waves
    db = S.device_batch(batch, dev)
    B, C = db.B, db.C
    Q, R = db.req_milli.shape
    use_extra = S._use_extra(batch)
    zeros = S._zeros_used(db)
    rows = []

    # K1 capacity
    cap_in = (db.req_milli, db.req_is_cpu, db.req_pods, db.avail_milli,
              zeros[0], db.has_alloc, db.pods_allowed, zeros[1],
              db.has_summary, db.est_override, zeros[2])
    est_k = S.capacity(*cap_in)
    est_p = S.capacity_plain(*cap_in)
    err1 = max_abs_err([(est_k, est_p)])
    b1 = bound_ms(nbytes(*cap_in) + nbytes(est_k), est_k.numel() * R)
    rows.append(dict(
        name="capacity", route="cuda",
        source="karmada_tpu_torch/ops/csrc/capacity.cu",
        replaces="karmada_tpu/ops/solver.py:287",
        max_abs_err=err1, ms=cuda_ms(lambda: S.capacity(*cap_in), reps),
        plain_ms=cuda_ms(lambda: S.capacity_plain(*cap_in), reps),
        bound_ms=b1[0], bound_by=b1[1], library_ms=None))
    host, device = split_ms(lambda: S.capacity(*cap_in), 10 * reps)
    log(f"phase 2 capacity split (alone, [{Q + 1}, {C}]): host enqueue "
        f"{host:.4f} ms, device "
        + (f"{device:.4f} ms" if device is not None else "not measured"))

    # K2 schedule_rows (+ K4 inside), the whole chunk wave by wave
    err2, k2_ms, k2_plain, b2, webs, (rep_k, sel_k, st_k, _) = hold_rows(
        db, waves, use_extra, "std", dev, reps)
    web = webs[0]
    rows.append(dict(
        name="schedule_rows", route="cuda",
        source="karmada_tpu_torch/ops/csrc/schedule_rows.cu",
        replaces="karmada_tpu/ops/solver.py:602",
        max_abs_err=err2, ms=k2_ms, plain_ms=k2_plain,
        bound_ms=b2[0], bound_by=b2[1], library_ms=None))

    # K2 on the big tier: the first wide chunk's ROUTE_DEVICE_BIG rows as
    # solve_big encodes them
    sub, n_big = big_subbatch(wide_items[:args.chunk], fleet)
    dbig = S.device_batch(sub, dev)
    err_b, kb_ms, kb_plain, bb, webs_big, _ = hold_rows(
        dbig, waves, S._use_extra(sub), "big", dev, reps)
    web_big = webs_big[0]
    for tier, probs in (("std, the chunk's 8 waves", webs),
                        ("big, the wide chunk's big rows", webs_big)):
        log(k4_census_line(tier, webster_census(probs)))
    # its K4 problems (5,248 lanes per row) against webster_plain too
    sb_k = S.webster_batch(*web_big)
    err_b = max(err_b, max_abs_err([(sb_k, S.webster_plain(*web_big))]))
    wb_ms = cuda_ms(lambda: S.webster_batch(*web_big), reps)
    log(f"phase 2 webster_batch on the big tier: {tuple(web_big[1].shape)} "
        f"ms={wb_ms:.4f} (inside schedule_rows_big)")
    for tier, wv in (("std", web), ("big", web_big)):
        host, device = split_ms(lambda wv=wv: S.webster_batch(*wv), 10 * reps)
        log(f"phase 2 webster_batch split ({tier}, wave 0 "
            f"{tuple(wv[1].shape)}): host enqueue {host:.4f} ms, device "
            + (f"{device:.4f} ms" if device is not None else "not measured"))
    if parent is not None:
        phase_turns_k4(parent, web, web_big, reps)
    rows.append(dict(
        name="schedule_rows_big", route="cuda",
        source="karmada_tpu_torch/ops/csrc/schedule_rows.cu",
        replaces="karmada_tpu/ops/solver.py:553",
        max_abs_err=err_b, ms=kb_ms, plain_ms=kb_plain,
        bound_ms=bb[0], bound_by=bb[1], library_ms=None))
    log(f"phase 2 big sub-batch: {n_big} rows -> {dbig.B}x{dbig.C}")
    # what the main path hands K2-big there, on the chunk's starting est
    z = S._zeros_used(dbig)
    est_big = S.capacity(dbig.req_milli, dbig.req_is_cpu, dbig.req_pods,
                         dbig.avail_milli, z[0], dbig.has_alloc,
                         dbig.pods_allowed, z[1], dbig.has_summary,
                         dbig.est_override, z[2])
    Bwb = dbig.B // S._effective_waves(dbig.B, waves)
    for ln in big_census_lines(
            "phase 2, the first wide chunk's big rows (the chunk's "
            "starting est)",
            [big_census(S, dbig, r0, r0 + Bwb, est_big, S._use_extra(sub))
             for r0 in range(0, dbig.B, Bwb)]):
        log(ln)
    if parent is not None:
        phase_turns_big(parent, sub, dev, reps)

    # K3 compact on the chunk's dense result
    nw = db.non_workload
    c_k = S.compact(rep_k, sel_k, st_k, nw, False)
    c_p = S.compact_plain(rep_k, sel_k, st_k, nw, False)
    nnz = int(c_k[3])
    if nnz != int(c_p[3]):
        raise AssertionError(f"compact nnz {nnz} != plain {int(c_p[3])}")
    err3 = max_abs_err([(c_k[0][:nnz], c_p[0]), (c_k[1][:nnz], c_p[1]),
                        (c_k[2], c_p[2])])
    flat = rep_k.reshape(-1)

    def library():
        # the same function as K3: the mask from rep, sel and nw, then
        # torch.nonzero and a gather
        mask = ((sel_k & nw[:, None]) | (rep_k > 0)).reshape(-1)
        i = torch.nonzero(mask).reshape(-1)
        return i, flat[i]

    b3 = bound_ms(nbytes(rep_k, sel_k, nw) + nnz * 8 + 8, B * C)
    rows.append(dict(
        name="compact", route="cuda",
        source="karmada_tpu_torch/ops/csrc/compact.cu",
        replaces="karmada_tpu/ops/solver.py:959",
        max_abs_err=err3,
        ms=cuda_ms(lambda: S.compact(rep_k, sel_k, st_k, nw, False), reps),
        plain_ms=cuda_ms(lambda: S.compact_plain(rep_k, sel_k, st_k, nw,
                                                 False), reps),
        bound_ms=b3[0], bound_by=b3[1],
        library_ms=cuda_ms(library, reps)))
    if parent is not None:
        phase_turns_rows(parent, batch, rep_k, sel_k, st_k, dev, reps)

    # K4 webster_batch on the Webster problems K2 handed it in wave 0
    s_k = S.webster_batch(*web)
    s_p = S.webster_plain(*web)
    err4 = max_abs_err([(s_k, s_p)])
    # the function's need: n, w, s0 and active read once, seats written
    # once, rank read only on the tie blocks' candidate lanes
    tie_lanes = int(webster_census([web])["tie_lanes"].sum())
    b4 = bound_ms(nbytes(*web[:4]) + nbytes(s_k)
                  + tie_lanes * web[4].element_size(), web[1].numel())
    log(f"phase 2 webster_batch bound: {tie_lanes} tie-block lanes of "
        f"{web[1].numel()} read rank")
    # the chunk's bound: its waves' K1 + K2 + K4 bounds (every wave's K1
    # and K2 need the same bytes as wave 0's) and K3's
    k4_bounds = []
    for wv in webs:
        tl = int(webster_census([wv])["tie_lanes"].sum())
        k4_bounds.append(bound_ms(nbytes(*wv[:4]) + nbytes(wv[1])
                                  + tl * wv[4].element_size(),
                                  wv[1].numel())[0])
    chunk_bound = len(webs) * (b1[0] + b2[0]) + sum(k4_bounds) + b3[0]
    log(f"phase 2 chunk bound: {chunk_bound:.6f} ms ({len(webs)} waves x "
        f"(K1 {b1[0]:.6f} + K2 {b2[0]:.6f}) + K4 {sum(k4_bounds):.6f} + "
        f"K3 {b3[0]:.6f})")
    rows.append(dict(
        name="webster_batch", route="cuda",
        source="karmada_tpu_torch/ops/csrc/webster_batch.cu",
        replaces="karmada_tpu/ops/solver.py:100",
        max_abs_err=err4, ms=cuda_ms(lambda: S.webster_batch(*web), reps),
        plain_ms=cuda_ms(lambda: S.webster_plain(*web), 2),
        bound_ms=b4[0], bound_by=b4[1], library_ms=None))

    # K5 / K6 on the first chunk's region-spread sub-batch, with the
    # operands solve_spread handed them
    part = items[:args.chunk]
    groups = T.spread_groups(batch, part)
    cap = {}
    SP.solve_spread(batch, part, groups[("", "std")], waves=waves,
                    device=dev, capture=cap)
    gi, pk = cap["group_info"], cap["pick"]
    census = spread_census(gi, pk)
    # use_extra as solve_spread passed it
    ux = dict(use_extra=use_extra)
    got = SP.spread_group_info(*gi, **ux)
    err5 = max_abs_err(zip(got, SP.spread_group_info_plain(*gi)))
    db5, G5 = gi[0], gi[6]
    # the function's need (spread_need_bytes; row scalars 38 B, outputs
    # 3 x 8 B a group and feas_any) and its work: a key a lane and the
    # walk's steps; beside it the figure of a full comparison sort of every
    # lane over every operand byte, which the parent's design was held to
    b5 = bound_ms(spread_need_bytes(db5, gi[1], use_extra,
                                    38 + 24 * G5 + 1),
                  db5.B * C + census["walk_steps"])
    b5_sort = bound_ms(
        nbytes(gi[1], gi[2], db5.cluster_valid, db5.deleting, db5.name_rank,
               db5.api_ok, db5.pl_mask, db5.pl_tol_bypass,
               db5.pl_extra_score, *gi[3:6], *got)
        + sum(nbytes(db5.t[f]) for f in S._BINDING_FIELDS),
        sort_ops(db5.B, C))
    rows.append(dict(
        name="spread_group_info", route="cuda",
        source="karmada_tpu_torch/ops/csrc/spread_group_info.cu",
        replaces="karmada_tpu/ops/spread.py:222",
        max_abs_err=err5,
        ms=cuda_ms(lambda: SP.spread_group_info(*gi, **ux), reps),
        plain_ms=cuda_ms(lambda: SP.spread_group_info_plain(*gi), 2),
        bound_ms=b5[0], bound_by=b5[1], library_ms=None))
    pick = SP.spread_pick(*pk, **ux)
    err6 = max_abs_err([(pick, SP.spread_pick_plain(*pk))])
    db6 = pk[0]
    # its need: row scalars 21 B, chosen G B, cluster_max 8 B and the pick
    # row C B; its work: a key a lane and the lanes selected
    b6 = bound_ms(spread_need_bytes(db6, pk[1], use_extra,
                                    21 + G5 + 8 + C),
                  db6.B * C + census["pick_steps"])
    b6_sort = bound_ms(
        nbytes(pk[1], pk[2], pk[3], pk[4], db6.cluster_valid, db6.deleting,
               db6.name_rank, db6.api_ok, db6.pl_mask, db6.pl_tol_bypass,
               db6.pl_extra_score, pick)
        + sum(nbytes(db6.t[f]) for f in S._BINDING_FIELDS),
        sort_ops(db6.B, C))
    rows.append(dict(
        name="spread_pick", route="cuda",
        source="karmada_tpu_torch/ops/csrc/spread_pick.cu",
        replaces="karmada_tpu/ops/spread.py:251",
        max_abs_err=err6, ms=cuda_ms(lambda: SP.spread_pick(*pk, **ux), reps),
        plain_ms=cuda_ms(lambda: SP.spread_pick_plain(*pk), 2),
        bound_ms=b6[0], bound_by=b6[1], library_ms=None))
    for name, b, old in (("spread_group_info", b5, b5_sort),
                         ("spread_pick", b6, b6_sort)):
        log(f"phase 2 {name} bound: {b[0]:.6f} ms ({b[1]}; the function's "
            f"need); a full sort of every lane over every operand byte: "
            f"{old[0]:.6f} ms ({old[1]})")
    for name, fn in (("spread_group_info",
                      lambda: SP.spread_group_info(*gi, **ux)),
                     ("spread_pick", lambda: SP.spread_pick(*pk, **ux))):
        host, device = split_ms(fn, 10 * reps)
        log(f"phase 2 {name} split: host enqueue {host:.4f} ms, device "
            + (f"{device:.4f} ms" if device is not None else "not measured"))
    if parent is not None:
        phase_turns_spread(parent, gi, pk, use_extra, reps)
    log(f"phase 2 spread sub-batch: {len(groups[('', 'std')])} rows -> "
        f"phase A {db5.B}x{C} G={gi[6]}, phase B {db6.B}x{C}, "
        f"{int(pick.sum())} lanes picked")
    log(spread_census_line("phase 2, the first forward chunk", census))

    # the whole chunk's dispatch (upload, 8 waves of K1 + K2/K4, then K3)
    # between two events on the stream: host launch gaps included
    chunk_ms = cuda_ms(lambda: S.dispatch_compact(
        batch, waves=waves, with_used=True, device=dev), reps)
    log(f"phase 2 chunk: {B}x{C} dispatch_compact stream time "
        f"{chunk_ms:.4f} ms (CUDA events, mean of {reps})")
    if parent is not None:
        phase_turns_dispatch(parent, batch, dev, reps)
    # the carry chain's vocabulary remap (not a kernel: index_select and
    # where) on the chunk's accumulators, into the same vocabulary; its
    # need is one read and one write of avail and est accumulators
    from karmada_tpu_torch.scheduler.pipeline import _CarryChain

    g = torch.Generator(device=dev).manual_seed(3)
    used = tuple(torch.randint(0, 1 << 20, u.shape, generator=g, device=dev)
                 for u in zeros)
    got = _CarryChain._device_remap(used, batch, batch)
    # the vocabulary's own columns and classes kept, its padding zeroed
    nr, nq = len(batch.res_names), len(batch.class_keys)
    want = (torch.cat([used[0][:, :nr], torch.zeros_like(used[0][:, nr:])], 1),
            used[1],
            torch.cat([used[2][:nq], torch.zeros_like(used[2][nq:])], 0))
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("the identity remap changed the accumulators")
    remap_ms = cuda_ms(lambda: _CarryChain._device_remap(used, batch, batch),
                       reps)
    host, device = split_ms(
        lambda: _CarryChain._device_remap(used, batch, batch), 10 * reps,
        whole=True)
    br = bound_ms(2 * nbytes(used[0], used[2]),
                  used[0].numel() + used[2].numel())
    log(f"phase 2 _CarryChain._device_remap: avail {tuple(used[0].shape)} "
        f"est {tuple(used[2].shape)}: {remap_ms:.4f} ms (CUDA events, index "
        f"uploads included); host {host:.4f} ms, device "
        + (f"{device:.4f} ms" if device is not None else "not measured")
        + f"; bound {br[0]:.6f} ms ({br[1]})")
    for r in rows:
        log(f"phase 2 {r['name']}: max_abs_err={r['max_abs_err']} "
            f"ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
            f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
            f"library_ms={r['library_ms']}")
        if r["max_abs_err"] != 0:
            raise AssertionError(f"{r['name']} disagrees with its plain "
                                 "version")
    return rows, chunk_ms


def explain_operands(part, fleet, dev, waves):
    """K7's operands at the main path's shapes, from this tree's modules:
    (the chunk's batch, wave 0's call -- (db, 0, Bw, est, fail_bits, sel,
    status), est wave 0's capacity, sel and status K2's wave 0 -- and the
    spread flavour's call on the chunk's region-spread phase B as
    solve_spread captures it: (rows, 0, Bs, est, fail_bits, sel, status,
    pick))."""
    from karmada_tpu_torch.estimator.general import GeneralEstimator
    from karmada_tpu_torch.ops import solver as S
    from karmada_tpu_torch.ops import spread as SP
    from karmada_tpu_torch.ops import tensors as T

    batch = T.encode_batch(part, T.ClusterIndex.build(fleet),
                           GeneralEstimator(), cache=T.EncoderCache(),
                           explain=True)
    db = S.device_batch(batch, dev, explain=True)
    B, C = db.B, db.C
    Bw = B // S._effective_waves(B, waves)
    zeros = S._zeros_used(db)
    est0 = S.capacity(db.req_milli, db.req_is_cpu, db.req_pods,
                      db.avail_milli, zeros[0], db.has_alloc,
                      db.pods_allowed, zeros[1], db.has_summary,
                      db.est_override, zeros[2])
    rep = torch.empty((B, C), dtype=torch.int64, device=dev)
    sel = torch.zeros((B, C), dtype=torch.bool, device=dev)
    st = torch.zeros((B,), dtype=torch.int32, device=dev)
    S.schedule_rows(db, 0, Bw, est0, *(u.clone() for u in zeros), rep, sel,
                    st, use_extra=S._use_extra(batch), charge=True)
    groups = T.spread_groups(batch, part)
    cap = {}
    SP.solve_spread(batch, part, groups[("", "std")], waves=waves,
                    device=dev, capture=cap, explain=True)
    return batch, (db, 0, Bw, est0, db.pl_fail_bits, sel, st), \
        cap["explain"]


def phase_kernels_k7_k9(items, fleet, mega, args, dev, reps,
                        parent=None) -> list:
    """K7 explain_rows, K8 shortlist_topk and K9 group_sums against their
    plain versions at the main path's shapes: K7 on the first forward
    chunk's wave 0 (its est and K2 outputs) and on that chunk's spread
    phase B (solve_spread's operands); K8 on the first megafleet chunk's
    profile rows (16,384 lanes) and on the same rows over 32,768 and
    2,097,152 lanes (the pair scratch); K9 on the 10k fleet.  With
    `parent`, the tier-1 turns (phase_turns_tier1)."""
    from karmada_tpu_torch.estimator.general import GeneralEstimator
    from karmada_tpu_torch.ops import kernels
    from karmada_tpu_torch.ops import shortlist as SL
    from karmada_tpu_torch.ops import solver as S
    from karmada_tpu_torch.ops import tensors as T

    rows = []
    # -- K7 on the first forward chunk, wave 0 --------------------------------
    part = items[:args.chunk]
    batch, k7_in, ex = explain_operands(part, fleet, dev, args.waves)
    db, _r0, Bw, est0 = k7_in[:4]
    B, C = db.B, db.C
    out_k = S.explain_planes(B, C, dev)
    out_p = S.explain_planes(B, C, dev)
    S.explain_rows(*k7_in, out_k)
    S.explain_rows_plain(*k7_in, out_p)
    err7 = max_abs_err(zip(out_k, out_p))
    # as schedule_core calls it: on the chunk's workspace, with the
    # batch's use_extra (False: the extra-score rows are all 0, not read)
    ux = S._use_extra(batch)
    ws7 = S.ExplainWorkspace(db, *k7_in[3:7], out_k, use_extra=ux)

    def k7():
        S.explain_rows(*k7_in, out_k, use_extra=ux, workspace=ws7)

    k7()
    err7 = max(err7, max_abs_err(zip(out_k, out_p)))
    b7 = bound_ms(
        3 * Bw * C * 4 + Bw * 4 + Bw * C
        + nbytes(est0, db.pl_mask, db.pl_tol_bypass, db.pl_fail_bits,
                 db.api_ok, db.cluster_valid, db.deleting)
        + (nbytes(db.pl_extra_score) if ux else 0)
        + sum(nbytes(db.t[f][:Bw]) for f in S._BINDING_FIELDS),
        20 * Bw * C)
    ms7 = cuda_ms(k7, reps)
    plain7 = cuda_ms(lambda: S.explain_rows_plain(*k7_in, out_p), 2)
    # its spread flavour on the chunk's region-spread phase B, as
    # solve_spread calls it
    sp_k = S.explain_planes(ex[0].B, C, dev)
    sp_p = S.explain_planes(ex[0].B, C, dev)

    def k7s():
        S.explain_rows(*ex[:7], sp_k, pick=ex[7], use_extra=ux)

    k7s()
    S.explain_rows_plain(*ex[:7], sp_p, pick=ex[7])
    err7s = max_abs_err(zip(sp_k, sp_p))
    ms7s = cuda_ms(k7s, reps)
    for label, fn, ms in (("wave 0", k7, ms7), ("spread flavour", k7s,
                                                 ms7s)):
        host, device = split_ms(fn, 10 * reps)
        log(f"phase 2 explain_rows split, {label}: CUDA events {ms:.4f} "
            f"ms, host enqueue {host:.4f} ms, device "
            + (f"{device:.4f} ms" if device is not None else "not measured"))
    log(f"phase 2 explain_rows spread flavour: {ex[0].B}x{C} "
        f"max_abs_err={err7s} ms={ms7s:.4f}")
    rows.append(dict(
        name="explain_rows", route="cuda",
        source="karmada_tpu_torch/ops/csrc/explain.cu",
        replaces="karmada_tpu/ops/solver.py:229",
        max_abs_err=max(err7, err7s), ms=ms7, plain_ms=plain7,
        bound_ms=b7[0], bound_by=b7[1], library_ms=None))
    if parent is not None:
        phase_turns_explain(parent, k7_in, ex, ux, dev, reps)
    log(f"phase 2 explain_rows: wave 0 of the forward chunk, {Bw}x{C}")

    # -- K8 on the first megafleet chunk's profile rows -------------------------
    mfleet, mitems = mega
    mbatch = T.encode_batch(mitems[:args.chunk], T.ClusterIndex.build(mfleet),
                            GeneralEstimator(), cache=T.EncoderCache())
    prof_keys, _prof_of, rep_max = SL._profiles(mbatch)
    agg = SL.cycle_aggregates(mbatch, dev)
    pdb = SL.profile_batch(mbatch, prof_keys, rep_max, dev)
    pref = torch.from_numpy(agg["group_pref"]).to(dev)

    def k8(db=pdb, p=pref):
        return SL.shortlist_topk(db, p, MEGA_K)

    got8 = k8()
    err8 = max_abs_err(zip(got8, SL.shortlist_topk_plain(pdb, pref,
                                                         MEGA_K)))
    Cm = pdb.C
    nprof = prof_keys.shape[0]
    # the function's need: the cluster planes and the snapshot's [C] and
    # [C, R] planes, the placement, GVK and override rows the profile rows
    # name, group_pref and the row scalars read once; cand and fcount
    # written once; a key a lane
    pid, gvk, cid = (np.unique(prof_keys[:, i]) for i in range(3))
    b8 = bound_ms(
        nbytes(pref, pdb.cluster_valid, pdb.deleting, pdb.name_rank,
               pdb.pods_allowed, pdb.has_summary, pdb.avail_milli,
               pdb.has_alloc, pdb.req_milli, pdb.req_is_cpu, pdb.req_pods,
               *got8)
        + 2 * Cm * pid.size + Cm * gvk.size + 8 * Cm * int((cid >= 0).sum())
        + sum(nbytes(pdb.t[f]) for f in S._BINDING_FIELDS if f in pdb.t),
        pdb.B * Cm)
    ms8 = cuda_ms(k8, reps)
    plain8 = cuda_ms(lambda: SL.shortlist_topk_plain(pdb, pref, MEGA_K), 2)
    # the select alone as one library call: torch.topk over the ready key
    # plane and the where to -1 (eligible keys are distinct: exact)
    keys = SL.topk_keys_plain(pdb, pref)

    def library():
        v, i = torch.topk(keys, MEGA_K, dim=1)
        return torch.where(v >= 0, i, -1).to(torch.int32)

    if not torch.equal(library(), got8[0]):
        raise AssertionError("torch.topk over the key plane disagrees with "
                             "K8")
    lib8 = cuda_ms(library, reps)
    h8, _d8 = split_ms(k8, 10 * reps)
    by8 = kernel_device_ms(k8, 10 * reps)
    log(f"phase 2 shortlist_topk split: host enqueue {h8:.4f} ms, device "
        + by_text(by8) + f" (one call, {pdb.B}x{Cm}, k={MEGA_K})")
    # the same rows over twice the lanes (the wide shape) and over 128
    # times them (rows wider than shared memory: the pair scratch)
    for times in (2, 128):
        wdb = tile_lanes(S, pdb, times)
        wpref = torch.cat([pref] * times)
        wk = SL.shortlist_topk(wdb, wpref, MEGA_K)
        err8 = max(err8, max_abs_err(zip(wk, SL.shortlist_topk_plain(
            wdb, wpref, MEGA_K))))
        wms = cuda_ms(lambda: SL.shortlist_topk(wdb, wpref, MEGA_K), reps)
        log(f"phase 2 shortlist_topk {wdb.B}x{wdb.C} ("
            + ("shared memory" if wdb.C <= kernels.TOPK_SMEM_LANES
               else "device-memory pair scratch")
            + f"): max_abs_err={err8} ms={wms:.4f}")
        del wdb, wpref, wk
    rows.append(dict(
        name="shortlist_topk", route="cuda",
        source="karmada_tpu_torch/ops/csrc/shortlist.cu",
        replaces="karmada_tpu/ops/shortlist.py:174",
        max_abs_err=err8, ms=ms8, plain_ms=plain8,
        bound_ms=b8[0], bound_by=b8[1], library_ms=lib8))
    log(f"phase 2 shortlist_topk: {nprof} profiles -> {pdb.B}x{Cm}, "
        f"k={MEGA_K}; fcount {got8[1][:nprof]}; library_ms is torch.topk "
        "over the ready key plane and the where to -1 (the select alone)"
        .replace("\n", " "))
    if parent is not None:
        phase_turns_tier1(parent, mbatch, prof_keys, rep_max, dev, reps)

    # -- K9 on the 10k fleet ------------------------------------------------------
    G = agg["n_groups"]
    gid = torch.from_numpy(np.array(mbatch.region_id, np.int32)).to(dev)
    capx = torch.from_numpy(agg["cap_proxy"]).to(dev)
    g_k = SL.group_sums(gid, capx, G)
    err9 = max_abs_err([(g_k, SL.group_sums_plain(gid, capx, G))])
    gid_eff = torch.where(gid >= 0, gid.long(), G)
    b9 = bound_ms(nbytes(gid, capx, g_k), gid.numel())
    # the tiled branch: more groups than one shared-memory tile of bins
    Gt = kernels.GROUP_SUM_TILE_BINS + 1000
    gidt = torch.from_numpy(np.random.default_rng(9).integers(
        -2, Gt + 2, gid.numel()).astype(np.int32)).to(dev)
    errt = max_abs_err([(SL.group_sums(gidt, capx, Gt),
                         SL.group_sums_plain(gidt, capx, Gt))])
    gidt_eff = torch.where(gidt >= 0, gidt.long(), Gt)

    def library_tiled():
        # ids beyond the last bin land in two spare bins, cut off
        return torch.zeros(Gt + 3, dtype=torch.int64, device=dev).index_add_(
            0, gidt_eff, capx)[:Gt + 1]

    tiles = -(-(Gt + 1) // kernels.GROUP_SUM_TILE_BINS)
    log(f"phase 2 group_sums tiled branch: G={Gt} ({tiles} tiles of "
        f"{kernels.GROUP_SUM_TILE_BINS} bins), {gid.numel()} lanes, "
        f"max_abs_err={errt} ms="
        f"{cuda_ms(lambda: SL.group_sums(gidt, capx, Gt), reps):.4f}, split "
        f"{split_ms(lambda: SL.group_sums(gidt, capx, Gt), 10 * reps)}, "
        f"library_ms={cuda_ms(library_tiled, reps):.4f} (torch.zeros + "
        "index_add_)")
    err9 = max(err9, errt)
    h9, d9 = split_ms(lambda: SL.group_sums(gid, capx, G), 10 * reps)
    log(f"phase 2 group_sums split: host {h9:.4f} ms, device {d9} ms per "
        f"call (G={G}, {gid.numel()} lanes)")
    rows.append(dict(
        name="group_sums", route="cuda",
        source="karmada_tpu_torch/ops/csrc/shortlist.cu",
        replaces="karmada_tpu/ops/shortlist.py:259",
        max_abs_err=err9, ms=cuda_ms(lambda: SL.group_sums(gid, capx, G),
                                     reps),
        plain_ms=cuda_ms(lambda: SL.group_sums_plain(gid, capx, G), reps),
        bound_ms=b9[0], bound_by=b9[1],
        library_ms=cuda_ms(lambda: torch.zeros(
            G + 1, dtype=torch.int64, device=dev).index_add_(0, gid_eff,
                                                             capx), reps)))
    for r in rows:
        log(f"phase 2 {r['name']}: max_abs_err={r['max_abs_err']} "
            f"ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
            f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
            f"library_ms={r['library_ms']}")
        if r["max_abs_err"] != 0:
            raise AssertionError(f"{r['name']} disagrees with its plain "
                                 "version")
    return rows


def check_results(items, results, names) -> dict:
    """Result classes per cycle, and the invariants every result must meet:
    targets on known clusters with positive (Divided: summing to the
    binding's replicas; Duplicated: equal to them) replica counts."""
    from karmada_tpu_torch.ops import serial

    known = set(names)
    counts: dict = {}
    for (spec, _st), r in zip(items, results):
        if r is None:
            raise AssertionError("a binding got no result")
        if isinstance(r, Exception):
            k = type(r).__name__
            counts[k] = counts.get(k, 0) + 1
            continue
        counts["ok"] = counts.get("ok", 0) + 1
        if not all(t.name in known and t.replicas > 0 for t in r):
            raise AssertionError(f"bad targets {r!r}")
        strat = serial.strategy_type(spec)
        if strat == serial.DUPLICATED:
            if any(t.replicas != spec.replicas for t in r):
                raise AssertionError("Duplicated replicas differ")
        elif sum(t.replicas for t in r) != spec.replicas:
            raise AssertionError(
                f"{strat}: {sum(t.replicas for t in r)} != {spec.replicas}")
    return counts


def phase_cycle(label, items, fleet, names, args, dev, chunk_ms: float,
                need, routes, chunk=None, need_coo=False, **kw):
    """One cycle through schedule_items; `need` names the kernels its path
    must launch, `routes` the routes its rows must take, `need_coo` that
    its decode run decode_coo; `kw` goes to schedule_items (explain=,
    shortlist=).  Returns the launch counts, the pipeline stats, the
    results and the wall seconds."""
    from karmada_tpu_torch import native
    from karmada_tpu_torch.ops import kernels
    from karmada_tpu_torch.scheduler.core import schedule_items
    from karmada_tpu_torch.scheduler.pipeline import PipelineResult

    chunk = chunk or args.chunk
    stats = PipelineResult()
    torch.cuda.synchronize()
    kernels.reset_counts()
    native.reset_counts()
    GC.reset()
    t0 = time.perf_counter()
    results = schedule_items(items, fleet, chunk=chunk, waves=args.waves,
                             device=dev, stats=stats, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    ncounts = dict(native.COUNTS)
    gc_line = GC.line()
    counts = check_results(items, results, names)
    log(f"phase {label}: {len(items)} bindings x {len(fleet)} clusters in "
        f"{wall:.3f} s ({len(items) / wall:.0f} bindings/s); chunks="
        f"{stats.chunks} encode_s={stats.encode_s:.3f} "
        f"shortlist_s={stats.shortlist_s:.3f} "
        f"dispatch_s={stats.dispatch_s:.3f} wait_s={stats.wait_s:.3f} "
        f"finalize_s={stats.finalize_s:.3f}"
        f" decode_s={stats.decode_s:.3f} spread_s={stats.spread_s:.3f} "
        f"big_s={stats.big_s:.3f} explain_s={stats.explain_s:.3f}; "
        f"routes={stats.routes}; results={counts}; "
        f"launches={launches}; main-path busy share (chunks x phase-2 chunk "
        f"time / wall) ~{stats.chunks * chunk_ms / 1e3 / wall:.3f}")
    log(native_line(label.split()[0], ncounts) + f"; {gc_line} in the cycle")
    check_native(label.split()[0], ncounts, need_coo)
    for k in need:
        if launches[k] <= 0:
            raise AssertionError(f"{label}: kernel {k} never launched")
    for r in routes:
        if stats.routes.get(r, 0) <= 0:
            raise AssertionError(f"{label}: no row took route {r}")
    return launches, stats, results, wall


def phase_explain(items, fleet, names, args, dev, chunk_ms, need):
    """Phase 7: the explain cycle.  Every binding gets exactly one
    Decision; main and spread rows full verdict tables, big-tier rows
    outcome-level ones; every unschedulable result with a verdict table
    carries its dominant reason."""
    from collections import Counter

    from karmada_tpu_torch.obs import decisions as D
    from karmada_tpu_torch.ops import tensors as T

    class Recorder(D.DecisionRecorder):
        """The default ring, plus a tally of every record."""

        def __init__(self):
            super().__init__()
            self.tally = []

        def record(self, decision):
            self.tally.append((decision["key"], decision["backend"],
                               decision["clusters_total"],
                               decision["clusters"], decision["reason"]))
            super().record(decision)

    rec = Recorder()
    launches, stats, results, _wall = phase_cycle(
        "7 explain", items, fleet, names, args, dev, chunk_ms, need,
        (T.ROUTE_DEVICE, T.ROUTE_DEVICE_SPREAD, T.ROUTE_DEVICE_BIG),
        chunk=EXPLAIN_CHUNK, explain=rec)
    keys = [D.default_key(spec) for spec, _st in items]
    per_key = Counter(k for k, *_ in rec.tally)
    if len(set(keys)) != len(items) or per_key != Counter(keys):
        raise AssertionError("phase 7: not exactly one decision per binding")
    backends = Counter(b for _k, b, *_ in rec.tally)
    device_rows = sum(stats.routes.get(r, 0) for r in (
        T.ROUTE_DEVICE, T.ROUTE_DEVICE_SPREAD, T.ROUTE_DEVICE_SPREAD_BIG,
        T.ROUTE_DEVICE_BIG))
    if (backends["device"] != stats.routes.get(T.ROUTE_DEVICE, 0)
            or backends["device-spread"] <= 0
            or backends["device-big"] < stats.routes.get(T.ROUTE_DEVICE_BIG, 1)
            or backends["serial"] != len(items) - device_rows):
        raise AssertionError(f"phase 7: decisions by backend {backends} "
                             f"do not match the routes {stats.routes}")
    with_table = set()
    for key, backend, total, rows, _reason in rec.tally:
        if total != len(fleet):
            raise AssertionError(f"phase 7: {key} covers {total} clusters")
        full = bool(rows) and all("score" in r for r in rows)
        if backend in ("device", "device-spread"):
            if not full:
                raise AssertionError(f"phase 7: {key} has no verdict table")
            with_table.add(key)
        elif any("score" in r for r in rows):
            raise AssertionError(f"phase 7: {key} ({backend}) is not "
                                 "outcome-level")
    errs = [(k, r) for k, r in zip(keys, results) if isinstance(r, Exception)]
    missing = [k for k, r in errs
               if k in with_table and not getattr(r, "reason", None)]
    if not any(k in with_table for k, _r in errs):
        raise AssertionError("phase 7: no unschedulable row with a verdict "
                             "table to check a reason on")
    if missing:
        raise AssertionError(f"phase 7: {len(missing)} unschedulable results "
                             f"without a reason, e.g. {missing[:3]}")
    log(f"phase 7 explain: decisions by backend {dict(backends)}; reasons of "
        f"the {len(errs)} unschedulable results "
        f"{dict(Counter(getattr(r, 'reason', None) for _k, r in errs))}; "
        f"decision reasons {dict(Counter(x[4] for x in rec.tally))}; "
        f"ring {rec.stats()}")
    return launches


def phase_megafleet(items, fleet, names, args, dev, chunk_ms, need):
    """Phase 8: the megafleet cycle with the shortlist armed -- every
    chunk shortlisted, no fallback."""
    from karmada_tpu_torch.ops import shortlist as SL
    from karmada_tpu_torch.ops import tensors as T

    launches, stats, _results, _wall = phase_cycle(
        "8 megafleet", items, fleet, names, args, dev, chunk_ms, need,
        (T.ROUTE_DEVICE,), need_coo=True,
        shortlist=SL.ShortlistConfig(k=MEGA_K))
    st = stats.shortlist
    unions = np.asarray(st["unions"])
    log(f"phase 8 megafleet: {st['chunks']} of {stats.chunks} chunks "
        f"shortlisted, fallbacks {st['fallbacks']}, widened {st['widened']}, "
        f"residual rows {st['residual_rows']}; union widths "
        f"min {unions.min()} mean {unions.mean():.1f} max {unions.max()}; "
        f"tier-2 cells {st['cells_solve']} vs dense {st['cells_dense']} "
        f"({st['cells_dense'] / st['cells_solve']:.0f}x fewer)")
    if st["fallbacks"] or st["chunks"] != stats.chunks:
        raise AssertionError(f"phase 8: not every chunk shortlisted: {st}")
    return launches


def phase_incremental(M, fleet, placements, n_bindings, chunk, dev, seed):
    """Phase 9: the incremental steady state at megafleet scale, on the
    legs of bench.py --incremental (its steady-fit fleet: three times the
    pods).  A fused ResidentState (audit off) under the IncrementalSolver
    with the shortlist (k = MEGA_K, every chunk), chunk `chunk`, waves 1:
    adopt -> write-back -> settle -> cluster-status catch-up (every
    cluster's rv bumped) -> STEADY_CYCLES cycles at INCREMENTAL_CHURN
    bindings (replicas +-1, rv bumped) -> a capacity flap (2 clusters,
    pods -16) -> a forced dense audit.  Checks: steady cycles incremental,
    no binding field uploaded in them, the audit "ok".  Returns the
    launch counts of the whole run (counts reset before the adopt), the
    plane, the solver and the roster."""
    from karmada_tpu_torch import native
    from karmada_tpu_torch.estimator.general import GeneralEstimator
    from karmada_tpu_torch.ops import kernels
    from karmada_tpu_torch.ops import resident_gather as RG
    from karmada_tpu_torch.ops import shortlist as SL
    from karmada_tpu_torch.ops import solver as S
    from karmada_tpu_torch.resident import CycleDeltas, ResidentState
    from karmada_tpu_torch.scheduler.incremental import IncrementalSolver

    rng = random.Random(seed)
    for c in fleet:
        q = c.status.resource_summary.allocatable["pods"]
        c.status.resource_summary.allocatable["pods"] = (
            M.Quantity.from_units(int(q.value()) * 3))
    t0 = time.perf_counter()
    bindings = [M.ResourceBinding(
        metadata=M.ObjectMeta(namespace=spec.resource.namespace,
                              name=spec.resource.name, resource_version=1),
        spec=spec, status=status) for spec, status in build_mega_bindings(
            M, rng, n_bindings, placements, chunk)]
    log(f"phase 9 incremental: {n_bindings} bindings x {len(fleet)} "
        f"clusters built in {time.perf_counter() - t0:.1f} s")
    state = ResidentState(audit_interval=0, fused=True, device=dev)
    solver = IncrementalSolver(
        state, GeneralEstimator(), chunk=chunk, audit_every=0,
        shortlist=SL.ShortlistConfig(k=MEGA_K, min_cells=0))
    SL.reset_for_tests()
    torch.cuda.synchronize()
    kernels.reset_counts()
    native.reset_counts()
    fields0 = RG.COUNTS["scatter_fields"]
    steady = []

    def leg(name, run, write_back=True):
        fb0 = sum(SL.FALLBACKS.values())
        h0 = S.TRANSFERS["h2d_binding_fields"]
        n0 = dict(native.COUNTS)
        GC.reset()
        t = time.perf_counter()
        rep = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        h2d = S.TRANSFERS["h2d_binding_fields"] - h0
        t = time.perf_counter()
        wrote = solver.write_back() if write_back else 0
        wb = time.perf_counter() - t
        log(f"phase 9 {name}: {rep.mode} ({rep.reason or 'dirty set'}) "
            f"wall {wall:.3f} s, dirty {rep.dirty} of {rep.total}, groups "
            f"{len(rep.groups)} (of {rep.chunk_groups} chunk groups), "
            f"shortlist fallbacks {sum(SL.FALLBACKS.values()) - fb0}, "
            f"binding fields uploaded {h2d}; write-back {wrote} in "
            f"{wb:.3f} s; audit {rep.audit_outcome}; host seconds by stage "
            f"{ {k: round(v, 3) for k, v in rep.stages.items()} }; dirty "
            f"stage split ms "
            f"{ {k: round(v * 1e3, 3) for k, v in rep.dirty_split.items()} }")
        log(native_line(f"9 {name}", {k: native.COUNTS[k] - n0[k]
                                      for k in n0})
            + f"; {GC.line()} in the leg and its write-back")
        return rep, wall, h2d

    t_all = time.perf_counter()
    leg("adopt", lambda: solver.adopt(fleet, bindings))
    leg("settle", lambda: solver.cycle(fleet, bindings, CycleDeltas()))
    for c in fleet:  # every member reports: the adopt-era ledger retires
        c.metadata.resource_version += 1
    leg("catch-up", lambda: solver.cycle(fleet, bindings, CycleDeltas()))
    live = sum(int(np.count_nonzero(a)) for a in solver.ledger.milli.values())
    log(f"phase 9 catch-up: {live} live ledger lanes")
    for cyc in range(STEADY_CYCLES):
        touched = []
        for pos in rng.sample(range(n_bindings), INCREMENTAL_CHURN):
            rb = bindings[pos]
            rb.spec.replicas = max(1, rb.spec.replicas + rng.choice((-1, 1)))
            rb.metadata.resource_version += 1
            touched.append((rb.namespace, rb.name))
        rep, wall, h2d = leg(f"steady {cyc + 1}", lambda: solver.cycle(
            fleet, bindings, CycleDeltas(bindings_touched=touched)))
        if rep.mode != "incremental" or h2d:
            raise AssertionError(f"phase 9: steady cycle {cyc + 1} ran "
                                 f"{rep.mode} with {h2d} binding fields "
                                 "uploaded")
        steady.append(wall)
    for c in rng.sample(fleet, 2):
        q = c.status.resource_summary.allocatable["pods"]
        c.status.resource_summary.allocatable["pods"] = (
            M.Quantity.from_units(max(8, int(q.value()) - 16)))
        c.metadata.resource_version += 1
    leg("capacity flap", lambda: solver.cycle(fleet, bindings, CycleDeltas()))
    rep, _wall, _h2d = leg("audit", lambda: solver.cycle(
        fleet, bindings, CycleDeltas(), force_audit=True), write_back=False)
    launches = dict(kernels.LAUNCHES)
    log(native_line("9", native.COUNTS))
    check_native("9", native.COUNTS, need_coo=False)
    log(f"phase 9 incremental: steady p50 {np.percentile(steady, 50):.3f} s "
        f"(walls {[round(w, 3) for w in steady]}); whole run "
        f"{time.perf_counter() - t_all:.1f} s; plane {state.stats()['fused']}"
        f", hits {state.hits} misses {state.misses}; launches "
        f"scatter_lanes={launches['scatter_lanes']} (scatter_fields="
        f"{RG.COUNTS['scatter_fields'] - fields0}) gather_rows="
        f"{launches['gather_rows']} dirty_codes={launches['dirty_codes']}; "
        f"all {launches}")
    if rep.audit_outcome != "ok":
        raise AssertionError(f"phase 9: forced audit {rep.audit_outcome}")
    for k in ("scatter_lanes", "gather_rows", "dirty_codes", "capacity",
              "schedule_rows", "webster_batch", "compact", "shortlist_topk",
              "group_sums"):
        if launches[k] <= 0:
            raise AssertionError(f"phase 9: kernel {k} never launched")
    return launches, state, solver, bindings


def sync_items(state, kind, lanes):
    """The scatter entries of one mirror sync of phase 9's plane, as the
    plane's own sync builds them: the twelve slot-store fields at `lanes`
    (kind "slot") or the nine scatterable cluster-side fields at `lanes`
    (kind "cluster"), into fresh device copies of the mirrors, with every
    value changed (so the scatter is visible)."""
    from karmada_tpu_torch.resident import state as RS

    p = state.plane
    if kind == "slot":
        fields = [(f, "rows") for f in RS.DEVICE_SLOT_FIELDS]
        src = state.device_rows.mirrors
    else:
        fields = [(f, "rows" if f in RS.ROW_SCATTER_FIELDS else "cols")
                  for f in RS.CLUSTER_SIDE_FIELDS
                  if f in RS.ROW_SCATTER_FIELDS | RS.COL_SCATTER_FIELDS]
        src = state.device_mirrors.mirrors
    items = []
    for f, mode in fields:
        m = getattr(p, f)
        vals = m[lanes] if mode == "rows" else m[..., lanes]
        vals = ~vals if vals.dtype == np.bool_ else vals + 1
        items.append((src[f].clone(), lanes, np.ascontiguousarray(vals),
                      mode))
    return items


def hold_sync(state, slot_lanes, clus_lanes, dev, reps) -> list:
    """K10's whole mirror syncs on phase 9's plane: all twelve slot-store
    fields at the 1,024 churned slots and the nine cluster-side fields at
    64 churned lanes.  Per sync: the fused launch (values already staged on
    the card) against its plain version, bit for bit, and timed against
    one index_copy_ per field (the library yardstick, lanes and values on
    the card); then the sync wall (host clock to synchronize(), staging
    and the upload included) of the plane's own _DeviceRows.sync /
    _DevicePlane.sync.  Returns the max_abs_err of each sync."""
    from karmada_tpu_torch.ops import kernels
    from karmada_tpu_torch.ops import resident_update as RU

    errs = []
    for kind, lanes in (("slot", slot_lanes), ("cluster", clus_lanes)):
        items = sync_items(state, kind, lanes)
        st = RU.stage_fields(items)
        staged = torch.from_numpy(st.buf).to(dev)
        host = [t.cpu() for t in st.dsts]
        kernels.reset_counts()
        RU.scatter_staged(st.dsts, staged, st.desc)
        torch.cuda.synchronize()
        launched = kernels.LAUNCHES["scatter_lanes"]
        RU.scatter_fields_plain(host, torch.from_numpy(st.buf), st.desc)
        err = max_abs_err(zip(st.dsts, (h.to(dev) for h in host)))
        if launched != 1 or sum(kernels.LAUNCHES.values()) != 1:
            raise AssertionError(f"{kind} sync: {kernels.LAUNCHES}")
        ms = cuda_ms(lambda: RU.scatter_staged(st.dsts, staged, st.desc),
                     reps)
        lib = [(t, 0 if m == "rows" else 1, up_to(la, dev), up_to(v, dev))
               for t, la, v, m in items]
        lib_ms = cuda_ms(lambda: [t.index_copy_(ax, la, v)
                                  for t, ax, la, v in lib], reps)
        # bound: the staged lanes and values read once, as many elements
        # written
        b = bound_ms(st.buf.nbytes + sum(v.nbytes for *_x, v, _m in items),
                     0)
        wall = sync_wall_ms(state, kind, lanes, dev, reps)
        split = split_ms(lambda: RU.scatter_staged(st.dsts, staged, st.desc),
                         10 * reps)
        log(f"phase 2 scatter_lanes {kind} sync split (host, device ms): "
            f"{split}")
        log(f"phase 2 scatter_lanes {kind} sync: {len(items)} fields, "
            f"{len(lanes)} lanes, staged {st.buf.nbytes} B in one upload; "
            f"max_abs_err={err} fused ms={ms:.4f} (1 launch) "
            f"library_ms={lib_ms:.4f} ({len(items)} index_copy_) "
            f"bound_ms={b[0]:.6f} sync wall ms={wall:.4f}")
        errs.append(err)
    return errs


def up_to(a, dev):
    """`a` on `dev`, from a writable copy (the plane's masters are
    frozen)."""
    return torch.from_numpy(np.array(a, order="C")).to(dev)


def sync_wall_ms(state, kind, lanes, dev, reps, pkg=None) -> float:
    """Mean host-clock milliseconds of one mirror sync of phase 9's plane
    (`kind` "slot": _DeviceRows.sync of `lanes` over the twelve fields;
    "cluster": _DevicePlane.sync of the nine scatterable fields at
    `lanes`), each ended by torch.cuda.synchronize(), on copies of the
    mirrors; `pkg` is the resident.state module to drive (default: this
    checkout's)."""
    if pkg is None:
        from karmada_tpu_torch.resident import state as pkg
    p = state.plane
    if kind == "slot":
        rows = pkg._DeviceRows(dev)
        rows.mirrors = {f: t.clone()
                        for f, t in state.device_rows.mirrors.items()}

        def run():
            rows.sync(p, lanes)
    else:
        plane = pkg._DevicePlane(dev)
        plane.mirrors = {f: t.clone()
                         for f, t in state.device_mirrors.mirrors.items()}
        fields = [f for f in pkg.CLUSTER_SIDE_FIELDS
                  if f in pkg.ROW_SCATTER_FIELDS | pkg.COL_SCATTER_FIELDS]
        dirty = {f: lanes for f in fields}
        refs = {f: getattr(p, f) for f in pkg.CLUSTER_SIDE_FIELDS}

        def run():
            plane.np_refs = dict(refs, **{f: None for f in fields})
            plane.sync(p, dirty)
    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        run()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def dirty_need_bytes(p, rv, flips) -> int:
    """The bytes K12's pass over the plane `p` needs for this store's row
    mix (host masters, numpy; the mirrors hold the same): every slot reads
    placement_id and route, and the device-route rows non_workload; of
    those the workload rows that are not spread-constrained, and of them
    the Dynamic ones fresh; the Dynamic workload rows on the device route,
    not spread-constrained and not fresh also read replicas and their
    prev / evict rows, and each distinct (placement, prev lane) they look
    up costs a mask byte; cluster_valid and deleting; per placement its
    strategy, two sc flags and a probe a flip lane; the rv list, the flip
    lanes and the codes written."""
    cap = p.placement_id.shape[0]
    P, C = p.pl_mask.shape
    Kp, Ke = p.prev_idx.shape[1], p.evict_idx.shape[1]
    pid = p.placement_id
    dev_route = p.route == 0
    strat = p.pl_strategy[pid]
    dyn = (strat == 2) | (strat == 3)
    sc = (p.pl_has_cluster_sc | p.pl_has_region_sc)[pid]
    work = dev_route & ~p.non_workload & ~sc
    need = work & dyn & ~p.fresh
    prev = p.prev_idx[need]
    rows = np.broadcast_to(pid[need][:, None], prev.shape)
    pairs = np.unique(rows[prev >= 0].astype(np.int64) * C
                      + prev[prev >= 0])
    return int(8 * cap + dev_route.sum() + (work & dyn).sum()
               + need.sum() * (8 + 8 * Kp + 4 * Ke) + pairs.size + 2 * C
               + P * (6 + len(flips)) + 8 * (len(rv) + len(flips)) + cap)


def phase_kernels_k10_k12(state, solver, dev, reps) -> list:
    """K10 scatter_lanes, K11 gather_rows and K12 dirty_codes against their
    plain versions on phase 9's plane: K10 on the fleet's avail_milli
    [C, R] (64 churned lanes), est_override [Q, C] columns (64 lanes) and
    the slot store's prev_idx at its capacity (1,024 churned slots); K11 on
    the first chunk's rows of the slot store, in both flavours (the sub
    flavour with a 64-lane union and every 16th row dropped); K12 on the
    whole slot store with 1,000 rv slots (slot 0 among them) and 8 flip
    lanes."""
    from karmada_tpu_torch.ops import dirty as DM
    from karmada_tpu_torch.ops import resident_gather as RG
    from karmada_tpu_torch.ops import resident_update as RU

    g = np.random.default_rng(0)
    p = state.plane
    mirrors = state.device_rows.mirrors
    rows = []

    def up(a):
        return up_to(a, dev)

    # -- K10 ----------------------------------------------------------------
    def hold_scatter(label, master, lanes, cols):
        vals = master[..., lanes] if cols else master[lanes]
        vals = ~vals if vals.dtype == np.bool_ else vals + 1
        lt, vt = up(lanes), up(vals)
        fn = RU.scatter_cols if cols else RU.scatter_rows
        plain = RU.scatter_cols_plain if cols else RU.scatter_rows_plain
        dk, dp = up(master), up(master)
        fn(dk, lt, vt)
        plain(dp, lt, vt)
        err = max_abs_err([(dk, dp)])
        ms = cuda_ms(lambda: fn(dk, lt, vt), reps)
        plain_ms = cuda_ms(lambda: plain(dp, lt, vt), reps)
        lib_ms = cuda_ms(lambda: dp.index_copy_(1 if cols else 0, lt, vt),
                         reps)
        # the lane list and the new values read once, as many elements
        # written
        b = bound_ms(nbytes(lt) + 2 * nbytes(vt), 0)
        split = split_ms(lambda: fn(dk, lt, vt), 10 * reps)
        log(f"phase 2 scatter_lanes {label}: {tuple(master.shape)} "
            f"{master.dtype}, {len(lanes)} lanes split {split} "
            f"max_abs_err={err} ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"bound_ms={b[0]:.6f} library_ms={lib_ms:.4f}")
        return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=b[0], bound_by=b[1], library_ms=lib_ms)

    nC = state.nC
    r_avail = hold_scatter("avail_milli rows", p.avail_milli,
                           np.sort(g.choice(nC, 64, replace=False)), False)
    r_est = hold_scatter("est_override columns", p.est_override,
                         np.sort(g.choice(nC, 64, replace=False)), True)
    cap = p.prev_idx.shape[0]
    r_slot = hold_scatter("slot-store prev_idx rows", p.prev_idx,
                          np.sort(g.choice(cap, 1024, replace=False)), False)
    slot_lanes = np.sort(g.choice(cap, 1024, replace=False))
    clus_lanes = np.sort(g.choice(nC, 64, replace=False))
    r_sync = hold_sync(state, slot_lanes, clus_lanes, dev, reps)
    rows.append(dict(
        name="scatter_lanes", route="cuda",
        source="karmada_tpu_torch/ops/csrc/resident.cu",
        replaces="karmada_tpu/ops/resident_update.py:40",
        **{**r_slot, "max_abs_err": max(
            [r["max_abs_err"] for r in (r_avail, r_est, r_slot)] + r_sync)}))

    # -- K11 on the first chunk's rows ----------------------------------------
    B = 4096
    slots = up(np.asarray(solver._slots[:B], np.int64))
    got = RG.gather_batch(slots, mirrors)
    err11 = max_abs_err(zip(got, RG.gather_batch_plain(slots, mirrors)))
    pid0 = int(p.placement_id[int(solver._slots[0])])
    union = np.flatnonzero(p.pl_mask[pid0][:nC])
    extra = np.setdiff1d(np.arange(nC), union)
    union = np.sort(np.concatenate([union, g.choice(
        extra, 64 - union.size, replace=False)]))
    inv = np.full(p.pl_mask.shape[1], -1, np.int32)
    inv[union] = np.arange(union.size, dtype=np.int32)
    drop = np.zeros(B, bool)
    drop[::16] = True
    sub_in = (slots, mirrors, up(inv), up(drop))
    got_s = RG.sub_gather_batch(*sub_in)
    err11s = max_abs_err(zip(got_s, RG.sub_gather_batch_plain(*sub_in)))
    Kp, Ke = p.prev_idx.shape[1], p.evict_idx.shape[1]
    per_row = 28 + 8 * Kp + 4 * Ke  # the twelve fields read, route included
    b11 = bound_ms(nbytes(slots) + B * per_row + nbytes(*got), 0)
    ms11s = cuda_ms(lambda: RG.sub_gather_batch(*sub_in), reps)
    log(f"phase 2 gather_rows sub flavour: {B} rows, union {union.size} "
        f"lanes, {int(drop.sum())} dropped, max_abs_err={err11s} "
        f"ms={ms11s:.4f}")
    host_slots = np.asarray(solver._slots[:B], np.int64)
    got_d = RG.dispatch_sub_gather(host_slots, mirrors, inv, drop)
    err11s = max(err11s, max_abs_err(zip(got_d, RG.sub_gather_batch_plain(
        *sub_in))))
    for name, fn in (
            ("gather_batch", lambda: RG.gather_batch(slots, mirrors)),
            ("sub_gather_batch", lambda: RG.sub_gather_batch(*sub_in)),
            ("dispatch_gather (upload included)",
             lambda: RG.dispatch_gather(host_slots, mirrors)),
            ("dispatch_sub_gather (upload included)",
             lambda: RG.dispatch_sub_gather(host_slots, mirrors, inv, drop))):
        host, device = split_ms(fn, 10 * reps)
        log(f"phase 2 gather_rows split, {name}: {B} rows, CUDA events "
            f"{cuda_ms(fn, reps):.4f} ms, host enqueue {host:.4f} ms, "
            "device "
            + (f"{device:.4f} ms" if device is not None else "not measured"))
    rows.append(dict(
        name="gather_rows", route="cuda",
        source="karmada_tpu_torch/ops/csrc/resident.cu",
        replaces="karmada_tpu/ops/resident_gather.py:100",
        max_abs_err=max(err11, err11s),
        ms=cuda_ms(lambda: RG.gather_batch(slots, mirrors), reps),
        plain_ms=cuda_ms(lambda: RG.gather_batch_plain(slots, mirrors),
                         reps),
        bound_ms=b11[0], bound_by=b11[1], library_ms=None))
    log(f"phase 2 gather_rows: {B} rows of a {cap}-slot store, "
        f"Kp={Kp} Ke={Ke}")

    # -- K12 on the whole slot store ------------------------------------------
    flips8 = np.sort(g.choice(nC, 8, replace=False))
    flips = DM._pad_lanes(flips8)
    rv_real = np.concatenate([[0], g.choice(np.arange(1, cap), 999,
                                            replace=False)])
    rv = DM._pad_lanes(rv_real)
    ins = ([mirrors[f] for f in DM.SLOT_FIELDS]
           + [up(getattr(p, f)) for f in DM.PLANE_FIELDS]
           + [up(flips), up(rv)])
    # the wrapper sorts the rv list on the card; dirty_codes hands it over
    # ascending (normalise_rv)
    srt = ins[:-1] + [up(np.sort(rv))]
    k12 = DM.dirty_kernel(*ins)
    want12 = DM.dirty_kernel_plain(*ins)
    err12 = max_abs_err([(k12, want12),
                         (DM.dirty_kernel(*srt), want12)])
    if not int(k12[0]) & DM.DIRTY:
        raise AssertionError("dirty_codes: rv slot 0 not dirty")
    b12 = bound_ms(nbytes(*ins) + nbytes(k12), 0)
    need12 = bound_ms(dirty_need_bytes(p, rv_real, flips8), 0)

    def kern12():
        return DM.dirty_kernel(*ins)

    rows.append(dict(
        name="dirty_codes", route="cuda",
        source="karmada_tpu_torch/ops/csrc/dirty.cu",
        replaces="karmada_tpu/ops/dirty.py:96",
        max_abs_err=err12, ms=cuda_ms(kern12, reps),
        plain_ms=cuda_ms(lambda: DM.dirty_kernel_plain(*ins), reps),
        bound_ms=b12[0], bound_by=b12[1], library_ms=None))
    log(f"phase 2 dirty_codes: {cap} slots, {len(rv)} rv slots (1,000 "
        f"real), {len(flips)} flip lanes (8 real), P x C "
        f"{tuple(p.pl_mask.shape)}; dirty rows "
        f"{int((k12 & DM.DIRTY).count_nonzero())}; bound by the need "
        f"{need12[0]:.6f} ms (all inputs {b12[0]:.6f})")
    host, device = split_ms(kern12, 10 * reps, whole=True)
    log(f"phase 2 dirty_codes split, the kernel on device operands: host "
        f"enqueue {host:.4f} ms, device (the whole call, the wrapper's rv "
        "sort included) "
        + (f"{device:.4f} ms" if device is not None else "not measured")
        + "; the kernel apart: " + by_text(kernel_device_ms(kern12,
                                                            10 * reps)))
    # the whole call from host inputs, as the incremental cycle makes it
    keep = state.last_flip_lanes
    state.last_flip_lanes = flips8

    def call():
        return DM.dirty_codes(state, rv_real, mirrors=mirrors)

    try:
        err = max_abs_err([(torch.from_numpy(call()), want12.cpu())])
        rows[-1]["max_abs_err"] = max(err12, err)
        host, device = split_ms(call, 10 * reps, whole=True)
        log(f"phase 2 dirty_codes whole call (host inputs to numpy codes, "
            f"max_abs_err={err}): {host:.4f} ms a call (host clock, its "
            "sync included), device "
            + (f"{device:.4f} ms" if device is not None else "not measured")
            + "; " + by_text(kernel_device_ms(call, 10 * reps)))
    finally:
        state.last_flip_lanes = keep
    for r in rows:
        log(f"phase 2 {r['name']}: max_abs_err={r['max_abs_err']} "
            f"ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
            f"bound_ms={r['bound_ms']:.6f} ({r['bound_by']}) "
            f"library_ms={r['library_ms']}")
        if r["max_abs_err"] != 0:
            raise AssertionError(f"{r['name']} disagrees with its plain "
                                 "version")
    return rows


def load_parent(tree: str):
    """The parent commit's port, importable beside this checkout's: `tree`
    holds its karmada_tpu_torch/ unpacked (git archive <parent>
    karmada_tpu_torch | tar -x -C <tree>).  It is copied to
    <tree>/karmada_tpu_torch_parent with its imports renamed to that
    name, built (its own kernel sources, its own build directory) and
    imported."""
    import importlib
    import shutil

    src = os.path.join(tree, "karmada_tpu_torch")
    dst = os.path.join(tree, "karmada_tpu_torch_parent")
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns(
        "_build", "__pycache__"))
    for root, _dirs, files in os.walk(dst):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(root, f)
                with open(path) as fh:
                    text = fh.read()
                with open(path, "w") as fh:
                    fh.write(text.replace("karmada_tpu_torch",
                                          "karmada_tpu_torch_parent"))
    sys.path.insert(0, os.path.abspath(tree))
    mods = {m: importlib.import_module(f"karmada_tpu_torch_parent.{m}")
            for m in ("ops.kernels", "ops.resident_gather",
                      "ops.resident_update", "ops.shortlist", "ops.solver",
                      "ops.spread", "resident.state", "ops.dirty",
                      "ops.rebalance_detect", "ops.probe")}
    _kmods().append(mods["ops.kernels"])
    t0 = time.perf_counter()
    mods["ops.kernels"].build()
    log(f"phase 2 turns: the parent's port built in "
        f"{time.perf_counter() - t0:.1f} s from {src}")
    return mods


def phase_turns(parent, state, solver, dev, reps,
                rounds=TURN_ROUNDS) -> dict:
    """Old (the parent's port) against new on one card, in turns (old,
    new, new, old) for `rounds` rounds, on phase 9's plane: K10 on one
    field (prev_idx, 1,024 slots), K10 over a whole slot-store sync (1,024
    slots, 12 fields) and a cluster-side sync (64 lanes, 9 fields) kernel
    side (lanes and values already on the card: the parent's 12 / 9
    single-field launches against one fused launch) and as sync walls
    (host clock to synchronize(), uploads included), and K9 at the
    megafleet's region layout (G = 200).  CUDA-event ms for the kernel
    sides, host-clock ms for the walls."""
    from karmada_tpu_torch.ops import dirty as NDM
    from karmada_tpu_torch.ops import resident_gather as NRG
    from karmada_tpu_torch.ops import resident_update as NRU
    from karmada_tpu_torch.ops import shortlist as NSL
    from karmada_tpu_torch.resident import state as NST

    ORU, OSL, OST = (parent["ops.resident_update"], parent["ops.shortlist"],
                     parent["resident.state"])
    ORG = parent["ops.resident_gather"]
    g = np.random.default_rng(7)
    p = state.plane
    cap, nC = p.prev_idx.shape[0], state.nC
    slot_lanes = np.sort(g.choice(cap, 1024, replace=False))
    clus_lanes = np.sort(g.choice(nC, 64, replace=False))
    dk = up_to(p.prev_idx, dev)
    lt = up_to(slot_lanes, dev)
    vt = up_to(p.prev_idx[slot_lanes] + 1, dev)
    cases = {"K10 single field": (
        lambda: cuda_ms(lambda: ORU.scatter_rows(dk, lt, vt), reps),
        lambda: cuda_ms(lambda: NRU.scatter_rows(dk, lt, vt), reps))}
    for kind, lanes in (("slot", slot_lanes), ("cluster", clus_lanes)):
        items = sync_items(state, kind, lanes)
        st = NRU.stage_fields(items)
        staged = up_to(st.buf, dev)
        lt_k = up_to(lanes, dev)
        old = [(t, ORU.scatter_rows if m == "rows" else ORU.scatter_cols,
                up_to(v, dev)) for t, _la, v, m in items]

        def old_kernel(old=old, lt_k=lt_k):
            for t, fn, v in old:
                fn(t, lt_k, v)

        def new_kernel(st=st, staged=staged):
            NRU.scatter_staged(st.dsts, staged, st.desc)

        cases[f"K10 {kind} sync kernel side"] = (
            lambda f=old_kernel: cuda_ms(f, reps),
            lambda f=new_kernel: cuda_ms(f, reps))
        cases[f"K10 {kind} sync wall"] = (
            lambda k=kind, la=lanes: sync_wall_ms(state, k, la, dev, reps,
                                                   OST),
            lambda k=kind, la=lanes: sync_wall_ms(state, k, la, dev, reps,
                                                   NST))
    gid = up_to(np.asarray(p.region_id[:nC], np.int32), dev)
    capx = up_to(g.integers(0, 1 << 20, nC), dev)
    G = int(p.region_id[:nC].max()) + 1
    if not torch.equal(OSL.group_sums(gid, capx, G),
                       NSL.group_sums(gid, capx, G)):
        raise AssertionError("turns: K9 old and new disagree")
    cases["K9 group_sums"] = (
        lambda: cuda_ms(lambda: OSL.group_sums(gid, capx, G), reps),
        lambda: cuda_ms(lambda: NSL.group_sums(gid, capx, G), reps))
    # K11 on the first chunk's rows, a 64-lane union, every 16th row dropped
    mirrors = state.device_rows.mirrors
    host_slots = np.asarray(solver._slots[:4096], np.int64)
    sl = up_to(host_slots, dev)
    inv = np.full(p.pl_mask.shape[1], -1, np.int32)
    inv[np.sort(g.choice(nC, 64, replace=False))] = np.arange(
        64, dtype=np.int32)
    drop = np.zeros(host_slots.size, bool)
    drop[::16] = True
    it, dt = up_to(inv, dev), up_to(drop, dev)
    for flavour, args in (
            ("gather_batch", (sl, mirrors)),
            ("sub_gather_batch", (sl, mirrors, it, dt)),
            ("dispatch_gather", (host_slots, mirrors)),
            ("dispatch_sub_gather", (host_slots, mirrors, inv, drop))):
        if not all(torch.equal(a, b) for a, b in zip(
                getattr(ORG, flavour)(*args), getattr(NRG, flavour)(*args))):
            raise AssertionError(f"turns: K11 {flavour} old and new "
                                 "disagree")
        name = f"K11 {flavour}" + (" (upload included)"
                                   if flavour.startswith("dispatch") else "")
        for side, mod in (("old", ORG), ("new", NRG)):
            host, device = split_ms(
                lambda f=flavour, a=args, m=mod: getattr(m, f)(*a),
                10 * reps)
            log(f"phase 2 turns {name} split, {side}: host enqueue "
                f"{host:.4f} ms, device "
                + (f"{device:.4f} ms" if device is not None
                   else "not measured"))
        cases[name] = (
            lambda f=flavour, a=args: cuda_ms(
                lambda: getattr(ORG, f)(*a), reps),
            lambda f=flavour, a=args: cuda_ms(
                lambda: getattr(NRG, f)(*a), reps))
    # K12: the kernel's wrapper on device operands (the padded rv list;
    # this tree's wrapper sorts it first) and the whole dirty_codes call
    # from host inputs, 8 flip lanes, 1,000 rv slots
    ODM = parent["ops.dirty"]
    flips8 = np.sort(g.choice(nC, 8, replace=False))
    rv_real = np.concatenate([[0], g.choice(np.arange(1, cap), 999,
                                            replace=False)])
    ins = ([mirrors[f] for f in NDM.SLOT_FIELDS]
           + [up_to(getattr(p, f), dev) for f in NDM.PLANE_FIELDS]
           + [up_to(NDM._pad_lanes(flips8), dev),
              up_to(NDM._pad_lanes(rv_real), dev)])
    if not torch.equal(ODM.dirty_kernel(*ins), NDM.dirty_kernel(*ins)):
        raise AssertionError("turns: K12 old and new disagree")
    keep = state.last_flip_lanes
    state.last_flip_lanes = flips8
    try:
        calls = {side: (lambda m=m: m.dirty_codes(state, rv_real,
                                                  mirrors=mirrors))
                 for side, m in (("old", ODM), ("new", NDM))}
        if not np.array_equal(calls["old"](), calls["new"]()):
            raise AssertionError("turns: dirty_codes old and new disagree")
        for side, fn in calls.items():
            host, device = split_ms(fn, 10 * reps, whole=True)
            log(f"phase 2 turns K12 dirty_codes split, {side}: host "
                f"{host:.4f} ms a call, device "
                + (f"{device:.4f} ms" if device is not None
                   else "not measured"))
        cases["K12 kernel (device operands)"] = (
            lambda: cuda_ms(lambda: ODM.dirty_kernel(*ins), reps),
            lambda: cuda_ms(lambda: NDM.dirty_kernel(*ins), reps))
        cases["K12 dirty_codes whole call (host clock)"] = (
            lambda: wall_ms(calls["old"], reps),
            lambda: wall_ms(calls["new"], reps))
        return run_turns(cases, rounds)
    finally:
        state.last_flip_lanes = keep


def phase_turns_explain(parent, k7_in, ex, use_extra, dev, reps,
                        rounds=TURN_ROUNDS) -> dict:
    """Old (the parent's port) against new on one card, in turns: K7 on
    wave 0 of the first forward chunk (512 x 8,192) and its spread flavour
    on that chunk's phase B, each as its tree's main path calls it (this
    tree's wave on the chunk's workspace, both flavours with the batch's
    use_extra); the planes must agree first.  Each side's host enqueue /
    device split is logged beside it."""
    from karmada_tpu_torch.ops import solver as NS

    OS = parent["ops.solver"]
    db, C, Bs = k7_in[0], k7_in[0].C, ex[0].B
    outs = {k: NS.explain_planes(db.B, C, dev) for k in ("old", "new")}
    sps = {k: NS.explain_planes(Bs, C, dev) for k in ("old", "new")}
    ws = NS.ExplainWorkspace(db, *k7_in[3:7], outs["new"],
                             use_extra=use_extra)
    calls = {
        "K7 wave 0": (
            lambda: OS.explain_rows(*k7_in, outs["old"]),
            lambda: NS.explain_rows(*k7_in, outs["new"], use_extra=use_extra,
                                    workspace=ws)),
        "K7 spread flavour": (
            lambda: OS.explain_rows(*ex[:7], sps["old"], pick=ex[7]),
            lambda: NS.explain_rows(*ex[:7], sps["new"], pick=ex[7],
                                    use_extra=use_extra))}
    for name, (old, new) in calls.items():
        old()
        new()
        torch.cuda.synchronize()
        planes = (outs if "wave" in name else sps)
        if not all(torch.equal(a, b) for a, b in zip(planes["old"],
                                                     planes["new"])):
            raise AssertionError(f"turns: {name} old and new disagree")
        for side, fn in (("old", old), ("new", new)):
            host, device = split_ms(fn, 10 * reps)
            log(f"phase 2 turns {name} split, {side}: host enqueue "
                f"{host:.4f} ms, device "
                + (f"{device:.4f} ms" if device is not None
                   else "not measured"))
    return run_turns({name: (lambda f=old: cuda_ms(f, reps),
                             lambda f=new: cuda_ms(f, reps))
                      for name, (old, new) in calls.items()}, rounds)


def phase_turns_rows(parent, batch, rep_k, sel_k, st_k, dev, reps,
                     rounds=TURN_ROUNDS) -> dict:
    """Old (the parent's port) against new on one card, in turns, at phase
    2's shapes: K3 on the first forward chunk's dense result, and K2 std's
    wave 0 (512 rows x 8192 lanes, K4 inside) on that chunk; the two
    ports' results must agree first.  The parent's K2 split (prepare, K4,
    finish) is logged once beside it."""
    from karmada_tpu_torch.ops import solver as NS

    OS, OK = parent["ops.solver"], parent["ops.kernels"]
    nw = NS.device_batch(batch, dev).non_workload
    old_c = OS.compact(rep_k, sel_k, st_k, nw, False)
    new_c = NS.compact(rep_k, sel_k, st_k, nw, False)
    nnz = int(new_c[3])
    if int(old_c[3]) != nnz or not all(
            torch.equal(a[:nnz], b[:nnz]) for a, b in zip(old_c[:2], new_c[:2])):
        raise AssertionError("turns: K3 old and new disagree")
    cases = {"K3 compact": (
        lambda: cuda_ms(lambda: OS.compact(rep_k, sel_k, st_k, nw, False),
                        reps),
        lambda: cuda_ms(lambda: NS.compact(rep_k, sel_k, st_k, nw, False),
                        reps))}
    waves = {}
    use_extra = NS._use_extra(batch)
    for which, P in (("old", OS), ("new", NS)):
        db = P.device_batch(batch, dev)
        B, C = db.B, db.C
        Bw = B // P._effective_waves(B, 8)
        zeros = P._zeros_used(db)
        est0 = P.capacity(db.req_milli, db.req_is_cpu, db.req_pods,
                          db.avail_milli, zeros[0], db.has_alloc,
                          db.pods_allowed, zeros[1], db.has_summary,
                          db.est_override, zeros[2])
        used = tuple(u.clone() for u in zeros)
        out = (torch.zeros((B, C), dtype=torch.int64, device=dev),
               torch.zeros((B, C), dtype=torch.bool, device=dev),
               torch.zeros((B,), dtype=torch.int32, device=dev))
        waves[which] = (lambda P=P, db=db, est0=est0, used=used, out=out,
                        Bw=Bw: P.schedule_rows(
                            db, 0, Bw, est0, *used, *out,
                            use_extra=use_extra, charge=True),
                        used, out)
    for which in ("old", "new"):
        waves[which][0]()
    if not all(torch.equal(a, b) for a, b in zip(
            waves["old"][1] + waves["old"][2],
            waves["new"][1] + waves["new"][2])):
        raise AssertionError("turns: K2 old and new disagree")
    log("phase 2 turns K2 split of the parent (std, wave 0): "
        + by_text(kernel_device_ms(waves["old"][0], reps)))
    cases["K2 std wave (K4 inside)"] = (
        lambda: cuda_ms(waves["old"][0], reps),
        lambda: cuda_ms(waves["new"][0], reps))
    # K1: alone, and wave 0 with its K1 (from Python in the parent, from
    # K2's first launch here); each side's host / device split logged
    whole, alone = [], []
    for which, P in (("old", OS), ("new", NS)):
        db = P.device_batch(batch, dev)
        zeros = P._zeros_used(db)
        out = (torch.zeros((db.B, db.C), dtype=torch.int64, device=dev),
               torch.zeros((db.B, db.C), dtype=torch.bool, device=dev),
               torch.zeros((db.B,), dtype=torch.int32, device=dev))
        w = wave_call(P, db, tuple(u.clone() for u in zeros), out,
                      use_extra, "std", fills_est(P))
        w()
        whole.append((w, out))
        cap_in = (db.req_milli, db.req_is_cpu, db.req_pods, db.avail_milli,
                  zeros[0], db.has_alloc, db.pods_allowed, zeros[1],
                  db.has_summary, db.est_override, zeros[2])
        alone.append(lambda P=P, c=cap_in: P.capacity(*c))
        host, _d = split_ms(w, reps)
        by = kernel_device_ms(w, reps)
        log(f"phase 2 turns K1 + K2 std wave 0 split ({which}): host enqueue "
            f"{host:.4f} ms, device {sum(by.values()):.4f} ms, of which "
            f"capacity_kernel (profiler_ms) "
            f"{sum(v for k, v in by.profiler_ms.items() if 'capacity' in k):.4f}"
            f" ms; {by_text(by)}")
    if not all(torch.equal(a, b) for a, b in zip(whole[0][1], whole[1][1])):
        raise AssertionError("turns: K1 + K2 wave old and new disagree")
    if not torch.equal(alone[0](), alone[1]()):
        raise AssertionError("turns: K1 old and new disagree")
    cases["K1 + K2 std wave 0"] = (
        lambda: cuda_ms(whole[0][0], reps),
        lambda: cuda_ms(whole[1][0], reps))
    cases["K1 capacity alone"] = (lambda: cuda_ms(alone[0], reps),
                                  lambda: cuda_ms(alone[1], reps))
    return run_turns(cases, rounds)


def phase_turns_tier1(parent, mbatch, prof_keys, rep_max, dev, reps,
                      rounds=TURN_ROUNDS) -> dict:
    """Old (the parent's tier 1: K1 on a zero used triple, then K8) against
    new (K8 alone) on one card, in turns, on the first megafleet chunk's
    profile rows (16 x 16,384, k = MEGA_K) and on the same rows over
    twice the lanes; each tree's rows built by its own profile_batch, the
    results equal first.  Each side's host enqueue and device time by
    kernel is logged beside the turns."""
    from karmada_tpu_torch.ops import shortlist as NSL
    from karmada_tpu_torch.ops import solver as NS

    cases = {}
    for times in (1, 2):
        calls = []
        for S, SL in ((parent["ops.solver"], parent["ops.shortlist"]),
                      (NS, NSL)):
            db = SL.profile_batch(mbatch, prof_keys, rep_max, dev)
            pref = torch.from_numpy(
                SL.cycle_aggregates(mbatch, dev)["group_pref"]).to(dev)
            if times > 1:
                db = tile_lanes(S, db, times)
                pref = torch.cat([pref] * times)
            calls.append(tier1_call(S, SL, db, pref, MEGA_K))
        if not all(torch.equal(a, b) for a, b in zip(calls[0](),
                                                      calls[1]())):
            raise AssertionError("turns: tier 1 old and new disagree")
        name = f"tier 1 (K1 + K8 -> K8) x{times} lanes"
        for which, fn in zip(("old", "new"), calls):
            host, _d = split_ms(fn, 10 * reps)
            by = kernel_device_ms(fn, 10 * reps)
            log(f"phase 2 turns {name} split ({which}): host enqueue "
                f"{host:.4f} ms, device " + by_text(by))
        cases[name] = (lambda f=calls[0]: cuda_ms(f, reps),
                       lambda f=calls[1]: cuda_ms(f, reps))
    return run_turns(cases, rounds)


def phase_turns_k4(parent, web, web_big, reps, rounds=TURN_ROUNDS) -> dict:
    """Old (the parent's port) against new on one card, in turns: K4 on
    wave 0's Webster problems of the first forward chunk (std, 656 lanes)
    and of the wide chunk's big rows (5,248 lanes); the two ports' seats
    must agree first."""
    from karmada_tpu_torch.ops import solver as NS

    OS = parent["ops.solver"]
    cases = {}
    for tier, wv in (("std", web), ("big", web_big)):
        if not torch.equal(OS.webster_batch(*wv), NS.webster_batch(*wv)):
            raise AssertionError(f"turns: K4 ({tier}) old and new disagree")
        cases[f"K4 webster_batch {tier} wave 0"] = (
            lambda wv=wv: cuda_ms(lambda: OS.webster_batch(*wv), reps),
            lambda wv=wv: cuda_ms(lambda: NS.webster_batch(*wv), reps))
    return run_turns(cases, rounds)


def phase_turns_spread(parent, gi, pk, use_extra, reps,
                       rounds=TURN_ROUNDS) -> dict:
    """Old (the parent's port) against new on one card, in turns: K5 and
    K6 on phase 2's spread sub-batch (solve_spread's operands; the new
    wrappers also get solve_spread's use_extra, the parent's are called
    with its operands alone); the two ports' results must agree first.
    Each side's host enqueue and device time is logged beside the
    turns."""
    from karmada_tpu_torch.ops import spread as NSP

    OSP = parent["ops.spread"]
    ux = dict(use_extra=use_extra)
    if not all(torch.equal(a, b) for a, b in zip(
            OSP.spread_group_info(*gi), NSP.spread_group_info(*gi, **ux))):
        raise AssertionError("turns: K5 old and new disagree")
    if not torch.equal(OSP.spread_pick(*pk), NSP.spread_pick(*pk, **ux)):
        raise AssertionError("turns: K6 old and new disagree")
    calls = {"K5 spread_group_info": (
                 lambda: OSP.spread_group_info(*gi),
                 lambda: NSP.spread_group_info(*gi, **ux)),
             "K6 spread_pick": (lambda: OSP.spread_pick(*pk),
                                lambda: NSP.spread_pick(*pk, **ux))}
    for name, fns in calls.items():
        for which, fn in zip(("old", "new"), fns):
            host, device = split_ms(fn, 10 * reps)
            log(f"phase 2 turns {name} split ({which}): host enqueue "
                f"{host:.4f} ms, device "
                + (f"{device:.4f} ms" if device is not None
                   else "not measured"))
    return run_turns({name: (lambda f=fns[0]: cuda_ms(f, reps),
                             lambda f=fns[1]: cuda_ms(f, reps))
                      for name, fns in calls.items()}, rounds)


def big_wave0(P, sub, dev):
    """Wave 0 of the big rows `sub` on tree P's K2-big, as hold_rows times
    it: est fixed at wave 0's (K1 on a zero carry), K4 inside, the rows
    charged into a carry no call reads, so every call does the same work.
    Returns (the call, its outputs and carry)."""
    db = P.device_batch(sub, dev)
    z = P._zeros_used(db)
    est0 = P.capacity(db.req_milli, db.req_is_cpu, db.req_pods,
                      db.avail_milli, z[0], db.has_alloc, db.pods_allowed,
                      z[1], db.has_summary, db.est_override, z[2])
    used = tuple(u.clone() for u in z)
    out = (torch.zeros((db.B, db.C), dtype=torch.int64, device=dev),
           torch.zeros((db.B, db.C), dtype=torch.bool, device=dev),
           torch.zeros((db.B,), dtype=torch.int32, device=dev))
    Bw = db.B // P._effective_waves(db.B, 8)
    use_extra = P._use_extra(sub)
    return (lambda: P.schedule_rows(db, 0, Bw, est0, *used, *out,
                                    use_extra=use_extra, charge=True,
                                    tier="big")), out + used


def phase_turns_big(parent, sub, dev, reps, rounds=TURN_ROUNDS) -> dict:
    """Old (the parent's port) against new on one card, in turns: K2-big's
    wave 0 (K4 inside, big_wave0) on the first wide chunk's big rows; the
    two ports' results and carries must agree first.  Each side's host
    enqueue and device time by kernel is logged beside the turns."""
    from karmada_tpu_torch.ops import solver as NS

    calls = [big_wave0(P, sub, dev) for P in (parent["ops.solver"], NS)]
    for fn, _o in calls:
        fn()
    if not all(torch.equal(a, b) for a, b in zip(calls[0][1], calls[1][1])):
        raise AssertionError("turns: K2-big wave 0 old and new disagree")
    for which, (fn, _o) in zip(("old", "new"), calls):
        host, _d = split_ms(fn, reps)
        by = kernel_device_ms(fn, reps)
        log(f"phase 2 turns K2-big wave 0 split ({which}): host enqueue "
            f"{host:.4f} ms, device " + by_text(by))
    return run_turns({"K2-big wave 0 (K4 inside)": (
        lambda: cuda_ms(calls[0][0], reps),
        lambda: cuda_ms(calls[1][0], reps))}, rounds)


def phase_turns_dispatch(parent, batch, dev, reps,
                         rounds=TURN_ROUNDS) -> dict:
    """Old (the parent's port) against new on one card, in turns: the
    forward chunk's dispatch_compact (upload, 8 waves of K1 + K2 with K4,
    K3) between two events on the stream; the two ports' COO, status and
    carry must agree first.  Each side's host enqueue and device time by
    kernel (split_ms, kernel_device_ms) is logged beside the turns."""
    from karmada_tpu_torch.ops import solver as NS

    fns = [lambda P=P: P.dispatch_compact(batch, waves=8, with_used=True,
                                          device=dev)
           for P in (parent["ops.solver"], NS)]
    got = [P.finalize_compact(fn()) for P, fn in
           zip((parent["ops.solver"], NS), fns)]
    if got[0][3] != got[1][3] or not all(
            np.array_equal(a, b) for a, b in zip(got[0][:3] + got[0][4],
                                                 got[1][:3] + got[1][4])):
        raise AssertionError("turns: forward chunk dispatch old and new "
                             "disagree")
    for which, fn in zip(("old", "new"), fns):
        host, _d = split_ms(fn, reps)
        by = kernel_device_ms(fn, reps)
        log(f"phase 2 turns forward chunk dispatch split ({which}): host "
            f"enqueue {host:.4f} ms, device " + by_text(by))
    return run_turns({"forward chunk dispatch (8 waves + K3)": (
        lambda: cuda_ms(fns[0], reps), lambda: cuda_ms(fns[1], reps))},
        rounds)


def run_turns(cases, rounds, label="phase 2") -> dict:
    """Each case's (old, new) timers in turns: old, new, new, old, for
    `rounds` rounds; logs every reading and the means."""
    out = {name: {"old": [], "new": []} for name in cases}
    for _r in range(rounds):
        for which in ("old", "new", "new", "old"):
            for name, fns in cases.items():
                out[name][which].append(fns[which == "new"]())
    for name, v in out.items():
        log(f"{label} turns {name}: old mean {np.mean(v['old']):.5f} ms "
            f"{[round(x, 5) for x in v['old']]}, new mean "
            f"{np.mean(v['new']):.5f} ms {[round(x, 5) for x in v['new']]}")
    return out


def phase_parity_resident(items, fleet, args, dev) -> None:
    """The resident plane on the card with config 5's mix: the first
    RESIDENT_BINDINGS forward bindings (main and region-spread rows) on
    the 5,000-cluster fleet, through schedule_items with a fused and a
    host-assemble ResidentState (both auditing every batch against a fresh
    encode_batch) and without one: adopt, then two churn windows, each
    bumping 1% of the bindings (replicas +-1, rv), the pods of 1% of the
    clusters and one cluster's `deleting` (on in the first window, off in
    the second).  Placements equal across fused, host and fresh; every
    audit ok; the fused windows upload no binding field."""
    import copy

    from karmada_tpu_torch.ops import solver as S
    from karmada_tpu_torch.resident import ResidentState, RowToken
    from karmada_tpu_torch.scheduler.core import schedule_items

    part = list(items[:RESIDENT_BINDINGS])
    clusters = copy.deepcopy(fleet)
    rng = random.Random(args.seed + 4)
    n = len(part)
    rvs = [1] * n
    planes = {"fused": ResidentState(audit_interval=1, fused=True,
                                     device=dev),
              "host": ResidentState(audit_interval=1, device=dev)}
    flip = clusters[7]
    for window in range(3):
        if window:
            for i in rng.sample(range(n), n // 100):
                spec, status = part[i]
                part[i] = (dataclasses.replace(spec, replicas=max(
                    1, spec.replicas + rng.choice((-1, 1)))), status)
                rvs[i] += 1
            for c in rng.sample(clusters, len(clusters) // 100):
                q = c.status.resource_summary.allocatable["pods"]
                c.status.resource_summary.allocatable["pods"] = (
                    type(q).from_units(max(8, int(q.value())
                                           + rng.choice((-4, 4)))))
                c.metadata.resource_version += 1
            flip.metadata.deletion_timestamp = 1.0 if window == 1 else None
            flip.metadata.resource_version += 1
        toks = [RowToken(f"b/{i}", rvs[i]) for i in range(n)]
        out = {}
        for name, state in list(planes.items()) + [("fresh", None)]:
            h0 = S.TRANSFERS["h2d_binding_fields"]
            t0 = time.perf_counter()
            kw = ({"resident": state, "tokens": toks} if state is not None
                  else {})
            out[name] = [norm(r) for r in schedule_items(
                part, clusters, chunk=args.chunk, waves=args.waves,
                device=dev, **kw)]
            h2d = S.TRANSFERS["h2d_binding_fields"] - h0
            extra = ""
            if state is not None:
                extra = (f", flip lanes {state.last_flip_lanes.tolist()}, "
                         f"audits {state.audits_ok} ok / "
                         f"{state.audit_mismatches} mismatch")
            log(f"phase 5 parity resident window {window} {name}: "
                f"{time.perf_counter() - t0:.2f} s, binding fields uploaded "
                f"{h2d}{extra}")
            if name == "fused" and window and h2d:
                raise AssertionError("resident: a fused window uploaded "
                                     f"{h2d} binding fields")
            if state is not None and window and not len(
                    state.last_flip_lanes):
                raise AssertionError("resident: the deleting flip was not "
                                     "seen")
        bad = [i for i in range(n) if not (
            out["fused"][i] == out["host"][i] == out["fresh"][i])]
        if bad:
            raise AssertionError(f"resident: window {window} rows {bad[:10]}"
                                 " differ across fused / host / fresh")
    for name, state in planes.items():
        st = state.stats()
        log(f"phase 5 parity resident {name}: {st['audits']}, "
            f"rebuilds {st['rebuilds']}, fused {st['fused']}")
        if state.audit_mismatches or not state.audits_ok:
            raise AssertionError(f"resident: {name} audits {st['audits']}")
    if not planes["fused"].fused_cycles:
        raise AssertionError("resident: the fused plane never gathered")


def norm(r):
    if isinstance(r, Exception):
        return type(r).__name__
    return sorted((t.name, t.replicas) for t in r)


def cpu_parity_job(parts, explain_part, fleet, chunk, waves) -> dict:
    """Phase 5's CPU halves (CpuRefs), by label: schedule_items with
    device="cpu" on each {label: chunk}, the results normalized, and on
    the explain chunk its decisions (ts and id left out); each with its
    wall."""
    from karmada_tpu_torch.obs import decisions as D
    from karmada_tpu_torch.scheduler.core import schedule_items

    out = {}
    for label, part in parts.items():
        t0 = time.perf_counter()
        out[label] = ([norm(r) for r in schedule_items(
            part, fleet, chunk=chunk, waves=waves, device="cpu")],
            time.perf_counter() - t0)
    rec = D.DecisionRecorder(capacity=len(explain_part))
    t0 = time.perf_counter()
    schedule_items(explain_part, fleet, chunk=EXPLAIN_CHUNK, waves=waves,
                   device="cpu", explain=rec)
    out["explain"] = ([{x: v for x, v in dec.items()
                        if x not in ("ts", "id")} for dec in rec.recent()],
                      time.perf_counter() - t0)
    return out


def submit_parity(refs, chunks, explain_items, fleet, args) -> None:
    """Phase 5's CPU halves to the child: schedule_items on the first
    chunk of each {label: items} and on the explain chunk."""
    refs.submit("5", cpu_parity_job,
                {label: items[:args.chunk] for label, items in chunks.items()},
                explain_items[:EXPLAIN_CHUNK], fleet, args.chunk, args.waves)


def phase_parity(label, items, fleet, args, dev, refs) -> None:
    """One chunk through the kernel path on the card and the plain path on
    the CPU: solve_compact's COO, status, nnz and carry accumulators, and
    schedule_items' results row by row (the CPU's from the child,
    submit_parity)."""
    from karmada_tpu_torch.estimator.general import GeneralEstimator
    from karmada_tpu_torch.ops import solver as S
    from karmada_tpu_torch.ops import tensors as T
    from karmada_tpu_torch.scheduler.core import schedule_items

    part = items[:args.chunk]
    batch = T.encode_batch(part, T.ClusterIndex.build(fleet),
                           GeneralEstimator(), cache=T.EncoderCache())
    k = S.solve_compact(batch, waves=args.waves, with_used=True, device=dev)
    p = S.solve_compact(batch, waves=args.waves, with_used=True, device="cpu")
    same = (k[3] == p[3] and np.array_equal(k[0], p[0])
            and np.array_equal(k[1], p[1]) and np.array_equal(k[2], p[2])
            and all(np.array_equal(a, b) for a, b in zip(k[4], p[4])))
    log(f"phase 5 parity {label}: chunk {batch.B}x{batch.C} nnz={k[3]} "
        f"solve_compact kernel==plain(cpu): {same}")
    if not same:
        raise AssertionError(f"{label}: kernel path != plain path")
    t0 = time.perf_counter()
    card = [norm(r) for r in schedule_items(
        part, fleet, chunk=args.chunk, waves=args.waves, device=dev)]
    t1 = time.perf_counter()
    cpu, cpu_s = refs.cpu5[label]
    bad = [i for i, (a, b) in enumerate(zip(card, cpu)) if a != b]
    log(f"phase 5 parity {label}: schedule_items on {len(part)} bindings, "
        f"card {t1 - t0:.2f} s, cpu {cpu_s:.2f} s (the child's), "
        f"rows differing: {len(bad)}")
    if bad:
        raise AssertionError(f"{label}: rows {bad[:10]} differ: card "
                             f"{card[bad[0]]} cpu {cpu[bad[0]]}")


def phase_parity_explain(items, fleet, args, dev, refs) -> None:
    """One phase-7 chunk: its explain planes (and COO, carry) card vs CPU
    bit for bit, and its decisions through schedule_items equal apart
    from ts/id (the CPU's from the child, submit_parity)."""
    from karmada_tpu_torch.estimator.general import GeneralEstimator
    from karmada_tpu_torch.obs import decisions as D
    from karmada_tpu_torch.ops import solver as S
    from karmada_tpu_torch.ops import tensors as T
    from karmada_tpu_torch.scheduler.core import schedule_items

    part = items[:EXPLAIN_CHUNK]
    batch = T.encode_batch(part, T.ClusterIndex.build(fleet),
                           GeneralEstimator(), cache=T.EncoderCache(),
                           explain=True)
    k = S.solve_compact(batch, waves=args.waves, with_used=True,
                        explain=True, device=dev)
    p = S.solve_compact(batch, waves=args.waves, with_used=True,
                        explain=True, device="cpu")
    same = (k[3] == p[3] and all(np.array_equal(a, b) for a, b in zip(
        k[:3] + k[4] + k[5], p[:3] + p[4] + p[5])))
    log(f"phase 5 parity explain: chunk {batch.B}x{batch.C} planes "
        f"kernel==plain(cpu): {same}")
    if not same:
        raise AssertionError("explain: kernel planes != plain planes")
    rec = D.DecisionRecorder(capacity=len(part))
    t0 = time.perf_counter()
    schedule_items(part, fleet, chunk=EXPLAIN_CHUNK, waves=args.waves,
                   device=dev, explain=rec)
    decs = [[{x: v for x, v in dec.items() if x not in ("ts", "id")}
             for dec in rec.recent()]]
    log(f"phase 5 parity explain: schedule_items on {dev}, "
        f"{len(decs[-1])} decisions in {time.perf_counter() - t0:.2f} s")
    cpu, cpu_s = refs.cpu5["explain"]
    decs.append(cpu)
    log(f"phase 5 parity explain: schedule_items on cpu (the child), "
        f"{len(cpu)} decisions in {cpu_s:.2f} s")
    if decs[0] != decs[1]:
        bad = next(i for i, (a, b) in enumerate(zip(*decs)) if a != b)
        raise AssertionError(f"explain: decision {bad} differs card vs cpu")


def phase_parity_shortlist(items, fleet, args, dev) -> None:
    """One shortlisted megafleet chunk card vs CPU (sub-batch, COO, carry,
    schedule_items row by row), and the first RECALL_BINDINGS megafleet
    bindings shortlisted vs dense on the card (bench.py's recall leg)."""
    from karmada_tpu_torch.estimator.general import GeneralEstimator
    from karmada_tpu_torch.ops import shortlist as SL
    from karmada_tpu_torch.ops import solver as S
    from karmada_tpu_torch.ops import tensors as T
    from karmada_tpu_torch.scheduler.core import schedule_items

    cfg = SL.ShortlistConfig(k=MEGA_K)
    part = items[:args.chunk]
    batch = T.encode_batch(part, T.ClusterIndex.build(fleet),
                           GeneralEstimator(), cache=T.EncoderCache())
    subs = []
    for d in (dev, "cpu"):
        SL.reset_for_tests()
        subs.append(SL.shrink_chunk(batch, cfg, device=d))
    (sk, ik), (sp, ip) = subs
    if sk is None or sp is None or ik != ip or not np.array_equal(
            sk.sub_lanes, sp.sub_lanes):
        raise AssertionError(f"shortlist: tier 1 differs card vs cpu: {ik} "
                             f"{ip}")
    k = S.solve_compact(sk, waves=args.waves, with_used=True, device=dev)
    p = S.solve_compact(sk, waves=args.waves, with_used=True, device="cpu")
    same = (k[3] == p[3] and all(np.array_equal(a, b) for a, b in zip(
        k[:3] + k[4], p[:3] + p[4])))
    log(f"phase 5 parity shortlist: chunk {batch.B}x{batch.C} -> "
        f"{sk.B}x{sk.C} (union {ik['union']}), solve_compact "
        f"kernel==plain(cpu): {same}")
    if not same:
        raise AssertionError("shortlist: kernel path != plain path")
    out = {}
    for d, sl in ((dev, cfg), ("cpu", cfg), ("dense", None)):
        t0 = time.perf_counter()
        out[str(d)] = [norm(r) for r in schedule_items(
            part, fleet, chunk=args.chunk, waves=args.waves,
            device=dev if d == "dense" else d, shortlist=sl)]
        log(f"phase 5 parity shortlist: schedule_items {d} "
            f"{time.perf_counter() - t0:.2f} s")
    bad = [i for i, (a, b) in enumerate(zip(out[str(dev)], out["cpu"]))
           if a != b]
    if bad:
        raise AssertionError(f"shortlist: rows {bad[:10]} differ card vs cpu")
    sample = items[:RECALL_BINDINGS]
    dense = [norm(r) for r in schedule_items(
        sample, fleet, chunk=args.chunk, waves=args.waves, device=dev)]
    short = [norm(r) for r in schedule_items(
        sample, fleet, chunk=args.chunk, waves=args.waves, device=dev,
        shortlist=cfg)]
    bad = [i for i, (a, b) in enumerate(zip(dense, short)) if a != b]
    log(f"phase 5 parity shortlist: {len(sample)} megafleet bindings "
        f"shortlisted vs dense on the card, rows differing: {len(bad)}")
    if bad:
        raise AssertionError(f"shortlist: rows {bad[:10]} differ from dense")


# -- phase 10: the rebalance loop on the control plane ------------------------

REBALANCE_PARITY_BINDINGS = 2_000   # phase 10a's roster
REBALANCE_CRUSHED = 8
REBALANCE_ROUNDS = 40
REBALANCE_AS_STATED_ROUNDS = 3      # the recipe as first specified, bounded
REBALANCE_GRACE_S = 600.0
#: BASELINE config 5's loop: 30 s cycles, threshold 1000 milli, spread
#: report-only, 512 evictions a cycle, 128 per cluster a minute (phases
#: 10 and 14)
REBALANCE_CFG = dict(
    interval_s=30, overcommit_threshold_milli=1000, spread_tolerance_milli=0,
    max_evictions_per_cycle=512, budget_per_cluster=128, budget_interval_s=60)


def rebalance_cfg():
    from karmada_tpu_torch.rebalance import RebalanceConfig

    return RebalanceConfig(**REBALANCE_CFG)


class FakeClock:
    """The loop's one clock (queue, plane, budget, eviction controller)."""

    def __init__(self, t: float = 1_000.0) -> None:
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, s: float) -> None:
        self.t += s


def restore_store(M, fleet, items, results, converged=False):
    """An ObjectStore holding the fleet and `items` as phase 3 placed them,
    as after a restart: each placed binding carries its targets,
    Scheduled=True and its observed generation; each binding phase 3
    could not place carries Scheduled=False.  Then REBALANCE_CRUSHED
    clusters have their allocatable pods crushed to 60% of what they hold.

    Not `converged`: the recipe as first specified -- members keep their
    configured pods, and the crushed clusters are those with the most
    Divided replicas.  `converged`: the fleet restored converged -- every
    member reports the replicas placed on it as allocated pods and as
    allocatable pods its configured pods or what it runs, the larger; the
    crushed clusters are those with the most Divided replicas among the
    ones no Duplicated or StaticWeight affinity names (a re-solve puts
    capacity-blind placements back, and Duplicated load is never
    drained).

    Returns the store, the crushed names, the seconds the creates took,
    and a census of the placements against the configured pods."""
    import copy

    from karmada_tpu_torch.ops import serial
    from karmada_tpu_torch.store import ObjectStore

    held, dup, div, pinned = {}, {}, {}, set()
    for (spec, _st), r in zip(items, results):
        strat = serial.strategy_type(spec)
        aff = spec.placement.cluster_affinity if spec.placement else None
        if aff is not None and strat in (serial.DUPLICATED,
                                         serial.STATIC_WEIGHT):
            pinned.update(aff.cluster_names)
        if isinstance(r, list):
            for t in r:
                held[t.name] = held.get(t.name, 0) + t.replicas
                to = dup if strat == serial.DUPLICATED else div
                to[t.name] = to.get(t.name, 0) + t.replicas
    pods = {c.name: int(c.status.resource_summary.allocatable["pods"].value())
            for c in fleet}
    over = [n for n in held if held[n] > pods[n]]
    stuck = [n for n in dup if dup[n] > pods[n]]
    census = dict(
        committed=sum(held.values()), duplicated=sum(dup.values()),
        allocatable=sum(pods.values()), over=len(over),
        over_excess=sum(held[n] - pods[n] for n in over),
        duplicated_over=len(stuck),
        duplicated_excess=sum(dup[n] - pods[n] for n in stuck))
    fullest = sorted(div, key=lambda n: (-div[n], n))
    census["fullest_pinned"] = sum(
        n in pinned for n in fullest[:REBALANCE_CRUSHED])
    crushed = [n for n in fullest
               if not (converged and n in pinned)][:REBALANCE_CRUSHED]
    t0 = time.perf_counter()
    store = ObjectStore()
    for c in fleet:
        c = copy.deepcopy(c)
        h = held.get(c.name, 0)
        s = c.status.resource_summary
        if c.name in crushed:
            s.allocatable["pods"] = M.Quantity.from_units(h * 600 // 1000)
        elif converged:
            s.allocatable["pods"] = M.Quantity.from_units(max(pods[c.name], h))
        if converged:
            s.allocated["pods"] = M.Quantity.from_units(h)
        store.create(c)
    for (spec, _st), r in zip(items, results):
        rb = M.ResourceBinding(
            metadata=M.ObjectMeta(namespace=spec.resource.namespace,
                                  name=spec.resource.name),
            spec=dataclasses.replace(
                spec, clusters=list(r) if isinstance(r, list) else []))
        rb.status.scheduler_observed_generation = 1  # create sets gen 1
        ok = isinstance(r, list)
        rb.status.conditions.append(M.Condition(
            type="Scheduled", status="True" if ok else "False",
            reason=("BindingScheduled" if ok else
                    "NoClusterFit" if isinstance(r, serial.FitError)
                    else "Unschedulable")))
        store.create(rb)
    return store, crushed, time.perf_counter() - t0, census


def census_line(census) -> str:
    return (f"{census['committed']} replicas committed "
            f"({census['duplicated']} Duplicated) against "
            f"{census['allocatable']} configured allocatable pods; "
            f"{census['over']} clusters hold {census['over_excess']} above "
            f"their configured pods, {census['duplicated_over']} of them "
            f"{census['duplicated_excess']} Duplicated replicas alone, which "
            f"no drain moves; {census['fullest_pinned']} of the "
            f"{REBALANCE_CRUSHED} clusters with the most Divided replicas are "
            f"named by a Duplicated or StaticWeight affinity")


def rebalance_loop(store, dev, label, verbose, rounds=REBALANCE_ROUNDS):
    """Phase 10's closed loop on `store`: a Scheduler (config 5's chunk
    and waves, rebalance armed per BASELINE config 5's loop) and a
    GracefulEvictionController on one clock.  Advance 30 s and tick until
    the plane converges (at most `rounds` rounds), then, if it did,
    advance past the grace period until every drain settled.  Returns
    what the run observed."""
    from karmada_tpu_torch.controllers.failover import (
        GracefulEvictionController,
    )
    from karmada_tpu_torch.scheduler import Scheduler, SchedulingQueue
    from karmada_tpu_torch.store import Runtime

    clock = FakeClock()
    rt = Runtime()
    sched = Scheduler(
        store, rt, device=dev, batch_window=4096, pipeline_chunk=4096,
        waves=8, queue=SchedulingQueue(now=clock), rebalance=30.0,
        rebalance_cfg=rebalance_cfg(), rebalance_clock=clock)
    GracefulEvictionController(store, rt, grace_period_s=REBALANCE_GRACE_S,
                               clock=clock)
    plane = sched.rebalance_plane
    promoted = []
    promote = sched.promote

    def record(key, priority=0, origin="rebalance"):
        promoted.append((key, priority, origin))
        return promote(key, priority=priority, origin=origin)
    sched.promote = record

    snaps, seen, cycles = [], 0, 0
    t_loop = time.perf_counter()

    def tick():
        nonlocal seen, cycles
        t0 = time.perf_counter()
        rt.tick()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = plane.stats()
        if st["cycles"] > cycles:
            cycles = st["cycles"]
            last = st["last"]
            snaps.append(last)
            tm = plane.last_timing
            if verbose:
                log(f"phase {label} detect {cycles}: evicted "
                    f"{last['evicted']}, drain_need "
                    f"{sum(r['drain_need'] for r in last['clusters'].values())}"
                    f" over {sum(r['drain_need'] > 0 for r in last['clusters'].values())}"
                    f" cluster(s), K13 {tm.get('kernel_ms', 0.0):.4f} ms, "
                    f"list {tm['list_s']:.3f} s assemble "
                    f"{tm['assemble_s']:.3f} s detect {tm['detect_s']:.4f} s"
                    f" drain {tm['drain_s']:.3f} s audit "
                    f"{tm['audit_s']:.3f} s; tick wall {wall:.3f} s")
        for c in list(sched.cycle_log):
            if c["cycle_id"] <= seen:
                continue
            seen = c["cycle_id"]
            if verbose:
                stages = " ".join(
                    f"{k}={c[k]:.3f}" for k in (
                        "encode_s", "dispatch_s", "wait_s", "finalize_s",
                        "decode_s", "spread_s", "big_s"))
                log(f"phase {label} scheduler cycle {c['cycle_id']}: "
                    f"{c['bindings']} bindings ({c['scheduled']} placed, "
                    f"{c['unschedulable']} unschedulable) in "
                    f"{c['wall_s']:.3f} s "
                    f"({c['bindings'] / max(c['wall_s'], 1e-9):.0f} "
                    f"bindings/s), {c['chunks']} chunk(s): {stages}")

    cap, rounds = rounds, 0
    while rounds < cap:
        clock.advance(30.0)
        tick()
        rounds += 1
        if plane.converged():
            break
    converged_snap = snaps[-1] if snaps else {}
    tasks = {(rb.namespace, rb.name): [
        (t.from_cluster, t.replicas, t.producer, t.creation_timestamp)
        for t in rb.spec.graceful_eviction_tasks]
        for rb in store.list("ResourceBinding")
        if rb.spec.graceful_eviction_tasks}
    drain_rounds = 0
    while (plane.converged() and plane.pending_drains()
           and drain_rounds < 8):
        clock.advance(REBALANCE_GRACE_S)
        tick()
        drain_rounds += 1
    wall = time.perf_counter() - t_loop
    t0 = time.perf_counter()
    final = {(rb.namespace, rb.name): (
        [(t.name, t.replicas) for t in rb.spec.clusters],
        [(c.type, c.status, c.reason) for c in rb.status.conditions],
        rb.metadata.generation, rb.status.scheduler_observed_generation)
        for rb in store.list("ResourceBinding")}
    list_s = time.perf_counter() - t0
    return dict(snaps=snaps, promoted=promoted, tasks=tasks, final=final,
                converged=plane.converged(), converged_snap=converged_snap,
                rounds=rounds, drain_rounds=drain_rounds,
                pending=plane.pending_drains(), stats=plane.stats(),
                faults=sched.faults(), errors=rt.reconcile_errors(),
                wall=wall, list_s=list_s, cycles=plane.stats()["cycles"])


def phase_rebalance_parity(M, fleet, items, results, dev) -> None:
    """Phase 10a: the closed loop on the first REBALANCE_PARITY_BINDINGS
    of config 5's bindings over the 5,000-cluster fleet, restored
    converged with no headroom, once with the Scheduler and plane on the
    card and once on the CPU: equal per-cycle snapshots, eviction tasks,
    promotions and final placements.  Then the recipe as first specified
    on the same roster, REBALANCE_AS_STATED_ROUNDS rounds on the card:
    what it drains and what it leaves over threshold."""
    n = REBALANCE_PARITY_BINDINGS
    runs = {}
    for d in (dev, torch.device("cpu")):
        store, crushed, _, census = restore_store(
            M, fleet, items[:n], results[:n], converged=True)
        runs[d.type] = rebalance_loop(store, d, "10a", verbose=False)
    a, b = runs["cuda"], runs["cpu"]
    log(f"phase 10a rebalance parity: {n} bindings x {len(fleet)} clusters,"
        f" crushed {crushed}; card: {a['cycles']} detect cycles, "
        f"{a['stats']['evictions']} evictions, converged {a['converged']} "
        f"in {a['rounds']} round(s), drains settled in {a['drain_rounds']} "
        f"grace round(s), {a['wall']:.2f} s; cpu: {b['cycles']} cycles, "
        f"{b['stats']['evictions']} evictions, {b['wall']:.2f} s")
    for k in ("snaps", "promoted", "tasks", "final"):
        if a[k] != b[k]:
            raise AssertionError(f"phase 10a: {k} differ card vs cpu")
    if not a["stats"]["evictions"]:
        raise AssertionError("phase 10a: the loop evicted nothing")
    if not a["converged"] or a["pending"]:
        raise AssertionError(f"phase 10a: converged {a['converged']}, "
                             f"{a['pending']} pending drains")
    for r in (a, b):
        if r["faults"] or any(r["errors"].values()):
            raise AssertionError(f"phase 10a: contained faults "
                                 f"{r['faults']} {r['errors']}")

    store, crushed, _, census = restore_store(M, fleet, items[:n],
                                              results[:n])
    r = rebalance_loop(store, dev, "10a", verbose=False,
                       rounds=REBALANCE_AS_STATED_ROUNDS)
    need = [sum(c["drain_need"] for c in snap["clusters"].values())
            for snap in r["snaps"]]
    over = sum(c["drain_need"] > 0 for c in r["snaps"][-1]["clusters"].values())
    log(f"phase 10a as first specified: {census_line(census)}; crushed "
        f"{crushed}; {r['rounds']} round(s): converged "
        f"{r['converged']}, {r['stats']['evictions']} evictions, drain_need "
        f"by cycle {need}, {over} clusters over threshold")
    if r["faults"] or any(r["errors"].values()):
        raise AssertionError(f"phase 10a as first specified: contained "
                             f"faults {r['faults']} {r['errors']}")


def phase_kernel_k13(fleet, results, dev, reps, parent=None) -> dict:
    """K13 rebalance_score against its plain version: config 5's 5,000
    lanes (committed from phase 3's placements, capacity the fleet's
    pods) and 16,384 random lanes, with zero-capacity-with-load lanes,
    invalid lanes and negatives mixed in; thresholds 1000 and 800, spread
    tolerance off (the plane's sentinel) and 50."""
    from karmada_tpu_torch.ops import rebalance_detect as RD
    from karmada_tpu_torch.rebalance.plane import SPREAD_REPORT_ONLY

    g = np.random.default_rng(13)
    idx = {c.name: i for i, c in enumerate(fleet)}
    com = np.zeros(len(fleet), np.int64)
    for r in results:
        if isinstance(r, list):
            for t in r:
                com[idx[t.name]] += t.replicas
    cap = np.array([int(c.status.resource_summary.allocatable["pods"].value())
                    for c in fleet], np.int64)

    def mix(com, cap):
        C = len(com)
        com, cap = com.copy(), cap.copy()
        cap[g.random(C) < 0.02] = 0       # zero capacity, with load
        com[g.random(C) < 0.01] *= -1     # negatives (clamped)
        cap[g.random(C) < 0.01] *= -1
        valid = g.random(C) >= 0.03       # invalid lanes
        return [torch.from_numpy(a).to(dev) for a in (com, cap, valid)]

    cases = {5000: mix(com, cap),
             16384: mix(g.integers(0, 1 << 16, 16384),
                        g.integers(0, 1 << 12, 16384))}
    err = 0.0
    for C, ins in cases.items():
        for thr in (1000, 800):
            for tol in (SPREAD_REPORT_ONLY, 50):
                got = RD.score_kernel(*ins, thr, tol)
                want = RD.score_kernel_plain(*ins, thr, tol)
                e = max_abs_err(zip(got, want))
                log(f"phase 2 rebalance_score: C={C} threshold={thr} "
                    f"tolerance={tol} max_abs_err={e} drain_need total "
                    f"{int(got[0].sum())}")
                err = max(err, e)
    ins = cases[5000]
    args = (*ins, 1000, SPREAD_REPORT_ONLY)
    outs = RD.score_kernel(*args)
    b = bound_ms(nbytes(*ins) + nbytes(*outs), 0)
    row = dict(name="rebalance_score", route="cuda",
               source="karmada_tpu_torch/ops/csrc/rebalance.cu",
               replaces="karmada_tpu/ops/rebalance_detect.py:40",
               max_abs_err=err,
               ms=cuda_ms(lambda: RD.score_kernel(*args), reps),
               plain_ms=cuda_ms(lambda: RD.score_kernel_plain(*args), reps),
               bound_ms=b[0], bound_by=b[1], library_ms=None)
    ms16 = cuda_ms(lambda: RD.score_kernel(*cases[16384], 1000,
                                           SPREAD_REPORT_ONLY), reps)
    host, device = split_ms(lambda: RD.score_kernel(*args), 10 * reps)
    log(f"phase 2 rebalance_score split, the kernel on device operands "
        f"(C=5000): host enqueue {host:.4f} ms, device "
        + (f"{device:.4f} ms" if device is not None else "not measured"))
    # the whole call from numpy, as the rebalance plane's detect makes it
    host_ins = {C: [t.cpu().numpy() for t in ins]
                for C, ins in cases.items()}
    for C, h in host_ins.items():
        tm = {}
        got = RD.score(*h, 1000, SPREAD_REPORT_ONLY, device=dev, timing=tm)
        e = max_abs_err(zip((torch.from_numpy(x) for x in got),
                            RD.score_kernel_plain(*(torch.from_numpy(x)
                                                    for x in h), 1000,
                                                  SPREAD_REPORT_ONLY)))
        err = max(err, e)

        def call(h=h):
            return RD.score(*h, 1000, SPREAD_REPORT_ONLY, device=dev)

        host, device = split_ms(call, 10 * reps)
        log(f"phase 2 rebalance_score whole call (numpy to numpy) C={C}: "
            f"max_abs_err={e}, {host:.4f} ms a call (host clock, its sync "
            "included), device "
            + (f"{device:.4f} ms" if device is not None else "not measured")
            + f", kernel_ms {tm['kernel_ms']:.4f} (its events); "
            + by_text(kernel_device_ms(call, 10 * reps)))
    log(f"phase 2 rebalance_score: max_abs_err={err} ms={row['ms']:.4f} "
        f"(C=5000) ms={ms16:.4f} (C=16384) plain_ms={row['plain_ms']:.4f} "
        f"bound_ms={row['bound_ms']:.6f} ({row['bound_by']}) "
        f"library_ms=None (no single call)")
    row["max_abs_err"] = err
    if err != 0:
        raise AssertionError("rebalance_score disagrees with its plain "
                             "version")
    if parent is not None:
        ORD = parent["ops.rebalance_detect"]
        h = host_ins[5000]
        for name, fn in (("score_kernel", lambda m: m.score_kernel(*args)),
                         ("score", lambda m: m.score(
                             *h, 1000, SPREAD_REPORT_ONLY, device=dev))):
            for side, m in (("old", ORD), ("new", RD)):
                host, device = split_ms(lambda m=m, fn=fn: fn(m), 10 * reps)
                log(f"phase 2 turns K13 {name} split, {side}: host "
                    f"{host:.4f} ms, device "
                    + (f"{device:.4f} ms" if device is not None
                       else "not measured"))
        run_turns({
            "K13 score_kernel (C=5000, device operands)": (
                lambda: cuda_ms(lambda: ORD.score_kernel(*args), reps),
                lambda: cuda_ms(lambda: RD.score_kernel(*args), reps)),
            "K13 score whole call (C=5000, numpy to numpy; host clock)": (
                lambda: wall_ms(lambda: ORD.score(
                    *h, 1000, SPREAD_REPORT_ONLY, device=dev), reps),
                lambda: wall_ms(lambda: RD.score(
                    *h, 1000, SPREAD_REPORT_ONLY, device=dev), reps))},
            TURN_ROUNDS)
    return row


# -- phase 11: the native host paths -----------------------------------------

#: phase 11b's bindings through the C++ control (config 5's first ones)
NATIVE_CONTROL_BINDINGS = 10_000  # 25,000 until phase 12 took the time
NATIVE_SAMPLE = 64         # 11b's stride sample through ops/serial.schedule
                           # (256 until phase 14 took the time)
NATIVE_STORE_SAMPLE = 128  # 11c's stride sample


def strict_norm(r):
    """A decoded result as it stands: targets in order, with their class,
    or the exception's class, message and reason."""
    if isinstance(r, Exception):
        return (type(r).__name__, str(r), getattr(r, "reason", None))
    return [(type(t).__name__, t.name, t.replicas) for t in r]


def same_batch(a, b, what: str) -> None:
    """Every FIELD_DTYPES field and the routes of two batches equal."""
    from karmada_tpu_torch.ops import tensors as T

    if (a.B, a.C, a.n_bindings) != (b.B, b.C, b.n_bindings):
        raise AssertionError(f"{what}: batch shapes differ")
    for f in T.FIELD_DTYPES:
        x, y = getattr(a, f, None), getattr(b, f, None)
        if x is None and y is None:
            continue
        x, y = np.asarray(x), np.asarray(y)
        if x.dtype != y.dtype or not np.array_equal(x, y):
            raise AssertionError(f"{what}: field {f} differs")
    if not np.array_equal(a.route, b.route):
        raise AssertionError(f"{what}: routes differ")


def turns(fn, rounds=TURN_ROUNDS):
    """fn(native) timed in turns -- Python, C, C, Python -- `rounds` times:
    {native: [seconds, ...]}, {native: garbage-collector pause seconds
    inside those calls} and the last result of each side."""
    times, gcs, last = {False: [], True: []}, {False: 0.0, True: 0.0}, {}
    for _ in range(rounds):
        for native in (False, True, True, False):
            g0 = GC.seconds
            t0 = time.perf_counter()
            last[native] = fn(native)
            times[native].append(time.perf_counter() - t0)
            gcs[native] += GC.seconds - g0
    return times, gcs, last


def phase_native_turns(label, chunk, fleet, args, dev) -> dict:
    """11a: encode_batch on one chunk, the C path against native=False in
    turns (each side on its own EncoderCache, warmed by one untimed call:
    a later chunk of a cycle), every field and route equal; then
    decode_compact on the chunk's card COO the same way, outputs equal."""
    from karmada_tpu_torch import native
    from karmada_tpu_torch.estimator.general import GeneralEstimator
    from karmada_tpu_torch.ops import solver as PS
    from karmada_tpu_torch.ops import tensors as T

    cindex = T.ClusterIndex.build(fleet)
    est = GeneralEstimator()
    caches = {False: T.EncoderCache(), True: T.EncoderCache()}

    def enc(nat):
        return T.encode_batch(chunk, cindex, est, cache=caches[nat],
                              native=nat)

    warm = {nat: enc(nat) for nat in (False, True)}
    same_batch(warm[True], warm[False], f"11a {label} warm-up encode")
    native.reset_counts()
    enc_t, enc_gc, last = turns(enc)
    enc_counts = dict(native.COUNTS)
    for nat in (False, True):
        same_batch(last[nat], warm[False], f"11a {label} encode in turns")
    batch = warm[True]
    res = PS.solve_compact(batch, waves=args.waves, device=dev)
    torch.cuda.synchronize()
    idx, val, status = res[:3]

    def dec(nat):
        return T.decode_compact(batch, idx, val, status, items=chunk,
                                native=nat)

    native.reset_counts()
    dec_t, dec_gc, out = turns(dec)
    dec_counts = dict(native.COUNTS)
    ref = [strict_norm(r) for r in out[False]]
    if [strict_norm(r) for r in out[True]] != ref:
        raise AssertionError(f"11a {label}: decode C differs from Python")
    n = len(chunk)
    parts = []
    for what, t, g in (("encode", enc_t, enc_gc), ("decode", dec_t, dec_gc)):
        py, c = (1e3 * float(np.median(t[nat])) for nat in (False, True))
        parts.append(
            f"{what} in turns, median Python {py:.3f} ms ({n / py * 1e3:.0f} "
            f"bindings/s) -> C {c:.3f} ms ({n / c * 1e3:.0f}/s), "
            f"{py / c:.2f}x (means {1e3 * np.mean(t[False]):.3f} -> "
            f"{1e3 * np.mean(t[True]):.3f} ms; gc pauses inside the calls "
            f"{g[False]:.3f} / {g[True]:.3f} s); times (s) Python "
            f"{[round(x, 4) for x in t[False]]} C "
            f"{[round(x, 4) for x in t[True]]}")
    log(f"phase 11a {label}: {n} bindings x {len(fleet)} clusters (COO "
        f"{idx.size} entries, {idx.dtype}), {TURN_ROUNDS} rounds; "
        f"{parts[0]}; every field and route equal; {parts[1]}; outputs "
        "equal")
    log(native_line(f"11a {label} encode turns", enc_counts))
    log(native_line(f"11a {label} decode turns", dec_counts))
    if enc_counts["encode_c"] + enc_counts["encode_miss"] <= 0 or (
            dec_counts["decode_coo"] <= 0):
        raise AssertionError(f"11a {label}: the C paths did not run")


def serial_outcome(spec, status, clusters, cal):
    """ops/serial.schedule's answer as (native status, {name: replicas})."""
    from karmada_tpu_torch import native as N
    from karmada_tpu_torch.ops import serial

    try:
        want = serial.schedule(spec, status, clusters, cal)
    except serial.FitError:
        return N.STATUS_FIT_ERROR, {}
    except serial.UnschedulableError:
        return N.STATUS_UNSCHEDULABLE, {}
    except serial.NoClusterAvailableError:
        return N.STATUS_NO_CLUSTER, {}
    return N.STATUS_OK, {t.name: t.replicas for t in want}


def phase_native_control(items, fleet, n) -> dict:
    """11b: schedule_batch_native over config 5's first `n` forward
    bindings on the 5,000-cluster fleet: the snapshot, the marshaling and
    the C++ call timed apart, status counts, rows STATUS_UNSUPPORTED; a
    stride sample of NATIVE_SAMPLE through ops/serial.schedule equal,
    binding for binding."""
    from collections import Counter

    from karmada_tpu_torch import native as N
    from karmada_tpu_torch.estimator.general import GeneralEstimator
    from karmada_tpu_torch.ops import serial

    sub = items[:n]
    t0 = time.perf_counter()
    snap = N.NativeSnapshot(fleet, N.collect_res_names(sub))
    t1 = time.perf_counter()
    nb = N.marshal_batch(sub, snap)
    t2 = time.perf_counter()
    res = N.run_marshaled(nb, snap)
    t3 = time.perf_counter()
    names = {N.STATUS_OK: "ok", N.STATUS_FIT_ERROR: "fit_error",
             N.STATUS_UNSCHEDULABLE: "unschedulable",
             N.STATUS_NO_CLUSTER: "no_cluster",
             N.STATUS_UNSUPPORTED: "unsupported",
             N.STATUS_OVERFLOW: "overflow"}
    counts = Counter(names.get(st, str(st)) for st, _t in res)
    stride = max(1, n // NATIVE_SAMPLE)
    sample = list(range(0, n, stride))[:NATIVE_SAMPLE]
    cal = serial.make_cal_available([GeneralEstimator()])
    t4 = time.perf_counter()
    bad, compared = [], 0
    for i in sample:
        st, targets = res[i]
        if st == N.STATUS_UNSUPPORTED:
            continue
        want_st, want = serial_outcome(*sub[i], fleet, cal)
        compared += 1
        got = {t.name: t.replicas for t in targets}
        if st != want_st or (st == N.STATUS_OK and got != want):
            bad.append(i)
    serial_s = time.perf_counter() - t4
    log(f"phase 11b native control: {n} bindings x {len(fleet)} clusters: "
        f"snapshot {t1 - t0:.3f} s, marshal {t2 - t1:.3f} s, C++ call "
        f"{t3 - t2:.3f} s ({n / (t3 - t2):.0f} bindings/s; "
        f"{n / (t3 - t0):.0f}/s with snapshot and marshaling); statuses "
        f"{dict(counts)}, STATUS_UNSUPPORTED rows {counts['unsupported']}; "
        f"ops/serial.schedule on a stride sample of {len(sample)} "
        f"({compared} compared): {serial_s:.2f} s "
        f"({compared / max(serial_s, 1e-9):.1f} bindings/s), "
        f"{len(bad)} differ")
    if bad:
        raise AssertionError(f"11b: native control differs from "
                             f"serial.schedule at bindings {bad[:10]}")
    if counts["overflow"]:
        raise AssertionError("11b: output overflow")
    return {"bindings": n, "call_s": t3 - t2,
            "per_s": n / (t3 - t2), "whole_s": t3 - t0}


def phase_native_store(M, fleet, items, results) -> None:
    """11c: a Scheduler(backend="native") on phase 10a's store recipe --
    the first REBALANCE_PARITY_BINDINGS bindings' fleet restored converged
    with no headroom and its crushed clusters -- with those bindings
    created unscheduled, no rebalance; ticks until every binding carries
    a Scheduled condition and nothing waits in the active queue.  No
    contained fault; on a stride sample of NATIVE_STORE_SAMPLE, every
    binding scheduled or failed as ops/serial.schedule says on the
    store's clusters."""
    from karmada_tpu_torch.estimator.general import GeneralEstimator
    from karmada_tpu_torch.ops import serial
    from karmada_tpu_torch.scheduler import Scheduler, SchedulingQueue
    from karmada_tpu_torch.store import ObjectStore, Runtime

    n = REBALANCE_PARITY_BINDINGS
    recipe, crushed, _, _ = restore_store(M, fleet, items[:n], results[:n],
                                          converged=True)
    store, rt, clock = ObjectStore(), Runtime(), FakeClock()
    for c in recipe.list("Cluster"):
        store.create(c)
    t0 = time.perf_counter()
    sched = Scheduler(store, rt, backend="native",
                      queue=SchedulingQueue(now=clock))
    build_s = time.perf_counter() - t0
    for spec, status in items[:n]:
        store.create(M.ResourceBinding(
            metadata=M.ObjectMeta(namespace=spec.resource.namespace,
                                  name=spec.resource.name),
            spec=dataclasses.replace(spec), status=status))
    t0 = time.perf_counter()
    ticks = 0
    while ticks < 20:
        clock.advance(1.0)
        rt.tick()
        ticks += 1
        rbs = store.list("ResourceBinding")
        if (all(any(c.type == "Scheduled" for c in rb.status.conditions)
                for rb in rbs) and sched.queue.depths()["active"] == 0):
            break
    wall = time.perf_counter() - t0
    rbs = {(rb.namespace, rb.name): rb for rb in store.list("ResourceBinding")}
    clusters = store.list("Cluster")
    cal = serial.make_cal_available([GeneralEstimator()])
    stride = max(1, n // NATIVE_STORE_SAMPLE)
    bad = []
    for i in list(range(0, n, stride))[:NATIVE_STORE_SAMPLE]:
        spec, status = items[i]
        rb = rbs[(spec.resource.namespace, spec.resource.name)]
        want_st, want = serial_outcome(spec, status, clusters, cal)
        cond = [c for c in rb.status.conditions if c.type == "Scheduled"]
        placed = bool(cond) and cond[-1].status == "True"
        got = {t.name: t.replicas for t in rb.spec.clusters}
        if placed != (want_st == 0) or (placed and got != want):
            bad.append(i)
    cycles = list(sched.cycle_log)
    stage = {k: sum(c[k] for c in cycles)
             for k in ("native_marshal_s", "native_s", "serial_s")}
    placed = sum(any(c.type == "Scheduled" and c.status == "True"
                     for c in rb.status.conditions) for rb in rbs.values())
    log(f"phase 11c native Scheduler: {n} bindings x {len(clusters)} "
        f"clusters (crushed {crushed}), g++ warm-up at construction "
        f"{build_s:.3f} s; {ticks} tick(s) in {wall:.2f} s, "
        f"{len(cycles)} cycle(s) (backends "
        f"{sorted({c['backend'] for c in cycles})}), host seconds "
        f"{ {k: round(v, 3) for k, v in stage.items()} }; {placed} placed, "
        f"queue {sched.queue.depths()}; faults {sched.faults()}; sample of "
        f"{len(range(0, n, stride)[:NATIVE_STORE_SAMPLE])} against "
        f"serial.schedule: {len(bad)} differ")
    if sched.faults() or any(rt.reconcile_errors().values()):
        raise AssertionError(f"11c: contained faults {sched.faults()} "
                             f"{rt.reconcile_errors()}")
    if sched.queue.depths()["active"] or len(rbs) != n:
        raise AssertionError(f"11c: still pending {sched.queue.depths()}")
    if bad:
        raise AssertionError(f"11c: bindings {bad[:10]} differ from "
                             "serial.schedule")
    if not stage["native_s"]:
        raise AssertionError("11c: the native control never ran")


# -- phase 12: the propagation loop on the card -------------------------------

LOOP_PARITY_MEMBERS = 64      # 12a
LOOP_PARITY_TEMPLATES = 512
LOOP_MEMBERS = 5_000          # 12b: config 5's fleet
LOOP_TEMPLATES = 4_096        # one chunk of config 5's forward mix
LOOP_TICKS = 40
LOOP_OVERRIDDEN = (0, 8, 16, 24)  # placements whose templates get an override
LOOP_SAMPLE = 64              # unscheduled bindings checked on the serial path
_LOOP_CLEARED = frozenset({
    "uid", "resource_version", "resourceVersion", "creation_timestamp",
    "creationTimestamp", "deletion_timestamp", "last_transition_time",
    "last_scheduled_time", "renew_time"})


class UidSeq:
    """The port store's uids from a counter while the block runs: a
    template's uid breaks the scheduler's ties (Webster, spread), so two
    planes built alike must hand out the same ones."""

    def __enter__(self):
        from karmada_tpu_torch.store import store as store_mod

        self.mod, self.saved = store_mod, store_mod.new_uid
        seq = iter(range(1, 1 << 62))
        store_mod.new_uid = lambda: f"uid-{next(seq):08d}"
        return self

    def __exit__(self, *exc):
        self.mod.new_uid = self.saved


def loop_template(b, spec, n_placements):
    """Binding b of config 5's forward mix as the Deployment a user
    applies: its namespace, replicas and requests (memory in Gi, as the
    members' capacity is), labelled with its placement."""
    req = spec.replica_requirements.resource_request
    return {
        "apiVersion": "apps/v1", "kind": "Deployment",
        "metadata": {"name": spec.resource.name,
                     "namespace": spec.resource.namespace,
                     "labels": {"placement": f"p{b % n_placements}"}},
        "spec": {"replicas": spec.replicas, "template": {"spec": {
            "containers": [{"name": "app",
                            "image": "registry.example/app:1.0",
                            "resources": {"requests": {
                                "cpu": f"{req['cpu'].milli}m",
                                "memory": f"{int(req['memory'].value())}Gi",
                            }}}]}}}}


def pinned_room(placements, items) -> dict:
    """The pods the capacity-blind placements pin on each member: every
    Duplicated template's replicas, and every StaticWeight template's
    replicas whole (a bound over any split, also after a member of the
    affinity fails), on each member their affinity names (give_room)."""
    room = {}
    for b, (spec, _st) in enumerate(items):
        p = placements[b % len(placements)]
        rs = p.replica_scheduling
        aff = p.cluster_affinity
        if aff is None or rs is None:
            continue
        if rs.replica_scheduling_type == "Duplicated" or (
                rs.replica_division_preference == "Weighted"
                and rs.weight_preference is None):
            for n in aff.cluster_names:
                room[n] = room.get(n, 0) + spec.replicas
    return room


def build_loop(M, dev, fleet, placements, items, **cp_kw):
    """A ControlPlane on `dev` (config 5's chunk, waves and batch window)
    on a FakeClock that only the phase moves (`cp.clock`), with `fleet`
    joined as members (allocatable cpu, memory in Gi and pods, region,
    provider; nothing running) and ticked once (the lifecycle's finalizers
    and execution spaces, the first heartbeat Leases), one
    ClusterPropagationPolicy a placement selecting its templates by
    label, an image override on the templates of LOOP_OVERRIDDEN's
    placements for members in regions r0 and r1, and `items` applied as
    Deployments.  Returns the plane and the seconds of each step.

    The scheduling queue's backoffs read the plane's clock too (the
    ControlPlane's own queue reads the wall clock); run_loop moves the
    clock past them.  `cp_kw` goes to the ControlPlane (phase 13d's
    guard, the rebalance plane of phases 12b and 14)."""
    import copy

    from karmada_tpu_torch.e2e import ControlPlane

    t0 = time.perf_counter()
    cp = ControlPlane(device=dev, pipeline_chunk=4096, waves=8,
                      batch_window=4096, clock=FakeClock(), **cp_kw)
    cp._lease_writes = LeaseWrites(cp.store)
    cp.scheduler.queue.now = cp.clock
    for c in fleet:
        a = c.status.resource_summary.allocatable
        cp.add_member(c.name, cpu_milli=a["cpu"].milli,
                      memory_gi=int(a["memory"].value()),
                      pods=int(a["pods"].value()), region=c.spec.region,
                      provider=c.spec.provider, collect=False)
    t1 = time.perf_counter()
    cp.cluster_status.collect_all()
    cp.tick(rounds=1)
    t2 = time.perf_counter()
    for p, placement in enumerate(placements):
        cp.apply_policy(M.ClusterPropagationPolicy(
            metadata=M.ObjectMeta(name=f"placement-{p}"),
            spec=M.PropagationSpec(
                resource_selectors=[M.ResourceSelector(
                    api_version=GVK[0], kind=GVK[1],
                    label_selector=M.LabelSelector(
                        match_labels={"placement": f"p{p}"}))],
                placement=copy.deepcopy(placement))))
    for p in LOOP_OVERRIDDEN:
        cp.apply_policy(M.ClusterOverridePolicy(
            metadata=M.ObjectMeta(name=f"mirror-{p}"),
            spec=M.OverrideSpec(
                resource_selectors=[M.ResourceSelector(
                    api_version=GVK[0], kind=GVK[1],
                    label_selector=M.LabelSelector(
                        match_labels={"placement": f"p{p}"}))],
                override_rules=[M.RuleWithCluster(
                    target_cluster=M.ClusterAffinity(
                        field_selector=M.FieldSelector(match_expressions=[
                            M.FieldSelectorRequirement(
                                key=M.REGION_FIELD, operator="In",
                                values=["r0", "r1"])])),
                    overriders=M.Overriders(image_overrider=[
                        M.ImageOverrider(component="Registry",
                                         operator="replace",
                                         value="mirror.example")]))])))
    t3 = time.perf_counter()
    for b, (spec, _st) in enumerate(items):
        cp.apply(loop_template(b, spec, len(placements)))
    t4 = time.perf_counter()
    return cp, {"join_s": t1 - t0, "collect_tick_s": t2 - t1,
                "policies_s": t3 - t2, "templates_s": t4 - t3}


class LoopClock:
    """Host seconds of one ControlPlane by controller: each worker's
    reconciles (a write's watch handlers run inside the writer, so the
    scheduler's Cluster-event scan is inside the collector's seconds and
    is also read apart), each periodic hook, and the members' ticks."""

    def __init__(self, cp):
        self.s: dict = {}
        for w in cp.runtime.workers:
            w.reconcile = self._wrap(w.name, w.reconcile)
        names = {cp.scheduler._periodic_flush: "scheduler-flush",
                 cp.cluster_status.collect_all: "cluster-status",
                 cp.graceful_eviction.resync: "eviction-resync",
                 cp.lease_monitor.check_all: "cluster-lease",
                 cp.cluster_lifecycle._resync_deleting: "lifecycle-resync",
                 cp.taint_manager._flush_deadlines: "taint-manager-flush",
                 cp.eviction_queue.drain: "eviction-queue",
                 cp.app_failover.run_once: "application-failover"}
        if cp.scheduler.rebalance_plane is not None:
            names[cp.scheduler.rebalance_plane.maybe_run] = "rebalance"
        periodic = cp.runtime._periodic  # noqa: SLF001 — the harness's probe
        periodic[:] = [self._wrap(names.get(fn, "periodic"), fn)
                       for fn in periodic]
        for m in cp.members.values():
            m.tick = self._wrap("members", m.tick)

    def _wrap(self, name, fn):
        def timed(*a):
            t0 = time.perf_counter()
            try:
                return fn(*a)
            finally:
                self.s[name] = self.s.get(name, 0.0) + time.perf_counter() - t0
        return timed

    def take(self) -> dict:
        out, self.s = self.s, {}
        return out


class LeaseWrites:
    """The Lease writes of one plane's store (a watch on kind Lease): the
    collectors renew every cluster's Lease on the wall clock each round,
    and a heartbeat is not a change of the loop's state."""

    def __init__(self, store) -> None:
        self.n = 0
        store.bus.subscribe(self, kind="Lease")

    def __call__(self, _event) -> None:
        self.n += 1


#: host seconds and calls of the collectors' Lease renewals since the
#: last take (controllers/lease.renew_cluster_lease, timed by
#: time_renewals; they run inside the "cluster-status" seconds)
RENEWALS = {"s": 0.0, "n": 0}


def time_renewals() -> None:
    """Wrap controllers/lease.renew_cluster_lease (the collector imports
    it at each collect) to count its calls and host seconds in RENEWALS;
    once a process."""
    from karmada_tpu_torch.controllers import lease as lease_mod

    renew = lease_mod.renew_cluster_lease
    if getattr(renew, "timed", False):
        return

    def timed(*a, **kw):
        t0 = time.perf_counter()
        try:
            return renew(*a, **kw)
        finally:
            RENEWALS["s"] += time.perf_counter() - t0
            RENEWALS["n"] += 1
    timed.timed = True
    lease_mod.renew_cluster_lease = timed


def take_renewals() -> tuple:
    out = (RENEWALS["n"], RENEWALS["s"])
    RENEWALS["n"], RENEWALS["s"] = 0, 0.0
    return out


def loop_revision(cp) -> int:
    """Writes of the plane and of its members, less the plane's Lease
    writes (build_loop arms the count)."""
    return (cp.store.revision - cp._lease_writes.n
            + sum(m.store.revision for m in cp.members.values()))


def run_loop(cp, label, verbose, max_ticks=LOOP_TICKS):
    """cp.tick(rounds=1) until a tick changes nothing (no write in the
    control plane or a member) or max_ticks; one line a tick with the
    host seconds by controller, the scheduler cycles' stage seconds, the
    Cluster-event scans and the collector's pauses (a tick's line also
    holds what pass_time drained before it).  A tick that changes
    nothing while the scheduling queue holds bindings in backoff moves
    the plane's clock past the longest backoff and ticks again: the
    loop is quiescent when a tick changes nothing with no backoff left,
    or right after such a move.  Returns (ticks, converged, wall).  The
    host seconds are taken by one LoopClock a plane, made at its first
    run."""
    clock = getattr(cp, "_host_seconds", None) or LoopClock(cp)
    cp._host_seconds = clock
    if not hasattr(cp, "_renewals"):
        cp._renewals = (0, 0.0)  # (calls, host seconds) in the loop's ticks
    time_renewals()
    take_renewals()
    log_ = cp.scheduler.cycle_log
    seen = log_[-1]["cycle_id"] if log_ else 0
    ticks, converged, moved = 0, False, False
    queue = cp.scheduler.queue
    t_loop = time.perf_counter()
    while ticks < max_ticks:
        rev = loop_revision(cp)
        ev0, evs0 = cp.scheduler.cluster_events, cp.scheduler.cluster_event_s
        GC.reset()
        t0 = time.perf_counter()
        n = cp.tick(rounds=1)
        if cp.scheduler.device is not None and \
                cp.scheduler.device.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ticks += 1
        split = clock.take()
        renewals = take_renewals()
        cp._renewals = (cp._renewals[0] + renewals[0],
                        cp._renewals[1] + renewals[1])
        cycles = [c for c in cp.scheduler.cycle_log if c["cycle_id"] > seen]
        if cycles:
            seen = cycles[-1]["cycle_id"]
        if verbose:
            stages = {k: round(sum(c[k] for c in cycles), 3) for k in (
                "wall_s", "encode_s", "dispatch_s", "wait_s", "finalize_s",
                "decode_s", "spread_s", "big_s")}
            log(f"phase {label} tick {ticks}: {n} reconciles, wall "
                f"{wall:.3f} s; by controller "
                f"{ {k: round(v, 3) for k, v in sorted(split.items())} }; "
                f"{len(cycles)} scheduler cycle(s) "
                f"({sum(c['bindings'] for c in cycles)} bindings) {stages}; "
                f"Cluster events {cp.scheduler.cluster_events - ev0} "
                f"scanned in {cp.scheduler.cluster_event_s - evs0:.3f} s; "
                f"Lease renewals {renewals[0]} in {renewals[1]:.3f} s; "
                f"{GC.line()}")
        if loop_revision(cp) != rev:
            moved = False
        elif moved or not queue.depths()["backoff"]:
            converged = True
            break
        elif ticks < max_ticks:
            cp.clock.advance(queue.max_backoff_s)
            moved = True
    return ticks, converged, time.perf_counter() - t_loop


def loop_norm(v):
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return {f.name: (None if f.name in _LOOP_CLEARED
                         else loop_norm(getattr(v, f.name)))
                for f in dataclasses.fields(v)}
    if isinstance(v, dict):
        return {k: (None if k in _LOOP_CLEARED else loop_norm(x))
                for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [loop_norm(x) for x in v]
    return v


def loop_snapshot(cp) -> dict:
    """Every control-plane object and every member's, normalized: uids,
    resourceVersions, timestamps and condition times cleared."""
    out = {(o.KIND, o.metadata.namespace, o.metadata.name): loop_norm(o)
           for o in cp.store.visit_all()}
    for name, m in cp.members.items():
        for o in m.store.visit_all():
            out[(name, o.KIND, o.metadata.namespace, o.metadata.name)] = \
                loop_norm(o)
    return out


def loop_faults(cp) -> dict:
    errs = {k: v for k, v in cp.runtime.reconcile_errors().items() if v}
    return {"scheduler": cp.scheduler.faults(), "reconcile": errs,
            "sync_failures": cp.execution.sync_failures}


def parity_recipe(M, fleet, items, seed, templates) -> tuple:
    """12a's, 14a's and 15a's inputs: the first LOOP_PARITY_MEMBERS
    members, placements drawn over their names, the first `templates`
    templates."""
    fleet = fleet[:LOOP_PARITY_MEMBERS]
    return (fleet, build_placements(M, random.Random(seed),
                                    [c.name for c in fleet]),
            items[:templates])


def submit_loop_parity(refs, M, fleet, items, seed) -> None:
    """The CPU halves of 12a, 14a and 15a to the child."""
    refs.submit("12a", loop_parity_run, None, *parity_recipe(
        M, fleet, items, seed, LOOP_PARITY_TEMPLATES))
    refs.submit("14a", failover_parity_run, None, *parity_recipe(
        M, fleet, items, seed, LOOP_PARITY_TEMPLATES))
    refs.submit("15a", descheduler_parity_run, None, *parity_recipe(
        M, fleet, items, seed, FACADE_PARITY_TEMPLATES))


def loop_parity_run(dev, fleet, placements, items) -> tuple:
    """12a on `dev` (None: the CPU, in the child): the plane built and
    ticked to quiescence; (snapshot, (ticks, converged, wall, faults,
    backends, device type))."""
    dev = dev or torch.device("cpu")
    with UidSeq():
        cp, _steps = build_loop(models(), dev, fleet, placements, items)
        ticks, converged, wall = run_loop(cp, "12a", verbose=False)
    return loop_snapshot(cp), (
        ticks, converged, wall, loop_faults(cp),
        [c["backend"] for c in cp.scheduler.cycle_log],
        cp.scheduler.device.type)


def phase_loop_parity(M, fleet, items, dev, seed, refs) -> None:
    """12a: the first LOOP_PARITY_MEMBERS members and
    LOOP_PARITY_TEMPLATES templates (config 5's build functions; the placements
    drawn over these members' names), a ControlPlane on the card against
    the same with device="cpu" (in the child, submit_loop_parity), ticked
    to quiescence: equal snapshots."""
    recipe = parity_recipe(M, fleet, items, seed, LOOP_PARITY_TEMPLATES)
    fleet = recipe[0]
    snaps, runs = {}, {}
    snaps["cuda"], runs["cuda"] = loop_parity_run(dev, *recipe)
    snaps["cpu"], runs["cpu"] = refs.result("12a")
    a, b = snaps["cuda"], snaps["cpu"]
    diff = sorted((k for k in set(a) | set(b) if a.get(k) != b.get(k)),
                  key=repr)
    kinds = {}
    for k in a:
        kind = k[0] if len(k) == 3 else "member " + k[1]
        kinds[kind] = kinds.get(kind, 0) + 1
    log(f"phase 12a loop parity: {len(fleet)} members x "
        f"{LOOP_PARITY_TEMPLATES} templates; card {runs['cuda'][:3]}, cpu "
        f"{runs['cpu'][:3]} (ticks, converged, wall s); snapshot "
        f"{len(a)} objects {kinds}; differing {len(diff)}")
    for t, r in runs.items():
        if not r[1] or any(r[3].values()) or set(r[4]) != {"device"} \
                or r[5] != t:
            raise AssertionError(f"phase 12a {t}: converged {r[1]}, faults "
                                 f"{r[3]}, backends {set(r[4])}, device "
                                 f"{r[5]}")
    if diff:
        raise AssertionError(f"phase 12a: {len(diff)} objects differ card "
                             f"vs cpu, first {diff[:4]}")


def phase_loop(M, fleet, placements, items, dev) -> dict:
    """12b: the loop at config 5's fleet width on the card -- every member
    of `fleet`, `items` as templates -- ticked until a tick changes
    nothing (at most LOOP_TICKS).  Every binding scheduled or failed as
    the serial path says (a sample of the failed), member replicas summing
    to each binding's targets, readyReplicas reflected on every template,
    no contained fault, K1-K4 launched.  Returns the launch counts."""
    from karmada_tpu_torch import native
    from karmada_tpu_torch.estimator.general import GeneralEstimator
    from karmada_tpu_torch.ops import kernels, serial

    t0 = time.perf_counter()
    with UidSeq():
        cp, steps = build_loop(M, dev, fleet, placements, items,
                               rebalance=30.0, rebalance_cfg=rebalance_cfg())
    log(f"phase 12b loop built: {len(fleet)} members, {len(placements)} "
        f"policies, {len(LOOP_OVERRIDDEN)} overrides, {len(items)} "
        f"templates; host seconds "
        f"{ {k: round(v, 3) for k, v in steps.items()} }")
    torch.cuda.synchronize()
    kernels.reset_counts()
    native.reset_counts()
    ticks, converged, wall = run_loop(cp, "12b", verbose=True)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    log(native_line("12b", native.COUNTS))
    check_native("12b", native.COUNTS, need_coo=False)
    t1 = time.perf_counter()
    rbs = cp.store.visit("ResourceBinding")
    works = cp.store.counts_by_kind().get("Work", 0)
    applied = sum(len(m.store) for m in cp.members.values())
    bad, unplaced, ready_full = [], [], 0
    for rb in rbs:
        ref = rb.spec.resource
        cond = [c for c in rb.status.conditions if c.type == "Scheduled"]
        if not cond:
            bad.append(f"{rb.name}: no Scheduled condition")
            continue
        if cond[-1].status != "True":
            unplaced.append(rb)
            continue
        want = sum(t.replicas for t in rb.spec.clusters)
        got = ready = 0
        for t in rb.spec.clusters:
            obj = cp.member(t.name).get(ref.kind, ref.namespace, ref.name)
            if obj is None:
                bad.append(f"{rb.name}: nothing applied on {t.name}")
                continue
            got += obj.manifest["spec"]["replicas"]
            ready += (obj.manifest.get("status") or {}).get(
                "readyReplicas", 0)
        if got != want:
            bad.append(f"{rb.name}: members run {got} != {want}")
        tpl = cp.store.get(ref.kind, ref.namespace, ref.name)
        st = tpl.manifest.get("status") or {}
        if st.get("readyReplicas") != ready:
            bad.append(f"{rb.name}: template readyReplicas "
                       f"{st.get('readyReplicas')} != members' {ready}")
        ready_full += ready == tpl.manifest["spec"]["replicas"]
    clusters = cp.store.list("Cluster")
    cal = serial.make_cal_available([GeneralEstimator()])
    for rb in unplaced[:LOOP_SAMPLE]:
        try:
            serial.schedule(rb.spec, rb.status, clusters, cal)
            bad.append(f"{rb.name}: unscheduled but serial.schedule places "
                       "it")
        except Exception:  # noqa: BLE001 — the expected outcome
            pass
    faults = loop_faults(cp)
    log(f"phase 12b propagation loop: converged {converged} in {ticks} "
        f"tick(s), loop wall {wall:.2f} s; {len(rbs)} bindings "
        f"({len(rbs) - len(unplaced)} scheduled, {len(unplaced)} not, "
        f"{min(len(unplaced), LOOP_SAMPLE)} of those checked on the serial "
        f"path); {works} Works, {applied} member objects applied; "
        f"{ready_full} templates fully ready; faults {faults}; checks "
        f"{time.perf_counter() - t1:.2f} s, phase "
        f"{time.perf_counter() - t0:.2f} s; launches {launches}")
    if not converged:
        bad.append(f"not quiescent after {ticks} ticks")
    if len(rbs) != len(items):
        bad.append(f"{len(rbs)} bindings for {len(items)} templates")
    if faults["scheduler"] or faults["reconcile"] or \
            faults["sync_failures"]:
        bad.append(f"contained faults {faults}")
    for k in ("capacity", "schedule_rows", "webster_batch", "compact"):
        if launches[k] <= 0:
            bad.append(f"kernel {k} never launched")
    plane = cp.scheduler.rebalance_plane
    drained = plane.stats()["evictions"]
    if drained:
        log(f"phase 12b: the rebalance plane drained {drained} replica "
            f"allotment(s) in {plane.stats()['cycles']} detect(s)")
    if bad:
        raise AssertionError(f"phase 12b: {len(bad)} failed checks: "
                             + "; ".join(bad[:8]))
    return launches, cp


# -- phase 14: failover and rebalance on the member model ---------------------

FAILOVER_FAILED = 4           # 14a: members that fail
FAILOVER_CRUSHED = 2          # 14a: members crushed to 60% of their pods
MEMBER_CRUSHED = 8            # 14b (10b's count)
CRUSH_MILLI = 600             # a crushed member keeps 60% of the pods it holds
FAILOVER_STEP_S = 30.0
TOLERATION_S = 300.0          # the default not-ready / unreachable toleration
SETTLE_ROUNDS = 40


#: 14c's ClusterTaintPolicy: a NoSchedule taint while a member is not
#: Ready.  The not-ready taint the taint controller adds is NoExecute
#: only, and the defaulted 300 s not-ready toleration tolerates it in the
#: scheduler's filter, so without this policy a Duplicated binding's
#: re-solve puts replicas back on failed members whose eviction drained.
OUTAGE_TAINT_POLICY = {
    "apiVersion": "policy.karmada.io/v1alpha1", "kind": "ClusterTaintPolicy",
    "metadata": {"name": "unschedulable-while-not-ready"},
    "spec": {
        "addOnConditions": [{"conditionType": "Ready", "operator": "In",
                             "statusValues": ["False", "Unknown"]}],
        "removeOnConditions": [{"conditionType": "Ready", "operator": "In",
                                "statusValues": ["True"]}],
        "taints": [{"key": "outage.example.io/not-ready",
                    "effect": "NoSchedule"}]}}


def failover_busy(cp) -> dict:
    """What the failover loop still has in flight: queued evictions,
    tolerations waiting out their deadline, graceful eviction tasks."""
    tasks = sum(len(rb.spec.graceful_eviction_tasks)
                for rb in cp.store.visit("ResourceBinding"))
    return {"queued": cp.eviction_queue.pending(),
            "deadlines": len(cp.taint_manager._pending),  # noqa: SLF001
            "tasks": tasks}


def pass_time(cp, seconds: float) -> None:
    """Move the plane's clock `seconds` forward, a second at a time, with
    the rate-limited eviction queue drained at each second, as its
    periodic hook drains it every half second in serve mode: the queue
    evicts at its pace over the time that passed, and the next tick
    re-places what it evicted.  Its seconds join the "eviction-queue"
    reading of the next tick's line."""
    t0 = time.perf_counter()
    whole = int(seconds)
    for _ in range(whole):
        cp.clock.advance(1.0)
        cp.eviction_queue.drain()
    if seconds > whole:
        cp.clock.advance(seconds - whole)
    clock = getattr(cp, "_host_seconds", None)
    if clock is not None:
        clock.s["eviction-queue"] = (clock.s.get("eviction-queue", 0.0)
                                     + time.perf_counter() - t0)


def settle_failover(cp, label, verbose, first_step_s):
    """Pass `first_step_s` of the plane's time (pass_time), then
    FAILOVER_STEP_S a round, ticking to quiescence each round, until no
    eviction is queued or waiting and every graceful eviction task
    drained (at most SETTLE_ROUNDS rounds, the last ones past the grace
    period).  The eviction queue drains at its own rate (the
    ControlPlane's default, 100 a second) a second at a time within each
    round.  Returns (rounds, quiescent every round, busy at the end)."""
    step, rounds, quiet = first_step_s, 0, True
    while rounds < SETTLE_ROUNDS:
        pass_time(cp, step)
        _ticks, converged, _wall = run_loop(cp, label, verbose)
        quiet = quiet and converged
        rounds += 1
        busy = failover_busy(cp)
        if not any(busy.values()):
            break
        # only drains waiting on their grace left: step past it
        step = (REBALANCE_GRACE_S if not busy["queued"]
                and not busy["deadlines"] and rounds >= 4
                else FAILOVER_STEP_S)
    return rounds, quiet, failover_busy(cp)


def settle_rebalance(cp, label, verbose, detects0):
    """Advance the plane's clock and tick, a tick at a time, until the
    rebalance plane converged in a detect after `detects0` with every
    drain settled (at most REBALANCE_ROUNDS ticks): FAILOVER_STEP_S a
    tick, or past the grace period while the plane is converged with
    drains pending; then tick to quiescence.  Returns (ticks, grace
    ticks, quiescent at the end, the last converged detect's
    snapshot)."""
    plane = cp.scheduler.rebalance_plane
    ticks = grace = 0
    snap = {}
    while ticks < REBALANCE_ROUNDS:
        detected = plane.stats()["cycles"] > detects0
        if detected and plane.converged():
            snap = plane.stats()["last"]
            if not plane.pending_drains():
                break
            cp.clock.advance(REBALANCE_GRACE_S)
            grace += 1
        else:
            cp.clock.advance(FAILOVER_STEP_S)
        run_loop(cp, label, verbose, max_ticks=1)
        ticks += 1
    _t, quiet, _w = run_loop(cp, label, verbose)
    return ticks, grace, quiet, snap


def divided_load(cp):
    """Divided replicas by member, and the members a Duplicated or
    StaticWeight affinity names (a re-solve puts those placements back,
    and Duplicated load is never drained)."""
    from karmada_tpu_torch.ops import serial

    div, pinned = {}, set()
    for rb in cp.store.visit("ResourceBinding"):
        strat = serial.strategy_type(rb.spec)
        aff = rb.spec.placement.cluster_affinity if rb.spec.placement \
            else None
        if aff is not None and strat in (serial.DUPLICATED,
                                         serial.STATIC_WEIGHT):
            pinned.update(aff.cluster_names)
        if strat != serial.DUPLICATED:
            for t in rb.spec.clusters:
                div[t.name] = div.get(t.name, 0) + t.replicas
    return div, pinned


def give_room(cp, label, placements, items) -> dict:
    """Before a crush on the member model (14a, 14b): every member a
    Duplicated or StaticWeight affinity names gets pinned_room's pods on
    top of those it was configured with, through the member model
    (`pods_allocatable`; the collector reports it).  The rebalance plane
    converges only when no cluster is over its capacity, and it never
    drains Duplicated load: a member that capacity-blind placements alone
    put over capacity would keep a drain need no eviction meets.  Logs
    those members (over with the pinned replicas the store holds there
    alone, against their configured pods) apart.  Returns the room."""
    from karmada_tpu_torch.ops import serial

    held = {}
    for rb in cp.store.visit("ResourceBinding"):
        if serial.strategy_type(rb.spec) in (serial.DUPLICATED,
                                             serial.STATIC_WEIGHT):
            for t in rb.spec.clusters:
                held[t.name] = held.get(t.name, 0) + t.replicas
    over = sorted((m, n, cp.member(m).pods_allocatable)
                  for m, n in held.items()
                  if n > cp.member(m).pods_allocatable)
    room = pinned_room(placements, items)
    for m, pods in room.items():
        cp.member(m).pods_allocatable += pods
    # reported before any detect reads the fleet (a tick runs the
    # rebalance plane's detect before the collector)
    cp.cluster_status.collect_all()
    _t, quiet, _w = run_loop(cp, label, verbose=False)
    log(f"phase {label}: {len(over)} members over their configured pods "
        f"with capacity-blind (Duplicated, StaticWeight) replicas alone, "
        f"(member, pinned, pods) first {over[:4]}; {len(room)} members "
        f"an affinity of those names given {sum(room.values())} pods "
        f"more through the member model; quiescent {quiet}")
    return room


def crush_members(cp, n):
    """The `n` members with the most Divided replicas among those no
    Duplicated or StaticWeight affinity names, their allocatable pods
    crushed to CRUSH_MILLI/1000 of the pods they hold (the member model:
    the collector reports it).  Returns [(name, held, kept)]."""
    div, pinned = divided_load(cp)
    names = [m for m in sorted(div, key=lambda m: (-div[m], m))
             if m not in pinned][:n]
    out = []
    for m in names:
        member = cp.member(m)
        held = member.used_milli()["pods"] // 1000
        member.pods_allocatable = held * CRUSH_MILLI // 1000
        out.append((m, held, member.pods_allocatable))
    return out


def record_promotions(cp) -> list:
    """The (key, origin) of every promotion the Scheduler takes from here
    on (the rebalance plane promotes what it evicts)."""
    sched, seen = cp.scheduler, []
    promote = sched.promote

    def record(key, priority=0, origin="rebalance"):
        seen.append((key, origin))
        return promote(key, priority=priority, origin=origin)
    sched.promote = record
    return seen


def failover_run(M, dev, fleet, placements, items) -> tuple:
    """14a's steps on `dev`: the plane built and ticked to quiescence;
    FAILOVER_FAILED members failed; the clock past the toleration and the
    eviction pacing; the members recovered; FAILOVER_CRUSHED members
    crushed and the rebalance plane converged with every drain settled.
    Returns the steps [(name, snapshot, quiescent, faults)], the plane and
    what each step did."""
    steps, notes = [], {}
    with UidSeq():
        cp, _ = build_loop(M, dev, fleet, placements, items, rebalance=30.0,
                           rebalance_cfg=rebalance_cfg())
        seen = record_promotions(cp)

        def step(name, quiet):
            steps.append((name, loop_snapshot(cp), quiet, loop_faults(cp)))

        _t, quiet, _w = run_loop(cp, "14a", verbose=False)
        step("built", quiet)
        held = {}
        for rb in cp.store.visit("ResourceBinding"):
            for t in rb.spec.clusters:
                held[t.name] = held.get(t.name, 0) + t.replicas
        failed = sorted(held, key=lambda m: (-held[m], m))[:FAILOVER_FAILED]
        for m in failed:
            cp.member(m).healthy = False
        pass_time(cp, FAILOVER_STEP_S)
        _t, quiet, _w = run_loop(cp, "14a", verbose=False)
        tainted = sum(bool(cp.store.get("Cluster", "", m).spec.taints)
                      for m in failed)
        step("failed", quiet)
        rounds, quiet, busy = settle_failover(cp, "14a", False,
                                              TOLERATION_S + 1.0)
        notes["failed"] = (failed, tainted, rounds, busy,
                           cp.taint_manager.evicted)
        step("evicted", quiet and not any(busy.values()))
        for m in failed:
            cp.member(m).healthy = True
        pass_time(cp, FAILOVER_STEP_S)
        _t, quiet, _w = run_loop(cp, "14a", verbose=False)
        notes["untainted"] = sum(
            not cp.store.get("Cluster", "", m).spec.taints for m in failed)
        step("recovered", quiet)
        give_room(cp, "14a", placements, items)
        crushed = crush_members(cp, FAILOVER_CRUSHED)
        detects0 = cp.scheduler.rebalance_plane.stats()["cycles"]
        rounds, drains, quiet, _snap = settle_rebalance(cp, "14a", False,
                                                        detects0)
        plane = cp.scheduler.rebalance_plane
        notes["crushed"] = (crushed, rounds, drains, plane.converged(),
                            plane.pending_drains(),
                            plane.stats()["evictions"])
        step("rebalanced", quiet and plane.converged()
             and not plane.pending_drains())
        notes["promoted"] = len(seen)
    return steps, cp, notes


def failover_parity_run(dev, fleet, placements, items) -> tuple:
    """14a on `dev` (None: the CPU, in the child): (steps, notes, wall,
    backends, device type)."""
    dev = dev or torch.device("cpu")
    t1 = time.perf_counter()
    steps, cp, notes = failover_run(models(), dev, fleet, placements, items)
    return (steps, notes, time.perf_counter() - t1,
            {c["backend"] for c in cp.scheduler.cycle_log},
            cp.scheduler.device.type)


def phase_failover_parity(M, fleet, items, dev, seed, refs) -> None:
    """14a: phase 12a's recipe (LOOP_PARITY_MEMBERS members x
    LOOP_PARITY_TEMPLATES templates) with the rebalance plane armed
    (phase 10's RebalanceConfig) on a clock only the phase moves, on the
    card and with device="cpu" (failover_run; the CPU's in the child,
    submit_loop_parity): equal snapshots after every step, every step
    quiescent with no contained fault, every scheduler cycle on backend
    "device"."""
    t0 = time.perf_counter()
    recipe = parity_recipe(M, fleet, items, seed, LOOP_PARITY_TEMPLATES)
    fleet = recipe[0]
    runs = {"cuda": failover_parity_run(dev, *recipe),
            "cpu": refs.result("14a")}
    a, b = runs["cuda"], runs["cpu"]
    failed, tainted, rounds, busy, evicted = a[1]["failed"]
    crushed, r_rounds, drains, conv, pending, evictions = a[1]["crushed"]
    bad = []
    for (name, snap, quiet, faults), (_n, other, q2, f2) in zip(a[0], b[0]):
        diff = sorted((k for k in set(snap) | set(other)
                       if snap.get(k) != other.get(k)), key=repr)
        log(f"phase 14a {name}: snapshot {len(snap)} objects, differing "
            f"card vs cpu {len(diff)}; quiescent {quiet} / {q2}")
        if diff:
            bad.append(f"{name}: {len(diff)} objects differ, first "
                       f"{diff[:3]}")
        if not quiet or not q2 or any(faults.values()) or \
                any(f2.values()):
            bad.append(f"{name}: quiescent {quiet} / {q2}, faults {faults}"
                       f" / {f2}")
    log(f"phase 14a failover parity: {len(fleet)} members x "
        f"{LOOP_PARITY_TEMPLATES} templates; failed {failed} ({tainted} "
        f"tainted NoExecute), settled in {rounds} round(s) with "
        f"{evicted} taint-manager evictions, {a[1]['untainted']} untainted"
        f" on recovery; crushed (member, held, kept) {crushed}: converged "
        f"{conv} in {r_rounds} tick(s) ({drains} past the grace), "
        f"{evictions} rebalance evictions, {pending} pending drains; "
        f"{a[1]['promoted']} promotions; card {a[2]:.2f} s, cpu "
        f"{b[2]:.2f} s; phase {time.perf_counter() - t0:.2f} s")
    for t, r in runs.items():
        if r[3] - {"device"} or r[4] != t:
            bad.append(f"{t}: backends {r[3]}, device {r[4]}")
    if tainted != len(failed) or not evicted or any(busy.values()):
        bad.append(f"failover: {tainted} tainted, {evicted} evicted, "
                   f"still in flight {busy}")
    if a[1]["untainted"] != len(failed):
        bad.append(f"{a[1]['untainted']} of {failed} untainted")
    if not conv or pending or not evictions:
        bad.append(f"rebalance: converged {conv}, {pending} pending, "
                   f"{evictions} evictions")
    if bad:
        raise AssertionError(f"phase 14a: {len(bad)} failed checks: "
                             + "; ".join(bad[:8]))


def phase_member_rebalance(cp, dev, placements, items) -> dict:
    """14b: phase 10b through the member model, on phase 12b's plane
    after it quiesced and its checks: room for the capacity-blind
    placements (give_room), then MEMBER_CRUSHED members (the most Divided replicas
    among those no Duplicated or StaticWeight affinity names) crushed to
    60% of the pods they hold, then FAILOVER_STEP_S a tick to
    convergence and past the grace period until every drain settled.
    10b's checks: converged with every cluster within its capacity, no
    conservation violation, no pending drain, every evicted binding
    re-placed, no contained fault, K13 once per detect cycle, K1-K4
    launched.  Returns the launch counts."""
    from karmada_tpu_torch import native
    from karmada_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    plane = cp.scheduler.rebalance_plane
    give_room(cp, "14b", placements, items)
    seen = record_promotions(cp)
    st0 = plane.stats()
    crushed = crush_members(cp, MEMBER_CRUSHED)
    log(f"phase 14b crushed (member, held, kept): {crushed}")
    torch.cuda.synchronize()
    kernels.reset_counts()
    native.reset_counts()
    rounds, drains, quiet, snap = settle_rebalance(cp, "14b", True,
                                                   st0["cycles"])
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    log(native_line("14b", native.COUNTS))
    check_native("14b", native.COUNTS, need_coo=False)
    st = plane.stats()
    detects = st["cycles"] - st0["cycles"]
    evictions = st["evictions"] - st0["evictions"]
    violations = (st["conservation_violations"]
                  - st0["conservation_violations"])
    faults = loop_faults(cp)
    log(f"phase 14b rebalance through the member model: converged "
        f"{plane.converged()} in {rounds} tick(s), drains settled in "
        f"{drains} grace tick(s), quiescent at the end {quiet}; "
        f"{detects} detect cycles, {evictions} evictions, {violations} "
        f"violations, {plane.pending_drains()} pending drains; faults "
        f"{faults}; phase {time.perf_counter() - t0:.2f} s; launches "
        f"{launches}")
    bad = []
    if not plane.converged() or not quiet:
        bad.append(f"converged {plane.converged()}, quiescent {quiet}")
    if violations:
        bad.append(f"{violations} violations")
    if plane.pending_drains():
        bad.append(f"{plane.pending_drains()} pending drains")
    if faults["scheduler"] or faults["reconcile"] or \
            faults["sync_failures"]:
        bad.append(f"contained faults {faults}")
    if not evictions:
        bad.append("no eviction")
    over = [n for n, r in snap.get("clusters", {}).items()
            if r["capacity"] > 0 and r["over_milli"] > 1000]
    if over:
        bad.append(f"over threshold at convergence: {over[:8]}")
    evicted = {key for key, origin in seen if origin == "rebalance"}
    unplaced = []
    for ns, name in evicted:
        rb = cp.store.peek("ResourceBinding", ns, name)
        cond = [c for c in rb.status.conditions if c.type == "Scheduled"]
        if not cond or cond[-1].status != "True" or \
                rb.metadata.generation != \
                rb.status.scheduler_observed_generation:
            unplaced.append((ns, name))
    if unplaced:
        bad.append(f"{len(unplaced)} evicted bindings not re-placed")
    if launches["rebalance_score"] != detects:
        bad.append(f"K13 launched {launches['rebalance_score']} times in "
                   f"{detects} detect cycles")
    for k in ("capacity", "schedule_rows", "webster_batch", "compact"):
        if launches[k] <= 0:
            bad.append(f"kernel {k} never launched")
    if bad:
        raise AssertionError("phase 14b: " + "; ".join(bad))
    return launches


def outage_region(cp) -> str:
    """The region holding the most replicas of region-spread bindings
    (its outage re-places them through the spread route, K5 / K6)."""
    held = {}
    for rb in cp.store.visit("ResourceBinding"):
        scs = rb.spec.placement.spread_constraints if rb.spec.placement \
            else []
        if not any(sc.spread_by_field == "region" for sc in scs):
            continue
        for t in rb.spec.clusters:
            r = cp.store.peek("Cluster", "", t.name).spec.region
            held[r] = held.get(r, 0) + t.replicas
    return min(held, key=lambda r: (-held[r], r))


def only_there(rb, healthy, cal) -> bool:
    """Whether the binding's placement cannot be met without the failed
    region: the serial path finds no placement on the healthy clusters."""
    import copy

    from karmada_tpu_torch.ops import serial

    spec = copy.deepcopy(rb.spec)
    spec.clusters = []
    try:
        serial.schedule(spec, rb.status, healthy, cal)
    except Exception:  # noqa: BLE001 — the outcome asked about
        return True
    return False


def phase_outage(cp, dev) -> dict:
    """14c: a regional outage on phase 12b's plane (after 14b), with
    OUTAGE_TAINT_POLICY applied (a karmada kind through the typed codec):
    every member of one of config 5's 8 regions unhealthy -- the one
    holding the most region-spread replicas (outage_region); the clock
    through the tolerations and the rate-limited eviction queue, ticking
    to quiescence, until no eviction is queued or waiting and every
    graceful eviction task drained; then the region recovered.  The
    failed members tainted NoExecute and untainted (every taint gone)
    after recovery; no binding keeping a target in the region while it
    is down unless its placement can only be met there (counted); each
    binding that left the region holding its replicas; no contained
    fault, sync failures only toward the failed members; every cycle on
    the card with K1-K4 launched and K5 / K6 on the region-spread rows.
    Returns the launch counts."""
    from karmada_tpu_torch import native
    from karmada_tpu_torch.estimator.general import GeneralEstimator
    from karmada_tpu_torch.ops import kernels, serial

    t0 = time.perf_counter()
    region = outage_region(cp)
    failed = sorted(m for m in cp.members
                    if cp.store.peek("Cluster", "", m).spec.region == region)
    down = set(failed)
    affected = {(rb.namespace, rb.name)
                for rb in cp.store.visit("ResourceBinding")
                if any(t.name in down for t in rb.spec.clusters)}
    cycles0 = len(cp.scheduler.cycle_log)
    sync0 = dict(cp.execution.sync_failures_by_cluster)
    cp.apply(OUTAGE_TAINT_POLICY)
    _t, quiet, _w = run_loop(cp, "14c", verbose=False)
    torch.cuda.synchronize()
    kernels.reset_counts()
    native.reset_counts()
    for m in failed:
        cp.member(m).healthy = False
    pass_time(cp, FAILOVER_STEP_S)
    _t, q1, _w = run_loop(cp, "14c", verbose=True)
    quiet = quiet and q1
    tainted = sum(any(t.key == "cluster.karmada.io/not-ready"
                      and t.effect == "NoExecute"
                      for t in cp.store.peek("Cluster", "", m).spec.taints)
                  for m in failed)
    log(f"phase 14c outage: {len(failed)} members of {region} "
        f"down, {tainted} tainted NoExecute; {len(affected)} bindings "
        f"with a target there")
    rounds, q2, busy = settle_failover(cp, "14c", True, TOLERATION_S + 1.0)
    quiet = quiet and q2
    healthy = [c for c in cp.store.visit("Cluster") if c.name not in down]
    cal = serial.make_cal_available([GeneralEstimator()])
    stuck, kept, short = [], [], []
    for rb in cp.store.visit("ResourceBinding"):
        there = [t.name for t in rb.spec.clusters if t.name in down]
        if there:
            (stuck if only_there(rb, healthy, cal) else kept).append(
                (rb.namespace, rb.name, there))
        if (rb.namespace, rb.name) not in affected:
            continue
        cond = [c for c in rb.status.conditions if c.type == "Scheduled"]
        if not cond or cond[-1].status != "True":
            continue
        strat = serial.strategy_type(rb.spec)
        reps = [t.replicas for t in rb.spec.clusters]
        ok = (all(r == rb.spec.replicas for r in reps)
              if strat == serial.DUPLICATED
              else sum(reps) == rb.spec.replicas)
        if not ok:
            short.append((rb.namespace, rb.name, rb.spec.replicas, reps))
    evicted = cp.taint_manager.evicted
    log(f"phase 14c outage settled in {rounds} round(s), the queue at "
        f"{cp.eviction_queue.rate:g} evictions a second: {evicted} "
        f"taint-manager evictions, queue "
        f"{busy}; bindings still in {region}: {len(stuck)} whose "
        f"placement only the region meets, {len(kept)} others; "
        f"{len(short)} re-placed bindings off their replicas")
    for m in failed:
        cp.member(m).healthy = True
    pass_time(cp, FAILOVER_STEP_S)
    _t, q3, _w = run_loop(cp, "14c", verbose=True)
    quiet = quiet and q3
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    log(native_line("14c", native.COUNTS))
    check_native("14c", native.COUNTS, need_coo=False)
    untainted = sum(not cp.store.peek("Cluster", "", m).spec.taints
                    for m in failed)
    cycles = list(cp.scheduler.cycle_log)[cycles0:]
    sync = {k: v - sync0.get(k, 0)
            for k, v in cp.execution.sync_failures_by_cluster.items()
            if v - sync0.get(k, 0)}
    faults = loop_faults(cp)
    log(f"phase 14c recovered: {untainted} of {len(failed)} untainted; "
        f"{len(cycles)} scheduler cycles (backends "
        f"{sorted({c['backend'] for c in cycles})}); sync failures by "
        f"cluster {sync}; faults {faults}; quiescent every round {quiet};"
        f" phase {time.perf_counter() - t0:.2f} s; launches {launches}")
    if stuck:
        log(f"phase 14c bindings only {region} can place: "
            f"{stuck[:8]}")
    bad = []
    if tainted != len(failed) or untainted != len(failed):
        bad.append(f"{tainted} tainted, {untainted} untainted of "
                   f"{len(failed)}")
    if any(busy.values()) or not quiet:
        bad.append(f"not settled: {busy}, quiescent {quiet}")
    if kept:
        bad.append(f"{len(kept)} bindings keep a target in the failed "
                   f"region, first {kept[:4]}")
    if short:
        bad.append(f"{len(short)} re-placed bindings off their replicas, "
                   f"first {short[:4]}")
    if not evicted:
        bad.append("no eviction")
    if faults["scheduler"] or faults["reconcile"]:
        bad.append(f"contained faults {faults}")
    if set(sync) - down:
        bad.append(f"sync failures toward healthy members {sync}")
    if any(c["backend"] != "device" for c in cycles):
        bad.append("a rescheduling cycle ran off the card")
    for k in ("capacity", "schedule_rows", "webster_batch", "compact",
              "spread_group_info", "spread_pick"):
        if launches[k] <= 0:
            bad.append(f"kernel {k} never launched")
    if bad:
        raise AssertionError(f"phase 14c: {len(bad)} failed checks: "
                             + "; ".join(bad[:8]))
    return launches


# -- phase 15: the estimator tier, the descheduler and the facade -------------

FACADE_PARITY_TEMPLATES = 128  # 15a (256, 13d's plane size, until the
                               # full run passed 1,000 s)
FACADE_PARITY_REQUESTS = 64
FACADE_PARITY_WINDOW = 16
DESCHED_PARITY_SQUEEZED = 2    # 15a: members squeezed through the member model
FACADE_REQUESTS = 512          # 15b
FACADE_THREADS = 16
FACADE_WINDOW = 128
FACADE_DEADLINE_S = 0.05       # 20x the median arrival spread of the
                               # 16 callers' resubmissions (15b prints
                               # it; 2.5 ms on the H100 host at 0.2 s)
FACADE_SAMPLE = 64             # 15b: solo answers held against ops/serial
DESCHED_SQUEEZED = 8           # 15c
DESCHED_SHORT_MAX = 2          # 15c: eligible bindings that may end short
DESCHED_ROUNDS = 20


def facade_requests(items, placements, n, prefix):
    """`n` AssignReplicas requests drawn from config 5's binding mix:
    binding b's replicas and requests (cpu, memory in Gi, as
    loop_template makes them), Divided when its placement
    (placements[b % len]) divides, the names of its affinity as the
    allowlist."""
    from karmada_tpu_torch.estimator import wire

    out = []
    for b in range(n):
        spec = items[b][0]
        p = placements[b % len(placements)]
        rs = p.replica_scheduling
        req = spec.replica_requirements.resource_request
        out.append(wire.AssignReplicasRequest(
            namespace="facade", name=f"{prefix}-{b}", replicas=spec.replicas,
            resource_request={"cpu": f"{req['cpu'].milli}m",
                              "memory": f"{int(req['memory'].value())}Gi"},
            divided=(rs is not None
                     and rs.replica_scheduling_type == "Divided"),
            cluster_names=(list(p.cluster_affinity.cluster_names)
                           if p.cluster_affinity else [])))
    return out


def whatif_queries(cp, limit):
    """The three what-if queries: where 8 new 500m / 1Gi replicas land,
    the largest count of 100-cpu / 64Gi replicas that still schedules
    (from 1,024 up; about 1,000 on config 5's fleet, ~12 probes), and
    what the loss of the member hosting the most bindings strands (its
    first `limit` bindings re-solved)."""
    from karmada_tpu_torch.facade import WhatIfRequest

    hosted = {}
    for rb in cp.store.visit("ResourceBinding"):
        for t in rb.spec.clusters:
            hosted[t.name] = hosted.get(t.name, 0) + 1
    busiest = min(hosted, key=lambda m: (-hosted[m], m))
    return [WhatIfRequest(query="placement", replicas=8,
                          resource_request={"cpu": "500m", "memory": "1Gi"}),
            WhatIfRequest(query="headroom", replicas=1024,
                          resource_request={"cpu": "100", "memory": "64Gi"}),
            WhatIfRequest(query="cluster-loss", cluster=busiest,
                          limit=limit)]


def desched_members(cp, desched, n, unpinned=True):
    """The `n` members with the most replicas of bindings the descheduler
    may shrink (Divided DynamicWeight or Aggregated), with `unpinned`
    among those no Duplicated or StaticWeight affinity names (the
    rebalance plane, when armed, converges only on those)."""
    pinned = divided_load(cp)[1] if unpinned else set()
    load = {}
    for rb in cp.store.visit("ResourceBinding"):
        if desched._eligible(rb):  # noqa: SLF001 — the controller's rule
            for t in rb.spec.clusters:
                load[t.name] = load.get(t.name, 0) + t.replicas
    return [m for m in sorted(load, key=lambda m: (-load[m], m))
            if m not in pinned][:n]


def squeeze(cp, names):
    """Each member's allocatable pods to CRUSH_MILLI/1000 of the pods it
    holds, through the member model: the workloads past it stay pending
    there (its estimator server's unschedulable replicas).  Returns
    [(name, held, kept)]."""
    out = []
    for m in names:
        member = cp.member(m)
        held = member.used_milli()["pods"] // 1000
        member.pods_allocatable = held * CRUSH_MILLI // 1000
        out.append((m, held, member.pods_allocatable))
    return out


def settle_descheduler(cp, desched, label, verbose):
    """FAILOVER_STEP_S of the plane's time a round (past the grace when
    only drains wait), ticking to quiescence each round, until a round
    shrinks nothing with nothing in flight (at most DESCHED_ROUNDS).
    Returns (rounds, quiescent every round)."""
    plane = cp.scheduler.rebalance_plane
    rounds, quiet, step = 0, True, FAILOVER_STEP_S
    while rounds < DESCHED_ROUNDS:
        shrinks, denied = desched.shrinks, desched.denied
        pass_time(cp, step)
        _t, converged, _w = run_loop(cp, label, verbose)
        quiet = quiet and converged
        rounds += 1
        busy = failover_busy(cp)
        drains = plane.pending_drains() if plane is not None else 0
        if (desched.shrinks, desched.denied) == (shrinks, denied) \
                and not any(busy.values()) and not drains:
            break
        step = (REBALANCE_GRACE_S if desched.shrinks == shrinks
                and busy["tasks"] and not busy["queued"] else
                FAILOVER_STEP_S)
    return rounds, quiet


def facade_run(cp, reqs, queries, window, deadline_s):
    """One FacadeService on the plane: the requests admitted in order
    (a window's last admission cuts and solves its batch), then the
    what-if queries.  Returns (answers, what-if answers, state payload,
    batch walls, what-if walls)."""
    from karmada_tpu_torch.facade import FacadeService

    svc = FacadeService(cp.scheduler, cp.store, batch_window=window,
                        batch_deadline_s=deadline_s)
    try:
        pending = [svc.assign_async(r) for r in reqs]
        answers = [p.result(600).to_json() for p in pending]
        whatifs, walls = [], []
        for q in queries:
            t0 = time.perf_counter()
            whatifs.append(svc.whatif(q).to_json())
            walls.append(time.perf_counter() - t0)
        state = svc.state_payload()
        batch_walls = list(svc.batch_walls)
    finally:
        svc.close()
    return answers, whatifs, state, batch_walls, walls


def descheduler_run(M, dev, fleet, placements, items):
    """15a's steps on `dev`: 12a's recipe with the descheduler armed,
    ticked to quiescence; DESCHED_PARITY_SQUEEZED members squeezed and
    the descheduler settled; then the facade's answers.  Returns the
    snapshots, the answers and what each step did."""
    from karmada_tpu_torch.controllers.descheduler import Descheduler

    with UidSeq():
        cp, _ = build_loop(M, dev, fleet, placements, items,
                           enable_descheduler=True,
                           rebalance_cfg=rebalance_cfg())
        _t, quiet0, _w = run_loop(cp, "15a", verbose=False)
        built = loop_snapshot(cp)
        desched = cp.descheduler
        assert isinstance(desched, Descheduler)
        squeezed = squeeze(cp, desched_members(
            cp, desched, DESCHED_PARITY_SQUEEZED, unpinned=False))
        rounds, quiet = settle_descheduler(cp, desched, "15a", False)
        settled = loop_snapshot(cp)
        rev = loop_revision(cp)
        run = facade_run(
            cp, facade_requests(items, placements, FACADE_PARITY_REQUESTS,
                                "parity"),
            whatif_queries(cp, 64), FACADE_PARITY_WINDOW, 600.0)
        notes = {"quiet": quiet0 and quiet, "squeezed": squeezed,
                 "rounds": rounds, "shrinks": desched.shrinks,
                 "denied": desched.denied, "faults": loop_faults(cp),
                 "wrote": loop_revision(cp) - rev,
                 "untouched": loop_snapshot(cp) == settled,
                 "backends": {c["backend"] for c in cp.scheduler.cycle_log},
                 "device": cp.scheduler.device.type,
                 "rpc_errors": cp.descheduler_estimator.counts()["errors"]}
    return (built, settled), run, notes


def descheduler_parity_run(dev, fleet, placements, items) -> tuple:
    """15a on `dev` (None: the CPU, in the child): (snapshots, the
    facade's run, notes, wall)."""
    dev = dev or torch.device("cpu")
    t1 = time.perf_counter()
    snaps, run, notes = descheduler_run(models(), dev, fleet, placements,
                                        items)
    return snaps, run, notes, time.perf_counter() - t1


def phase_descheduler_parity(M, fleet, items, dev, seed, refs) -> None:
    """15a: 12a's members and placements with FACADE_PARITY_TEMPLATES
    templates, ControlPlane(enable_descheduler=True), on the card and with
    device="cpu" (descheduler_run; the CPU's in the child,
    submit_loop_parity): equal snapshots built and after the squeeze
    settled, the descheduler shrank replicas with no estimator error, no
    contained fault; one FacadeService a plane answering the same
    FACADE_PARITY_REQUESTS AssignReplicas and the three what-if queries
    equal, writing nothing."""
    t0 = time.perf_counter()
    recipe = parity_recipe(M, fleet, items, seed, FACADE_PARITY_TEMPLATES)
    fleet = recipe[0]
    runs = {"cuda": descheduler_parity_run(dev, *recipe),
            "cpu": refs.result("15a")}
    a, b = runs["cuda"], runs["cpu"]
    bad = []
    for i, name in enumerate(("built", "settled")):
        diff = sorted((k for k in set(a[0][i]) | set(b[0][i])
                       if a[0][i].get(k) != b[0][i].get(k)), key=repr)
        if diff:
            bad.append(f"{name}: {len(diff)} objects differ, first "
                       f"{diff[:3]}")
    for j, what in enumerate(("AssignReplicas answers", "what-if answers")):
        if a[1][j] != b[1][j]:
            first = next(k for k, (x, y) in enumerate(zip(a[1][j], b[1][j]))
                         if x != y)
            bad.append(f"{what} differ, first at {first}: {a[1][j][first]}"
                       f" vs {b[1][j][first]}")
    state, walls, qwalls = a[1][2], a[1][3], a[1][4]
    n = a[2]
    scheduled = sum(x["outcome"] == "scheduled" for x in a[1][0])
    log(f"phase 15a descheduler + facade parity: {len(fleet)} members x "
        f"{FACADE_PARITY_TEMPLATES} templates; squeezed (member, held, "
        f"kept) {n['squeezed']}: {n['shrinks']} shrinks ({n['denied']} "
        f"denied by the budget) settled in {n['rounds']} round(s); facade "
        f"{state['calls']} calls in {state['batches']} batches (ratio "
        f"{state['coalesce_ratio']}), {scheduled} scheduled, batch walls "
        f"{[round(w, 4) for _n, w in walls]} s, what-if "
        f"{[x['query'] for x in a[1][1]]} in "
        f"{[round(w, 4) for w in qwalls]} s; card {a[3]:.2f} s, cpu "
        f"{b[3]:.2f} s; phase {time.perf_counter() - t0:.2f} s")
    for t, r in runs.items():
        n = r[2]
        if not n["quiet"] or any(n["faults"].values()) or n["rpc_errors"] \
                or n["backends"] - {"device"} or n["device"] != t:
            bad.append(f"{t}: quiescent {n['quiet']}, faults {n['faults']},"
                       f" estimator errors {n['rpc_errors']}, backends "
                       f"{n['backends']}, device {n['device']}")
        if not n["shrinks"]:
            bad.append(f"{t}: the descheduler shrank nothing")
        if n["wrote"] or not n["untouched"]:
            bad.append(f"{t}: the facade wrote {n['wrote']} times")
        if r[1][2]["errors"] or r[1][2]["calls"] != FACADE_PARITY_REQUESTS:
            bad.append(f"{t}: facade state {r[1][2]}")
    if bad:
        raise AssertionError(f"phase 15a: {len(bad)} failed checks: "
                             + "; ".join(bad[:8]))


def same_answer(resp, res, ordered=True) -> bool:
    """A facade answer against a solve's outcome for the same binding:
    the targets in order, or (`ordered` False: against ops/serial, which
    lists a Duplicated placement's clusters in its score order, the
    device path in the fleet's) as a set."""
    if isinstance(res, Exception) or res is None:
        return resp["outcome"] == "unschedulable"
    want = [{"cluster": t.name, "replicas": t.replicas} for t in res]
    got = resp["assignments"]
    if not ordered:
        def key(a):
            return a["cluster"]
        want, got = sorted(want, key=key), sorted(got, key=key)
    return resp["outcome"] == "scheduled" and got == want


def phase_facade(cp, items, placements) -> dict:
    """15b: the facade on phase 12b's plane after 14c.  FACADE_REQUESTS
    AssignReplicas drawn from config 5's mix, FACADE_THREADS client
    threads each with its own TcpTransport, batch window FACADE_WINDOW:
    every answer equal to a device="cpu" Scheduler's detached solve of
    its batch, in the batch's order, on the clusters the facade read; a
    stride sample of FACADE_SAMPLE answered alone (a window of 1) equal
    to ops/serial.schedule; the three what-if queries equal card vs CPU;
    the plane's non-Lease revision unchanged.  Returns the launch
    counts."""
    from karmada_tpu_torch.estimator import wire
    from karmada_tpu_torch.estimator.general import GeneralEstimator
    from karmada_tpu_torch.facade import FacadeClient, FacadeService
    from karmada_tpu_torch.facade import whatif as whatif_mod
    from karmada_tpu_torch.ops import kernels, serial
    from karmada_tpu_torch.scheduler import Scheduler
    from karmada_tpu_torch.scheduler.core import ClusterView
    from karmada_tpu_torch.store import ObjectStore, Runtime

    t0 = time.perf_counter()
    reqs = facade_requests(items, placements, FACADE_REQUESTS, "tcp")
    by_name = {r.name: r for r in reqs}
    rev = loop_revision(cp)
    torch.cuda.synchronize()
    kernels.reset_counts()
    svc = FacadeService(cp.scheduler, cp.store, batch_window=FACADE_WINDOW,
                        batch_deadline_s=FACADE_DEADLINE_S)
    batches, spreads = [], []
    solve = svc._solve_assign  # noqa: SLF001 — the harness records batches

    def recorded(batch, bid):
        batches.append([p.request.name for p in batch])
        # the arrival spread of the batch's callers: first to last
        # admission, on the service's clock
        spreads.append(batch[-1].t_enqueue - batch[0].t_enqueue)
        return solve(batch, bid)
    svc._solve_assign = recorded  # noqa: SLF001
    answers, errors, latency = {}, [], []
    try:
        host, port = svc.serve()

        def caller(k):
            client = FacadeClient(wire.TcpTransport(host, port,
                                                    timeout=600.0))
            try:
                for r in reqs[k::FACADE_THREADS]:
                    t = time.perf_counter()
                    answers[r.name] = client.assign_replicas(r).to_json()
                    latency.append(time.perf_counter() - t)
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(repr(e))
            finally:
                client.close()
        t1 = time.perf_counter()
        threads = [threading.Thread(target=caller, args=(k,))
                   for k in range(FACADE_THREADS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        tcp_wall = time.perf_counter() - t1
        state = svc.state_payload()
        walls = list(svc.batch_walls)
    finally:
        svc.close()
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    # the CPU's detached solves of the same batches, in their order, on
    # one view of a copy of the same Clusters (the facade's own view is
    # a copy too, taken once: no Cluster moved during the burst)
    clusters = cp.store.list("Cluster")
    view = ClusterView(clusters)
    cpu = Scheduler(ObjectStore(), Runtime(), device="cpu",
                    pipeline_chunk=4096, waves=8, batch_window=4096)
    t1 = time.perf_counter()
    differ = []
    for names in batches:
        results, _ = cpu.solve_batch(
            [whatif_mod.synthesize_binding(by_name[n]) for n in names],
            clusters, detached=True, view=view)
        for i, n in enumerate(names):
            if not same_answer(answers.get(n, {}), results.get(i)):
                differ.append(n)
    cpu_s = time.perf_counter() - t1
    # the stride sample, each request alone, against ops/serial
    sample = reqs[::FACADE_REQUESTS // FACADE_SAMPLE]
    solo = FacadeService(cp.scheduler, cp.store, batch_window=1)
    t1 = time.perf_counter()
    try:
        solos = [solo.assign(r).to_json() for r in sample]
    finally:
        solo.close()
    solo_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    cal = serial.make_cal_available([GeneralEstimator()])
    off_serial = []
    for r, resp in zip(sample, solos):
        rb = whatif_mod.synthesize_binding(r)
        try:
            res = serial.schedule(rb.spec, rb.status, clusters, cal)
        except Exception as e:  # noqa: BLE001 — the outcome compared
            res = e
        if not same_answer(resp, res, ordered=False):
            off_serial.append(r.name)
    serial_s = time.perf_counter() - t1
    # the what-if queries, card against CPU
    qs, qdiff, qwalls = whatif_queries(cp, 128), [], []
    for q in qs:
        t1 = time.perf_counter()
        card = whatif_mod.run_query(cp.scheduler, cp.store, q).to_json()
        t2 = time.perf_counter()
        other = whatif_mod.run_query(cpu, cp.store, q).to_json()
        if q.query == "headroom":
            headroom = (card["result"]["max_replicas"],
                        card["result"]["probes"])
        qwalls.append((round(t2 - t1, 4), round(time.perf_counter() - t2,
                                                4)))
        if card != other:
            qdiff.append(q.query)
    wrote = loop_revision(cp) - rev
    sizes = [len(b) for b in batches]
    spreads.sort()
    latency.sort()
    log(f"phase 15b facade over TCP on 12b's plane: {len(reqs)} requests "
        f"from {FACADE_THREADS} threads in {tcp_wall:.3f} s, {len(batches)}"
        f" batches (window {FACADE_WINDOW}, deadline {FACADE_DEADLINE_S} s;"
        f" sizes min {min(sizes)} / max {max(sizes)}; the callers' arrival "
        f"spread a batch median {spreads[len(spreads) // 2]:.4f} / max "
        f"{spreads[-1]:.4f} s), coalesce ratio {state['coalesce_ratio']}, "
        f"a call's latency at the client median "
        f"{latency[len(latency) // 2]:.4f} / p90 "
        f"{latency[len(latency) * 9 // 10]:.4f} / max {latency[-1]:.4f} s, "
        f"{sum(a['outcome'] == 'scheduled' for a in answers.values())} "
        f"scheduled; the facade's device cycles {sum(w for _n, w in walls):.3f}"
        f" s (per batch min {min(w for _n, w in walls):.4f} / median "
        f"{sorted(w for _n, w in walls)[len(walls) // 2]:.4f} / max "
        f"{max(w for _n, w in walls):.4f}); CPU replay {cpu_s:.2f} s, "
        f"{len(differ)} differ; {len(sample)} alone in {solo_s:.3f} s, "
        f"{len(off_serial)} off ops/serial (its solves {serial_s:.2f} s); "
        f"headroom {headroom} (replicas, probes); what-if (card s, cpu s) "
        f"{dict(zip([q.query for q in qs], qwalls))}, differing {qdiff}; "
        f"non-Lease writes {wrote}; launches {launches}; phase "
        f"{time.perf_counter() - t0:.2f} s")
    bad = []
    if errors or len(answers) != len(reqs):
        bad.append(f"{len(answers)} answers, client errors {errors[:3]}")
    if differ:
        bad.append(f"{len(differ)} answers differ from the CPU's, first "
                   f"{differ[:3]}")
    if off_serial:
        bad.append(f"{len(off_serial)} solo answers off ops/serial, first "
                   f"{off_serial[:3]}")
    if qdiff:
        bad.append(f"what-if {qdiff} differ card vs CPU")
    if wrote:
        bad.append(f"the facade wrote {wrote} times")
    if state["errors"] or state["calls"] != len(reqs):
        bad.append(f"facade state {state}")
    for k in ("capacity", "schedule_rows", "webster_batch", "compact"):
        if launches[k] <= 0:
            bad.append(f"kernel {k} never launched")
    if bad:
        raise AssertionError("phase 15b: " + "; ".join(bad))
    return launches


def phase_descheduler(cp) -> dict:
    """15c: a Descheduler attached to phase 12b's plane through its
    constructor, over the plane's estimator client and its shared
    eviction budget; the DESCHED_SQUEEZED members with the most
    descheduler-eligible replicas squeezed, then settled: every eligible
    binding placed in full before keeps its replica total, but for at
    most DESCHED_SHORT_MAX that lost no more than the descheduler shrank
    of them (the estimator's unschedulable counts at their shrinks), are
    Unschedulable and that ops/serial cannot place in full either; no
    squeezed member holds more of them than it admits, no contained
    fault or failed sync, K1-K4 launched.  Returns the launch counts."""
    from karmada_tpu_torch import native
    from karmada_tpu_torch.controllers.descheduler import Descheduler
    from karmada_tpu_torch.estimator.general import GeneralEstimator
    from karmada_tpu_torch.ops import kernels, serial

    t0 = time.perf_counter()
    budget = cp.eviction_budget_shared
    desched = Descheduler(cp.store, cp.runtime, cp.members,
                          estimator=cp.descheduler_estimator, budget=budget)
    # the replicas each workload had stuck where the descheduler asked:
    # every positive answer is a shrink of that many but for the
    # budget's refusals (printed; none so far)
    asked, shrunk = desched._stuck_replicas, {}  # noqa: SLF001

    def stuck_replicas(cluster, resource):
        n = asked(cluster, resource)
        if n > 0:
            k = (resource.namespace, resource.name)
            shrunk.setdefault(k, []).append((cluster, n))
        return n
    desched._stuck_replicas = stuck_replicas  # noqa: SLF001
    # the eligible bindings placed in full before the squeeze (their
    # targets summing to their replicas), and those short already
    totals, short = {}, 0
    for rb in cp.store.visit("ResourceBinding"):
        if desched._eligible(rb) and rb.spec.clusters:  # noqa: SLF001
            held = sum(t.replicas for t in rb.spec.clusters)
            if held == rb.spec.replicas:
                totals[(rb.namespace, rb.name)] = (
                    held, [(t.name, t.replicas) for t in rb.spec.clusters])
            else:
                short += 1
    squeezed = squeeze(cp, desched_members(cp, desched, DESCHED_SQUEEZED))
    log(f"phase 15c squeezed (member, held, kept): {squeezed}")
    denied0 = dict(budget.denied)
    torch.cuda.synchronize()
    kernels.reset_counts()
    native.reset_counts()
    rounds, quiet = settle_descheduler(cp, desched, "15c", True)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    log(native_line("15c", native.COUNTS))
    check_native("15c", native.COUNTS, need_coo=False)
    # a binding short of its total after the settle must have lost no
    # more than the descheduler shrank of it, be Unschedulable, and be
    # one the serial path cannot place either (its constraints leave no
    # room on the fleet as it is now)
    clusters = cp.store.list("Cluster")
    cal = serial.make_cal_available([GeneralEstimator()])
    lost, no_room, stuck = [], [], []
    for key, (total, before) in totals.items():
        rb = cp.store.peek("ResourceBinding", *key)
        now = sum(t.replicas for t in rb.spec.clusters)
        if now == total:
            continue
        cond = [(c.status, c.reason, c.message[:160])
                for c in rb.status.conditions if c.type == "Scheduled"]
        res = rb.spec.resource
        shrinks = shrunk.get((res.namespace, res.name), [])
        entry = (key, total, before,
                 [(t.name, t.replicas) for t in rb.spec.clusters], cond,
                 shrinks)
        if total - now > sum(n for _m, n in shrinks) or \
                [c[:2] for c in cond] != [("False", "Unschedulable")]:
            lost.append(entry)
            continue
        try:
            serial.schedule(rb.spec, rb.status, clusters, cal)
            lost.append(entry)
        except Exception:  # noqa: BLE001 — the outcome asked about
            no_room.append(entry)
    for m, _held, _kept in squeezed:
        member = cp.member(m)
        for rb in cp.store.visit("ResourceBinding"):
            if not desched._eligible(rb):  # noqa: SLF001
                continue
            if any(t.name == m for t in rb.spec.clusters):
                ref = rb.spec.resource
                if member.unschedulable_replicas(ref.kind, ref.namespace,
                                                 ref.name):
                    stuck.append((m, rb.name))
    # a squeeze's knock-on: re-placed replicas can fill a member that was
    # not squeezed, and leave what it held before pending there
    elsewhere = sorted({m for e in no_room for m, _n in e[5]}
                       - {m for m, _h, _k in squeezed})
    faults = loop_faults(cp)
    denied = {k: v - denied0.get(k, 0) for k, v in budget.denied.items()}
    log(f"phase 15c descheduler on 12b's plane: {desched.shrinks} shrinks,"
        f" {desched.denied} denied by the shared budget (the budget's "
        f"refusals by consumer {denied}), settled in {rounds} round(s), "
        f"quiescent {quiet}; {len(totals)} eligible bindings placed in "
        f"full ({short} short of their replicas before the squeeze, not "
        f"held to it), {len(lost) + len(no_room)} off their replica total "
        f"({len(no_room)} of them, at most {DESCHED_SHORT_MAX} allowed, "
        f"short by no more than their shrinks, Unschedulable, and the "
        f"serial path cannot place them either: (binding, replicas, "
        f"targets before, after, Scheduled, shrinks (member, stuck)) "
        f"{no_room[:DESCHED_SHORT_MAX + 1]}; their shrinks on members "
        f"not squeezed {elsewhere}), {len(stuck)} still stuck on a "
        f"squeezed member; "
        f"estimator errors "
        f"{cp.descheduler_estimator.counts()['errors']}; faults {faults}; "
        f"phase {time.perf_counter() - t0:.2f} s; launches {launches}")
    bad = []
    if not quiet:
        bad.append("not quiescent")
    if not desched.shrinks:
        bad.append("no shrink")
    if lost:
        bad.append(f"{len(lost)} eligible bindings off their total beyond "
                   f"their shrinks, not Unschedulable, or that ops/serial "
                   f"places, first (binding, replicas, targets before, "
                   f"after, Scheduled, shrinks) {lost[:2]}")
    if len(no_room) > DESCHED_SHORT_MAX:
        bad.append(f"{len(no_room)} eligible bindings left short, more "
                   f"than {DESCHED_SHORT_MAX}")
    if stuck:
        bad.append(f"{len(stuck)} stuck on squeezed members, first "
                   f"{stuck[:3]}")
    if faults["scheduler"] or faults["reconcile"] or \
            faults["sync_failures"]:
        bad.append(f"contained faults {faults}")
    for k in ("capacity", "schedule_rows", "webster_batch", "compact"):
        if launches[k] <= 0:
            bad.append(f"kernel {k} never launched")
    if bad:
        raise AssertionError("phase 15c: " + "; ".join(bad))
    return launches


# -- phase 13: the device lifecycle -------------------------------------------

PROBE_N = 128              # the probe snippet's matrix (K14 on the main path)
PROBE_N_WIDE = 1_024
MARKER_N = 128             # capture_profile's marker input (K15)
MARKER_N_WIDE = 1 << 20
MARKER_N_ODD = MARKER_N_WIDE + 3  # 13b: an odd length (the scalar tail)
PROBE_N_RAGGED = 1_000     # 13a: a ragged edge (TMA's zero fill)
PROBE_N_REFUSED = 100      # 13a: n % 8 != 0, refused with a ValueError
GUARD_TEMPLATES = 256      # 13d's plane (12a's 512 until phase 14 took
                           # the time)
GUARD_TIMEOUT_S = 0.001    # 13d: shorter than any device cycle
GUARD_RAISED_S = 600.0     # 13d: the timeout once the plane degraded
GUARD_HOLD_S = 0.5         # 13d held: the zombie is on the card by then


def probe_sass() -> dict:
    """K14's tensor-core (HGMMA), TMA-load (UTMALDG) and mbarrier (SYNCS)
    instructions in the built libprobe.so, counted in cuobjdump -sass."""
    from karmada_tpu_torch.ops import kernels

    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(kernels.build()["probe"])],
                          capture_output=True, text=True, check=True).stdout
    return {op: sass.count(op) for op in ("HGMMA", "UTMALDG", "SYNCS")}


def order_tolerance_share(got, want, a) -> float:
    """The largest |got - want| over its tolerance, one bf16 ulp of the
    plain result `want` (2^(e-7) in [2^e, 2^(e+1))) + n * 2^-24 * sum_k
    |a_ik * a_kj|: two float32 sums of the same products in another
    order, each rounded once to bf16.  At most 1 when every entry is
    within it."""
    g, w, x = got.double(), want.double(), a.double().abs()
    mag = w.abs()
    ulp = torch.where(mag > 0, torch.exp2(torch.floor(torch.log2(
        torch.where(mag > 0, mag, torch.ones_like(mag)))) - 7),
        torch.zeros_like(mag))
    tol = ulp + a.shape[0] * 2.0 ** -24 * (x @ x)
    return float(((g - w).abs() / tol).max())


def fed_ms(fn, reps: int) -> float:
    """Milliseconds a call of `fn` holds the stream when calls run back to
    back with no host gap between them: one event pair around `reps`
    calls enqueued on a held stream, over `reps`."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    hold_stream(reps * (2 * host + 0.05))
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def kernel_times(fn, plain, lib, bound: float, reps: int) -> dict:
    """A kernel's times beside its yardsticks: cuda_ms of back-to-back
    calls (the median of TURN_ROUNDS x 2 readings taken in turns with
    the library call's: kernel, library, library, kernel), its one-launch
    device ms by CUDA events (split_ms) and that over the bound, its
    fed_ms, the host enqueue, the plain version's cuda_ms, and the
    library call's cuda_ms (the median of its readings in those turns),
    device ms (a whole-call event pair), fed_ms and host enqueue."""
    host, device = split_ms(fn, 10 * reps)
    lib_host, lib_device = split_ms(lib, 10 * reps, whole=True)
    got = {fn: [], lib: []}
    for _ in range(TURN_ROUNDS):
        for f in (fn, lib, lib, fn):
            got[f].append(cuda_ms(f, 10 * reps))
    return dict(ms=float(np.median(got[fn])), readings=got[fn],
                device=device, host=host,
                share=bound / device if device else None,
                fed=fed_ms(fn, 10 * reps), plain_ms=cuda_ms(plain, reps),
                library_ms=float(np.median(got[lib])),
                library_readings=got[lib], library_device=lib_device,
                library_fed=fed_ms(lib, 10 * reps), library_host=lib_host)


def times_text(t: dict) -> str:
    share = "none" if t["share"] is None else f"{t['share']:.1%}"
    return (f"ms={t['ms']:.5f} {[round(x, 5) for x in t['readings']]} "
            f"device (one launch, events) {t['device']:.5f} ms = {share} "
            f"of the bound, fed back to back {t['fed']:.5f} ms, host "
            f"enqueue {t['host']:.5f} ms; plain_ms={t['plain_ms']:.5f} "
            f"library_ms={t['library_ms']:.5f} "
            f"{[round(x, 5) for x in t['library_readings']]} (device "
            f"{t['library_device']:.5f}, fed {t['library_fed']:.5f}, host "
            f"{t['library_host']:.5f})")


def lifecycle_turns(label: str, cases: dict, reps: int) -> None:
    """K14 / K15 old (the parent's) against new in turns (old, new, new,
    old; TURN_ROUNDS rounds) by cuda_ms, each side's one-launch device ms
    beside: cases {name: (old fn, new fn)}."""
    for name, (old, new) in cases.items():
        for side, fn in (("old", old), ("new", new)):
            log(f"phase {label} turns {name} split, {side}: "
                f"{split_ms(fn, 10 * reps)!r}")
    run_turns({name: (lambda f=old: cuda_ms(f, reps),
                      lambda f=new: cuda_ms(f, reps))
               for name, (old, new) in cases.items()}, TURN_ROUNDS,
              label=f"phase {label}")


def phase_probe(dev, reps, parent=None) -> dict:
    """13a: resolve_backend("device") through the real probe subprocess
    (K14 on every visible card, its own launch count reported back): ok,
    gpu, the visible cards, a positive bytes_limit each; K14's SASS holds
    wgmma (HGMMA) and TMA loads (UTMALDG); then K14 against its plain
    version, bit for bit on seeded {-1, 0, 1} bf16 matrices (every fp32
    partial sum exact) and within order_tolerance_share on normal(0, 1)
    ones, at 128, 1,000 (a ragged edge) and 1,024; a ValueError at 100
    (n % 8 != 0); at 128 and 1,024 kernel_times beside torch.mm (the
    yardstick; the port never calls it) and the bound (2 n^3 operations
    at the bf16 tensor-core rate, or one read of A and one write of C),
    1,024's cuda_ms over TURN_ROUNDS readings, and with `parent` the
    parent's K14 in turns.  Returns K14's report row."""
    from karmada_tpu_torch.ops import probe
    from karmada_tpu_torch.utils import deviceprobe

    t0 = time.perf_counter()
    backend, diag = deviceprobe.resolve_backend("device",
                                                probe_timeout_s=600)
    wall = time.perf_counter() - t0
    n = torch.cuda.device_count()
    mem = diag.get("memory_stats") or []
    launches = (diag.get("launches") or {}).get("probe_mm", 0)
    log(f"phase 13a probe: resolve_backend('device') -> {backend!r} in "
        f"{wall:.2f} s wall (probe subprocess {diag['attempts']}); ok "
        f"{diag['ok']}, platform {diag['platform']!r}, cards "
        f"{diag['device_count']} of {n} visible; K14 launches in the probe "
        f"{launches}; MEMSTATS {mem}; last_probe "
        f"{deviceprobe.last_probe()}")
    bad = []
    if backend != "device" or not diag["ok"] or diag["platform"] != "gpu":
        bad.append(f"probe answered {backend!r} {diag}")
    if diag["device_count"] != n or launches != n:
        bad.append(f"cards {diag['device_count']}, K14 launches {launches}, "
                   f"visible {n}")
    if len(mem) != n or any(m["memory_stats"]["bytes_limit"] <= 0
                            for m in mem):
        bad.append(f"MEMSTATS {mem}")
    sass = probe_sass()
    log(f"phase 13a K14 SASS (cuobjdump -sass libprobe.so): {sass}")
    if not (sass["HGMMA"] and sass["UTMALDG"] and sass["SYNCS"]):
        bad.append(f"K14's SASS lacks wgmma, TMA or mbarrier: {sass}")
    # the plain version in full fp32 on the card (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(13)
    row, turns = None, {}
    for size in (PROBE_N, PROBE_N_RAGGED, PROBE_N_WIDE):
        a = torch.from_numpy(rng.integers(-1, 2, (size, size)).astype(
            np.float32)).to(dev, torch.bfloat16)
        got, want = probe.probe_mm(a), probe.probe_mm_plain(a)
        norm = torch.from_numpy(rng.standard_normal((size, size)).astype(
            np.float32)).to(dev, torch.bfloat16)
        share = order_tolerance_share(probe.probe_mm(norm),
                                      probe.probe_mm_plain(norm), norm)
        torch.cuda.synchronize()
        same = torch.equal(got.view(torch.int16), want.view(torch.int16))
        err = max_abs_err([(got, want)])
        line = (f"phase 13a K14 probe_mm {size}x{size} bf16: ternary "
                f"bit-exact {same} max_abs_err={err}; normal(0, 1) at "
                f"{share:.3f} of the order tolerance")
        if not same:
            bad.append(f"K14 at {size} differs from its plain version")
        if share > 1:
            bad.append(f"K14 at {size} on normal inputs beyond the "
                       f"tolerance ({share:.3f})")
        if size == PROBE_N_RAGGED:
            log(line)
            continue
        b = bound_ms(2 * nbytes(a), 2.0 * size ** 3, BF16_OPS_PER_S)
        t = kernel_times(lambda: probe.probe_mm(a),
                         lambda: probe.probe_mm_plain(a),
                         lambda: torch.mm(a, a), b[0], reps)
        log(f"{line}; {times_text(t)} (torch.mm) bound_ms={b[0]:.6f} "
            f"({b[1]})")
        if size == PROBE_N_WIDE:
            spread = [cuda_ms(lambda: probe.probe_mm(a), reps)
                      for _ in range(TURN_ROUNDS)]
            log(f"phase 13a K14 {size}: cuda_ms over {TURN_ROUNDS} readings "
                f"{[round(x, 5) for x in spread]} (spread "
                f"{max(spread) - min(spread):.5f} ms)")
        if parent is not None:
            OP = parent["ops.probe"]
            if not torch.equal(OP.probe_mm(a).view(torch.int16),
                               want.view(torch.int16)):
                bad.append(f"the parent's K14 at {size} disagrees")
            turns[f"K14 probe_mm {size}"] = (lambda a=a: OP.probe_mm(a),
                                             lambda a=a: probe.probe_mm(a))
        if size == PROBE_N:
            row = dict(name="probe_mm", route="cuda",
                       source="karmada_tpu_torch/ops/csrc/probe.cu",
                       replaces="karmada_tpu/utils/deviceprobe.py:100",
                       launches=launches, max_abs_err=err, ms=t["ms"],
                       plain_ms=t["plain_ms"], bound_ms=b[0], bound_by=b[1],
                       library_ms=t["library_ms"])
    try:
        probe.probe_mm(torch.zeros((PROBE_N_REFUSED, PROBE_N_REFUSED),
                                   dtype=torch.bfloat16, device=dev))
        bad.append(f"K14 took n = {PROBE_N_REFUSED}")
    except ValueError as e:
        log(f"phase 13a K14 at {PROBE_N_REFUSED}: ValueError {e}")
    if turns:
        lifecycle_turns("13a", turns, reps)
    if bad:
        raise AssertionError("phase 13a: " + "; ".join(bad))
    return row


def marker_input(rng, size: int, offset: int, dev) -> tuple:
    """Seeded int64 values (negatives and the int64 edges among them) on
    the card as a view `offset` elements into its buffer (1: 8 bytes off
    a 16-byte boundary), and their host copy."""
    h = rng.integers(-(1 << 62), 1 << 62, size, dtype=np.int64)
    h[:3] = (np.iinfo(np.int64).min, np.iinfo(np.int64).max, -1)
    buf = torch.empty(size + offset, dtype=torch.int64, device=dev)
    buf[offset:].copy_(torch.from_numpy(h))
    return buf[offset:], h


def phase_profile(dev, reps, parent=None) -> dict:
    """13b: capture_profile(1.0) (held MIN_DEVICE_WINDOW_S on the card,
    a window the profiler lost taken again) with the launch counts reset
    just before and read just after: ok, a chrome trace that holds a
    device kernel event named marker_affine_i64 -- K15's kernel, one a
    marker launch -- and a K15 launch count equal to the markers of the
    windows taken; K15 against its plain version, bit for bit, at 128,
    2^20 and 2^20 + 3 (an odd length) int64 elements, each also as an
    8-byte-offset view, negatives and the int64 edges among them; at 128
    and 2^20 kernel_times beside torch.add(1, a, alpha=2), and with
    `parent` the parent's K15 in turns; memory_stats_payload() against
    torch.cuda.memory_stats and mem_get_info read right after.  Returns
    K15's report row."""
    from karmada_tpu_torch.obs import devprof
    from karmada_tpu_torch.ops import kernels, probe

    bad = []
    torch.cuda.synchronize()
    kernels.reset_counts()
    with tempfile.TemporaryDirectory() as tmp:
        rec = devprof.capture_profile(1.0, tmp)
        launches = kernels.LAUNCHES["marker_affine"]
        events = []
        if rec.get("files"):
            with open(os.path.join(rec["dir"], devprof.TRACE_FILE)) as f:
                events = json.load(f).get("traceEvents", [])
    kernel_events = [e for e in events if e.get("cat") == "kernel"]
    marks = [e for e in kernel_events
             if e.get("name") == "marker_affine_i64"]
    windows = rec.get("windows") or 0
    log(f"phase 13b capture: ok {rec.get('ok')} in {rec.get('wall_s')} s "
        f"(window {rec.get('seconds')} s, {rec.get('requested_s')} s asked; "
        f"{windows} window(s), {rec.get('lost_windows')} of them lost to "
        f"the profiler; {rec.get('error')}), files {rec.get('files')}, "
        f"{len(events)} trace events, {len(kernel_events)} device kernel "
        f"events, marker kernels {len(marks)} of {rec.get('markers')} "
        f"launched ({[e.get('dur') for e in marks]} us); K15 launches "
        f"{launches}")
    if not rec.get("ok") or not rec.get("total_bytes"):
        bad.append(f"capture {rec}")
    if not marks:
        bad.append("the trace holds no marker_affine_i64 kernel event")
    if launches != (rec.get("markers") or 0) * windows:
        bad.append(f"K15 launches {launches} in the capture, markers "
                   f"{rec.get('markers')} x {windows} window(s)")
    rng = np.random.default_rng(15)
    row, turns = None, {}
    for size in (MARKER_N, MARKER_N_WIDE, MARKER_N_ODD):
        for offset in (0, 1):
            a, h = marker_input(rng, size, offset, dev)
            got, want = probe.marker_affine(a), probe.marker_affine_plain(a)
            torch.cuda.synchronize()
            same = torch.equal(got, want)
            with np.errstate(over="ignore"):
                same = same and np.array_equal(got.cpu().numpy(), h * 2 + 1)
            if not same:
                bad.append(f"K15 at {size} (offset {offset}) differs from "
                           "its plain version")
            line = (f"phase 13b K15 marker_affine {size} int64, "
                    f"{8 * offset}-byte offset: equal {same}")
            if offset or size == MARKER_N_ODD:
                log(line)
                continue
            # the one PyTorch call computing 1 + 2 a (the yardstick only)
            one = torch.ones((), dtype=a.dtype, device=a.device)
            if not torch.equal(torch.add(one, a, alpha=2), want):
                bad.append(f"torch.add(1, a, alpha=2) at {size} differs")
            b = bound_ms(2 * nbytes(a), 2.0 * size)
            t = kernel_times(lambda: probe.marker_affine(a),
                             lambda: probe.marker_affine_plain(a),
                             lambda: torch.add(one, a, alpha=2), b[0], reps)
            log(f"{line}; {times_text(t)} (torch.add(1, a, alpha=2)) "
                f"bound_ms={b[0]:.6f} ({b[1]})")
            if parent is not None:
                OP = parent["ops.probe"]
                if not torch.equal(OP.marker_affine(a), want):
                    bad.append(f"the parent's K15 at {size} disagrees")
                turns[f"K15 marker_affine {size}"] = (
                    lambda a=a: OP.marker_affine(a),
                    lambda a=a: probe.marker_affine(a))
            if size == MARKER_N:
                row = dict(name="marker_affine", route="cuda",
                           source="karmada_tpu_torch/ops/csrc/probe.cu",
                           replaces="karmada_tpu/obs/devprof.py:233",
                           launches=launches, max_abs_err=0.0 if same
                           else float("inf"), ms=t["ms"],
                           plain_ms=t["plain_ms"], bound_ms=b[0],
                           bound_by=b[1], library_ms=t["library_ms"])
    if turns:
        lifecycle_turns("13b", turns, reps)
    torch.cuda.synchronize()
    payload = devprof.memory_stats_payload()
    stats = torch.cuda.memory_stats(0)
    total = torch.cuda.mem_get_info(0)[1]
    want = {"bytes_in_use": stats["allocated_bytes.all.current"],
            "peak_bytes_in_use": stats["allocated_bytes.all.peak"],
            "bytes_limit": total}
    log(f"phase 13b memory_stats_payload {payload}; torch.cuda "
        f"{want}; refresh_memory_gauges read "
        f"{devprof.refresh_memory_gauges()} values")
    if payload[0]["memory_stats"] != want:
        bad.append(f"memory_stats_payload {payload[0]} != {want}")
    if bad:
        raise AssertionError("phase 13b: " + "; ".join(bad))
    return row


def phase_warm(fleet, items, dev, args, first3_s) -> None:
    """13c: warm_executables over config 5's fleet with warm_shapes(4096,
    4096) x the variants phase 3's cycle dispatches (chunk 4096 over more
    bindings than one chunk: plain and carry); every label done, its
    seconds and device ms; a second call already-warm for every label;
    then one forward chunk of 4,096 bindings beside phase 3's first."""
    from karmada_tpu_torch.estimator.general import GeneralEstimator
    from karmada_tpu_torch.obs import devprof
    from karmada_tpu_torch.ops import aotcache
    from karmada_tpu_torch.scheduler.core import schedule_items

    shapes = aotcache.warm_shapes(4096, args.chunk)
    variants = aotcache.variants_for(0.0, len(items) > args.chunk)
    kw = dict(shapes=shapes, variants=variants, waves=args.waves,
              device=dev)
    t0 = time.perf_counter()
    first = aotcache.warm_executables(fleet, GeneralEstimator(), **kw)
    wall = time.perf_counter() - t0
    labels = [k for k in first if k != "_totals"]
    ledger = aotcache.state_payload()["warmup"]
    costs = devprof.cost_ledger()
    for label in labels:
        r = first[label]
        log(f"phase 13c warm {label}: "
            + (f"{r['seconds']:.3f} s, device {r.get('device_ms')} ms"
               if isinstance(r, dict) else str(r)))
    second = aotcache.warm_executables(fleet, GeneralEstimator(), **kw)
    log(f"phase 13c warm: {len(labels)} labels ({len(shapes)} shapes x "
        f"{variants}) in {wall:.2f} s, totals {first['_totals']}; second "
        f"call {second['_totals']}")
    bad = [f"{k}: {ledger.get(k)}" for k in labels
           if ledger.get(k, {}).get("state") != "done" or k not in costs]
    bad += [f"{k} second call {second.get(k)}" for k in labels
            if second.get(k) != "already-warm"]
    if len(labels) != len(shapes) * len(variants):
        bad.append(f"{len(labels)} labels")
    part = items[:args.chunk]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    schedule_items(part, fleet, chunk=args.chunk, waves=args.waves,
                   device=dev)
    torch.cuda.synchronize()
    chunk_s = time.perf_counter() - t0
    log(f"phase 13c forward chunk after the warm: {len(part)} bindings in "
        f"{chunk_s:.3f} s; phase 3's first chunk {first3_s:.3f} s")
    if bad:
        raise AssertionError(f"phase 13c: {len(bad)} failed checks: "
                             + "; ".join(bad[:8]))


class HoldAfterDispatch:
    """Holds the guarded cycle's thread, once, right after
    solver.dispatch_compact returned -- its chunk's K1 / K2 waves queued
    on the card in its own workspaces -- until `release`."""

    def __init__(self):
        from karmada_tpu_torch.ops import solver

        self.solver, self.orig = solver, solver.dispatch_compact
        self.reached, self.release = threading.Event(), threading.Event()
        self.armed = True

    def __enter__(self):
        def held(*a, **kw):
            out = self.orig(*a, **kw)
            if self.armed and threading.current_thread().name == \
                    "scheduler-device-cycle":
                self.armed = False
                self.reached.set()
                self.release.wait(GUARD_RAISED_S)
            return out
        self.solver.dispatch_compact = held
        return self

    def __exit__(self, *exc):
        self.release.set()
        self.solver.dispatch_compact = self.orig


def guard_run(M, dev, fleet, placements, items, guarded: bool,
              hold: Optional[HoldAfterDispatch] = None):
    """Phase 13d's plane built on the card and ticked to quiescence.
    Guarded: the mid-serve guard at GUARD_TIMEOUT_S (GUARD_HOLD_S with
    `hold`, which keeps the abandoned cycle's thread after its dispatch
    while the later cycles run) with device_recover_cycles=1, and the
    timeout raised to GUARD_RAISED_S by the harness right after the
    degrade, so the next cycle re-arms on the card.  Unguarded: no
    guard, the same backend cycle by cycle -- native for the first
    cycle, the card after it (native and the card's 8-wave solve place
    differently under contention, so an all-card run is not the
    reference for a run whose first cycle degraded).  Returns (plane,
    ticks, converged, wall)."""
    kw = (dict(device_cycle_timeout_s=GUARD_HOLD_S if hold else
               GUARD_TIMEOUT_S, device_recover_cycles=1) if guarded else {})
    with UidSeq():
        cp, _steps = build_loop(M, dev, fleet, placements, items, **kw)
        sched = cp.scheduler
        if guarded:
            degrade = sched._degrade_device

            def degrade_then_raise():
                degrade()
                sched.device_cycle_timeout_s = GUARD_RAISED_S
            sched._degrade_device = degrade_then_raise
        else:
            sched.backend = "native"
            log_cycle = sched._log_cycle

            def log_then_card(*a):
                log_cycle(*a)
                sched.backend = "device"
            sched._log_cycle = log_then_card
        if hold is None:
            ticks, converged, wall = run_loop(cp, "13d", verbose=False)
        else:
            with hold:
                ticks, converged, wall = run_loop(cp, "13d", verbose=False)
                # read before the release: the zombie held all along
                hold.held_through = sched.abandoned_cycles()
    return cp, ticks, converged, wall


def guard_checks(label, cp, ref, ticks, converged, wall, ref_run,
                 n_items) -> list:
    """One guarded run's line and its failed checks against the unguarded
    run `ref`."""
    sched = cp.scheduler
    done = sched.join_abandoned(120)
    cycles = list(sched.cycle_log)
    trans = sched.backend_transitions()
    ab = sched.abandoned_cycles()
    snap, unguarded = loop_snapshot(cp), loop_snapshot(ref)
    diff = sorted((k for k in set(snap) | set(unguarded)
                   if snap.get(k) != unguarded.get(k)), key=repr)
    log(f"phase 13d {label}: converged {converged} in {ticks} tick(s), "
        f"{wall:.2f} s (unguarded run {ref_run}); cycles (backend, "
        f"bindings, chunks) "
        f"{[(c['backend'], c['bindings'], c['chunks']) for c in cycles]}, "
        f"unguarded "
        f"{[(c['backend'], c['bindings']) for c in ref.scheduler.cycle_log]}"
        f"; transitions {trans}; abandoned {ab} (zombies done {done}); "
        f"faults {loop_faults(cp)}; snapshot {len(snap)} objects, "
        f"differing from the unguarded run's {len(diff)}")
    bad = []
    c0 = cycles[0] if cycles else {}
    if c0.get("backend") != "native" or c0.get("fault") or \
            c0.get("bindings") != n_items or c0.get("errors"):
        bad.append(f"{label}: the abandoned cycle's entry {c0}")
    if trans != {"degraded_to_native": 1, "degraded_to_serial": 0,
                 "rearmed": 1}:
        bad.append(f"{label}: transitions {trans}")
    if len(cycles) < 2 or any(c["backend"] != "device" or c["chunks"] < 1
                              for c in cycles[1:]):
        bad.append(f"{label}: a cycle after the re-arm ran off the card")
    if [c["backend"] for c in ref.scheduler.cycle_log] != \
            [c["backend"] for c in cycles]:
        bad.append(f"{label}: the unguarded run took other backends")
    if not done or len(ab) != 1 or ab[0]["cancelled"] is not True or \
            ab[0]["chunks"] != 0 or ab[0]["error"]:
        bad.append(f"{label}: abandoned cycles {ab}")
    if not converged or any(loop_faults(cp).values()):
        bad.append(f"{label}: converged {converged}, faults "
                   f"{loop_faults(cp)}")
    if diff:
        bad.append(f"{label}: {len(diff)} objects differ from the "
                   f"unguarded run, first {diff[:4]}")
    return bad


def phase_guard(M, fleet, items, dev, seed) -> None:
    """13d: phase 12a's members and placements with GUARD_TEMPLATES
    templates on the card under the mid-serve guard (guard_run).  The first
    scheduler cycle, a real device cycle, is abandoned: the plane degrades
    to native and that cycle still gives every binding its outcome; the
    next cycle re-arms and runs on the card.  Ticked to quiescence:
    transitions 1 degrade to native and 1 re-arm, every later cycle on the
    card, the zombie's cycle cancelled with nothing recorded, no contained
    fault, and the snapshot equal to the unguarded run's.  Twice: with
    the 1 ms timeout (the zombie stops at its first gate), and held --
    the zombie kept right after its chunk's dispatch, its waves queued
    on the card, through every later cycle, released after the loop (the
    re-armed cycles run beside it in workspaces of their own)."""
    fleet = fleet[:LOOP_PARITY_MEMBERS]
    placements = build_placements(M, random.Random(seed),
                                  [c.name for c in fleet])
    items = items[:GUARD_TEMPLATES]
    ref, *ref_run = guard_run(M, dev, fleet, placements, items, False)
    bad = [] if not any(loop_faults(ref).values()) else [
        f"unguarded faults {loop_faults(ref)}"]
    cp, *run = guard_run(M, dev, fleet, placements, items, True)
    bad += guard_checks("guard", cp, ref, *run, ref_run, len(items))
    del cp
    hold = HoldAfterDispatch()
    cp, *run = guard_run(M, dev, fleet, placements, items, True, hold)
    held = hold.held_through
    log(f"phase 13d held: the zombie reached its dispatch "
        f"{hold.reached.is_set()}; abandoned cycles at the loop's end, "
        f"before the release {held}")
    if not hold.reached.is_set() or len(held) != 1 or \
            not held[0]["running"]:
        bad.append(f"held: the zombie was not held after its dispatch "
                   f"through the loop ({held})")
    bad += guard_checks("held", cp, ref, *run, ref_run, len(items))
    if bad:
        raise AssertionError(f"phase 13d: {len(bad)} failed checks: "
                             + "; ".join(bad))


# -- phase 16: sustained traffic on the card -----------------------------------

SOAK_SCENARIOS = ("steady", "storm", "churn", "whatif", "megafleet")
SOAK_HEAVY = ("megafleet-heavy", "storm-heavy")
SOAK_SEED = 11
RESOLVE_EVERY = 8          # 16b: every 8th cycle re-solved on ops/serial
# the soaks' flight-recorder ring: every trace of a run kept (the
# driver's default, 4,096, drops the first cycles of a heavy run from
# the report), and a ledger as large (its shed records count bindings)
SOAK_TRACES = 1 << 17
CLI_MEMBERS = 8            # 16c's joins
CLI_PODS = 2_000           # their pods: the load never runs a member full
SERVE_SECONDS = 40.0       # 16c's serve window: the 320 arrivals at 10/s
CLI_TIMEOUT_S = 240.0
PROFILE_SECONDS = 4        # 16c's /debug/profile window
#: the kernels of a serving cycle (ops/csrc's __global__ functions but
#: K14's probe, K15's marker, K12's dirty pass and K4's floor test): a
#: profile window over a serving plane must name one
SERVING_KERNELS = (
    "capacity_kernel", "schedule_rows_prepare", "schedule_rows_finish",
    "webster_rows", "compact_kernel", "explain_rows", "scatter_kernel",
    "gather_kernel", "rebalance_score_kernel", "spread_group_info_kernel",
    "spread_pick_kernel", "shortlist_topk", "group_sums")


def soak_comparable(payload: dict) -> dict:
    """A SOAK payload without `wall_s`, `stage_utilization` reduced to its
    span names and counts, a chaos soak's fire log without its
    wall-clock stamps (`ts`), and the resident and rebalance planes'
    stats without the name of their device: what card and CPU must
    agree on."""
    out = json.loads(json.dumps(payload, default=str))
    out.pop("wall_s")
    out["stage_utilization"] = {
        k: v["count"] for k, v in out["stage_utilization"].items()}
    for rec in (out.get("chaos") or {}).get("recent", ()):
        rec.pop("ts", None)
    for plane in ("resident", "rebalance"):
        if isinstance(out.get(plane), dict):
            out[plane].pop("device", None)
    return out


def soak_placements(plane) -> dict:
    return {f"{rb.namespace}/{rb.name}": tuple(sorted(
        (t.name, t.replicas) for t in rb.spec.clusters))
        for rb in plane.store.visit("ResourceBinding")}


def soak_run(name: str, device, seed: int, strip_events: bool = False,
             record: bool = False, device_time: bool = False,
             scenario=None, plane_kw: Optional[dict] = None,
             warm: bool = False) -> dict:
    """One compressed soak of `name` on ServeSlice(backend="device") on
    `device` (`plane_kw` may name another backend), into a fresh
    process ledger (restored after).  With
    `record`, every RESOLVE_EVERY-th cycle's input (the bindings and
    clusters its solve saw, copied) and results are kept; with
    `device_time`, an event pair around each kernel launch of the run
    gives the kernels' device seconds.  `scenario` replaces the catalog's
    `name`, `plane_kw` goes to ServeSlice, and `warm` runs
    loadgen.warm_device_path first (a guarded soak's first calls must not
    read as a hung cycle).  `launches` holds the kernel launch counts of
    the driver's run alone: they are set to 0 after the warm-up, just
    before it, and read just after it."""
    import copy

    from karmada_tpu_torch import loadgen as L
    from karmada_tpu_torch.obs import events as obs_events
    from karmada_tpu_torch.ops import kernels
    from karmada_tpu_torch.ops import shortlist as SL
    from karmada_tpu_torch.scheduler import service
    from tools import soak_hold

    if scenario is None:
        scenario = L.get_scenario(name)
    if strip_events:
        scenario = dataclasses.replace(scenario, events=())
    clock = L.VirtualClock()
    model = L.ServiceModel()
    plane = L.ServeSlice(scenario, clock, model, device=device,
                         **{"backend": "device", **(plane_kw or {})})
    if warm:
        L.warm_device_path(plane)
    sched = plane.scheduler
    recorded, cycles = [], [0]
    if record:
        solve = sched.solve_batch

        def solve_batch(bindings, clusters, **kw):
            res = solve(bindings, clusters, **kw)
            if not kw.get("detached"):
                cycles[0] += 1
                if cycles[0] % RESOLVE_EVERY == 1:
                    recorded.append((copy.deepcopy(bindings),
                                     copy.deepcopy(list(clusters)),
                                     dict(res[0])))
            return res

        sched.solve_batch = solve_batch
    pairs = []
    orig_launch = kernels.launch
    if device_time:
        def launch(source, args, entry=None, count=None, device=None):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            orig_launch(source, args, entry, count, device)
            e1.record()
            pairs.append((e0, e1))

        kernels.launch = launch
    driver = L.LoadDriver(plane, scenario, clock=clock, model=model,
                          seed=seed, trace_capacity=SOAK_TRACES)
    prev = obs_events.ledger()
    obs_events.configure(capacity=SOAK_TRACES)
    sl0, fb0 = dict(SL.COUNTS), dict(SL.FALLBACKS)
    t0 = time.perf_counter()
    try:
        # the counts are this run's alone: the warm-up's launches are not
        kernels.reset_counts()
        with soak_hold.still_cycle_clock(service), \
                soak_hold.held_cut_timers(service):
            payload = driver.run()
        launches = dict(kernels.LAUNCHES)
        if device_time:
            torch.cuda.synchronize()
        shed = {(e.ref.namespace, e.ref.name)
                for e in obs_events.ledger().list(kind="ResourceBinding")
                if e.reason == obs_events.REASON_BINDING_SHED}
        never = [k for k, f in driver._flight.items()  # noqa: SLF001
                 if not f.done]
    finally:
        obs_events._LEDGER[0] = prev  # noqa: SLF001 — restore the ledger
        kernels.launch = orig_launch
    wall = time.perf_counter() - t0
    return {
        "payload": payload, "comparable": soak_comparable(payload),
        "placements": soak_placements(plane),
        "bindings": [rb for rb in plane.store.visit("ResourceBinding")
                     if rb.name.startswith("lg-b")] if record else None,
        "faults": sched.faults(),
        "never_shed": sum(k in shed for k in never),
        "never": len(never), "dropped": driver.recorder.dropped,
        "whatif": driver.whatif_results,
        "shortlist": SL.COUNTS["dispatches"] - sl0["dispatches"],
        "fallbacks": {k: v - fb0.get(k, 0) for k, v in SL.FALLBACKS.items()
                      if v - fb0.get(k, 0)},
        "wall": wall, "recorded": recorded, "waves": sched.waves,
        "backend": sched.backend,
        "plane_bindings": list(plane.store.visit("ResourceBinding")),
        "estimators": sched.estimators,
        "chunk": sched.pipeline_chunk,
        "device_s": (sum(a.elapsed_time(b) for a, b in pairs) / 1e3
                     if device_time else None),
        "device_pairs": len(pairs), "launches": launches}


def soak_job(name: str, seed: int) -> dict:
    """CpuRefs job: the soak on device="cpu", its picklable part."""
    r = soak_run(name, "cpu", seed)
    return {k: r[k] for k in ("comparable", "placements", "faults",
                              "whatif", "wall")}


def submit_soaks(refs) -> None:
    for name in SOAK_SCENARIOS + ("storm-heavy",):
        refs.submit(("16", name), soak_job, name, SOAK_SEED)
    for name in FAULT_SOAKS:
        refs.submit(("17", name), fault_soak_job, name)


def serial_resolve(recorded, waves: int, estimators) -> tuple:
    """Re-solve recorded cycle inputs on ops/serial, one wave at a time:
    a wave's bindings (the solver's contiguous rows: B, the batch padded
    to a power of two, over its effective waves) solve against the
    snapshot less what the earlier waves placed (pods and requests a
    replica), as the device waves price.  (cycles, bindings, mismatches
    [(binding, serial, device)])."""
    from karmada_tpu_torch.ops import serial
    from karmada_tpu_torch.ops import solver as PS
    from karmada_tpu_torch.ops import tensors as T
    from karmada_tpu_torch.utils.quantity import Quantity

    cal = serial.make_cal_available(estimators)

    def norm(r):
        return (tuple(sorted((t.name, t.replicas) for t in r))
                if isinstance(r, list) else type(r).__name__)

    bad, n = [], 0
    for bindings, clusters, results in recorded:
        by = {c.name: c for c in clusters}
        B = T._next_pow2(max(len(bindings), 1), 8)  # noqa: SLF001
        per_wave = B // PS._effective_waves(B, waves)  # noqa: SLF001
        placed = []
        for i, rb in enumerate(bindings):
            if i % per_wave == 0:
                for req, targets in placed:
                    for t in targets:
                        summ = by[t.name].status.resource_summary
                        for res, q in req.items():
                            cur = summ.allocated.get(res)
                            summ.allocated[res] = Quantity.from_milli(
                                (cur.milli if cur else 0)
                                + q * t.replicas)
                placed = []
            try:
                out = serial.schedule(rb.spec, rb.status, clusters, cal)
            except Exception as e:  # noqa: BLE001 — the binding's outcome
                out = e
            if isinstance(out, list):
                rr = rb.spec.replica_requirements
                req = {"pods": 1000}
                for res, q in (rr.resource_request if rr else {}).items():
                    req[res] = q.milli
                placed.append((req, out))
            n += 1
            if norm(out) != norm(results.get(i)):
                bad.append((rb.name, norm(out), norm(results.get(i))))
    return len(recorded), n, bad


def soak_diff(a: dict, b: dict) -> list:
    return [k for k in sorted(set(a) | set(b)) if a.get(k) != b.get(k)]


def soak_vs_cpu(label: str, card: dict, cpu: dict) -> None:
    """Card against the CPU replay: payloads, placements, whatif
    answers."""
    diff = soak_diff(card["comparable"], cpu["comparable"])
    if diff:
        raise AssertionError(
            f"phase {label}: SOAK payload card != CPU in {diff}: "
            + "; ".join(f"{k}: {card['comparable'].get(k)} vs "
                        f"{cpu['comparable'].get(k)}" for k in diff[:3]))
    if card["placements"] != cpu["placements"]:
        raise AssertionError(f"phase {label}: final placements card != CPU")
    if card["whatif"] != cpu["whatif"]:
        raise AssertionError(f"phase {label}: what-if answers card != CPU")


def sum_launches(counts) -> dict:
    out = {}
    for c in counts:
        for k, v in c.items():
            out[k] = out.get(k, 0) + v
    return out


def phase_soaks(dev, refs) -> dict:
    """16a: the compressed soaks on the card, each held against its CPU
    replay (CpuRefs).  Returns the launch counts of the card soaks."""
    torch.cuda.synchronize()
    runs = {}
    for name in SOAK_SCENARIOS:
        runs[name] = soak_run(name, dev, SOAK_SEED)
    torch.cuda.synchronize()
    launches = sum_launches(r["launches"] for r in runs.values())
    control = soak_run("whatif", dev, SOAK_SEED, strip_events=True)
    for name, r in runs.items():
        p = r["payload"]
        cpu = refs.result(("16", name))
        soak_vs_cpu(f"16a {name}", r, cpu)
        log(f"phase 16a {name}: {p['injected']} injected, "
            f"{p['scheduled']} scheduled, admission {p['admission']}, "
            f"{p['cycles']['count']} cycles (batch p50 "
            f"{p['cycles']['batch_size'].get('p50')}), latency p99 "
            f"{p['schedule_latency_s'].get('p99')} s, dwell p99 "
            f"{p['queue_dwell_s'].get('p99')} s (virtual), events "
            f"{p['events']['recorded']}; card {r['wall']:.2f} s, CPU "
            f"replay {cpu['wall']:.2f} s; equal to the CPU replay")
        if r["faults"] or cpu["faults"]:
            raise AssertionError(f"phase 16a {name}: faults {r['faults']} "
                                 f"/ {cpu['faults']}")
        if name in ("steady", "whatif", "megafleet") and \
                p["scheduled"] != p["injected"]:
            raise AssertionError(f"phase 16a {name}: {p['scheduled']} of "
                                 f"{p['injected']} scheduled")
    mf = runs["megafleet"]
    if mf["shortlist"] <= 0 or mf["fallbacks"]:
        raise AssertionError(f"phase 16a megafleet: shortlist dispatches "
                             f"{mf['shortlist']}, fallbacks "
                             f"{mf['fallbacks']}")
    if runs["whatif"]["placements"] != control["placements"]:
        raise AssertionError("phase 16a whatif: placements moved against "
                             "the control run without the queries")
    if len(runs["whatif"]["whatif"]) != 5:
        raise AssertionError("phase 16a whatif: the queries did not run")
    log(f"phase 16a: megafleet shortlist dispatches {mf['shortlist']}, 0 "
        f"fallbacks; whatif placements equal the control run's; launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    for k in ("capacity", "schedule_rows", "webster_batch", "compact",
              "shortlist_topk", "group_sums"):
        if launches[k] <= 0:
            raise AssertionError(f"phase 16a: kernel {k} never launched")
    return launches


def stage_shares(payload) -> dict:
    return {k: v.get("of_cycle") for k, v in
            sorted(payload["stage_utilization"].items())
            if k.startswith("pipeline.")}


def phase_heavy(dev, refs) -> dict:
    """16b: megafleet-heavy and storm-heavy at full width on the card:
    invariants, every RESOLVE_EVERY-th cycle re-solved on ops/serial, and
    storm-heavy whole against its CPU replay.  Returns the launch counts
    of the card runs."""
    torch.cuda.synchronize()
    runs = {name: soak_run(name, dev, SOAK_SEED, record=True,
                           device_time=True) for name in SOAK_HEAVY}
    launches = sum_launches(r["launches"] for r in runs.values())
    for name, r in runs.items():
        p = r["payload"]
        dev_s = r["device_s"]
        log(f"phase 16b {name}: " + json.dumps({
            "injected": p["injected"], "scheduled": p["scheduled"],
            "admission": p["admission"],
            "schedule_latency_s": p["schedule_latency_s"],
            "queue_dwell_s": p["queue_dwell_s"],
            "cycles": p["cycles"], "stage_of_cycle": stage_shares(p),
            "wall_s": round(r["wall"], 3),
            "kernel_device_s": round(dev_s, 4),
            "kernel_launch_pairs": r["device_pairs"],
            "idle_share": round(1.0 - dev_s / r["wall"], 4),
            "never_scheduled_shed": r["never_shed"]}))
        if r["faults"]:
            raise AssertionError(f"phase 16b {name}: faults {r['faults']}")
        # every injected binding scheduled or shed (a binding shed
        # again on a later re-offer counts once), the queue drained, the
        # ring whole
        if (p["scheduled"] + r["never_shed"] != p["injected"]
                or r["never_shed"] != r["never"]
                or any(p["residual_queue"].values()) or r["dropped"]):
            raise AssertionError(
                f"phase 16b {name}: scheduled {p['scheduled']} + never "
                f"scheduled but shed {r['never_shed']} (never scheduled "
                f"{r['never']}) vs injected {p['injected']}; residual "
                f"{p['residual_queue']}; traces dropped {r['dropped']}")
        if r["fallbacks"]:
            raise AssertionError(f"phase 16b {name}: shortlist fallbacks "
                                 f"{r['fallbacks']}")
        t0 = time.perf_counter()
        assert max(len(b) for b, _, _ in r["recorded"]) <= r["chunk"]
        n_cyc, n_rows, bad = serial_resolve(r["recorded"], r["waves"],
                                            r["estimators"])
        log(f"phase 16b {name}: {n_cyc} cycles ({n_rows} bindings, every "
            f"{RESOLVE_EVERY}th cycle) re-solved on ops/serial one wave at "
            f"a time in {time.perf_counter() - t0:.1f} s: "
            f"{len(bad)} differ")
        if bad or not n_rows:
            raise AssertionError(f"phase 16b {name}: serial re-solve "
                                 f"differs: {bad[:3]}")
    mh = runs["megafleet-heavy"]
    if mh["shortlist"] <= 0:
        raise AssertionError("phase 16b megafleet-heavy: no shortlist "
                             "dispatch")
    for rb in mh["bindings"]:
        names = set(rb.spec.placement.cluster_affinity.cluster_names)
        total = sum(t.replicas for t in rb.spec.clusters)
        if total != 5 or not {t.name for t in rb.spec.clusters} <= names:
            raise AssertionError(f"phase 16b megafleet-heavy: {rb.name} "
                                 f"placed {rb.spec.clusters} outside its "
                                 "region or not 5 replicas")
    log(f"phase 16b megafleet-heavy: {len(mh['bindings'])} placements, "
        f"each 5 replicas inside its region; shortlist dispatches "
        f"{mh['shortlist']}, 0 fallbacks")
    soak_vs_cpu("16b storm-heavy", runs["storm-heavy"],
                refs.result(("16", "storm-heavy")))
    log("phase 16b storm-heavy: equal to the CPU replay")
    for k in ("capacity", "schedule_rows", "webster_batch", "compact",
              "shortlist_topk", "group_sums"):
        if launches[k] <= 0:
            raise AssertionError(f"phase 16b: kernel {k} never launched")
    return launches


CLI_APP = """\
apiVersion: apps/v1
kind: Deployment
metadata:
  name: web
  namespace: default
spec:
  replicas: 6
  template:
    spec:
      containers:
      - name: web
        image: web:1
        resources:
          requests:
            cpu: 500m
---
apiVersion: policy.karmada.io/v1alpha1
kind: PropagationPolicy
metadata:
  name: web-pp
  namespace: default
spec:
  resourceSelectors:
  - apiVersion: apps/v1
    kind: Deployment
    name: web
  placement:
    replicaScheduling:
      replicaSchedulingType: Divided
      replicaDivisionPreference: Weighted
"""


def cli(plane_dir: str, *argv, timeout: float = CLI_TIMEOUT_S) -> str:
    """One `python -m karmada_tpu_torch.cli --dir DIR ...` from the
    checkout; its stdout (raises on a non-zero exit)."""
    proc = subprocess.run(
        [sys.executable, "-m", "karmada_tpu_torch.cli", "--dir", plane_dir,
         *argv], capture_output=True, text=True, timeout=timeout,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    if proc.returncode != 0:
        raise AssertionError(f"cli {' '.join(argv)}: exit "
                             f"{proc.returncode}: {proc.stderr[-2000:]}")
    return proc.stdout


def http_get(base: str, path: str, timeout: float = 60.0) -> tuple:
    """(status, body) of one GET on the debug server: a JSON body parsed,
    a text one as text."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(base + path, timeout=timeout) as r:
            code, ctype, raw = r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        code, ctype, raw = e.code, e.headers["Content-Type"], e.read()
    text = raw.decode()
    return code, (json.loads(text) if ctype == "application/json"
                  else text)


def debug_route_checks(base: str) -> list:
    """Every route of the serve process's debug server: its status and the
    shape of its payload (the planes serve arms: the resident, rebalance,
    explain, telemetry, incident, facade, load and flight-recorder ones;
    chaos disarmed).  Returns the failed checks."""
    bad = []

    def check(path, code, ok=lambda b: True):
        got, body = http_get(base, path)
        try:
            fine = got == code and ok(body)
        except (KeyError, TypeError, IndexError, AttributeError):
            fine = False
        if not fine:
            bad.append(f"{path}: {got} {str(body)[:300]}")
        return body

    check("/metrics", 200, lambda b: "karmada_scheduler_" in b
          and "karmada_lock_hold_seconds" in b)
    check("/healthz", 200, lambda b: b == "ok")
    check("/readyz", 200)
    check("/debug/state", 200, lambda b: {
        "objects_by_kind", "events", "device_probe", "aot", "mesh",
        "resident", "shortlist", "locks", "traces", "explain"} <= set(b)
        and b["resident"]["enabled"] and b["traces"] is not None
        and b["explain"] is not None and b["locks"]["armed"]
        and b["mesh"]["devices"] == 1)
    traces = check("/debug/traces", 200,
                   lambda b: b["enabled"] and b["summaries"])
    check("/debug/traces/slow", 200, lambda b: b["enabled"])
    if isinstance(traces, dict) and traces.get("summaries"):
        # the newest: the ring is oldest-first, and its oldest trace is the
        # next the loadgen traffic evicts
        tid = traces["summaries"][-1]["trace_id"]
        check(f"/debug/traces/{tid}", 200,
              lambda b: isinstance(b, str) and "|" in b)
        check(f"/debug/traces/{tid}?format=json", 200,
              lambda b: b["trace_id"] == tid)
    check("/debug/traces/nosuchtrace", 404, lambda b: b["error"])
    check("/debug/load", 200,
          lambda b: b["enabled"] and b["scenario"] == "steady")
    check("/debug/resident?recent=4", 200,
          lambda b: b["enabled"] and b["device"].startswith("cuda")
          and isinstance(b["recent_cycles"], list))
    check("/debug/chaos", 200, lambda b: b == {"enabled": False})
    check("/debug/rebalance", 200,
          lambda b: b["enabled"] and b["device"].startswith("cuda"))
    check("/debug/facade", 200, lambda b: b["enabled"])
    check("/debug/timeseries?points=0", 200,
          lambda b: b["enabled"] and b["series"])
    check("/debug/timeseries?n=4&prefix=karmada_scheduler", 200,
          lambda b: b["enabled"])
    check("/debug/slo", 200, lambda b: b["enabled"] and b["objectives"])
    check("/debug/incidents", 200, lambda b: b["enabled"])
    check("/debug/incidents/inc-nosuch", 404, lambda b: b["error"])
    check("/debug/events?n=8", 200, lambda b: b["recent"])
    check("/debug/events/default/web-deployment", 200,
          lambda b: b["binding"]["clusters"])
    explain = check("/debug/explain", 200,
                    lambda b: b["enabled"] and b["decisions"])
    if isinstance(explain, dict) and explain.get("decisions"):
        key = explain["decisions"][-1]["key"]
        check(f"/debug/explain/{key}", 200, lambda b: b["key"] == key
              and b["clusters"])
    check("/debug/explain/default/nosuchbinding", 404, lambda b: b["error"])
    check("/whatif?query=bogus", 400, lambda b: b["error"])
    check("/debug/nosuchendpoint", 404, lambda b: b["error"])
    return bad


def debug_server_phase(d: str, base: str) -> dict:
    """16c's debug-server part, against the serving plane: a
    PROFILE_SECONDS /debug/profile window on the card while the loadgen
    traffic and the rebalance plane run, naming K15 and a serving kernel,
    with a second capture answering 409 while it runs; every route
    (debug_route_checks); a /whatif placement query that moves no
    placement (web-deployment's, read before and after through
    /debug/events/default/web-deployment); each verb that reads the
    server, exit 0; 0 lock inversions and 0 watchdog trips in
    /debug/state.  Returns what it saw (the profile's kernels, the
    placement, the rebalance plane's evictions, the walls)."""
    bad = []
    t0 = time.perf_counter()
    first: dict = {}

    def capture():
        first["answer"] = http_get(
            base, f"/debug/profile?seconds={PROFILE_SECONDS}", timeout=300)

    th = threading.Thread(target=capture, name="phase-16c-profile")
    th.start()
    time.sleep(1.0)
    busy = http_get(base, "/debug/profile?seconds=1", timeout=300)
    th.join(timeout=300)
    profile_s = time.perf_counter() - t0
    code, rec = first.get("answer", (None, {}))
    kernels = rec.get("kernels") or {} if isinstance(rec, dict) else {}
    serving = {k: n for k, n in kernels.items()
               if any(name in k for name in SERVING_KERNELS)}
    if code != 200 or not any("marker_affine" in k for k in kernels):
        bad.append(f"/debug/profile: {code} {str(rec)[:400]}")
    if not serving:
        bad.append(f"/debug/profile names no serving kernel: {kernels}")
    if busy[0] != 409:
        bad.append(f"a second /debug/profile answered {busy[0]}, not 409: "
                   f"{str(busy[1])[:200]}")
    t0 = time.perf_counter()
    bad += debug_route_checks(base)
    routes_s = time.perf_counter() - t0

    def web_placement():
        code, body = http_get(base, "/debug/events/default/web-deployment")
        b = body["binding"]
        return code, (b["generation"], sorted(
            (c["name"], c["replicas"]) for c in b["clusters"]))

    before = web_placement()
    code, answer = http_get(
        base, "/whatif?query=placement&replicas=12&cpu=500m", timeout=120)
    after = web_placement()
    if code != 200 or answer["result"]["outcome"] != "scheduled" or sum(
            a["replicas"] for a in answer["result"]["assignments"]) != 12:
        bad.append(f"/whatif placement: {code} {str(answer)[:300]}")
    if before != after or before[0] != 200:
        bad.append(f"/whatif moved web-deployment: {before} -> {after}")
    def newest_decision() -> str:
        # the explain ring keeps the last 256 decisions, which the loadgen
        # traffic turns over in well under 16c's window: web-deployment's
        # may be gone by the time the verbs run
        code, body = http_get(base, "/debug/explain")
        if code != 200 or not body.get("decisions"):
            raise AssertionError(f"/debug/explain before the explain verb: "
                                 f"{code} {str(body)[:300]}")
        return body["decisions"][-1]["key"]

    t0 = time.perf_counter()
    # an argument that is a function is called just before its verb runs
    verbs = [
        ("events", "--endpoint", base),
        ("events", "default/web-deployment", "--endpoint", base),
        ("describe", "default/web-deployment", "--endpoint", base),
        ("explain", "--endpoint", base),
        ("explain", newest_decision, "--endpoint", base),
        ("trace", "--endpoint", base),
        ("trace", "--endpoint", base, "--slow"),
        ("resident", "--endpoint", base, "--recent", "4"),
        ("rebalance", "--endpoint", base),
        ("whatif", "--endpoint", base, "--query", "headroom", "--cpu",
         "1000m"),
        ("incidents", "--endpoint", base),
        ("loadgen", "--endpoint", base),
        ("profile", "--endpoint", base, "--seconds", "1"),
    ]
    for argv in verbs:
        try:
            cli(d, *(a() if callable(a) else a for a in argv))
        except AssertionError as e:
            bad.append(str(e)[:400])
    verbs_s = time.perf_counter() - t0
    code, reb = http_get(base, "/debug/rebalance")
    evictions = reb.get("evictions") if code == 200 else None
    if evictions == 0 and web_placement() != before:
        bad.append("the verbs moved web-deployment's placement")
    code, state = http_get(base, "/debug/state")
    locks = state["locks"] if code == 200 else {}
    inversions = locks.get("inversions", {}).get("total")
    trips = locks.get("watchdog", {}).get("trips_total")
    if inversions != 0 or trips != 0 or not locks.get("armed") \
            or not locks.get("watchdog", {}).get("running"):
        bad.append(f"locks: armed {locks.get('armed')}, inversions "
                   f"{inversions} ({locks.get('inversions')}), watchdog "
                   f"{locks.get('watchdog')}")
    if bad:
        raise AssertionError(f"phase 16c debug server: {len(bad)} failed "
                             "checks: " + "; ".join(bad))
    return {"kernels": kernels, "serving": serving,
            "windows": rec.get("windows"), "lost": rec.get("lost_windows"),
            "placement": before[1][1], "whatif": answer["result"][
                "assignments"], "evictions": evictions,
            "locks": len(locks.get("locks", ())),
            "edges": locks.get("order_edges"),
            "walls": {"routes_s": round(routes_s, 2),
                      "profile_s": round(profile_s, 2),
                      "verbs_s": round(verbs_s, 2)}}


def phase_entry_points(box: dict) -> None:
    """16c (on a thread, EntryPoints): the port CLI as a user runs it, in
    subprocesses on a temporary plane directory -- init, CLI_MEMBERS
    joins, apply of a Deployment and its PropagationPolicy, tick on the
    card, get ResourceBinding showing the placement -- then serve on the
    card with the facade, steady loadgen traffic, the flight recorder,
    the debug server (--metrics-port 0), the resident, rebalance,
    explain and telemetry planes and --check-invariants; estimate
    against it, the debug server's routes, /whatif, a profile window and
    the verbs that read it (debug_server_phase), serving for at least
    SERVE_SECONDS; SIGINT: exit 0, the banner's backend=device, and the
    checkpoint reloading with every loadgen binding scheduled and
    web-deployment where /whatif found it.  Fills `box` with the walls,
    or its error."""
    import signal

    t_all = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    d = os.path.join(root, "plane")
    walls = {}
    try:
        t0 = time.perf_counter()
        cli(d, "init")
        for i in range(CLI_MEMBERS):
            cli(d, "join", f"m{i}", "--pods", str(CLI_PODS),
                "--region", f"r{i % 2}")
        app = os.path.join(root, "app.yaml")
        with open(app, "w") as f:
            f.write(CLI_APP)
        cli(d, "apply", "-f", app)
        walls["init_join_apply_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        ticked = cli(d, "tick", "--backend", "device")
        got = cli(d, "get", "ResourceBinding")
        walls["tick_get_s"] = time.perf_counter() - t0
        row = [ln for ln in got.splitlines() if "web-deployment" in ln]
        if not row or ":" not in row[0].split()[-1]:
            raise AssertionError(f"get ResourceBinding shows no placement "
                                 f"after the device tick: {got!r}")
        placed = row[0].split()[-1]
        if sum(int(x.split(":")[1]) for x in placed.split(",")) != 6:
            raise AssertionError(f"the placement {placed} is not 6 replicas")
        log(f"phase 16c: init, {CLI_MEMBERS} joins, apply in "
            f"{walls['init_join_apply_s']:.1f} s; tick --backend device "
            f"({ticked.strip()}) and get in {walls['tick_get_s']:.1f} s: "
            f"web-deployment {placed}")
        t0 = time.perf_counter()
        out_path = os.path.join(root, "serve.out")
        with open(out_path, "w") as out:
            proc = subprocess.Popen(
                [sys.executable, "-m", "karmada_tpu_torch.cli", "--dir", d,
                 "serve", "--backend", "device", "--facade", ":0",
                 "--loadgen", "steady", "--loadgen-rate", "10",
                 "--trace-buffer", "256", "--metrics-port", "0",
                 "--resident", "--rebalance", "2", "--explain", "1",
                 "--telemetry", "256", "--check-invariants"],
                stdout=out, stderr=subprocess.STDOUT, text=True,
                cwd=os.path.dirname(os.path.abspath(__file__)),
                start_new_session=True)

        def kill_serve() -> None:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()

        # a failing run elsewhere must not leave the plane serving
        atexit.register(kill_serve)
        try:
            addr, base = None, None
            deadline = time.time() + CLI_TIMEOUT_S
            while time.time() < deadline and proc.poll() is None:
                text = open(out_path).read()
                if "ctrl-c to stop" in text:
                    for ln in text.splitlines():
                        if ln.startswith("facade plane armed at "):
                            addr = ln.split()[4]
                        if ln.startswith("observability endpoint at "):
                            base = ln.split()[3]
                    break
                time.sleep(0.5)
            if addr is None or base is None:
                raise AssertionError("serve did not come up: "
                                     + open(out_path).read()[-2000:])
            t_up = time.perf_counter() - t0
            est = json.loads(cli(d, "estimate", "--facade-addr", addr,
                                 "--replicas", "4", "--cpu", "250m",
                                 "--format", "json"))
            if est["outcome"] != "scheduled" or sum(
                    a["replicas"] for a in est["assignments"]) != 4:
                raise AssertionError(f"estimate answered {est}")
            t1 = time.perf_counter()
            seen = debug_server_phase(d, base)
            walls["debug_server_s"] = time.perf_counter() - t1
            time.sleep(max(0.0, SERVE_SECONDS - (time.perf_counter() - t0
                                                 - t_up)))
            proc.send_signal(signal.SIGINT)
            rc = proc.wait(timeout=120)
        finally:
            kill_serve()
        text = open(out_path).read()
        walls["serve_s"] = time.perf_counter() - t0
        banner = [ln for ln in text.splitlines()
                  if ln.startswith("serving control plane")]
        if rc != 0 or not banner or "backend=device" not in banner[0]:
            raise AssertionError(f"serve: exit {rc}, banner {banner}: "
                                 + text[-2000:])
        from karmada_tpu_torch.models.work import COND_SCHEDULED
        from karmada_tpu_torch.store.persistence import load_store

        store = load_store(d)
        lg = [rb for rb in store.list("ResourceBinding")
              if rb.namespace == "loadgen"]
        unsched = [rb.name for rb in lg if not rb.spec.clusters or not any(
            c.type == COND_SCHEDULED and c.status == "True"
            for c in rb.status.conditions)]
        if not lg or unsched:
            raise AssertionError(f"the checkpoint holds {len(lg)} loadgen "
                                 f"bindings, unscheduled: {unsched[:5]}")
        web = store.get("ResourceBinding", "default", "web-deployment")
        # the rebalance plane may drain it; with no eviction it stays put
        if seen["evictions"] == 0 and sorted(
                (t.name, t.replicas)
                for t in web.spec.clusters) != seen["placement"]:
            raise AssertionError(
                f"the checkpoint's web-deployment {web.spec.clusters} is "
                f"not where /whatif found it: {seen['placement']}")
        log(f"phase 16c: serve --backend device up in {t_up:.1f} s "
            f"({banner[0]}); estimate via {addr}: {est['assignments']} "
            f"(batch {est.get('batchId')}); SIGINT: exit 0 after "
            f"{walls['serve_s']:.1f} s; the checkpoint reloads with "
            f"{len(lg)} loadgen bindings, all scheduled")
        log(f"phase 16c debug server at {base}: every route answered "
            f"({seen['walls']}); /whatif placement {seen['whatif']} moved "
            f"no placement (web-deployment {seen['placement']}; "
            f"rebalance evictions {seen['evictions']}, the checkpoint "
            "compared when 0); /debug/profile "
            f"({seen['windows']} window(s), {seen['lost']} lost) kernels "
            f"{seen['kernels']}, "
            f"serving {sorted(seen['serving'])}; a second capture 409; "
            f"every verb exit 0; --check-invariants: {seen['locks']} "
            f"VetLocks, {seen['edges']} order edges, 0 inversions, 0 "
            "watchdog trips")
        box["walls"] = walls
        box["debug_server"] = seen
    except Exception as e:  # noqa: BLE001 — raised on the main thread
        box["error"] = e
    finally:
        box["wall"] = time.perf_counter() - t_all
        import shutil

        shutil.rmtree(root, ignore_errors=True)


class EntryPoints:
    """16c on a thread, started beside phases 3-11 (its CLI processes'
    start-up is host work that would otherwise set phase 16's wall) and
    joined at the end of phase 16."""

    def __init__(self) -> None:
        self.box: dict = {}
        self.thread = threading.Thread(target=phase_entry_points,
                                       args=(self.box,), daemon=True,
                                       name="phase-16c")
        self.thread.start()


def phase_traffic(dev, refs, entry: EntryPoints) -> tuple:
    """Phase 16: 16a and 16b here, then 16c's thread joined.  Returns the
    card soaks' launch counts (16a, 16b)."""
    t16 = time.perf_counter()
    t0 = time.perf_counter()
    soaks = phase_soaks(dev, refs)
    log(f"phase 16a: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    heavy = phase_heavy(dev, refs)
    log(f"phase 16b: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    entry.thread.join()
    box = entry.box
    if "error" in box:
        raise box["error"]
    log(f"phase 16c: {box['wall']:.1f} s ({box['walls']}; waited "
        f"{time.perf_counter() - t0:.1f} s for it after 16b)")
    log(f"phase 16: {time.perf_counter() - t16:.1f} s")
    return soaks, heavy


# -- phase 17: faults and telemetry on the card --------------------------------

#: the catalog soaks phase 17 runs uncut, each held against its CPU replay
FAULT_SOAKS = ("chaos", "hotspot")
FAULT_SEED = 0
#: 17a's plane: the JAX package's chaos soak test's
CHAOS_PLANE = {"resident": True, "resident_audit_interval": 0,
               "device_cycle_timeout_s": 2.0, "device_recover_cycles": 2}
#: 17c's telemetry ring: about this many samples over the run (the ring's
#: min interval on the virtual clock is the soak's duration over it), each
#: a snapshot of the whole registry
FAULT_RING = 1024
MAIN_KERNELS = ("capacity", "schedule_rows", "webster_batch", "compact")


#: 17b's plane: the JAX package's hotspot soak test's.  Its Scheduler
#: places on ops/serial, which packs the skewed arrivals onto the hot
#: clusters; the rebalance plane scores them on the card (K13).  On the
#: device backend the catalog's hotspot never overcommits (peak 900 of a
#: 1,000 threshold at this seed, in both packages), so there is nothing
#: to drain.
HOTSPOT_PLANE = {"backend": "serial"}


def fault_plane_kw(name: str) -> dict:
    """The chaos soak's guarded plane (warmed first, as the JAX package's
    chaos soak test warms it); the hotspot soak's plane, unwarmed."""
    return CHAOS_PLANE if name == "chaos" else HOTSPOT_PLANE


def fault_soak_job(name: str) -> dict:
    """CpuRefs job: 17a / 17b's soak on device="cpu", its picklable
    part."""
    r = soak_run(name, "cpu", FAULT_SEED, plane_kw=fault_plane_kw(name),
                 warm=name == "chaos")
    return {k: r[k] for k in ("comparable", "placements", "faults",
                              "whatif", "wall", "backend")}


def disarm_fault_planes() -> None:
    """The chaos plane, the SLO evaluator, the ring and the incident store
    are process-wide: disarmed before anything else runs."""
    from karmada_tpu_torch import chaos
    from karmada_tpu_torch.obs import incidents, slo, timeseries

    chaos.disarm()
    timeseries.disarm()
    slo.disarm()
    incidents.disarm()


def check_launched(label: str, launches: dict, names) -> None:
    for k in names:
        if launches[k] <= 0:
            raise AssertionError(f"phase {label}: kernel {k} never launched")


def check_chaos_soak(label: str, p: dict, backend: str,
                     circuit_tos: Optional[set] = None) -> None:
    """The JAX package's chaos soak test's checks, on one SOAK payload
    (its race-detector leg is phase_chaos_soak's).  `circuit_tos`: the circuit's target
    states seen in the run, when its bounded transition log (the last
    256) cannot hold them all."""
    from karmada_tpu_torch import chaos

    audit = p["safety_audit"]
    if audit["violations"]:
        raise AssertionError(f"phase {label}: safety violations "
                             f"{json.dumps(audit['violations'])[:600]}")
    fires = audit["fault_fires"]
    deltas = audit["metric_deltas"]
    cons = audit["conservation"]
    tos = [t["to"] for t in p["estimator_circuit"]["transitions"]]
    if circuit_tos is None:
        circuit_tos = set(tos)
    checks = {
        "one device.cycle fire": fires.get("device.cycle") == 1,
        "one device.dispatch fire": fires.get("device.dispatch") == 1,
        "one resident.mirror fire": fires.get("resident.mirror") == 1,
        "estimator.rpc fires": fires.get("estimator.rpc", 0) > 0,
        "estimator errors >= its fires":
            deltas["estimator_errors"] >= fires.get("estimator.rpc", 0),
        "circuit open, half-open, closed":
            {"open", "half-open", "closed"} <= circuit_tos,
        "every circuit closed at the end": all(
            s == "closed" for s in p["estimator_circuit"]["states"].values()),
        "backend degraded": deltas["backend_degraded"] >= 1,
        "backend re-armed": deltas["backend_rearmed"] >= 1,
        "ends on the device": backend == "device",
        "a contained cycle fault": deltas["cycle_faults"] >= 1,
        "one resident audit mismatch":
            deltas["resident_audits_mismatch"] == 1,
        "nothing double-placed": cons["double_placed"] == 0,
        "unaccounted within the shed budget":
            cons["unaccounted"] <= cons["shed_budget"],
        "conservation": cons["scheduled"] + cons["queued_residual"]
            + cons["unaccounted"] == cons["injected"],
        "residual queue empty": p["residual_queue"] == {
            "active": 0, "backoff": 0, "unschedulable": 0},
        "the plane disarmed after": not chaos.armed(),
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"phase {label}: failed {bad}; fires {fires}, "
                             f"deltas {deltas}, conservation {cons}, "
                             f"circuit {tos[:12]}")


def phase_chaos_soak(dev, refs) -> dict:
    """17a: the catalog chaos soak, uncut, on the card, with the race
    detector armed (the JAX chaos soak test's leg): analysis/guards and
    the VetLocks' ownership and order recording, a LockWatchdog polling;
    no order inversion and no watchdog trip."""
    from karmada_tpu_torch.analysis import guards
    from karmada_tpu_torch.utils import locks

    torch.cuda.synchronize()
    locks.reset_for_tests()
    inv0, trips0 = locks._INVERSIONS.total(), locks._TRIPS.total()  # noqa: SLF001
    guards.arm()
    watchdog = locks.LockWatchdog(threshold_s=5.0, poll_s=0.2).start()
    try:
        r = soak_run("chaos", dev, FAULT_SEED, plane_kw=CHAOS_PLANE,
                     warm=True)
    finally:
        watchdog.stop()
        guards.arm(False)
    lock_state = locks.state_payload()
    inversions = locks._INVERSIONS.total() - inv0  # noqa: SLF001
    trips = locks._TRIPS.total() - trips0  # noqa: SLF001
    if inversions or trips:
        raise AssertionError(
            f"phase 17a chaos: the race detector saw {inversions} order "
            f"inversion(s) {lock_state['inversions']['recent']} and "
            f"{trips} watchdog trip(s)")
    t0 = time.perf_counter()
    torch.cuda.synchronize()  # after the re-arm: must not hang
    sync_s = time.perf_counter() - t0
    launches = r["launches"]
    p = r["payload"]
    check_chaos_soak("17a chaos", p, r["backend"])
    if p["injected"] <= 300 or p["scheduled"] <= 300:
        raise AssertionError(f"phase 17a chaos: {p['injected']} injected, "
                             f"{p['scheduled']} scheduled")
    cpu = refs.result(("17", "chaos"))
    soak_vs_cpu("17a chaos", r, cpu)
    audit = p["safety_audit"]
    log(f"phase 17a chaos: {p['injected']} injected, {p['scheduled']} "
        f"scheduled; fires {audit['fault_fires']}; deltas "
        f"{ {k: v for k, v in audit['metric_deltas'].items() if v} }; "
        f"conservation {audit['conservation']}; 0 violations; backend "
        f"{r['backend']}; synchronize after the re-arm {sync_s:.4f} s; "
        f"card {r['wall']:.2f} s, CPU replay {cpu['wall']:.2f} s; equal to "
        "the CPU replay but for the fire log's wall-clock stamps; the "
        f"race-detector leg (guards armed, LockWatchdog polling): "
        f"{len(lock_state['locks'])} VetLocks, "
        f"{lock_state['order_edges']} order edges, 0 inversions, 0 "
        "watchdog trips")
    check_launched("17a", launches, MAIN_KERNELS + ("scatter_lanes",))
    return launches


def phase_hotspot_soak(dev, refs) -> dict:
    """17b: the catalog hotspot soak, uncut, placed by ops/serial and
    scored by K13 on the card (HOTSPOT_PLANE)."""
    torch.cuda.synchronize()
    r = soak_run("hotspot", dev, FAULT_SEED, plane_kw=HOTSPOT_PLANE)
    torch.cuda.synchronize()
    launches = r["launches"]
    p = r["payload"]
    reb = p["rebalance"]
    last = reb["last"]
    thr = reb["config"]["overcommit_threshold_milli"]
    audit = p["safety_audit"]
    checks = {
        "every binding scheduled": p["injected"] == p["scheduled"],
        "evictions": reb["evictions"] > 0,
        "no conservation violation": reb["conservation_violations"] == 0,
        "converged": bool(last["converged"]),
        "inside the threshold": all(
            row["over_milli"] <= thr for row in last["clusters"].values()
            if row["capacity"] > 0),
        "an overcommit episode": max(reb["peak_over_milli"].values()) > thr,
        "no safety violation": audit["violations"] == [],
        "one rebalance.plan fire":
            p["chaos"]["fired_by_site"].get("rebalance.plan") == 1,
        "the skip accounted":
            audit["metric_deltas"]["rebalance_cycle_faults"] >= 1,
        "residual queue empty": sum(p["residual_queue"].values()) == 0,
        "every drain settled": not any(
            rb.spec.graceful_eviction_tasks for rb in r["plane_bindings"]),
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"phase 17b hotspot: failed {bad}; rebalance "
                             f"{json.dumps(reb)[:600]}")
    cpu = refs.result(("17", "hotspot"))
    soak_vs_cpu("17b hotspot", r, cpu)
    log(f"phase 17b hotspot: {p['injected']} injected and scheduled, "
        f"{reb['evictions']} evictions, peak over_milli "
        f"{max(reb['peak_over_milli'].values())} > {thr}, converged, 0 "
        f"conservation violations, rebalance.plan fires 1 (skip "
        f"accounted), 0 safety violations; K13 launches "
        f"{launches['rebalance_score']}; card {r['wall']:.2f} s, CPU "
        f"replay {cpu['wall']:.2f} s; equal to the CPU replay")
    check_launched("17b", launches, ("rebalance_score",))
    return launches


def phase_fleet_chaos(dev) -> dict:
    """17c: 16b's megafleet-heavy shape with the chaos scenario's fault
    events, resident plane and shortlist tier armed, and the SLO,
    time-series and incident planes armed."""
    from karmada_tpu_torch import loadgen as L
    from karmada_tpu_torch.estimator import client as est_client
    from karmada_tpu_torch.obs import incidents, slo, timeseries

    states = ("open", "half-open", "closed")
    moves0 = {t: est_client.CIRCUIT_TRANSITIONS.value(to=t) for t in states}
    scenario = dataclasses.replace(
        L.get_scenario("megafleet-heavy"),
        events=L.get_scenario("chaos").events)
    duration = scenario.duration_s(L.ServiceModel().capacity_rate)
    with tempfile.TemporaryDirectory() as inc_dir:
        ring = timeseries.configure(capacity=FAULT_RING,
                                    min_interval_s=duration / FAULT_RING)
        slo.configure()
        incidents.configure(inc_dir)
        torch.cuda.synchronize()
        r = soak_run("megafleet-heavy", dev, FAULT_SEED, device_time=True,
                     scenario=scenario, plane_kw=CHAOS_PLANE, warm=True)
        torch.cuda.synchronize()
        launches = r["launches"]
        samples = len(ring)
        bundles = sorted(f for f in os.listdir(inc_dir)
                         if f.endswith(".json"))
    p = r["payload"]
    # 512 circuits: the transitions by target state from the registry
    moves = {t: est_client.CIRCUIT_TRANSITIONS.value(to=t) - moves0[t]
             for t in states}
    check_chaos_soak("17c megafleet-heavy + chaos", p, r["backend"],
                     {t for t, n in moves.items() if n > 0})
    by_trigger = p["incidents"]["by_trigger"]
    if not by_trigger.get("backend-degrade") or \
            not by_trigger.get("cycle-fault"):
        raise AssertionError(f"phase 17c: incident index {by_trigger}")
    if len(bundles) != p["incidents"]["captured"]:
        raise AssertionError(f"phase 17c: {len(bundles)} bundles on disk "
                             f"for {p['incidents']['captured']} captured")
    if r["shortlist"] <= 0:
        raise AssertionError("phase 17c: no shortlist dispatch")
    dev_s = r["device_s"]
    log("phase 17c megafleet-heavy + chaos: " + json.dumps({
        "injected": p["injected"], "scheduled": p["scheduled"],
        "fault_fires": p["safety_audit"]["fault_fires"],
        "circuit_transitions": moves,
        "violations": 0,
        "slo": {o["name"]: o["healthy"] for o in p["slo"]["objectives"]},
        "slo_healthy": p["slo"]["healthy"],
        "incidents": by_trigger, "bundles_on_disk": len(bundles),
        "ring_samples": samples,
        "ring_min_interval_s": round(duration / FAULT_RING, 6),
        "shortlist_dispatches": r["shortlist"],
        "shortlist_fallbacks": r["fallbacks"],
        "wall_s": round(r["wall"], 3),
        "kernel_device_s": round(dev_s, 4),
        "kernel_launch_pairs": r["device_pairs"],
        "idle_share": round(1.0 - dev_s / r["wall"], 4)}))
    check_launched("17c", launches,
                   MAIN_KERNELS + ("shortlist_topk", "group_sums"))
    return launches


def phase_d2h_poison(dev) -> dict:
    """17d: device.d2h:poison#1 on a two-cluster device slice."""
    from karmada_tpu_torch import chaos
    from karmada_tpu_torch.loadgen.driver import build_binding, build_cluster
    from karmada_tpu_torch.ops import kernels
    from karmada_tpu_torch.scheduler import metrics as sched_metrics
    from karmada_tpu_torch.scheduler.queue import SchedulingQueue
    from karmada_tpu_torch.scheduler.service import Scheduler
    from karmada_tpu_torch.store.store import ObjectStore
    from karmada_tpu_torch.store.worker import Runtime

    store, rt = ObjectStore(), Runtime()
    sched = Scheduler(store, rt, backend="device", device=dev,
                      queue=SchedulingQueue(initial_backoff_s=0.0))
    for i in range(2):
        store.create(build_cluster(f"poison-m{i}"))
    store.create(build_binding("poison-b0"))
    torch.cuda.synchronize()
    kernels.reset_counts()
    chaos.configure("device.d2h:poison#1")
    base = sched_metrics.CYCLE_FAULTS.value(kind="InvariantViolation")
    rt.pump()
    faulted = sched_metrics.CYCLE_FAULTS.value(kind="InvariantViolation")
    queued = sched.queue.depths()
    rt.tick()
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    fires = chaos.active().fires("device.d2h")
    chaos.disarm()
    rbs = list(store.list("ResourceBinding"))
    if (fires != 1 or faulted != base + 1
            or sched.faults() != {"InvariantViolation": 1}
            or not queued["backoff"]
            or not all(rb.spec.clusters for rb in rbs)):
        raise AssertionError(
            f"phase 17d: fires {fires}, InvariantViolation cycle faults "
            f"{faulted - base}, faults {sched.faults()}, queue after the "
            f"fault {queued}, scheduled {[rb.spec.clusters for rb in rbs]}")
    log(f"phase 17d: device.d2h:poison fired once; the poisoned copy of "
        f"K3's index plane raised InvariantViolation (check_d2h), the "
        f"cycle fault was contained, the binding re-queued ({queued}) and "
        f"scheduled on the retry to {rbs[0].spec.clusters}")
    check_launched("17d", launches, MAIN_KERNELS)
    return launches


def phase_faults(dev, refs) -> tuple:
    """Phase 17: 17a-17d, the fault planes disarmed after, raise or not.
    Returns their launch counts."""
    t17 = time.perf_counter()
    out = []
    try:
        for label, fn in (("17a", lambda: phase_chaos_soak(dev, refs)),
                          ("17b", lambda: phase_hotspot_soak(dev, refs)),
                          ("17c", lambda: phase_fleet_chaos(dev)),
                          ("17d", lambda: phase_d2h_poison(dev))):
            t0 = time.perf_counter()
            out.append(fn())
            log(f"phase {label}: {time.perf_counter() - t0:.1f} s, "
                f"launches { {k: v for k, v in out[-1].items() if v} }")
    finally:
        disarm_fault_planes()
    total = sum_launches(out)
    log(f"phase 17: {time.perf_counter() - t17:.1f} s; launches of its "
        f"runs (17a-c the soaks' driver runs, 17d's cycles): "
        f"{ {k: v for k, v in total.items() if v} }")
    return tuple(out)


def parity_loop_phases(M, fleet, items, dev, args, refs) -> None:
    """The loop's card-vs-CPU phases on 12a's recipe: 12a, 14a and 15a
    (their CPU halves from the child, submit_loop_parity)."""
    phase_loop_parity(M, fleet, items, dev, args.seed + 7, refs)
    t14 = time.perf_counter()
    phase_failover_parity(M, fleet, items, dev, args.seed + 7, refs)
    log(f"phase 14a: {time.perf_counter() - t14:.1f} s")
    t15 = time.perf_counter()
    phase_descheduler_parity(M, fleet, items, dev, args.seed + 7, refs)
    log(f"phase 15a: {time.perf_counter() - t15:.1f} s")


def plane_phases(M, fleet, placements, items, dev, args) -> tuple:
    """The loop's plane at config 5's width: 12b, then 14b, 14c, 15b and
    15c on 12b's plane.  Returns the launch counts of these main-path
    runs."""
    REMAPS["on"] = True
    loop_items = items[:args.loop_templates]
    prop, plane = phase_loop(M, fleet, placements, loop_items, dev)
    renewed = plane._renewals
    log(f"phase 12b Lease renewals in the loop's ticks: {renewed[0]} in "
        f"{renewed[1]:.3f} s")
    t14 = time.perf_counter()
    member_reb = phase_member_rebalance(plane, dev, placements, loop_items)
    renewed = plane._renewals
    outage = phase_outage(plane, dev)
    log(f"phase 14c Lease renewals in the loop's ticks: "
        f"{plane._renewals[0] - renewed[0]} in "
        f"{plane._renewals[1] - renewed[1]:.3f} s")
    log(f"phase 14b-c: {time.perf_counter() - t14:.1f} s")
    t15 = time.perf_counter()
    facade = phase_facade(plane, loop_items, placements)
    desched = phase_descheduler(plane)
    REMAPS["on"] = False
    log(f"phase 15b-c: {time.perf_counter() - t15:.1f} s")
    return prop, member_reb, outage, facade, desched


def peak_rss_gib() -> float:
    """This process's peak resident memory (ru_maxrss, KiB on Linux)."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20


def collect_loop_garbage() -> None:
    """The loop phases' planes are garbage now: collected here, with their
    phases' time, not in phase 13d's first loop."""
    t0 = time.perf_counter()
    gc.collect()
    log(f"the loop phases' garbage collected in "
        f"{time.perf_counter() - t0:.2f} s")


def loop_child_main(args, dev) -> int:
    """`--loop-child`: config 5's workload rebuilt from --seed, the plane
    phases (plane_phases) on the card, then one line LOOP_CHILD_RESULT
    with their launch counts and remap calls (LoopChild)."""
    from karmada_tpu_torch import native
    from karmada_tpu_torch.ops import kernels

    kernels.build()  # loads what the parent built
    native.build()
    M = models()
    rng = random.Random(args.seed)
    fleet = build_fleet(M, rng, args.clusters)
    placements = build_placements(M, rng, [c.name for c in fleet])
    items = build_bindings(M, rng, args.bindings, placements)
    launches = plane_phases(M, fleet, placements, items, dev, args)
    log(f"loop child: peak resident memory {peak_rss_gib():.2f} GiB")
    payload = {"launches": list(launches), "remaps": REMAPS["calls"]}
    with _PRINT:
        print(LOOP_CHILD_RESULT + json.dumps(payload), flush=True)
    # the plane's garbage dies with the process
    os._exit(0)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bindings", type=int, default=100_000)
    ap.add_argument("--clusters", type=int, default=5_000)
    ap.add_argument("--chunk", type=int, default=4096)
    ap.add_argument("--waves", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--native-bindings", type=int,
                    default=NATIVE_CONTROL_BINDINGS,
                    help="phase 11b's bindings through the C++ control")
    ap.add_argument("--loop-templates", type=int, default=LOOP_TEMPLATES,
                    help="phase 12b's templates (config 5's first ones)")
    ap.add_argument("--only-loop", action="store_true",
                    help="run phases 1, 12, 14 and 15 alone (no kernel "
                         "report, no result line)")
    ap.add_argument("--loop-child", action="store_true",
                    help="run phases 12b, 14b-c and 15b-c alone and end "
                         "with their launch counts (the second process a "
                         "full run starts; kernels already built)")
    ap.add_argument("--parent", metavar="TREE", default=None,
                    help="a directory holding the parent commit's "
                         "karmada_tpu_torch/ unpacked: phase 2 then also "
                         "times old against new in turns")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import karmada_tpu_torch  # noqa: F401 — fails outside a checkout

    from karmada_tpu_torch.estimator.general import GeneralEstimator
    from karmada_tpu_torch.ops import solver as PS
    from karmada_tpu_torch.ops import tensors as T

    dev = torch.device("cuda", 0)
    GC.arm()
    if args.loop_child:
        return loop_child_main(args, dev)
    t_start = time.perf_counter()
    power = phase_device()
    phase_build()

    M = models()
    rng = random.Random(args.seed)
    t0 = time.perf_counter()
    fleet = build_fleet(M, rng, args.clusters)
    names = [c.name for c in fleet]
    placements = build_placements(M, rng, names)
    items = build_bindings(M, rng, args.bindings, placements)
    wide_items = build_wide_items(M, random.Random(args.seed + 1),
                                  WIDE_BINDINGS, placements, names)
    log(f"workload: {args.bindings} bindings x {args.clusters} clusters, "
        f"wide {WIDE_BINDINGS}, built in {time.perf_counter() - t0:.1f}"
        f" s (seed {args.seed})")

    refs = CpuRefs()
    atexit.register(refs.close)
    if args.only_loop:
        submit_loop_parity(refs, M, fleet, items, args.seed + 7)
        parity_loop_phases(M, fleet, items, dev, args, refs)
        launches = plane_phases(M, fleet, placements, items, dev, args)
        refs.close()
        log(f"loop phases' launches (12b, 14b, 14c, 15b, 15c): "
            f"{[{k: v for k, v in c.items() if v} for c in launches]}")
        log(f"chip_smoke --only-loop: {time.perf_counter() - t_start:.1f} "
            f"s; card: {power}")
        return 0
    explain_items = starve_items(M, wide_items[:EXPLAIN_BINDINGS])
    t0 = time.perf_counter()
    mfleet, mplacements = build_megafleet(M, random.Random(args.seed + 2),
                                          MEGA_CLUSTERS, MEGA_REGIONS)
    mitems = build_mega_bindings(M, random.Random(args.seed + 3),
                                 MEGAFLEET_BINDINGS, mplacements, args.chunk)
    mnames = [c.name for c in mfleet]
    log(f"workload: megafleet {MEGAFLEET_BINDINGS} bindings x "
        f"{MEGA_CLUSTERS} clusters in {MEGA_REGIONS} regions, built in "
        f"{time.perf_counter() - t0:.1f} s")

    first = T.encode_batch(items[:args.chunk], T.ClusterIndex.build(fleet),
                           GeneralEstimator(), cache=T.EncoderCache())
    parent = load_parent(args.parent) if args.parent else None
    report, chunk_ms = phase_kernels(first, items, wide_items, fleet, args,
                                     dev, args.reps, parent)
    report += phase_kernels_k7_k9(items, fleet, (mfleet, mitems), args, dev,
                                  args.reps, parent)

    # phases 12b, 14b-c and 15b-c from here to phase 13, in a second
    # process on the card
    loop_child = LoopChild(args)
    entry_points = EntryPoints()  # 16c beside phases 3-11
    main_path = ("capacity", "schedule_rows", "webster_batch", "compact",
                 "spread_group_info", "spread_pick")
    cfg5 = (T.ROUTE_DEVICE, T.ROUTE_DEVICE_SPREAD)
    # phase 3's first chunk alone, for phase 13c's warmed chunk
    from karmada_tpu_torch.scheduler.core import schedule_items

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    schedule_items(items[:args.chunk], fleet, chunk=args.chunk,
                   waves=args.waves, device=dev)
    torch.cuda.synchronize()
    first3 = time.perf_counter() - t0
    log(f"phase 3 first chunk: {args.chunk} bindings in {first3:.3f} s")
    count_remaps()
    REMAPS["on"] = True
    fwd, _, fwd_results, _ = phase_cycle(
        "3 forward", items, fleet, names, args, dev, chunk_ms, main_path,
        cfg5, need_coo=True)
    reb_items = build_rebalance_items(M, rng, items, names)
    # the CPU halves of phases 5, 12a, 14a and 15a start now, in the
    # child, after phase 2's CPU timings
    submit_parity(refs, {"forward": items, "rebalance": reb_items,
                         "wide": wide_items}, explain_items, fleet, args)
    submit_loop_parity(refs, M, fleet, items, args.seed + 7)
    submit_soaks(refs)
    reb = phase_cycle("4 rebalance", reb_items, fleet, names, args, dev,
                      chunk_ms, main_path, cfg5)[0]
    wide = phase_cycle(
        "6 wide", wide_items, fleet, names, args, dev, chunk_ms,
        main_path + ("schedule_rows_big",),
        cfg5 + (T.ROUTE_DEVICE_BIG, T.ROUTE_DEVICE_SPREAD_BIG))[0]
    expl = phase_explain(explain_items, fleet, names, args, dev, chunk_ms,
                         main_path + ("schedule_rows_big", "explain_rows"))
    mega = phase_megafleet(
        mitems, mfleet, mnames, args, dev, chunk_ms,
        ("capacity", "schedule_rows", "webster_batch", "compact",
         "shortlist_topk", "group_sums"))
    REMAPS["on"] = False
    refs.cpu5 = refs.result("5")
    phase_parity("forward", items, fleet, args, dev, refs)
    phase_parity("rebalance", reb_items, fleet, args, dev, refs)
    phase_parity("wide", wide_items, fleet, args, dev, refs)
    phase_parity_explain(explain_items, fleet, args, dev, refs)
    phase_parity_shortlist(mitems, mfleet, args, dev)
    # phase 11a's megafleet chunk and rebalance chunk (every binding with
    # previous clusters: the C loop hands each back to encode_one)
    mchunk, rchunk = mitems[:args.chunk], reb_items[:args.chunk]
    del mitems, reb_items, wide_items, explain_items  # phase 9 builds 1M

    REMAPS["on"] = True
    inc, state, solver, roster = phase_incremental(
        M, mfleet, mplacements, INCREMENTAL_BINDINGS, args.chunk, dev,
        args.seed + 5)
    REMAPS["on"] = False
    report += phase_kernels_k10_k12(state, solver, dev, args.reps)
    if parent is not None:
        phase_turns(parent, state, solver, dev, args.reps)
    del state, solver, roster
    phase_parity_resident(items, fleet, args, dev)

    report.append(phase_kernel_k13(fleet, fwd_results, dev, args.reps,
                                   parent))
    phase_rebalance_parity(M, fleet, items, fwd_results, dev)
    phase_native_turns("forward chunk", items[:args.chunk], fleet, args, dev)
    phase_native_turns("megafleet chunk", mchunk, mfleet, args, dev)
    phase_native_turns("rebalance chunk", rchunk, fleet, args, dev)
    phase_native_control(items, fleet, min(args.native_bindings, len(items)))
    phase_native_store(M, fleet, items, fwd_results)
    parity_loop_phases(M, fleet, items, dev, args, refs)
    traffic = phase_traffic(dev, refs, entry_points)
    faults = phase_faults(dev, refs)
    refs.close()
    collect_loop_garbage()
    child = loop_child.result()
    loop_launches = tuple(child["launches"])
    log(f"_CarryChain._device_remap calls on the main-path phases (3, 4, "
        f"6-9, 12b, 14b-c, 15b-c): {REMAPS['calls'] + child['remaps']} "
        f"({child['remaps']} in the loop child)")
    for r in report:
        r["launches"] = sum(c[r["name"]] for c in (
            fwd, reb, wide, expl, mega, inc) + loop_launches + traffic
            + faults)
    t13 = time.perf_counter()
    report.append(phase_probe(dev, args.reps, parent))
    report.append(phase_profile(dev, args.reps, parent))
    phase_warm(fleet, items, dev, args, first3)
    phase_guard(M, fleet, items, dev, args.seed + 7)
    log(f"phase 13 lifecycle: {time.perf_counter() - t13:.1f} s")
    log(f"split_ms / kernel_device_ms readings: "
        f"{PROFILER_CHECKS['readings']}, {PROFILER_CHECKS['lost']} of them "
        f"with the profiler under {PROFILER_LOST_BELOW} x the events "
        "(profiler lost records)")
    log(f"K2 key scratch allocated in the run, bytes by tier: "
        f"{PS.KEY_SCRATCH_BYTES}")
    if any(PS.KEY_SCRATCH_BYTES.values()):
        raise AssertionError("K2 allocated a key scratch")

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(f"peak resident memory: {peak_rss_gib():.2f} GiB (this process)")
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s to the report "
        f"(16c took {entry_points.box.get('wall', float('nan')):.1f} s on "
        "its thread)")
    log(f"card: {power}")
    log(json.dumps({"kernels": [{k: r[k] for k in keys} for r in report]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
