#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (karmada_tpu_torch) on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's kernels from ops/csrc/ with nvcc (sm_90a), then
drives the device scheduling cycle at the synthetic-stress size
(100,000 bindings x 5,000 clusters; chunk 4096, 8 waves, carry on):

  1. device and build: the card's name and power limit, nvcc's register /
     shared-memory report per kernel;
  2. kernel vs plain: each kernel against its plain PyTorch version on the
     first chunk of the forward cycle (4096 x 8192 lanes), bit-exact, with
     CUDA-event times, the plain version's time, the least time the card
     could take (bound) and, for the COO extraction, a torch.nonzero
     yardstick;
  3. forward cycle through scheduler.core.schedule_items, launch counters
     reset just before and read just after;
  4. rebalance cycle (prev assignments, reschedule triggers) the same way;
  5. chunk parity: one chunk of each cycle through the kernel path on the
     card and the plain path on the CPU, bit-exact (COO, status, nnz and
     the carry accumulators), and result invariants over every binding.

Any mismatch or exception exits non-zero.  Without a CUDA card it exits 2
before printing any result.  The second-to-last line is the per-kernel
JSON report; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import random
import subprocess
import sys
import time

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (data sheet)
SCALAR_OPS_PER_S = 67e12   # H100 SXM fp32 outside the tensor cores


def log(msg: str) -> None:
    print(msg, flush=True)


# -- the bench.py workload mix, written against the port's models --------------
# (bench.py's generators, minus its region-spread placement class, which is
# the spread plane's and not ported yet)

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
    return out


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


def max_abs_err(pairs) -> float:
    err = 0.0
    for a, b in pairs:
        if a.shape != b.shape:
            raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
        if a.numel():
            d = (a.to(torch.float64) - b.to(torch.float64)).abs().max()
            err = max(err, float(d))
    return err


def bound_ms(nbytes: float, ops: float):
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / SCALAR_OPS_PER_S * 1e3
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
    from karmada_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    kernels.build(verbose=True)  # prints nvcc -Xptxas -v per source
    dt = time.perf_counter() - t0
    log(f"phase 1 build: {len(kernels.KERNELS)} kernels in {dt:.1f} s "
        f"(sources {kernels.CSRC})")


def phase_kernels(batch, waves: int, dev, reps: int) -> list:
    """Each kernel vs its plain version on the same card inputs."""
    from karmada_tpu_torch.ops import solver as S

    db = S.device_batch(batch, dev)
    B, C = db.B, db.C
    Q, R = db.req_milli.shape
    waves = S._effective_waves(B, waves)
    Bw = B // waves
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

    # K2 schedule_rows (+ K4 inside), the whole chunk wave by wave, kernel
    # path and plain path from the same zero carry
    def run(rows_fn, cap_fn, capture=None):
        used = tuple(u.clone() for u in zeros)
        rep = torch.empty((B, C), dtype=torch.int64, device=dev)
        sel = torch.empty((B, C), dtype=torch.bool, device=dev)
        st = torch.empty((B,), dtype=torch.int32, device=dev)
        for wv in range(waves):
            est = cap_fn(db.req_milli, db.req_is_cpu, db.req_pods,
                         db.avail_milli, used[0], db.has_alloc,
                         db.pods_allowed, used[1], db.has_summary,
                         db.est_override, used[2])
            kw = {"capture": capture} if capture is not None and wv == 0 else {}
            rows_fn(db, wv * Bw, (wv + 1) * Bw, est, *used, rep, sel, st,
                    use_extra=use_extra, charge=True, **kw)
        return rep, sel, st, used

    cap = {}
    rep_k, sel_k, st_k, used_k = run(S.schedule_rows, S.capacity, cap)
    rep_p, sel_p, st_p, used_p = run(S.schedule_rows_plain, S.capacity_plain)
    err2 = max_abs_err([(rep_k, rep_p), (sel_k, sel_p), (st_k, st_p)]
                       + list(zip(used_k, used_p)))
    # one wave's launch on wave 0's inputs, fresh accumulators per call
    est0 = S.capacity(*cap_in)
    out = (torch.empty((B, C), dtype=torch.int64, device=dev),
           torch.empty((B, C), dtype=torch.bool, device=dev),
           torch.empty((B,), dtype=torch.int32, device=dev))
    pool = [tuple(u.clone() for u in zeros) for _ in range(reps + 1)]
    it = iter(pool * 2)

    def wave(fn):
        return lambda: fn(db, 0, Bw, est0, *next(it), *out,
                          use_extra=use_extra, charge=True)

    k2_ms = cuda_ms(wave(S.schedule_rows), reps)
    it = iter([tuple(u.clone() for u in zeros) for _ in range(4)])
    k2_plain = cuda_ms(wave(S.schedule_rows_plain), 2)
    row_in = nbytes(est0, db.pl_mask, db.pl_tol_bypass, db.pl_static_w,
                    db.pl_extra_score, db.api_ok, db.cluster_valid,
                    db.deleting, db.name_rank) + sum(
        nbytes(db.t[f][:Bw]) for f in S._BINDING_FIELDS)
    row_out = Bw * C * (8 + 1) + Bw * 4 + 2 * nbytes(*zeros)
    b2 = bound_ms(row_in + row_out, Bw * C)
    rows.append(dict(
        name="schedule_rows", route="cuda",
        source="karmada_tpu_torch/ops/csrc/schedule_rows.cu",
        replaces="karmada_tpu/ops/solver.py:602",
        max_abs_err=err2, ms=k2_ms, plain_ms=k2_plain,
        bound_ms=b2[0], bound_by=b2[1], library_ms=None))

    # K3 compact on the chunk's dense result
    nw = db.non_workload
    c_k = S.compact(rep_k, sel_k, st_k, nw, False)
    c_p = S.compact_plain(rep_k, sel_k, st_k, nw, False)
    nnz = int(c_k[3])
    if nnz != int(c_p[3]):
        raise AssertionError(f"compact nnz {nnz} != plain {int(c_p[3])}")
    err3 = max_abs_err([(c_k[0][:nnz], c_p[0]), (c_k[1][:nnz], c_p[1]),
                        (c_k[2], c_p[2])])
    mask = ((sel_k & nw[:, None]) | (rep_k > 0)).reshape(-1)
    flat = rep_k.reshape(-1)

    def library():
        i = torch.nonzero(mask).reshape(-1)
        return flat[i]

    b3 = bound_ms(nbytes(rep_k, sel_k, nw) + nnz * 8 + (B + 1) * 8, B * C)
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

    # K4 webster_batch on the Webster problems K2 handed it in wave 0
    web = cap["webster"]
    s_k = S.webster_batch(*web)
    s_p = S.webster_plain(*web)
    err4 = max_abs_err([(s_k, s_p)])
    b4 = bound_ms(nbytes(*web) + nbytes(s_k), web[1].numel())
    rows.append(dict(
        name="webster_batch", route="cuda",
        source="karmada_tpu_torch/ops/csrc/webster_batch.cu",
        replaces="karmada_tpu/ops/solver.py:100",
        max_abs_err=err4, ms=cuda_ms(lambda: S.webster_batch(*web), reps),
        plain_ms=cuda_ms(lambda: S.webster_plain(*web), 2),
        bound_ms=b4[0], bound_by=b4[1], library_ms=None))
    # the whole chunk's dispatch (upload, 8 waves of K1 + K2/K4, then K3)
    # between two events on the stream: host launch gaps included
    chunk_ms = cuda_ms(lambda: S.dispatch_compact(
        batch, waves=waves, with_used=True, device=dev), reps)
    log(f"phase 2 chunk: {B}x{C} dispatch_compact stream time "
        f"{chunk_ms:.4f} ms (CUDA events, mean of {reps})")
    for r in rows:
        log(f"phase 2 {r['name']}: max_abs_err={r['max_abs_err']} "
            f"ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
            f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
            f"library_ms={r['library_ms']}")
        if r["max_abs_err"] != 0:
            raise AssertionError(f"{r['name']} disagrees with its plain "
                                 "version")
    return rows, chunk_ms


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


def phase_cycle(label, items, fleet, names, args, dev,
                chunk_ms: float) -> dict:
    from karmada_tpu_torch.ops import kernels
    from karmada_tpu_torch.scheduler.core import schedule_items
    from karmada_tpu_torch.scheduler.pipeline import PipelineResult

    stats = PipelineResult()
    torch.cuda.synchronize()
    kernels.reset_counts()
    t0 = time.perf_counter()
    results = schedule_items(items, fleet, chunk=args.chunk,
                             waves=args.waves, device=dev, stats=stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    counts = check_results(items, results, names)
    log(f"phase {label}: {len(items)} bindings x {len(fleet)} clusters in "
        f"{wall:.3f} s ({len(items) / wall:.0f} bindings/s); chunks="
        f"{stats.chunks} encode_s={stats.encode_s:.3f} "
        f"dispatch_s={stats.dispatch_s:.3f} finalize_s={stats.finalize_s:.3f}"
        f" decode_s={stats.decode_s:.3f}; results={counts}; "
        f"launches={launches}; device busy share (chunks x phase-2 chunk "
        f"time / wall) ~{stats.chunks * chunk_ms / 1e3 / wall:.3f}")
    for k, v in launches.items():
        if v <= 0:
            raise AssertionError(f"{label}: kernel {k} never launched")
    return launches


def phase_parity(label, items, fleet, args, dev) -> None:
    """One chunk through the kernel path on the card and the plain path on
    the CPU; bit-exact COO, status, nnz and carry accumulators."""
    from karmada_tpu_torch.estimator.general import GeneralEstimator
    from karmada_tpu_torch.ops import solver as S
    from karmada_tpu_torch.ops import tensors as T

    part = items[:args.chunk]
    batch = T.encode_batch(part, T.ClusterIndex.build(fleet),
                           GeneralEstimator(), cache=T.EncoderCache())
    k = S.solve_compact(batch, waves=args.waves, with_used=True, device=dev)
    p = S.solve_compact(batch, waves=args.waves, with_used=True,
                        device="cpu")
    import numpy as np

    same = (k[3] == p[3] and np.array_equal(k[0], p[0])
            and np.array_equal(k[1], p[1]) and np.array_equal(k[2], p[2])
            and all(np.array_equal(a, b) for a, b in zip(k[4], p[4])))
    log(f"phase 5 parity {label}: chunk {batch.B}x{batch.C} nnz={k[3]} "
        f"kernel==plain(cpu): {same}")
    if not same:
        raise AssertionError(f"{label}: kernel path != plain path")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bindings", type=int, default=100_000)
    ap.add_argument("--clusters", type=int, default=5_000)
    ap.add_argument("--chunk", type=int, default=4096)
    ap.add_argument("--waves", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import karmada_tpu_torch  # noqa: F401 — fails outside a checkout

    from karmada_tpu_torch.estimator.general import GeneralEstimator
    from karmada_tpu_torch.ops import tensors as T

    dev = torch.device("cuda", 0)
    power = phase_device()
    phase_build()

    M = models()
    rng = random.Random(args.seed)
    t0 = time.perf_counter()
    fleet = build_fleet(M, rng, args.clusters)
    names = [c.name for c in fleet]
    items = build_bindings(M, rng, args.bindings,
                           build_placements(M, rng, names))
    log(f"workload: {args.bindings} bindings x {args.clusters} clusters "
        f"built in {time.perf_counter() - t0:.1f} s (seed {args.seed})")

    first = T.encode_batch(items[:args.chunk], T.ClusterIndex.build(fleet),
                           GeneralEstimator(), cache=T.EncoderCache())
    report, chunk_ms = phase_kernels(first, args.waves, dev, args.reps)

    fwd = phase_cycle("3 forward", items, fleet, names, args, dev,
                      chunk_ms)
    reb_items = build_rebalance_items(M, rng, items, names)
    reb = phase_cycle("4 rebalance", reb_items, fleet, names, args,
                      dev, chunk_ms)
    for r in report:
        r["launches"] = fwd[r["name"]] + reb[r["name"]]

    phase_parity("forward", items, fleet, args, dev)
    phase_parity("rebalance", reb_items, fleet, args, dev)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(f"card: {power}")
    log(json.dumps({"kernels": [{k: r[k] for k in keys} for r in report]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
