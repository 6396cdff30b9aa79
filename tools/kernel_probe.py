#!/usr/bin/env python3
"""Probe of single kernels of the port on one CUDA card, at chip_smoke
phase 2's shapes: K3 compact and K2 schedule_rows (std tier), K4
webster_batch, K11 gather_rows, K5 spread_group_info, K6 spread_pick, K1
capacity, K8 shortlist_topk, K7 explain_rows, K12 dirty_codes and K13
rebalance_score.

Run from the root of a checkout, on a machine with a card and nvcc:

    python3 tools/kernel_probe.py [k3k2] [k4] [k11] [k5k6] [k1] [k8]
        [k8census] [k2big] [k2launch] [k2census] [k7] [k12] [k13]
        [--parent TREE]

It builds the first forward chunk of chip_smoke's workload (bench.py's
config-5 mix, seed 0: 4096 bindings x 8192 lanes) and prints, after the
card's name and power limit, the parts named (default: all):

  k3k2  K3: the wrapper's CUDA-event ms; its yardsticks, torch.nonzero
        and a gather on a mask built outside the timed call and with the
        mask built inside it (the same function); torch.sum over rep, a
        plain read of it.  K3 shapes: compact.cu rebuilt with other steps
        per warp and blocks per SM, each held against compact_plain and
        timed.  K2 std: wave 0's device time by kernel (prepare, K4,
        finish) and a clock64 profile of the prepare kernel, in cycles
        per row (its KT_MARK points, K2BIG_PHASES["marks"]).
  k4    chip_smoke's K4 census of the chunk's 8 waves and of the wide
        chunk's big rows; then on wave 0 of each tier, per tree: K4's
        CUDA-event ms, host enqueue against device time, and a clock64
        profile of its phases in cycles a row (K4_MARKS: markers
        substituted into the tree's webster.cuh, held against
        webster_plain).
  k11   K11 at 4,096 rows of a 2^20-slot store, per tree: CUDA-event ms
        and host enqueue against device time (by activity: the kernel,
        the upload) of gather_batch, sub_gather_batch, dispatch_gather
        and dispatch_sub_gather; then both dispatches' host pieces, each
        timed alone (k11_pieces: the parent design's signature check,
        staging, pinned buffer, slab, copy_, block writes, launch and
        views; the workspace design's check, inputs, slab, block writes,
        one C call and views).
  k5k6  chip_smoke's spread census of the spread sub-batches of the first
        forward chunk (phase 2's), the first wide chunk and the first
        explain chunk; then on phase 2's sub-batch, per tree: K5's and
        K6's CUDA-event ms, host enqueue against device time, and, where
        the tree's sources hold KT_MARK points (spread.cuh), a clock64
        profile of each kernel's phases in cycles a row (built with
        -DKT_PROFILE; held against the unmarked kernel).
  k1    K1 per tree: alone at [Q+1, 8,192] (CUDA-event ms, host enqueue
        against device time), and wave 0 of each tier with its K1 (std
        on the forward chunk, big on the first wide chunk's big rows):
        CUDA-event ms, host enqueue, device time by kernel (K1's apart)
        and each launch's CUDA events.
  k8    K8 per tree on the first megafleet chunk's profile rows (16 x
        16,384, k = 64) and over twice the lanes: the tier-1 call's
        CUDA-event ms (the parent's K1 + K8 pair, or the fused K8), host
        enqueue and device time by kernel; a clock64 profile of K8's
        phases in cycles a block (KT_MARK points built with -DKT_PROFILE,
        or K8_OLD_MARKS substituted into a source without them).
  k8census  not in the default set: what the main path hands K8 in
        chip_smoke's phases 8 and 9 (profile rows a launch, C, k,
        eligible lanes a row), from those phases' runs (~4 min).
  k2big K2-big per tree on the first wide chunk's big rows (64 x 8,192):
        wave 0 with its K1 and K4 -- CUDA-event ms, host enqueue, device
        time by kernel, each launch's CUDA events -- and a clock64
        profile of its prepare kernel in cycles a row (K2BIG_PHASES: the
        select's phases, the lane_info loop, each sort, the swap loop,
        the Aggregated prefix, the web_* / wk_* writes; KT_MARK points
        built with -DKT_PROFILE, or K2BIG_OLD_MARKS substituted into a
        copy of a source without them).
  k2launch  where a K2 std wave's host enqueue goes, per tree (wave 0 of
        the forward chunk): the whole call with and without the chunk's
        workspace, and its pieces each timed alone.
  k2census  not in the default set: what the main path hands K2-big in
        chip_smoke's phases 6 and 7 (rows a launch, C, U, each gather
        group's eligible lanes against k, the select's histogram passes,
        strategy and has_sc), from those phases' runs (~3 min).
  k7    K7 per tree at chip_smoke.explain_operands' shapes: wave 0 of
        the first forward chunk (512 x 8,192) and the spread flavour on
        its phase B (1,024 x 8,192) -- CUDA-event ms, host enqueue
        against device time and a clock64 profile of a row's phases
        (K7_PHASES: KT_MARK points built with -DKT_PROFILE, or
        K7_OLD_MARKS substituted into a copy of a source without them);
        for a tree whose wrapper takes a workspace also the wave as
        schedule_core launches it.
  k12   not in the default set (~4 min: it runs chip_smoke's phase 9,
        whose lines carry the "dirty" stage's split into roster,
        dirty_codes and the position mapping): on phase 9's plane (cap
        2^20) with 8 flip lanes and 1,000 rv slots, per tree:
        dirty_codes whole and in pieces (the parent's cluster-side
        uploads, rv / flip uploads, scratches and memset, launch and D2H;
        this tree's mirror sync, rv normalisation, operand bind, one C
        call and copy out), its device time by activity, and the kernel
        on device operands (CUDA-event ms, host enqueue against device
        time by kernel, and a clock64 profile of a block where the
        source has KT_MARK points); then this tree's dirty.cu built at
        each block shape of K12_SHAPES on a synthetic store shaped like
        phase 9's: registers and spills, CUDA-event ms and device time,
        each held against the plain pass.
  k13   K13 at C = 5,000, 10,000 and 16,384, per tree: score from numpy
        whole (with and without its timing events) and in pieces, its
        device time by activity, the kernel on device operands, and a
        clock64 profile of its passes (KT_MARK points built with
        -DKT_PROFILE, or K13_OLD_MARKS substituted into the parent's
        source).

With --parent TREE (the parent commit's karmada_tpu_torch/ unpacked in
TREE, as chip_smoke.py --parent takes it) k4, k11, k5k6, k1, k8, k2big,
k2launch, k7, k12 and k13 also run on the parent's port.  The variant libraries build into a temporary directory.
Device times come from CUDA events (chip_smoke's split_ms and
kernel_device_ms: a pair around each launch, or around the whole call
where it runs library kernels of its own), torch.profiler's figures only
beside them as profiler_ms.
Exits non-zero without a card, or when a variant disagrees with its
plain version.
"""

from __future__ import annotations

import ctypes
import os
import random
import re
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

#: compact.cu shapes: (steps per warp, blocks an SM)
K3_SHAPES = ((8, 4), (12, 3), (16, 2), (24, 2))


def build_variant(kernels, src, subs, name, out_dir, text=None, inc=None,
                  flags=(), show=None):
    """A kernel source (`src`, or its `text`) with `subs` substituted,
    built with nvcc (and `flags`) into out_dir against the headers of
    `inc` (default: this checkout's ops/csrc); returns the loaded
    library.  Prints ptxas' last register line, or with `show` the report
    of every entry whose mangled name holds it."""
    text = open(src).read() if text is None else text
    for old, new in subs:
        if text.count(old) != 1:
            raise AssertionError(f"{name}: {old!r} is not in {src} once")
        text = text.replace(old, new)
    cu = os.path.join(out_dir, f"{name}.cu")
    so = os.path.join(out_dir, f"lib{name}.so")
    with open(cu, "w") as fh:
        fh.write(text)
    out = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, *flags, "-I",
                          str(inc or kernels.CSRC), "-o", so, cu],
                         capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{out.stdout}{out.stderr}")
    lines = (out.stdout + out.stderr).splitlines()
    if show:
        # each entry whose name holds `show`: its registers and spills
        keep = False
        for ln in lines:
            if "Compiling entry" in ln:
                keep = show in ln
            if keep:
                print(f"{name}: {ln.strip()}", flush=True)
    else:
        regs = [ln.strip() for ln in lines if "registers" in ln]
        print(f"{name}: {regs[-1] if regs else ''}", flush=True)
    return ctypes.CDLL(so)


def entry(lib, name):
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def probe_k3_k2(CS, batch, dev):
    """K3's yardsticks and shapes, K2 std's wave-0 split and its prepare
    profile."""
    from karmada_tpu_torch.ops import kernels
    from karmada_tpu_torch.ops import solver as S

    db = S.device_batch(batch, dev)
    use_extra = S._use_extra(batch)
    rep, sel, st, _, _ = S.schedule_core(db, waves=8, use_extra=use_extra)
    nw = db.non_workload
    B, C = rep.shape
    want = S.compact_plain(rep, sel, st, nw, False)
    nnz = int(want[3])
    flat = rep.reshape(-1)
    mask = ((sel & nw[:, None]) | (rep > 0)).reshape(-1)

    def inside():
        m = ((sel & nw[:, None]) | (rep > 0)).reshape(-1)
        return flat[torch.nonzero(m).reshape(-1)]

    print(f"K3 {B}x{C}, nnz {nnz}: wrapper "
          f"{CS.cuda_ms(lambda: S.compact(rep, sel, st, nw, False), 50):.4f}"
          f" ms; mask outside "
          f"{CS.cuda_ms(lambda: flat[torch.nonzero(mask).reshape(-1)], 50):.4f}"
          f" ms; mask inside {CS.cuda_ms(inside, 50):.4f} ms; torch.sum(rep) "
          f"{CS.cuda_ms(lambda: rep.sum(), 50):.4f} ms", flush=True)

    src3 = os.path.join(kernels.CSRC, "compact.cu")
    src2 = os.path.join(kernels.CSRC, "schedule_rows.cu")
    with tempfile.TemporaryDirectory() as tmp:
        idx = torch.empty(B * C, dtype=torch.int32, device=dev)
        val = torch.empty_like(idx)
        state = torch.empty(B * C // 512 + 2, dtype=torch.int64, device=dev)
        args = kernels.CompactArgs(
            kernels.ptr(rep), kernels.ptr(sel), kernels.ptr(nw),
            kernels.ptr(idx), kernels.ptr(val), kernels.ptr(state), B, C, 0,
            state.numel())
        for steps, per_sm in K3_SHAPES:
            fn = entry(build_variant(kernels, src3, [
                ("constexpr int STEPS = 12;", f"constexpr int STEPS = {steps};"),
                ("__launch_bounds__(NT, 3) compact_kernel",
                 f"__launch_bounds__(NT, {per_sm}) compact_kernel")],
                f"compact_s{steps}_b{per_sm}", tmp), "kt_compact")

            def call(fn=fn):
                rc = fn(ctypes.addressof(args),
                        torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"compact variant: CUDA error {rc}")

            call()
            torch.cuda.synchronize()
            if int(state[1]) != nnz or not (
                    torch.equal(idx[:nnz], want[0])
                    and torch.equal(val[:nnz], want[1])):
                raise AssertionError(f"compact s{steps} b{per_sm} disagrees")
            print(f"K3 shape: {steps} steps a warp, {per_sm} blocks an SM: "
                  f"{CS.cuda_ms(call, 50):.4f} ms", flush=True)

        # K2 std, wave 0: the stream operations, then the prepare profile
        Bw = B // 8
        zeros = S._zeros_used(db)
        est0 = S.capacity(db.req_milli, db.req_is_cpu, db.req_pods,
                          db.avail_milli, zeros[0], db.has_alloc,
                          db.pods_allowed, zeros[1], db.has_summary,
                          db.est_override, zeros[2])
        used = tuple(u.clone() for u in zeros)
        out = (torch.empty_like(rep), torch.empty_like(sel),
               torch.empty_like(st))

        def wave():
            S.schedule_rows(db, 0, Bw, est0, *used, *out,
                            use_extra=use_extra, charge=True)
            return out

        print("K2 std wave 0: " + _dev_line(CS.kernel_device_ms(wave, 20)),
              flush=True)
        phases, h = profile_k2big(kernels, wave, tmp, "schedule_rows_prof",
                                  tier="std")
    for p, a, b in phases:
        m = (h[:, a] != 0) & (h[:, b] != 0)
        if m.any():
            d = h[m, b] - h[m, a]
            print(f"K2 std prepare, {p}: mean {d.mean():.0f} cycles, p90 "
                  f"{np.percentile(d, 90):.0f}, max {d.max()} "
                  f"({int(m.sum())} rows)", flush=True)


#: the clock64 marks of a K4 design, by a line of its webster.cuh that
#: names the design: the phase names, (anchor, replacement) pairs, and
#: the searches whose rounds it counts, each by the mark it follows.  One
#: thread of a row makes its marks: "kt_mark(row, k)" (slots 0-6 of the
#: row hold clock64 readings, slot 7 is 1 where it took the n_eff = 0
#: exit), "kt_round(row)" once per search round (slot 8 + the last mark),
#: "kt_kept(row, K)" the lanes kept after the select (slot 16)
K4_MARKS = {
    # the parent's: one 256-thread block a row, every lane re-read and
    # re-clamped in every step of both bisections
    "struct WebsterLane {": (
        ("sums", "threshold bisection", "full award", "tie bisection",
         "award"),
        (("  i64 tw = 0;\n",
          "  if (threadIdx.x == 0) kt_mark(blockIdx.x, 0);\n  i64 tw = 0;\n"),
         ("    __syncthreads();\n    return;\n",
          "    if (threadIdx.x == 0) kt_mark(blockIdx.x, -1);\n"
          "    __syncthreads();\n    return;\n"),
         ("  const i64 hi0 = maxll(block_max<NT>(mx, red), 1);\n",
          "  const i64 hi0 = maxll(block_max<NT>(mx, red), 1);\n"
          "  if (threadIdx.x == 0) kt_mark(blockIdx.x, 1);\n"),
         ("  const i64 t_star = cnt(0) <= n_eff ? 0 : hi;\n",
          "  const i64 t_star = cnt(0) <= n_eff ? 0 : hi;\n"
          "  if (threadIdx.x == 0) kt_mark(blockIdx.x, 2);\n"),
         ("  const i64 r = n_eff - block_sum<NT>(fsum, red);\n",
          "  const i64 r = n_eff - block_sum<NT>(fsum, red);\n"
          "  if (threadIdx.x == 0) kt_mark(blockIdx.x, 3);\n"),
         ("    k_star = hi;\n  }\n",
          "    k_star = hi;\n  }\n"
          "  if (threadIdx.x == 0) kt_mark(blockIdx.x, 4);\n"),
         ("    seats[i] = active[i] ? l.s0 + full + award : 0;\n  }\n"
          "  __syncthreads();\n",
          "    seats[i] = active[i] ? l.s0 + full + award : 0;\n  }\n"
          "  __syncthreads();\n"
          "  if (threadIdx.x == 0) kt_mark(blockIdx.x, 5);\n")),
        ()),
    # this one: a row per warp (std) or per block (big), lanes compacted
    # once, a select that drops the lanes below G, tight brackets
    "struct Recip {": (
        ("lanes", "select", "threshold search", "full award",
         "tie search", "award"),
        tuple((anchor, text.replace(
            "MARK", "if (tid == 0) kt_mark(ROW, ").replace(
            "KEPT", "if (tid == 0) kt_kept(ROW, ").replace(
            "ROW", "blockIdx.x * (blockDim.x / NT) + threadIdx.x / NT"))
              for anchor, text in (
            ("  // 1. lanes, once: default seats, positive lanes compacted\n",
             "  MARK0);\n"
             "  // 1. lanes, once: default seats, positive lanes compacted\n"),
            ("  if (n == 0) return;  // every lane keeps its default seats\n",
             "  if (n == 0) { MARK-1); return; }\n  MARK1);\n"),
            ("  // 3. threshold search on the kept lanes\n",
             "  MARK2);\n  KEPT K);\n"
             "  // 3. threshold search on the kept lanes\n"),
            ("  while (hi - lo > 1) {\n    const u64 D = hi - lo;\n",
             "  while (hi - lo > 1) {\n    const u64 D = hi - lo;\n"
             "    if (tid == 0) kt_round(ROW);\n"),
            ("  // 4. full award above t*; the tie block at q == t* "
             "(t* > 0)\n",
             "  MARK3);\n"
             "  // 4. full award above t*; the tie block at q == t* (t* > 0)"
             "\n"),
            ("  i64 k_star = 0;\n", "  MARK4);\n  i64 k_star = 0;\n"),
            ("    seats[idx[j]] = (i64)s0v[j] + award;\n  }\n}\n",
             "    seats[idx[j]] = (i64)s0v[j] + award;\n  }\n  MARK6);\n}\n"),
            ("  for (u32 j = tid; j < K; j += NT) {\n    const u32 award",
             "  MARK5);\n"
             "  for (u32 j = tid; j < K; j += NT) {\n    const u32 award"))),
        (("select", 1), ("threshold", 2), ("tie", 4))),
}
#: rows the K4 profile holds
K4_PROF_ROWS = 4096
#: profile slots a row
K4_SLOTS = 24
K4_PROLOGUE = (
    "__device__ long long kt_prof[%d * %d];\n"
    "__device__ __forceinline__ void kt_mark(long long row, int k) {\n"
    "  long long* p = kt_prof + row * %d;\n"
    "  if (k < 0) { p[7] = 1; return; }\n"
    "  p[k] = clock64();\n"
    "  p[15] = k;\n"
    "}\n"
    "__device__ __forceinline__ void kt_round(long long row) {\n"
    "  long long* p = kt_prof + row * %d;\n"
    "  p[8 + p[15]] += 1;\n"
    "}\n"
    "__device__ __forceinline__ void kt_kept(long long row, long long K) {\n"
    "  kt_prof[row * %d + 16] = K;\n"
    "}\n"
    'extern "C" int kt_prof_read(long long* h) { return '
    "(int)cudaMemcpyFromSymbol(h, kt_prof, sizeof(kt_prof)); }\n"
    % ((K4_PROF_ROWS,) + (K4_SLOTS,) * 4))


def profile_k4(kmod, smod, web, out_dir, name):
    """clock64 profile of one K4 launch on `web` (n, w, s0, active, rank):
    the tree's webster.cuh with its design's marks, built beside its
    webster_batch.cu and launched through its wrapper (smod.webster_batch
    with kmod's entry swapped); held against webster_plain.  Returns
    (phase names, [rows, phases] cycles of the rows that solved, their
    row indices, {search: rounds of those rows}, their kept lanes or
    None)."""
    csrc = str(kmod.CSRC)
    head = open(os.path.join(csrc, "webster.cuh")).read()
    found = [k for k in K4_MARKS if k in head]
    if len(found) != 1:
        raise AssertionError(f"{csrc}/webster.cuh: no K4 design to mark")
    phases, subs, searches = K4_MARKS[found[0]]
    for old, new in subs:
        if head.count(old) != 1:
            raise AssertionError(f"K4 mark anchor not in webster.cuh once: "
                                 f"{old!r}")
        head = head.replace(old, new)
    head = head.replace("#pragma once\n", "").replace(
        '#include "common.cuh"\n', '#include "common.cuh"\n' + K4_PROLOGUE)
    lib = build_variant(kmod, os.path.join(csrc, "webster_batch.cu"),
                        [('#include "webster.cuh"\n', head)], name, out_dir,
                        inc=csrc)
    saved = kmod._FNS["webster_batch"]
    try:
        kmod._FNS["webster_batch"] = entry(lib, "kt_webster_batch")
        got = smod.webster_batch(*web)
        torch.cuda.synchronize()
    finally:
        kmod._FNS["webster_batch"] = saved
    if not torch.equal(got, smod.webster_plain(*web)):
        raise AssertionError(f"{name}: the profiled K4 disagrees")
    h = np.zeros(K4_PROF_ROWS * K4_SLOTS, np.int64)
    fn = lib.kt_prof_read
    fn.argtypes = [ctypes.c_void_p]
    if fn(ctypes.c_void_p(h.ctypes.data)):
        raise RuntimeError("reading the K4 profile failed")
    h = h.reshape(K4_PROF_ROWS, K4_SLOTS)[:web[0].shape[0]]
    rows = np.flatnonzero(h[:, 7] == 0)
    rounds = {name: h[rows, 8 + mark] for name, mark in searches}
    kept = h[rows, 16] if searches else None
    return (phases, np.diff(h[rows, :len(phases) + 1], axis=1), rows,
            rounds, kept)


def probe_k4(CS, batch, wide, fleet, dev, trees):
    """K4 on the main path's problems: the census of every wave of the
    forward chunk (std) and of the wide chunk's big rows, then per tree
    (this checkout, the parent) on wave 0 of each tier: CUDA-event ms,
    host enqueue against device time, and the clock64 profile of its
    phases, in cycles a row."""
    from karmada_tpu_torch.ops import kernels
    from karmada_tpu_torch.ops import solver as S

    for ln in kernels.BUILD_LOG.get("webster_batch", "").splitlines():
        if "registers" in ln or "spill" in ln or "Compiling" in ln:
            print(f"K4 ptxas: {ln.strip()}", flush=True)
    db = S.device_batch(batch, dev)
    webs = CS.hold_rows(db, 8, S._use_extra(batch), "std", dev, 10)[4]
    sub, _ = CS.big_subbatch(wide, fleet)
    webs_big = CS.hold_rows(S.device_batch(sub, dev), 8, S._use_extra(sub),
                            "big", dev, 10)[4]
    for tier, probs in (("std, the chunk's 8 waves", webs),
                        ("big, the wide chunk's big rows", webs_big)):
        print(CS.k4_census_line(tier, CS.webster_census(probs)), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        for label, kmod, smod in trees:
            for tier, web in (("std", webs[0]), ("big", webs_big[0])):
                def call(smod=smod, web=web):
                    return smod.webster_batch(*web)

                ms = CS.cuda_ms(call, 50)
                host, device = CS.split_ms(call, 50)
                phases, d, solved, rounds, kept = profile_k4(
                    kmod, smod, web, tmp, f"webster_{label}_{tier}")
                print(f"K4 {label}, {tier} wave 0 {tuple(web[1].shape)}: "
                      f"{ms:.4f} ms; split_ms host {host:.4f} ms, device "
                      f"{device} ms; clock64 cycles a row (mean / max over "
                      f"{len(d)} rows that solved): " + "; ".join(
                          f"{p} {d[:, i].mean():.0f} / {d[:, i].max()}"
                          for i, p in enumerate(phases))
                      + f"; a row {d.sum(1).mean():.0f} / {d.sum(1).max()}"
                      + "".join(f"; {p} rounds {v.mean():.1f} / {v.max()}"
                                for p, v in rounds.items()), flush=True)
                # the rows that set the kernel's time, with their census
                # and the kernel's own counts
                c = CS.webster_census([web])
                for i in np.argsort(-d.sum(1))[:5]:
                    row = solved[i]
                    print(f"K4 {label}, {tier}: row {row} took "
                          f"{d[i].sum()} cycles ("
                          + ", ".join(f"{p} {d[i, k]}"
                                      for k, p in enumerate(phases))
                          + f"); n_eff {c['n_eff'][row]} P {c['P'][row]} "
                          f"r>0 {bool(c['r'][row])} tie-block lanes "
                          f"{c['tie_lanes'][row]}"
                          + ("" if kept is None else f"; kept lanes {kept[i]}")
                          + "".join(f", {p} rounds {v[i]}"
                                    for p, v in rounds.items()), flush=True)


#: the phases between the KT_MARK(k) points of a K5 / K6 source
#: (spread.cuh; compiled in with -DKT_PROFILE), by source
K5K6_PHASES = {
    "spread_group_info": ("init + row + pass 1", "decide + walk",
                          "long walks", "scores"),
    "spread_pick": ("init + row + pass 1", "rest", "select", "write"),
}
#: rows the K5 / K6 profile holds (the value of KT_PROFILE)
K5K6_PROF_ROWS = 4096


def profile_k5k6(kmod, call, source, out_dir, name):
    """clock64 profile of one launch of a K5 / K6 source (`call` runs it
    through the tree's wrapper and returns its outputs): the tree's
    source built beside its headers with -DKT_PROFILE (its KT_MARK points
    compiled in), launched with kmod's entry swapped, held against the
    unmarked kernel's outputs.  Returns (phase names, [rows, phases]
    cycles), or None for a tree whose source has no marks."""
    csrc = str(kmod.CSRC)
    src = os.path.join(csrc, f"{source}.cu")
    if "KT_MARK(" not in open(src).read():
        return None
    lib = build_variant(kmod, src, [], name, out_dir, inc=csrc,
                        flags=(f"-DKT_PROFILE={K5K6_PROF_ROWS}",))
    want = call()
    torch.cuda.synchronize()
    saved = kmod._FNS[source]
    try:
        kmod._FNS[source] = entry(lib, "kt_" + source)
        got = call()
        torch.cuda.synchronize()
    finally:
        kmod._FNS[source] = saved
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"{name}: the profiled kernel disagrees")
    h = np.zeros(K5K6_PROF_ROWS * 8, np.int64)
    fn = lib.kt_prof_read
    fn.argtypes = [ctypes.c_void_p]
    if fn(ctypes.c_void_p(h.ctypes.data)):
        raise RuntimeError("reading the K5 / K6 profile failed")
    phases = K5K6_PHASES[source]
    rows = got[0].shape[0]
    h = h.reshape(K5K6_PROF_ROWS, 8)[:rows]
    return phases, np.diff(h[:, :len(phases) + 1], axis=1)


def probe_k5k6(CS, batch, items, wide, explain, fleet, dev, trees):
    """K5 and K6: spread_census of the spread sub-batches of the first
    forward chunk (phase 2's), the first wide chunk and the first explain
    chunk; then per tree on phase 2's sub-batch: CUDA-event ms, host
    enqueue against device time, and the clock64 profile of each
    kernel's phases in cycles a row."""
    from karmada_tpu_torch.estimator.general import GeneralEstimator
    from karmada_tpu_torch.ops import kernels
    from karmada_tpu_torch.ops import tensors as T

    for src in ("spread_group_info", "spread_pick"):
        for ln in kernels.BUILD_LOG.get(src, "").splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"{src} ptxas: {ln.strip()}", flush=True)
    cindex = T.ClusterIndex.build(fleet)
    ops = CS.spread_operands(batch, items, dev, 8)
    for label, part, chunk in (("the first wide chunk", wide, 4096),
                               ("the first explain chunk", explain, 1024)):
        b = T.encode_batch(part[:chunk], cindex, GeneralEstimator())
        for (axis, tier), (gi, pk) in CS.spread_operands(
                b, part[:chunk], dev, 8).items():
            print(CS.spread_census_line(f"{label}, {tier} tier",
                                        CS.spread_census(gi, pk)),
                  flush=True)
    gi, pk = ops[("", "std")]
    print(CS.spread_census_line("phase 2, the first forward chunk",
                                CS.spread_census(gi, pk)), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        for label, kmod, smod in trees:
            SP = smod.SP
            # every tree's wrappers with the operands alone (their default
            # use_extra), so that trees whose wrappers differ in it are
            # timed alike
            for source, call in (
                    ("spread_group_info",
                     lambda SP=SP: SP.spread_group_info(*gi)),
                    ("spread_pick", lambda SP=SP: SP.spread_pick(*pk))):
                ms = CS.cuda_ms(call, 50)
                host, device = CS.split_ms(call, 50)
                prof = profile_k5k6(kmod, call, source, tmp,
                                    f"{source}_{label.split()[-1]}")
                line = (f"{source} {label}, phase 2 ({gi[0].B} / {pk[0].B} "
                        f"rows x {gi[0].C}): {ms:.4f} ms; split_ms host "
                        f"{host:.4f} ms, device {device} ms")
                if prof is not None:
                    phases, d = prof
                    line += (
                        f"; clock64 cycles a row (mean / max over {len(d)} "
                        "rows): " + "; ".join(
                            f"{p} {d[:, i].mean():.0f} / {d[:, i].max()}"
                            for i, p in enumerate(phases))
                        + f"; a row {d.sum(1).mean():.0f} / "
                        f"{d.sum(1).max()}")
                print(line, flush=True)


def host_ms(fn, n=200):
    """Host-clock ms a call of `fn` over `n` calls enqueued back to back
    (nothing waits inside), after one warm-up, the stream drained after."""
    import time

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    ms = (time.perf_counter() - t0) / n * 1e3
    torch.cuda.synchronize()
    return ms


def k11_pieces(RG, kmod, slots, mirrors, dev, sub=None):
    """Where one K11 dispatch from host slots goes on the host, piece by
    piece, each timed alone (host ms a call): for a tree whose wrapper
    stages through a pinned buffer of its own a call (_staged_gather
    without _staged_len) the signature check, the numpy staging, the
    pinned torch.empty and its fill, the slab, the copy_, the block
    writes, kernels.launch and _views, and two other ways to make the
    twelve outputs; for a tree whose mirror-set workspace stages through
    its ring in the C call (_staged_len) the check, the numpy inputs, the
    ring's size check, the slab, the block writes, the one C call and
    _views.  `sub` = (lane_inv, drop) for the sub flavour."""
    from array import array

    B = slots.shape[0]
    p = RG._plan(mirrors)
    parts = {"_plan (signature check)": host_ms(lambda: RG._plan(mirrors))}
    if hasattr(RG, "_staged_len"):
        arr = [np.ascontiguousarray(slots, np.int64)]
        if sub is not None:
            arr += [np.ascontiguousarray(sub[0], np.int32),
                    np.ascontiguousarray(sub[1], np.bool_)]
        n_inv = arr[1].shape[0] if sub is not None else 0
        staged = RG._staged_len(B, n_inv, sub is not None)
        p.stage(staged)
        nbytes, spec, offs = RG._layout(p, B, staged)
        RG._launch(p, B, staged, tuple(a.ctypes.data for a in arr) + (0,) *
                   (3 - len(arr)), n_inv)  # the block's layout for B
        slab = torch.empty((nbytes,), dtype=torch.uint8, device=dev)
        blk = p.blk

        def writes():
            blk[0], blk[1], blk[2] = tuple(
                a.ctypes.data for a in arr) + (0,) * (3 - len(arr))
            blk[RG._B] = B
            blk[RG._SLAB] = slab.data_ptr()
            blk[RG._STAGED] = 1
            blk[RG._NINV] = n_inv

        writes()
        parts.update({
            "numpy inputs (ascontiguousarray, addresses)": host_ms(
                lambda: [np.ascontiguousarray(a).ctypes.data for a in arr]),
            "ring size check": host_ms(lambda: p.stage(staged)),
            "_layout (cached)": host_ms(lambda: RG._layout(p, B, staged)),
            "slab allocation": host_ms(lambda: torch.empty(
                (nbytes,), dtype=torch.uint8, device=dev)),
            "block writes": host_ms(writes),
            "the C call (staging, upload, kernel)": host_ms(
                lambda: kmod.launch("resident", blk, "gather_rows",
                                    device=p.dev)),
            "_views": host_ms(lambda: RG._views(slab, spec))})
    elif hasattr(RG, "_staged_gather"):
        arrays = [np.ascontiguousarray(slots, np.int64)]
        if sub is not None:
            arrays += [np.ascontiguousarray(sub[0], np.int32),
                       np.ascontiguousarray(sub[1], np.bool_)]

        def staging():
            arr = [np.ascontiguousarray(a) for a in arrays]
            offs, n = [], 0
            for a in arr:
                offs.append(n)
                n = RG._aligned(n + a.nbytes)
            return arr, offs, n

        arr, in_offs, staged = staging()
        host = torch.empty((staged,), dtype=torch.uint8, pin_memory=True)
        hv = host.numpy()

        def fill():
            for a, o in zip(arr, in_offs):
                hv[o:o + a.nbytes] = a.view(np.uint8)

        nbytes, spec, out_offs = RG._layout(p, B, staged)
        slab = torch.empty((nbytes,), dtype=torch.uint8, device=dev)
        base = slab.data_ptr()
        inputs = [base + o for o in in_offs] + [0] * (3 - len(in_offs))
        blk = p.blk

        def writes():
            blk[0:RG._ARG_MIRRORS] = array("q", inputs)
            blk[RG._ARG_OUTS:RG._ARG_B] = array(
                "q", [base + o for o in out_offs])
            blk[RG._ARG_B] = B

        writes()
        parts.update({
            "numpy staging (offsets)": host_ms(staging),
            "pinned torch.empty": host_ms(lambda: torch.empty(
                (staged,), dtype=torch.uint8, pin_memory=True)),
            "pinned fill": host_ms(fill),
            "_layout (cached)": host_ms(lambda: RG._layout(p, B, staged)),
            "slab allocation": host_ms(lambda: torch.empty(
                (nbytes,), dtype=torch.uint8, device=dev)),
            "copy_": host_ms(lambda: slab[:staged].copy_(
                host, non_blocking=True)),
            "block writes": host_ms(writes),
            "kernels.launch": host_ms(lambda: kmod.launch(
                "resident", blk, "gather_rows", device=p.dev)),
            "_views": host_ms(lambda: RG._views(slab, spec))})
        # view constructions a redesign could use instead (one slab)
        Kp, Ke = p.Kp, p.Ke
        n32 = 3 * B + 2 * B * Kp + B * Ke

        def split_views():
            i64 = slab[:8 * B].view(torch.int64)
            i32 = slab[8 * B:8 * B + 4 * n32].view(torch.int32)
            a = i32.split_with_sizes((B, B, B, B * Kp, B * Kp, B * Ke))
            b8 = slab[8 * B + 4 * n32:8 * B + 4 * n32 + 5 * B].view(
                torch.bool).split(B)
            return (b8[0], a[0], a[1], a[2], i64, *b8[1:],
                    a[3].view(B, Kp), a[4].view(B, Kp), a[5].view(B, Ke))

        def empties():
            return tuple(torch.empty(sh, dtype=dt, device=dev) for dt, sh, *_
                         in spec)

        parts["alternative: split_with_sizes views of one slab"] = host_ms(
            split_views)
        parts["alternative: twelve torch.empty"] = host_ms(empties)
    if sub is None:
        parts["whole dispatch_gather"] = host_ms(
            lambda: RG.dispatch_gather(slots, mirrors))
    else:
        parts["whole dispatch_sub_gather"] = host_ms(
            lambda: RG.dispatch_sub_gather(slots, mirrors, *sub))
    return parts


def probe_k11(CS, dev, trees):
    """K11 per tree at phase 2's shape (4,096 rows of a 2^20-slot store,
    Kp = Ke = 4; a 64-lane union and every 16th row dropped in the sub
    flavour): CUDA-event ms and host enqueue against device time of
    gather_batch and sub_gather_batch on card operands, and of
    dispatch_gather and dispatch_sub_gather from host slots (their uploads
    included)."""
    rng = np.random.default_rng(0)
    cap, B, C, Kp, Ke = 1 << 20, 4096, 10_000, 4, 4
    store = {
        "placement_id": rng.integers(0, 200, cap).astype(np.int32),
        "gvk_id": rng.integers(0, 3, cap).astype(np.int32),
        "class_id": rng.integers(-1, 9, cap).astype(np.int32),
        "replicas": rng.integers(0, 12, cap).astype(np.int64),
        "uid_desc": rng.random(cap) < 0.5,
        "fresh": rng.random(cap) < 0.3,
        "non_workload": rng.random(cap) < 0.1,
        "nw_shortcut": rng.random(cap) < 0.1,
        "route": rng.choice([0, 0, 0, 6, 8, 1], cap).astype(np.int32),
        "prev_idx": rng.integers(-1, C, (cap, Kp)).astype(np.int32),
        "prev_val": rng.integers(0, 6, (cap, Kp)).astype(np.int32),
        "evict_idx": rng.integers(-1, C, (cap, Ke)).astype(np.int32),
    }
    mirrors = {k: torch.from_numpy(v).to(dev) for k, v in store.items()}
    slots = rng.choice(cap, B, replace=False).astype(np.int64)
    slots[-40:] = -1
    inv = np.full(C, -1, np.int32)
    inv[rng.choice(C, 64, replace=False)] = np.arange(64, dtype=np.int32)
    drop = np.zeros(B, bool)
    drop[::16] = True
    st, it, dt = (torch.from_numpy(a).to(dev) for a in (slots, inv, drop))
    for label, kmod, smod in trees:
        RG = smod.RG
        calls = (
            ("gather_batch", lambda RG=RG: RG.gather_batch(st, mirrors)),
            ("sub_gather_batch",
             lambda RG=RG: RG.sub_gather_batch(st, mirrors, it, dt)),
            ("dispatch_gather",
             lambda RG=RG: RG.dispatch_gather(slots, mirrors)),
            ("dispatch_sub_gather",
             lambda RG=RG: RG.dispatch_sub_gather(slots, mirrors, inv,
                                                  drop)))
        for name, fn in calls:
            ms = CS.cuda_ms(fn, 200)
            host, device = CS.split_ms(fn, 200)
            by = CS.kernel_device_ms(fn, 200)
            print(f"K11 {label}, {name} ({B} rows of {cap} slots): "
                  f"{ms:.4f} ms; split_ms host {host:.4f} ms, device "
                  f"{device} ms; {CS.by_text(by)}", flush=True)
        for name, sub in (("dispatch_gather", None),
                          ("dispatch_sub_gather", (inv, drop))):
            parts = k11_pieces(RG, kmod, slots, mirrors, dev, sub)
            print(f"K11 {label}, {name} host pieces, host ms a call: "
                  + "; ".join(f"{k} {v:.4f}" for k, v in parts.items()),
                  flush=True)


# -- K7 explain_rows -------------------------------------------------------------

#: clock64 marks substituted into a copy of an explain.cu without KT_MARK
#: points (its first design: load_row, the lane loop over lane_info, nine
#: block_sum reductions)
K7_OLD_MARKS = (
    ("  const i64 b = a.r0 + blockIdx.x;\n",
     "  KT_MARK(0);\n  const i64 b = a.r0 + blockIdx.x;\n"),
    ("  load_row<NT>(a, b, row, pidx, pval, eidx);\n",
     "  load_row<NT>(a, b, row, pidx, pval, eidx);\n  KT_MARK(1);\n"),
    ("  i64 best = 0;\n", "  KT_MARK(2);\n  i64 best = 0;\n"),
    ("    a.outcome[b] = st | (code << 8);\n  }\n}\n",
     "    a.outcome[b] = st | (code << 8);\n  }\n  KT_MARK(3);\n}\n"),
)
#: K7's phases, (name, from slot, to slot): "old" for K7_OLD_MARKS,
#: "marks" for a source with KT_MARK points
K7_PHASES = {
    "old": (("load_row", 0, 1), ("lane loop (lane_info)", 1, 2),
            ("nine block_sum reductions + outcome", 2, 3), ("a row", 0, 3)),
    "marks": (("load_row", 0, 1), ("row_bits", 1, 2), ("lane loop", 2, 3),
              ("reductions + outcome", 3, 4), ("a row", 0, 4)),
}
K7_PROF_ROWS = 1024


def profile_k7(kmod, call, entry_name, out_dir, name):
    """clock64 profile of one K7 launch (`call` runs it through the
    tree's wrapper and returns its planes): the tree's explain.cu built
    with -DKT_PROFILE, its KT_MARK points or K7_OLD_MARKS substituted
    into a copy, launched with kmod's entry swapped and held against the
    unmarked kernel.  Returns (phases, {phase: cycles a row array})."""
    csrc = str(kmod.CSRC)
    src = os.path.join(csrc, "explain.cu")
    text = open(src).read()
    marked = "KT_MARK(" in text
    lib = build_variant(kmod, src, [] if marked else K7_OLD_MARKS, name,
                        out_dir, inc=csrc,
                        flags=(f"-DKT_PROFILE={K7_PROF_ROWS}",))
    want = tuple(t.clone() for t in call())
    torch.cuda.synchronize()
    saved = kmod._FNS[entry_name]
    try:
        kmod._FNS[entry_name] = entry(lib, "kt_" + entry_name)
        got = call()
        torch.cuda.synchronize()
    finally:
        kmod._FNS[entry_name] = saved
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"{name}: the profiled kernel disagrees")
    h = np.zeros(K7_PROF_ROWS * 8, np.int64)
    fn = lib.kt_prof_read
    fn.argtypes = [ctypes.c_void_p]
    if fn(ctypes.c_void_p(h.ctypes.data)):
        raise RuntimeError("reading the K7 profile failed")
    h = h.reshape(K7_PROF_ROWS, 8)
    h = h[h[:, 0] != 0]
    phases = K7_PHASES["marks" if marked else "old"]
    return phases, {p: h[:, b] - h[:, a] for p, a, b in phases}


def probe_k7(CS, items, fleet, dev, trees):
    """K7 per tree at phase 2's shapes (chip_smoke.explain_operands): wave
    0 of the first forward chunk (512 x 8,192) and the spread flavour on
    that chunk's region-spread phase B -- CUDA-event ms, host enqueue
    against device time, and a clock64 profile of a row's phases; for a
    tree whose wrapper takes a workspace, also the call as schedule_core
    makes it (the chunk's workspace, the batch's use_extra).  The trees'
    planes must agree."""
    import inspect

    from karmada_tpu_torch.ops import solver as NS

    batch, k7_in, ex = CS.explain_operands(items[:4096], fleet, dev, 8)
    db, C = k7_in[0], k7_in[0].C
    Bw, Bs = k7_in[2], ex[2]
    use_extra = NS._use_extra(batch)
    outs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, kmod, smod in trees:
            S = smod.S
            tag = label.split()[-1]
            for ln in kmod.BUILD_LOG.get("explain", "").splitlines():
                if "registers" in ln or "spill" in ln:
                    print(f"K7 ptxas ({label}): {ln.strip()}", flush=True)
            planes = S.explain_planes(db.B, C, dev)
            sp = S.explain_planes(Bs, C, dev)
            calls = {
                "explain_rows": (
                    f"wave 0 ({Bw} x {C})",
                    lambda S=S, o=planes: (S.explain_rows(*k7_in, o), o)[1]),
                "explain_rows_spread": (
                    f"spread flavour ({Bs} x {C})",
                    lambda S=S, o=sp: (S.explain_rows(*ex[:7], o,
                                                      pick=ex[7]), o)[1])}
            if "workspace" in inspect.signature(S.explain_rows).parameters:
                ws = S.ExplainWorkspace(db, *k7_in[3:7], planes,
                                        use_extra=use_extra)
                calls["explain_rows (main path)"] = (
                    f"wave 0 ({Bw} x {C}) on the chunk's workspace, "
                    f"use_extra {use_extra}",
                    lambda S=S, o=planes, ws=ws: (S.explain_rows(
                        *k7_in, o, use_extra=use_extra, workspace=ws),
                        o)[1])
            for ename, (what, call) in calls.items():
                got = tuple(t.clone() for t in call())
                torch.cuda.synchronize()
                outs.setdefault(what.split(" on ")[0], []).append(got)
                ms = CS.cuda_ms(call, 200)
                host, device = CS.split_ms(call, 200)
                line = (f"K7 {label}, {what}: {ms:.4f} ms; host enqueue "
                        f"{host:.4f} ms, device {device} ms")
                if "main path" not in ename:
                    phases, d = profile_k7(kmod, call, ename, tmp,
                                           f"k7_{ename}_{tag}")
                    line += "; clock64 cycles a row (mean / max over " + \
                        f"{len(d['a row'])} rows): " + "; ".join(
                            f"{p} {d[p].mean():.0f} / {d[p].max()}"
                            for p, _a, _b in phases)
                print(line, flush=True)
    for what, got in outs.items():
        if not all(all(torch.equal(a, b) for a, b in zip(got[0], g))
                   for g in got[1:]):
            raise AssertionError(f"K7 probe: {what} disagrees")


# -- K1 capacity and K8 shortlist_topk -----------------------------------------

def _dev_line(by):
    """A kernel_device_ms reading: the device ms per call by CUDA events
    (by C entry, and their sum), the profiler's by kernel beside them and
    K1's share of those."""
    k1 = sum(v for k, v in by.profiler_ms.items() if "capacity" in k)
    return (f"device {sum(by.values()):.4f} ms ({_by_text(by)}; K1 "
            f"capacity_kernel profiler_ms {k1:.4f})")


def probe_k1(CS, batch, wide, fleet, dev, trees):
    """K1 per tree: the standalone call at phase 2's shape (the forward
    chunk's [Q+1, 8,192] est) -- CUDA-event ms, host enqueue against
    device time -- and one whole wave 0 of each tier (K1, K2's prepare,
    K4, K2's finish), std on the forward chunk and big on the first wide
    chunk's big rows: CUDA-event ms, host enqueue, device time by kernel
    and each launch's CUDA events.  The trees' waves must agree."""
    sub, _n = CS.big_subbatch(wide, fleet)
    outs = {}
    for label, kmod, smod in trees:
        S = smod.S
        db = S.device_batch(batch, dev)
        Q, C = db.req_milli.shape[0], db.C
        z = S._zeros_used(db)
        cap_in = (db.req_milli, db.req_is_cpu, db.req_pods, db.avail_milli,
                  z[0], db.has_alloc, db.pods_allowed, z[1],
                  db.has_summary, db.est_override, z[2])

        def cap(S=S, cap_in=cap_in):
            return S.capacity(*cap_in)
        ms = CS.cuda_ms(cap, 200)
        host, device = CS.split_ms(cap, 200)
        print(f"K1 {label}, capacity [{Q + 1}, {C}]: {ms:.4f} ms; split_ms "
              f"host {host:.4f} ms, device {device} ms", flush=True)
        for tier, b in (("std", batch), ("big", sub)):
            dbx = S.device_batch(b, dev)
            used = tuple(u.clone() for u in S._zeros_used(dbx))
            out = (torch.zeros((dbx.B, dbx.C), dtype=torch.int64,
                               device=dev),
                   torch.zeros((dbx.B, dbx.C), dtype=torch.bool, device=dev),
                   torch.zeros((dbx.B,), dtype=torch.int32, device=dev))
            wave = CS.wave_call(S, dbx, used, out, S._use_extra(b), tier,
                                CS.fills_est(S))
            wave()
            torch.cuda.synchronize()
            outs.setdefault(tier, []).append(tuple(t.clone() for t in out))
            ms = CS.cuda_ms(wave, 20)
            host, _d = CS.split_ms(wave, 20)
            by = CS.kernel_device_ms(wave, 20)
            Bw = dbx.B // S._effective_waves(dbx.B, 8)
            print(f"K1 {label}, {tier} wave 0 ({Bw} x {dbx.C}): {ms:.4f} "
                  f"ms; host enqueue {host:.4f} ms; " + _dev_line(by),
                  flush=True)
    for tier, v in outs.items():
        if not all(all(torch.equal(a, b) for a, b in zip(v[0], x))
                   for x in v[1:]):
            raise AssertionError(f"K1 probe: the trees' {tier} waves "
                                 "disagree")


#: the clock64 marks of the parent's K8 (one block a row, rows.cuh
#: topk_select): (anchor, replacement) pairs in its shortlist.cu; the
#: first holds the profile buffer's size (K8_PROF_BLOCKS)
K8_OLD_MARK = ("__syncthreads(); if (threadIdx.x == 0) "
               "kt_prof[blockIdx.x * 8 + (%d)] = clock64();\n")
K8_OLD_MARKS = (
    ('#include "rows.cuh"\n', '#include "rows.cuh"\n'
     "__device__ long long kt_prof[%d * 8];\n"
     'extern "C" int kt_prof_read(long long* h) { return '
     "(int)cudaMemcpyFromSymbol(h, kt_prof, sizeof(kt_prof)); }\n"),
    ("  Row row;\n  row.slot = b;\n",
     "  " + K8_OLD_MARK % 0 + "  Row row;\n  row.slot = b;\n"),
    ("  topk_select<NT>(keys, C, 1,", "  " + K8_OLD_MARK % 1
     + "  topk_select<NT>(keys, C, 1,"),
    ("  // the members (min(fcount, k) of them)", "  " + K8_OLD_MARK % 2
     + "  // the members (min(fcount, k) of them)"),
    ("  block_sort<NT>(mkey, midx, (int)a.nk);\n",
     "  " + K8_OLD_MARK % 3 + "  block_sort<NT>(mkey, midx, (int)a.nk);\n  "
     + K8_OLD_MARK % 4),
    ("  if (threadIdx.x == 0) a.fcount[b] = cnt[0];\n}",
     "  if (threadIdx.x == 0) a.fcount[b] = cnt[0];\n  "
     + K8_OLD_MARK % 5 + "}"))
#: the phases between the marks of a K8 design, by a line of its
#: shortlist.cu that names the design
K8_PHASES = {
    "  topk_select<NT>(keys, C, 1,": (
        "row + lane pass", "select (8 radix passes)", "member gather",
        "sort", "write"),
    # a row over a cluster of blocks; the leader (rank 0) sorts and writes
    "__cluster_dims__(TK_CLUSTER, 1, 1)": (
        "row + lane pass + counts", "select + member push", "cluster wait",
        "sort (leader)", "write (leader)"),
}
#: blocks the K8 profile holds
K8_PROF_BLOCKS = 4096


def profile_k8(kmod, call, out_dir, name):
    """clock64 profile of one K8 launch (`call` runs the tree's tier-1
    call and returns (cand, fcount)): the tree's shortlist.cu with its
    design's marks -- compiled in with -DKT_PROFILE where the source holds
    KT_MARK points, else K8_OLD_MARKS substituted -- launched with kmod's
    entry swapped and held against the unmarked kernel.  Returns (phase
    names, [blocks, phases] cycles)."""
    csrc = str(kmod.CSRC)
    src = os.path.join(csrc, "shortlist.cu")
    text = open(src).read()
    phases = next(v for k, v in K8_PHASES.items() if k in text)
    if "KT_MARK(" in text:
        lib = build_variant(kmod, src, [], name, out_dir, inc=csrc,
                            flags=(f"-DKT_PROFILE={K8_PROF_BLOCKS}",))
    else:
        subs = [(a, b % K8_PROF_BLOCKS if i == 0 else b)
                for i, (a, b) in enumerate(K8_OLD_MARKS)]
        lib = build_variant(kmod, src, subs, name, out_dir, inc=csrc)
    want = call()
    torch.cuda.synchronize()
    saved = kmod._FNS["shortlist_topk"]
    try:
        kmod._FNS["shortlist_topk"] = entry(lib, "kt_shortlist_topk")
        got = call()
        torch.cuda.synchronize()
    finally:
        kmod._FNS["shortlist_topk"] = saved
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"{name}: the profiled kernel disagrees")
    h = np.zeros(K8_PROF_BLOCKS * 8, np.int64)
    fn = lib.kt_prof_read
    fn.argtypes = [ctypes.c_void_p]
    if fn(ctypes.c_void_p(h.ctypes.data)):
        raise RuntimeError("reading the K8 profile failed")
    h = h.reshape(K8_PROF_BLOCKS, 8)
    blocks = np.flatnonzero(h[:, 0] != 0)
    return phases, np.diff(h[blocks, :len(phases) + 1], axis=1), blocks


def mega_profile_rows(CS, M, n=4096):
    """The first megafleet chunk's tier-1 operands, as chip_smoke phase 2
    holds K8 on them: (its SolverBatch, the profile keys, rep_max)."""
    from karmada_tpu_torch.estimator.general import GeneralEstimator
    from karmada_tpu_torch.ops import shortlist as SL
    from karmada_tpu_torch.ops import tensors as T

    mfleet, mpl = CS.build_megafleet(M, random.Random(2), CS.MEGA_CLUSTERS,
                                     CS.MEGA_REGIONS)
    mitems = CS.build_mega_bindings(M, random.Random(3), n, mpl, n)
    mbatch = T.encode_batch(mitems, T.ClusterIndex.build(mfleet),
                            GeneralEstimator(), cache=T.EncoderCache())
    prof_keys, _of, rep_max = SL._profiles(mbatch)
    return mbatch, prof_keys, rep_max


def probe_k8(CS, M, dev, trees, k=64):
    """K8 per tree on the first megafleet chunk's profile rows (16 x
    16,384, k = 64) and on the same rows over twice the lanes (the
    parent's device-memory key path): the tier-1 call's CUDA-event ms
    (the parent's K1 + K8, or the fused K8), host enqueue and device time
    by kernel, and the clock64 phase profile of K8 at 16,384 lanes.  The
    trees must agree."""
    mbatch, prof_keys, rep_max = mega_profile_rows(CS, M)
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, kmod, smod in trees:
            S, SL = smod.S, smod.SL
            agg = SL.cycle_aggregates(mbatch, dev)
            pref = torch.from_numpy(agg["group_pref"]).to(dev)
            db = SL.profile_batch(mbatch, prof_keys, rep_max, dev)
            for shape, d, p in (("", db, pref),
                                (" wide", CS.tile_lanes(S, db),
                                 torch.cat([pref, pref]))):
                call = CS.tier1_call(S, SL, d, p, k)
                res.setdefault(shape, []).append(call())
                ms = CS.cuda_ms(call, 200)
                host, _dv = CS.split_ms(call, 200)
                by = CS.kernel_device_ms(call, 200)
                print(f"K8 {label}{shape}, tier-1 call ({d.B} x {d.C}, k = "
                      f"{k}): {ms:.4f} ms; host enqueue {host:.4f} ms; "
                      + _dev_line(by), flush=True)
            phases, cyc, blocks = profile_k8(
                kmod, CS.tier1_call(S, SL, db, pref, k), tmp,
                f"shortlist_{label.split()[-1]}")
            groups = [("a block", cyc)]
            if len(blocks) > db.B:  # a row over a cluster: its leaders too
                groups.append(("a leader block", cyc[
                    blocks % (len(blocks) // db.B) == 0]))
            for what, c in groups:
                print(f"K8 {label}, clock64 cycles {what} ({len(c)}, mean / "
                      "max): " + "; ".join(
                          f"{p} {c[:, i].mean():.0f} / {c[:, i].max()}"
                          for i, p in enumerate(phases))
                      + f"; in all {c.sum(1).mean():.0f} / {c.sum(1).max()}",
                      flush=True)
    for shape, v in res.items():
        if not all(all(torch.equal(a, b) for a, b in zip(v[0], x))
                   for x in v[1:]):
            raise AssertionError(f"K8 probe{shape}: the trees disagree")


def probe_k8_census(CS, M, dev):
    """What the main path hands K8: every tier-1 dispatch (_t1_rows) of
    chip_smoke's phase 8 (the megafleet cycle) and phase 9 (the
    incremental steady state), by phase: launches, profile rows a launch
    (real and padded), C, k, and the eligible lanes a row (fcount)."""
    from karmada_tpu_torch.ops import shortlist as SL
    from karmada_tpu_torch.ops import tensors as T
    from karmada_tpu_torch.scheduler.core import schedule_items

    calls = []
    orig = SL._t1_rows

    def hooked(batch, prof_keys, rep_max, k, agg, device):
        cand, fcount = orig(batch, prof_keys, rep_max, k, agg, device)
        n = prof_keys.shape[0]
        calls.append((n, T._next_pow2(max(n, 1), 8), int(batch.C), k,
                      np.asarray(fcount)))
        return cand, fcount

    def report(label):
        rows = np.array([c[0] for c in calls])
        fc = np.concatenate([c[4] for c in calls])
        print(f"K8 census, {label}: {len(calls)} launches; profile rows a "
              f"launch p50 {np.percentile(rows, 50):.0f} max {rows.max()} "
              f"(padded {sorted({c[1] for c in calls})}); C "
              f"{sorted({c[2] for c in calls})}; k "
              f"{sorted({c[3] for c in calls})}; eligible lanes a row "
              f"(fcount) p50 {np.percentile(fc, 50):.0f} max {fc.max()} "
              f"over {fc.size} rows", flush=True)
        calls.clear()

    SL._t1_rows = hooked
    try:
        mfleet, mpl = CS.build_megafleet(M, random.Random(2),
                                         CS.MEGA_CLUSTERS, CS.MEGA_REGIONS)
        mitems = CS.build_mega_bindings(M, random.Random(3),
                                        CS.MEGAFLEET_BINDINGS, mpl, 4096)
        SL.reset_for_tests()
        schedule_items(mitems, mfleet, chunk=4096, waves=8, device=dev,
                       shortlist=SL.ShortlistConfig(k=CS.MEGA_K))
        report("phase 8 (the megafleet cycle)")
        del mitems
        CS.phase_incremental(M, mfleet, mpl, CS.INCREMENTAL_BINDINGS, 4096,
                             dev, 5)
        report("phase 9 (the incremental steady state)")
    finally:
        SL._t1_rows = orig


#: K2-big's prepare profile: slots a row holds (a source with KT_MARK
#: points: its KT_PROF_SLOTS), rows it holds
K2BIG_SLOTS = 32
K2BIG_PROF_ROWS = 4096
#: the parent's K2-big (gather_lanes over the device-memory key scratch,
#: rows.cuh topk_select): (file, anchor, replacement) marks substituted
#: into a copy of its sources; KT_PMARK(k) syncs the block and its thread
#: 0 writes clock64() into slot k of the block's row
K2BIG_OLD_MARKS = (
    ("rows.cuh", '#include "common.cuh"\n',
     '#include "common.cuh"\n'
     "__device__ long long kt_prof[%d * %d];\n"
     'extern "C" int kt_prof_read(long long* h) { return '
     "(int)cudaMemcpyFromSymbol(h, kt_prof, sizeof(kt_prof)); }\n"
     "#define KT_PMARK(k) do { __syncthreads(); if (threadIdx.x == 0 && "
     "blockIdx.x < %d) kt_prof[blockIdx.x * %d + (k)] = clock64(); "
     "} while (0)\n"),
    ("rows.cuh",
     "    const u64 high = shift >= 56 ? 0ULL : (~0ULL << (shift + 8));\n",
     "    KT_PMARK(2 + (56 - shift) / 8);\n"
     "    const u64 high = shift >= 56 ? 0ULL : (~0ULL << (shift + 8));\n"),
    ("rows.cuh", "  if (!fill) return;\n",
     "  KT_PMARK(10);\n  if (!fill) return;\n"),
    ("schedule_rows.cu",
     "  load_row<NT>(a, b, row, s.pidx, s.pval, s.eidx);\n",
     "  load_row<NT>(a, b, row, s.pidx, s.pval, s.eidx);\n  KT_PMARK(0);\n"),
    ("schedule_rows.cu",
     "  topk_select<NT>(keys, a.C, ng, G_PREV, G_TOPK, cnt, thr, cut, "
     "remaining,\n",
     "  KT_PMARK(1);\n  topk_select<NT>(keys, a.C, ng, G_PREV, G_TOPK, cnt, "
     "thr, cut, remaining,\n"),
    ("schedule_rows.cu", "  // ordered union of the members\n  int U = 0;\n",
     "  KT_PMARK(11);\n  // ordered union of the members\n  int U = 0;\n"),
    ("schedule_rows.cu",
     "    else U = gather_lanes_std<T>(a, row, s, wsum);\n  }\n",
     "    else U = gather_lanes_std<T>(a, row, s, wsum);\n  }\n"
     "  KT_PMARK(12);\n"),
    ("schedule_rows.cu", "  // the lanes' ranks, densified in rank_eff order\n",
     "  KT_PMARK(13);\n  // the lanes' ranks, densified in rank_eff order\n"),
    ("schedule_rows.cu",
     "  // what the lane math reads and the working set does not keep\n",
     "  KT_PMARK(14);\n"
     "  // what the lane math reads and the working set does not keep\n"),
    ("schedule_rows.cu", "    const i64 need = minll(row.sc_max, fcount);\n",
     "    KT_PMARK(15);\n    const i64 need = minll(row.sc_max, fcount);\n"),
    ("schedule_rows.cu", "    const i64 tot = total_sel();\n",
     "    KT_PMARK(16);\n    const i64 tot = total_sel();\n"),
    ("schedule_rows.cu",
     "  // Aggregated: trim to the capacity-descending prefix reaching "
     "target\n",
     "  KT_PMARK(17);\n"
     "  // Aggregated: trim to the capacity-descending prefix reaching "
     "target\n"),
    ("schedule_rows.cu",
     "    // exclusive cumsum of active w in sorted order, each thread a "
     "chunk\n",
     "    KT_PMARK(18);\n"
     "    // exclusive cumsum of active w in sorted order, each thread a "
     "chunk\n"),
    ("schedule_rows.cu", "  const bool run_webster =\n",
     "  KT_PMARK(19);\n  const bool run_webster =\n"),
    ("schedule_rows.cu",
     "(row.has_sc ? FLAG_HAS_SC : 0) | FLAG_VALID;\n  }\n}\n",
     "(row.has_sc ? FLAG_HAS_SC : 0) | FLAG_VALID;\n  }\n  KT_PMARK(20);\n}\n"),
)
#: the phases of a K2-big design's prepare kernel, (name, from slot, to
#: slot): "old" for a source without KT_MARK points (K2BIG_OLD_MARKS),
#: "marks" for one with them; a phase is read on the rows that passed
#: both slots
K2BIG_PHASES = {
    "old": (
        ("key write", 0, 1),
        *((f"topk pass {i}", 2 + i, 3 + i) for i in range(8)),
        ("fill", 10, 11), ("union", 11, 12), ("lane_info loop", 12, 13),
        ("rank argsort", 13, 14), ("selection argsort (has_sc)", 14, 15),
        ("swap loop (has_sc)", 15, 16), ("aggregated argsort", 17, 18),
        ("aggregated prefix", 18, 19), ("web / wk writes", 19, 20),
        ("a row", 0, 20)),
    # the std tier's select on both tiers (KT_MARK points in the source)
    "marks": (
        ("select pass 1", 0, 1), ("histogram passes", 1, 2),
        ("collect", 2, 3), ("fill", 3, 4), ("union", 4, 5),
        ("lane_info loop", 5, 6), ("rank argsort", 6, 7),
        ("selection argsort (has_sc)", 7, 8), ("swap loop (has_sc)", 8, 9),
        ("aggregated argsort", 10, 11), ("aggregated prefix", 11, 12),
        ("web / wk writes", 12, 13), ("a row", 0, 13)),
}


def k2_wave_entries(kmod, tier):
    """The tree's C entries of one K2 wave on `tier`: the wave entry, or
    the prepare and finish entries."""
    pre = "schedule_rows_big" if tier == "big" else "schedule_rows"
    names = [e for e in (f"{pre}_wave", f"{pre}_prepare", f"{pre}_finish")
             if e in kmod.ENTRIES["schedule_rows"]]
    return names


def profile_k2big(kmod, call, out_dir, name, tier="big"):
    """clock64 profile of one K2 wave's prepare kernel on `tier` (default
    the big one; `call` runs the wave through the tree's wrapper and
    returns its outputs): the
    tree's schedule_rows.cu with its design's marks -- compiled in with
    -DKT_PROFILE where the source holds KT_MARK points, else
    K2BIG_OLD_MARKS substituted into a copy of its sources -- launched
    with kmod's entries swapped and held against the unmarked kernel.
    Returns (phases, [rows, slots] clock64 readings of the rows that
    passed slot 0)."""
    import shutil

    csrc = str(kmod.CSRC)
    text = open(os.path.join(csrc, "schedule_rows.cu")).read()
    phases = K2BIG_PHASES["marks" if "KT_MARK(" in text else "old"]
    inc = os.path.join(out_dir, f"{name}_csrc")
    shutil.copytree(csrc, inc)
    if "KT_MARK(" in text:
        lib = build_variant(kmod, os.path.join(inc, "schedule_rows.cu"), [],
                            name, out_dir, inc=inc,
                            flags=(f"-DKT_PROFILE={K2BIG_PROF_ROWS}",))
    else:
        for i, (f, old, new) in enumerate(K2BIG_OLD_MARKS):
            if i == 0:
                new = new % (K2BIG_PROF_ROWS, K2BIG_SLOTS, K2BIG_PROF_ROWS,
                             K2BIG_SLOTS)
            path = os.path.join(inc, f)
            src = open(path).read()
            if src.count(old) != 1:
                raise AssertionError(f"{name}: {old!r} is not in {f} once")
            with open(path, "w") as fh:
                fh.write(src.replace(old, new))
        lib = build_variant(kmod, os.path.join(inc, "schedule_rows.cu"), [],
                            name, out_dir, inc=inc)
    want = tuple(t.clone() for t in call())
    torch.cuda.synchronize()
    names = k2_wave_entries(kmod, tier)
    saved = {e: kmod._FNS[e] for e in names}
    try:
        for e in names:
            kmod._FNS[e] = entry(lib, "kt_" + e)
        got = call()
        torch.cuda.synchronize()
    finally:
        kmod._FNS.update(saved)
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"{name}: the profiled kernel disagrees")
    m = re.search(r"#define KT_PROF_SLOTS (\d+)", text)
    slots = int(m.group(1)) if "KT_MARK(" in text and m else K2BIG_SLOTS
    h = np.zeros(K2BIG_PROF_ROWS * slots, np.int64)
    fn = lib.kt_prof_read
    fn.argtypes = [ctypes.c_void_p]
    if fn(ctypes.c_void_p(h.ctypes.data)):
        raise RuntimeError("reading the K2-big profile failed")
    h = h.reshape(K2BIG_PROF_ROWS, slots)
    return phases, h[h[:, 0] != 0]


#: K2-big thread counts a row tried beside the tree's own (variants of
#: its schedule_rows.cu, for a source whose tiers take NT)
K2BIG_NT = (256, 512, 1024)
K2BIG_TIER = "using TierBig = Tier<128, 1024, 4224, false, %d, 1, 1 << 18>;"


def probe_k2big(CS, wide, fleet, dev, trees):
    """K2-big per tree on the first wide chunk's big rows (chip_smoke's
    big_subbatch, 64 x 8,192), wave 0 with K4 inside on wave 0's est
    (chip_smoke.big_wave0): CUDA-event ms, host enqueue, device time by kernel, each
    launch's CUDA events, and the clock64 profile of the prepare kernel in
    cycles a row; for a tree whose tiers take NT, the same wave with the
    big tier at K2BIG_NT threads a row (variant builds).  The trees' and
    variants' waves must agree."""
    sub, _n = CS.big_subbatch(wide, fleet)
    outs = []
    with tempfile.TemporaryDirectory() as tmp:
        for label, kmod, smod in trees:
            for ln in kmod.BUILD_LOG.get("schedule_rows", "").splitlines():
                if "registers" in ln or "spill" in ln or "Compiling" in ln:
                    print(f"K2 ptxas ({label}): {ln.strip()}", flush=True)
            S = smod.S
            wave, res = CS.big_wave0(S, sub, dev)
            Bw = res[2].shape[0] // S._effective_waves(res[2].shape[0], 8)
            C = res[0].shape[1]

            def call(wave=wave, res=res):
                wave()
                return res[:3]

            call()
            torch.cuda.synchronize()
            outs.append(tuple(t.clone() for t in call()))
            ms = CS.cuda_ms(call, 50)
            host, _d = CS.split_ms(call, 50)
            by = CS.kernel_device_ms(call, 50)
            print(f"K2-big {label}, wave 0 ({Bw} x {C}, K4 inside, est "
                  f"fixed): {ms:.4f} ms; host enqueue {host:.4f} ms; "
                  + _dev_line(by), flush=True)
            phases, h = profile_k2big(kmod, call, tmp,
                                      f"k2big_{label.split()[-1]}")
            parts = []
            for p, a, b in phases:
                m = (h[:, a] != 0) & (h[:, b] != 0)
                if m.any():
                    d = h[m, b] - h[m, a]
                    parts.append(f"{p} {d.mean():.0f} / {d.max()} "
                                 f"({int(m.sum())} rows)")
            print(f"K2-big {label}, prepare clock64 cycles a row (mean / "
                  f"max): " + "; ".join(parts), flush=True)
            src = os.path.join(str(kmod.CSRC), "schedule_rows.cu")
            text = open(src).read()
            own = next((nt for nt in (256, 512, 1024)
                        if K2BIG_TIER % nt in text), None)
            if own is None or "schedule_rows_big_wave" not in kmod._FNS:
                continue
            for nt in K2BIG_NT:
                if nt == own:
                    continue
                lib = build_variant(kmod, src, [(K2BIG_TIER % own,
                                                 K2BIG_TIER % nt)],
                                    f"k2big_nt{nt}_{label.split()[-1]}",
                                    tmp, show="Li4224E")
                saved = kmod._FNS["schedule_rows_big_wave"]
                try:
                    kmod._FNS["schedule_rows_big_wave"] = entry(
                        lib, "kt_schedule_rows_big_wave")
                    got = tuple(t.clone() for t in call())
                    torch.cuda.synchronize()
                    if not all(torch.equal(a, b)
                               for a, b in zip(got, outs[-1])):
                        raise AssertionError(f"K2-big NT {nt} disagrees")
                    ms = CS.cuda_ms(call, 50)
                    by = CS.kernel_device_ms(call, 50)
                finally:
                    kmod._FNS["schedule_rows_big_wave"] = saved
                print(f"K2-big {label}, NT {nt} a row (variant): {ms:.4f} "
                      "ms; " + _dev_line(by), flush=True)
    if not all(all(torch.equal(a, b) for a, b in zip(outs[0], x))
               for x in outs[1:]):
        raise AssertionError("K2-big probe: the trees' waves disagree")


def probe_k2launch(CS, batch, dev, trees, reps=200):
    """Where a K2 std wave's host enqueue goes, per tree, on wave 0 of the
    forward chunk (512 x 8,192, its K1 in the wave): the whole call's
    host clock as schedule_core makes it (with the chunk's workspace where
    the tree has one) and as a caller without one makes it, then the
    pieces -- the parent's: the operand checks, the allocations, the two
    RowsArgs structs, K4's wrapper and the two launches; this tree's: the
    argument block's patch and the one C call -- each timed alone; then
    the chunk's dispatch_compact in pieces (device_batch with its uploads,
    _use_extra, schedule_core's 8 waves, compact, and the whole), each
    on a drained stream."""
    import time

    def host_ms(fn, n=reps):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        ms = (time.perf_counter() - t0) / n * 1e3
        torch.cuda.synchronize()
        return ms

    for label, kmod, smod in trees:
        S = smod.S
        db = S.device_batch(batch, dev)
        B, C = db.B, db.C
        Bw = B // S._effective_waves(B, 8)
        use_extra = S._use_extra(batch)
        used = tuple(u.clone() for u in S._zeros_used(db))
        out = (torch.zeros((B, C), dtype=torch.int64, device=dev),
               torch.zeros((B, C), dtype=torch.bool, device=dev),
               torch.zeros((B,), dtype=torch.int32, device=dev))
        Q, R = db.req_milli.shape
        est = torch.empty((Q + 1, C), dtype=torch.int64, device=dev)
        kw = dict(use_extra=use_extra, charge=True, fill_est=True)
        parts = {"whole call": host_ms(lambda: S.schedule_rows(
            db, 0, Bw, est, *used, *out, **kw))}
        if hasattr(S, "RowsWorkspace"):
            ws = S.RowsWorkspace(db, Bw, est, *used, *out, tier="std",
                                 use_extra=use_extra, charge=True)
            parts["whole call, the chunk's workspace"] = host_ms(
                lambda: S.schedule_rows(db, 0, Bw, est, *used, *out,
                                        workspace=ws, **kw))
            parts["patch + C call"] = host_ms(lambda: ws.launch(0, Bw, True))
        else:
            t = db.t
            P, G = db.pl_mask.shape[0], db.api_ok.shape[0]
            Kp, Ke = db.prev_idx.shape[1], db.evict_idx.shape[1]
            I64, b8, i32 = torch.int64, torch.bool, torch.int32
            spec = {
                "cluster_valid": (b8, (C,)), "deleting": (b8, (C,)),
                "name_rank": (I64, (C,)), "api_ok": (b8, (G, C)),
                "req_milli": (I64, (Q, R)), "req_is_cpu": (b8, (R,)),
                "req_pods": (I64, (Q,)), "pl_mask": (b8, (P, C)),
                "pl_tol_bypass": (b8, (P, C)), "pl_strategy": (i32, (P,)),
                "pl_static_w": (I64, (P, C)),
                "pl_has_cluster_sc": (b8, (P,)), "pl_sc_min": (i32, (P,)),
                "pl_sc_max": (i32, (P,)), "pl_ignore_avail": (b8, (P,)),
                "pl_extra_score": (I64, (P, C)), "b_valid": (b8, (B,)),
                "placement_id": (i32, (B,)), "gvk_id": (i32, (B,)),
                "class_id": (i32, (B,)), "replicas": (I64, (B,)),
                "uid_desc": (b8, (B,)), "fresh": (b8, (B,)),
                "non_workload": (b8, (B,)), "nw_shortcut": (b8, (B,)),
                "prev_idx": (i32, (B, Kp)), "prev_val": (i32, (B, Kp)),
                "evict_idx": (i32, (B, Ke))}

            def checks():
                for f, (dt, shape) in spec.items():
                    kmod.check(t[f], dt, shape)
                kmod.check(est, I64, (Q + 1, C))
                kmod.check(used[0], I64, (C, R))
                kmod.check(used[1], I64, (C,))
                kmod.check(used[2], I64, (Q, C))
                kmod.check(out[0], I64, (B, C))
                kmod.check(out[1], b8, (B, C))
                kmod.check(out[2], i32, (B,))

            L = kmod.LMAX["std"]

            def allocs():
                bufs = [torch.empty((0,), dtype=I64, device=dev),
                        torch.empty((0,), dtype=torch.uint8, device=dev)]
                for shape, dt in (((Bw,), I64), ((Bw, L), I64),
                                  ((Bw, L), b8), ((Bw, L), I64),
                                  ((Bw, L), i32), ((Bw, L), I64),
                                  ((Bw, L), I64), ((Bw, L), b8),
                                  ((Bw, L), b8), ((Bw,), i32),
                                  ((Bw,), i32)):
                    bufs.append(torch.empty(shape, dtype=dt, device=dev))
                bufs.append(torch.zeros((Bw, L), dtype=I64, device=dev))
                return bufs

            bufs = allocs()
            # seats: any [Bw, L] int64 buffer (the timed launches' results
            # are not read)
            work = dict(zip(("scratch", "work") + kmod.ROWS_WORK_FIELDS,
                            bufs[:6] + [bufs[5]] + bufs[6:13]))

            def struct():
                return kmod.RowsArgs(
                    *(kmod.ptr(t[f]) for f in kmod.ROWS_TENSOR_FIELDS),
                    kmod.ptr(est), *(kmod.ptr(u) for u in used),
                    *(kmod.ptr(o) for o in out), kmod.ptr(work["scratch"]),
                    kmod.ptr(work["work"]),
                    *(kmod.ptr(work[f]) for f in kmod.ROWS_WORK_FIELDS),
                    0, Bw, C, Q, R, Kp, Ke, int(use_extra), 1, 0)

            cap = {}
            S.schedule_rows(db, 0, Bw, est, *used, *out, capture=cap, **kw)
            web = cap["webster"]
            a = struct()

            def launches():
                kmod.launch("schedule_rows", a, "schedule_rows_prepare")
                kmod.launch("schedule_rows", a, "schedule_rows_finish")

            parts.update({"operand checks": host_ms(checks),
                          "allocations": host_ms(allocs),
                          "two RowsArgs structs": host_ms(
                              lambda: (struct(), struct())),
                          "K4's wrapper": host_ms(
                              lambda: S.webster_batch(*web)),
                          "two launches": host_ms(launches)})
        print(f"K2 std launch path {label}, wave 0 ({Bw} x {C}), host ms a "
              "wave: " + "; ".join(f"{k} {v:.4f}" for k, v in parts.items()),
              flush=True)

        # the chunk's dispatch_compact piece by piece: host ms of each
        # piece alone, the stream drained before it (so no piece waits for
        # another's kernels)
        def drained(fn, n=20):
            total = 0.0
            for _ in range(n + 1):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn()
                dt = time.perf_counter() - t0
                total += dt if _ else 0.0
            torch.cuda.synchronize()
            return total / n * 1e3, out

        dbw = [None]

        def upload():
            dbw[0] = S.device_batch(batch, dev)

        pieces = {"device_batch (uploads)": drained(upload)[0],
                  "_use_extra": drained(lambda: S._use_extra(batch))[0]}
        res = [None]

        def core():
            res[0] = S.schedule_core(dbw[0], waves=8, use_extra=use_extra,
                                     with_used=True)

        pieces["schedule_core (8 waves)"] = drained(core)[0]
        rep_, sel_, st_ = res[0][:3]
        pieces["compact"] = drained(lambda: S.compact(
            rep_, sel_, st_, dbw[0].non_workload, False))[0]
        pieces["whole dispatch_compact"] = drained(lambda: S.dispatch_compact(
            batch, waves=8, with_used=True, device=dev))[0]
        print(f"dispatch_compact pieces {label}, the forward chunk ({B} x "
              f"{C}), host ms (stream drained before each): " + "; ".join(
                  f"{k} {v:.4f}" for k, v in pieces.items()), flush=True)


def probe_k2census(CS, M, fleet, placements, dev):
    """What the main path hands K2-big: every big-tier launch of
    chip_smoke's phase 6 (the wide cycle: ROUTE_DEVICE_BIG and the
    SPREAD_BIG assignments) and phase 7 (the explain cycle), by phase
    (chip_smoke.big_census: rows a launch, C, each gather group's eligible
    lanes against its k, the select's histogram passes, U, strategy and
    has_sc)."""
    from karmada_tpu_torch.obs.decisions import DecisionRecorder
    from karmada_tpu_torch.ops import solver as S
    from karmada_tpu_torch.scheduler.core import schedule_items

    calls = []
    orig = S.schedule_rows

    def hooked(db, r0, r1, est, *a, tier="std", use_extra=False, **kw):
        orig(db, r0, r1, est, *a, tier=tier, use_extra=use_extra, **kw)
        if tier == "big" and r1 > r0:
            calls.append(CS.big_census(S, db, r0, r1, est, use_extra))

    S.schedule_rows = hooked
    try:
        wide = CS.build_wide_items(M, random.Random(1), CS.WIDE_BINDINGS,
                                   placements, [c.name for c in fleet])
        schedule_items(wide, fleet, chunk=4096, waves=8, device=dev)
        for ln in CS.big_census_lines("phase 6 (the wide cycle)", calls):
            print(ln, flush=True)
        calls.clear()
        expl = CS.starve_items(M, wide[:CS.EXPLAIN_BINDINGS])
        schedule_items(expl, fleet, chunk=CS.EXPLAIN_CHUNK, waves=8,
                       device=dev, explain=DecisionRecorder())
        for ln in CS.big_census_lines("phase 7 (the explain cycle)", calls):
            print(ln, flush=True)
    finally:
        S.schedule_rows = orig


# -- K12 dirty_codes and K13 rebalance_score ------------------------------------

def wall_ms(fn, n=50):
    """Host-clock ms a call of `fn`, each call ended by synchronize(),
    over `n` calls after one warm-up."""
    import time

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def _by_text(by):
    """chip_smoke.by_text: a kernel_device_ms reading, the events by C
    entry and the profiler's by kernel beside them."""
    return sys.modules["chip_smoke"].by_text(by)


def profile_marks(kmod, source, subs, entry_name, call, out_dir, name,
                  phases, blocks=8, slots=8):
    """clock64 profile of one launch of `entry_name` (`call` runs it
    through the tree's wrapper and returns its outputs): the tree's
    `source` built with -DKT_PROFILE=`blocks`, `subs` (marks) substituted
    into a copy where it has no KT_MARK points, launched with kmod's
    entry swapped and held against the unmarked kernel.  Returns
    {phase: cycles a block array} for the blocks that ran."""
    csrc = str(kmod.CSRC)
    src = os.path.join(csrc, source)
    text = open(src).read()
    lib = build_variant(kmod, src, [] if "KT_MARK(" in text else subs, name,
                        out_dir, inc=csrc,
                        flags=(f"-DKT_PROFILE={blocks}",))
    want = [t.clone() for t in call()]
    torch.cuda.synchronize()
    saved = kmod._FNS[entry_name]
    try:
        kmod._FNS[entry_name] = entry(lib, "kt_" + entry_name)
        got = call()
        torch.cuda.synchronize()
    finally:
        kmod._FNS[entry_name] = saved
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"{name}: the profiled kernel disagrees")
    h = np.zeros(blocks * slots, np.int64)
    fn = lib.kt_prof_read
    fn.argtypes = [ctypes.c_void_p]
    if fn(ctypes.c_void_p(h.ctypes.data)):
        raise RuntimeError(f"reading the {name} profile failed")
    h = h.reshape(blocks, slots)
    h = h[h[:, 0] != 0]
    return {p: h[:, b] - h[:, a] for p, a, b in phases}


#: K12's phases in a block: its slots, then its rv hits (KT_MARK points
#: of a dirty.cu that has them)
K12_PHASES = (("slots", 0, 1), ("rv hits", 1, 2), ("a block", 0, 2))


def k12_operands(DM, state, mirrors, rv, flips):
    """K12's device operands as chip_smoke phase 2 builds them: the slot
    mirrors, the plane's cluster-side fields uploaded, the -1 padded flip
    lanes and rv slots."""
    p = state.plane
    dev = state.device

    def up(a):
        return torch.from_numpy(np.array(a, order="C")).to(dev)

    return ([mirrors[f] for f in DM.SLOT_FIELDS]
            + [up(getattr(p, f)) for f in DM.PLANE_FIELDS]
            + [up(DM._pad_lanes(flips)), up(DM._pad_lanes(rv))])


def k12_pieces(DM, SM, state, mirrors, rv, n=50):
    """Where one dirty_codes call goes, piece by piece, each timed alone
    (host ms a call, each ended by synchronize()): for a tree whose
    dirty_codes uploads the cluster-side fields (no workspace): those
    uploads (the frozen masters copied first), the rv / flip uploads, the
    scratch allocations with the memset, the launch and the D2H; for a
    tree with a workspace: the mirror sync, the rv normalisation, the one
    C call (staging, kernel, D2H into pinned memory, sync) and the copy
    out."""
    p = state.plane
    dev = state.device
    cap, P = p.placement_id.shape[0], p.pl_mask.shape[0]
    out = {}
    if not hasattr(DM, "normalise_rv"):
        def up(a):
            return SM._to_dev(a, dev)

        out["cluster-side uploads"] = wall_ms(
            lambda: [up(getattr(p, f)) for f in DM.PLANE_FIELDS], n)
        out["of which pl_mask"] = wall_ms(lambda: up(p.pl_mask), n)
        out["rv / flip uploads"] = wall_ms(
            lambda: (up(DM._pad_lanes(state.last_flip_lanes)),
                     up(DM._pad_lanes(rv))), n)
        out["scratch allocations + memset"] = wall_ms(
            lambda: (torch.empty((P,), dtype=torch.uint8, device=dev),
                     torch.zeros((cap,), dtype=torch.uint8, device=dev),
                     torch.empty((cap,), dtype=torch.uint8, device=dev)), n)
        ins = k12_operands(DM, state, mirrors, rv, state.last_flip_lanes)
        codes = DM.dirty_kernel(*ins)
        out["launch (host enqueue)"] = host_ms(
            lambda: DM.dirty_kernel(*ins), 200)
        out["D2H (.cpu().numpy())"] = wall_ms(lambda: codes.cpu().numpy(), n)
    else:
        out["mirror sync (in sync)"] = wall_ms(state.sync_device, n)
        out["rv normalisation"] = host_ms(
            lambda: DM.normalise_rv(rv), 200)
        dm = state.device_mirrors.mirrors
        ops = ([mirrors[f] for f in DM.SLOT_FIELDS]
               + [dm[f] for f in DM.PLANE_FIELDS[:-1]])
        ws = DM._workspace(dev)
        out["operand bind (the set's check, hit)"] = host_ms(
            lambda: ws.bind(ops), 200)
        # the block as dirty_codes fills it, on inputs kept alive here
        flips = np.ascontiguousarray(state.last_flip_lanes, np.int64)
        rvn = DM.normalise_rv(rv)
        reg = np.ascontiguousarray(p.pl_has_region_sc, np.bool_)
        ws.bind(ops)
        ws.stage(8 * (flips.size + rvn.size) + reg.size)
        ws.codes(cap)
        blk = ws.blk
        blk[DM._REG], blk[DM._FLIPS], blk[DM._RV] = (
            reg.ctypes.data, flips.ctypes.data, rvn.ctypes.data)
        blk[DM._OUT], blk[DM._HOST] = ws.out.data_ptr(), ws.host.data_ptr()
        blk[DM._F], blk[DM._S], blk[DM._STAGED] = flips.size, rvn.size, 1
        out["the C call (stage, upload, kernel, D2H, sync)"] = wall_ms(
            lambda: DM._launch(ws), n)
        out["copy out"] = host_ms(lambda: ws.host_np[:cap].copy(), 200)
    out["whole dirty_codes"] = wall_ms(
        lambda: DM.dirty_codes(state, rv, mirrors=mirrors), n)
    return out


def probe_k12(CS, M, dev, trees):
    """K12 at phase 9's shapes: chip_smoke's phase 9 (adopt, settle,
    catch-up, four steady cycles, flap, audit; its lines carry the
    "dirty" stage's split), then on its plane (cap 2^20, P x C as
    phase 2 logs them), with 8 real flip lanes and 1,000 real rv slots
    (slot 0 among them), per tree: dirty_codes whole and in pieces, the
    whole call's device time by activity, and the kernel alone on device
    operands -- CUDA-event ms, host enqueue against device time, device
    time by kernel (the parent's prep and main launches apart) and, for a
    source with KT_MARK points, a clock64 profile of a block; then this
    tree's block shapes (k12_shapes).  The trees must agree with the plain
    pass."""
    mfleet, mpl = CS.build_megafleet(M, random.Random(2), CS.MEGA_CLUSTERS,
                                     CS.MEGA_REGIONS)
    _l, state, solver, _r = CS.phase_incremental(
        M, mfleet, mpl, CS.INCREMENTAL_BINDINGS, 4096, dev, 5)
    del _r
    p = state.plane
    cap, nC = p.placement_id.shape[0], state.nC
    g = np.random.default_rng(0)
    state.last_flip_lanes = np.sort(g.choice(nC, 8, replace=False))
    rv = np.concatenate([[0], g.choice(np.arange(1, cap), 999,
                                       replace=False)]).astype(np.int64)
    mirrors = state.device_rows.mirrors
    print(f"K12 operands: cap {cap}, P x C {tuple(p.pl_mask.shape)}, Kp "
          f"{p.prev_idx.shape[1]}, Ke {p.evict_idx.shape[1]}, 8 flip "
          "lanes, 1,000 rv slots", flush=True)
    res = []
    with tempfile.TemporaryDirectory() as tmp:
        for label, kmod, smod in trees:
            DM = smod.DM
            ins = k12_operands(DM, state, mirrors, rv, state.last_flip_lanes)
            want = DM.dirty_kernel_plain(*ins)
            got = DM.dirty_codes(state, rv, mirrors=mirrors)
            if not np.array_equal(got, want.cpu().numpy()):
                raise AssertionError(f"K12 {label}: dirty_codes disagrees "
                                     "with the plain pass")
            res.append(got)
            parts = k12_pieces(DM, smod.S, state, mirrors, rv)
            print(f"K12 {label}, dirty_codes pieces, ms a call: " + "; ".join(
                f"{k} {v:.4f}" for k, v in parts.items()), flush=True)
            call = lambda DM=DM: DM.dirty_codes(state, rv, mirrors=mirrors)
            print(f"K12 {label}, dirty_codes device by activity: "
                  + _by_text(CS.kernel_device_ms(call, 50)), flush=True)

            def kern(DM=DM, ins=ins):
                return (DM.dirty_kernel(*ins),)
            if not torch.equal(kern()[0], want):
                raise AssertionError(f"K12 {label}, the kernel: disagrees")
            ms = CS.cuda_ms(kern, 200)
            host, device = CS.split_ms(kern, 200, whole=True)
            print(f"K12 {label}, kernel on device operands, the padded rv "
                  f"list: {ms:.4f} ms; host enqueue {host:.4f} ms, device "
                  f"(the whole call, the wrapper's sort included) {device} "
                  "ms; by kernel: "
                  f"{_by_text(CS.kernel_device_ms(kern, 200))}", flush=True)
            text = open(os.path.join(str(kmod.CSRC), "dirty.cu")).read()
            if "KT_MARK(" in text:
                d = profile_marks(kmod, "dirty.cu", (), "dirty_codes", kern,
                                  tmp, f"dirty_{label.split()[-1]}",
                                  K12_PHASES, blocks=512)
                print(f"K12 {label}, clock64 cycles a block (mean / max "
                      f"over {len(d['a block'])} blocks): " + "; ".join(
                          f"{ph} {d[ph].mean():.0f} / {d[ph].max()}"
                          for ph, _a, _b in K12_PHASES), flush=True)
    if not all(np.array_equal(res[0], r) for r in res[1:]):
        raise AssertionError("K12 probe: the trees disagree")
    _l, kmod, smod = trees[0]
    k12_shapes(CS, dev, kmod, smod.DM, trees)


#: K12 block shapes (threads a block, the blocks an SM must hold: the
#: register budget) the k12 part builds as variants of dirty.cu
K12_SHAPES = ((256, 8), (256, 6), (256, 4), (128, 16), (512, 4))


def k12_synthetic(dev):
    """A slot store shaped like phase 9's (cap 2^20, 10,000 clusters in
    C = 16,384 lanes, 200 DynamicWeight placements of 50 clusters each,
    4,096 consecutive slots a placement, 1-3 prev lanes a row in its
    placement, 1% of rows with an evicted lane, 98% steady), 8 flip lanes
    and 1,000 rv slots ascending: K12's device operands (the rv list
    last)."""
    rng = np.random.default_rng(12)
    cap, P, C, nC, Kp, Ke = 1 << 20, 256, 16384, 10000, 4, 4
    pid = ((np.arange(cap) // 4096) % 200).astype(np.int32)
    members = np.arange(nC).reshape(50, 200).T  # region r: r, r + 200, ..
    pl_mask = np.zeros((P, C), bool)
    for r in range(200):
        pl_mask[r, members[r]] = True
    prev = members[pid[:, None], rng.integers(0, 50, (cap, Kp))]
    used = np.arange(Kp)[None, :] < rng.integers(1, 4, cap)[:, None]
    prev = np.where(used, prev, -1).astype(np.int32)
    val = np.where(used, rng.integers(1, 3, (cap, Kp)), 0).astype(np.int32)
    evict = np.full((cap, Ke), -1, np.int32)
    ev = rng.random(cap) < 0.01
    evict[ev, 0] = prev[ev, 0]
    rep = val.sum(1).astype(np.int64)
    rep[rng.random(cap) < 0.02] += 1
    route = np.where(rng.random(cap) < 0.01, 6, 0).astype(np.int32)
    store = dict(placement_id=pid, replicas=rep, fresh=np.zeros(cap, bool),
                 non_workload=np.zeros(cap, bool), route=route,
                 prev_idx=prev, prev_val=val, evict_idx=evict,
                 cluster_valid=np.arange(C) < nC, deleting=np.zeros(C, bool),
                 pl_mask=pl_mask,
                 pl_strategy=np.full(P, 2, np.int32),
                 pl_has_cluster_sc=np.zeros(P, bool),
                 pl_has_region_sc=np.zeros(P, bool))
    flips = np.sort(rng.choice(nC, 8, replace=False)).astype(np.int64)
    rv = np.sort(rng.choice(cap, 1000, replace=False)).astype(np.int64)
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in store.values()] + [torch.from_numpy(flips).to(dev),
                                        torch.from_numpy(rv).to(dev)]


def k12_shapes(CS, dev, kmod, DM, trees):
    """K12 (this tree) on a phase-9-shaped synthetic store
    (k12_synthetic), its dirty.cu built at each of K12_SHAPES (its NT and
    MIN_BLOCKS substituted): ptxas' registers and spills, CUDA-event ms
    of back-to-back launches and the profiler's device ms, each held
    against the plain pass; the other trees' K12 on the same operands
    beside them."""
    ins = k12_synthetic(dev)
    want = DM.dirty_kernel_plain(*ins)
    for label, _k, smod in trees[1:]:
        def old(smod=smod):
            return (smod.DM.dirty_kernel(*ins),)
        if not torch.equal(old()[0], want):
            raise AssertionError(f"K12 shapes, {label}: disagrees")
        print(f"K12 shapes, {label}: {CS.cuda_ms(old, 200):.4f} ms back to "
              f"back; device {_by_text(CS.kernel_device_ms(old, 200))}",
              flush=True)
    csrc = str(kmod.CSRC)
    src = os.path.join(csrc, "dirty.cu")
    saved = kmod._FNS["dirty_codes"]

    def kern():
        return (DM.dirty_kernel(*ins),)

    print(f"K12 shapes: the synthetic store's codes "
          f"{torch.bincount(want.long(), minlength=8).tolist()} "
          "(count by code)", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        for nt, minb in K12_SHAPES:
            name = f"dirty_{nt}_{minb}"
            lib = build_variant(
                kmod, src, [("constexpr int NT = 256;",
                             f"constexpr int NT = {nt};"),
                            ("constexpr int MIN_BLOCKS = 8;",
                             f"constexpr int MIN_BLOCKS = {minb};")],
                name, tmp, inc=csrc, show="dirty_kernel")
            try:
                kmod._FNS["dirty_codes"] = entry(lib, "kt_dirty_codes")
                if not torch.equal(kern()[0], want):
                    raise AssertionError(f"{name}: disagrees")
                ms = CS.cuda_ms(kern, 200)
                by = CS.kernel_device_ms(kern, 200)
            finally:
                kmod._FNS["dirty_codes"] = saved
            print(f"K12 shape NT={nt} min blocks/SM={minb}: {ms:.4f} "
                  f"ms back to back; device {_by_text(by)}", flush=True)


#: clock64 marks substituted into a copy of a rebalance.cu without KT_MARK
#: points (its first design: one block, pass 1, two block_sums, pass 2)
K13_OLD_MARKS = (
    ("  __shared__ i64 red[33];\n",
     "  __shared__ i64 red[33];\n  KT_MARK(0);\n"),
    ("  // every thread gets both totals back (block_sum syncs around red)\n",
     "  KT_MARK(1);\n"),
    ("  const i64 thr = a.threshold_milli, tol = a.spread_tol_milli;\n",
     "  KT_MARK(2);\n"
     "  const i64 thr = a.threshold_milli, tol = a.spread_tol_milli;\n"),
    ("    a.div_milli[i] = div;\n  }\n}\n",
     "    a.div_milli[i] = div;\n  }\n  KT_MARK(3);\n}\n"),
)
K13_PHASES = (("pass 1", 0, 1), ("reductions", 1, 2), ("pass 2", 2, 3),
              ("a block", 0, 3))


def k13_pieces(RD, com, cap, valid, dev, n=200):
    """Where one score call goes, piece by piece (host ms a call, each
    ended by synchronize()): for a tree without a workspace the three
    uploads, the launch's host enqueue and the three downloads; for a
    tree with one the C call's pieces."""
    out = {}
    if hasattr(RD, "score_layout"):
        C = len(com)
        a = [np.ascontiguousarray(x, dt) for x, dt in (
            (com, np.int64), (cap, np.int64), (valid, np.bool_))]
        out["numpy operands"] = host_ms(lambda: [np.ascontiguousarray(
            x, dt) for x, dt in ((com, np.int64), (cap, np.int64),
                                 (valid, np.bool_))], n)
        ws = RD._workspace(dev)
        o_out = ws.stage(C)
        blk = ws.blk
        blk[RD._COM], blk[RD._CAP], blk[RD._VALID] = (x.ctypes.data
                                                      for x in a)
        for timed in (0, 1):
            blk[RD._STAGED], blk[RD._TIMED] = 1, timed
            out["the C call (stage, upload, kernel, D2H, sync)"
                + (", timed" if timed else "")] = wall_ms(
                lambda: RD._launch(ws, C, 1000, 50), n)
        out["copy out"] = host_ms(
            lambda: ws.pin_np[o_out:o_out + 24 * C].view(np.int64).copy(), n)
        return out
    ups = []
    for name, a, dt in (("committed", com, np.int64),
                        ("capacity", cap, np.int64), ("valid", valid, bool)):
        out[f"upload {name}"] = wall_ms(lambda a=a, dt=dt: torch.from_numpy(
            np.ascontiguousarray(a, dt)).to(dev), n)
        ups.append(torch.from_numpy(np.ascontiguousarray(a, dt)).to(dev))
    out["launch (host enqueue)"] = host_ms(
        lambda: RD.score_kernel(*ups, 1000, 50), n)
    outs = RD.score_kernel(*ups, 1000, 50)
    for name, o in zip(("drain_need", "over_milli", "div_milli"), outs):
        out[f"download {name}"] = wall_ms(lambda o=o: o.cpu().numpy(), n)
    return out


def probe_k13(CS, dev, trees):
    """K13 per tree at C = 5,000 (config 5's fleet), 10,000 (the
    megafleet's) and 16,384: score from numpy whole (with and without
    its timing dict) and in pieces, the whole call's device time by
    activity, the kernel on device operands (CUDA-event ms, host enqueue
    against device time), and a clock64 profile of its phases.  The trees
    and the plain version must agree."""
    with tempfile.TemporaryDirectory() as tmp:
        for C in (5000, 10000, 16384):
            g = np.random.default_rng(C)
            com = g.integers(0, 1 << 16, C)
            cap = g.integers(0, 1 << 12, C)
            cap[g.random(C) < 0.02] = 0
            valid = g.random(C) >= 0.03
            ins = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                   for a in (com, cap, valid)]
            res = []
            for label, kmod, smod in trees:
                RD = smod.RD
                got = RD.score(com, cap, valid, 1000, 50, device=dev)
                want = RD.score_kernel_plain(*(t.cpu() for t in ins), 1000,
                                             50)
                if not all(np.array_equal(a, b.numpy())
                           for a, b in zip(got, want)):
                    raise AssertionError(f"K13 {label} C={C}: disagrees")
                res.append(got)
                tm = {}
                whole = wall_ms(lambda RD=RD: RD.score(
                    com, cap, valid, 1000, 50, device=dev), 200)
                timed = wall_ms(lambda RD=RD: RD.score(
                    com, cap, valid, 1000, 50, device=dev, timing=tm), 200)
                parts = k13_pieces(RD, com, cap, valid, dev)
                by = CS.kernel_device_ms(lambda RD=RD: RD.score(
                    com, cap, valid, 1000, 50, device=dev), 200)
                print(f"K13 {label}, C={C}: score {whole:.4f} ms ({timed:.4f}"
                      f" with its timing, kernel_ms {tm.get('kernel_ms')});"
                      " pieces: " + "; ".join(f"{k} {v:.4f}"
                                              for k, v in parts.items())
                      + f"; device by activity: {_by_text(by)}", flush=True)

                def kern(RD=RD):
                    return RD.score_kernel(*ins, 1000, 50)
                ms = CS.cuda_ms(kern, 200)
                host, device = CS.split_ms(kern, 200)
                d = profile_marks(kmod, "rebalance.cu", K13_OLD_MARKS,
                                  "rebalance_score", kern, tmp,
                                  f"rebalance_{C}_{label.split()[-1]}",
                                  K13_PHASES)
                print(f"K13 {label}, C={C} kernel on device operands: "
                      f"{ms:.4f} ms; host enqueue {host:.4f} ms, device "
                      f"{device} ms; clock64 cycles a block (mean / max over "
                      f"{len(d['a block'])} blocks): " + "; ".join(
                          f"{ph} {d[ph].mean():.0f} / {d[ph].max()}"
                          for ph, _a, _b in K13_PHASES), flush=True)
            if not all(all(np.array_equal(a, b) for a, b in zip(res[0], r))
                       for r in res[1:]):
                raise AssertionError(f"K13 probe C={C}: the trees disagree")


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parts", nargs="*",
                    default=["k3k2", "k4", "k11", "k5k6", "k1", "k8",
                             "k2big", "k2launch", "k7", "k13"],
                    help="k3k2, k4, k11, k5k6, k1, k8, k8census, k2big, "
                         "k2launch, k2census, k7, k12, k13 "
                         "(default: all but k8census, k2census and k12)")
    ap.add_argument("--parent", metavar="TREE", default=None,
                    help="a directory holding the parent commit's "
                         "karmada_tpu_torch/ unpacked: k4, k11, k5k6, k1, "
                         "k8, k2big, k2launch, k7, k12 and k13 then probe "
                         "it too")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_probe: no CUDA device", file=sys.stderr)
        return 2
    import types

    import chip_smoke as CS
    from karmada_tpu_torch.estimator.general import GeneralEstimator
    from karmada_tpu_torch.ops import dirty as DM
    from karmada_tpu_torch.ops import kernels
    from karmada_tpu_torch.ops import rebalance_detect as RD
    from karmada_tpu_torch.ops import resident_gather as RG
    from karmada_tpu_torch.ops import shortlist as SL
    from karmada_tpu_torch.ops import solver as S
    from karmada_tpu_torch.ops import spread as SP
    from karmada_tpu_torch.ops import tensors as T

    dev = torch.device("cuda", 0)
    CS.phase_device()
    kernels.build()
    trees = [("this tree", kernels, types.SimpleNamespace(
        webster_batch=S.webster_batch, webster_plain=S.webster_plain,
        RG=RG, SP=SP, S=S, SL=SL, DM=DM, RD=RD))]
    if args.parent:
        par = CS.load_parent(args.parent)
        trees.append(("the parent", par["ops.kernels"], types.SimpleNamespace(
            webster_batch=par["ops.solver"].webster_batch,
            webster_plain=par["ops.solver"].webster_plain,
            RG=par["ops.resident_gather"], SP=par["ops.spread"],
            S=par["ops.solver"], SL=par["ops.shortlist"],
            DM=par["ops.dirty"], RD=par["ops.rebalance_detect"])))
    M = CS.models()
    rng = random.Random(0)
    fleet = CS.build_fleet(M, rng, 5000)
    placements = CS.build_placements(M, rng, [c.name for c in fleet])
    items = CS.build_bindings(M, rng, 4096, placements)
    batch = T.encode_batch(items, T.ClusterIndex.build(fleet),
                           GeneralEstimator())
    if "k3k2" in args.parts:
        probe_k3_k2(CS, batch, dev)
    if "k4" in args.parts:
        names = [c.name for c in fleet]
        wide = CS.build_wide_items(M, random.Random(1), CS.WIDE_BINDINGS,
                                   placements, names)
        probe_k4(CS, batch, wide[:4096], fleet, dev, trees)
    if "k11" in args.parts:
        probe_k11(CS, dev, trees)
    if "k5k6" in args.parts:
        names = [c.name for c in fleet]
        wide = CS.build_wide_items(M, random.Random(1), CS.WIDE_BINDINGS,
                                   placements, names)
        explain = CS.starve_items(M, wide[:CS.EXPLAIN_BINDINGS])
        probe_k5k6(CS, batch, items, wide, explain, fleet, dev, trees)
    if "k1" in args.parts:
        wide = CS.build_wide_items(M, random.Random(1), CS.WIDE_BINDINGS,
                                   placements, [c.name for c in fleet])
        probe_k1(CS, batch, wide[:4096], fleet, dev, trees)
    if "k8" in args.parts:
        probe_k8(CS, M, dev, trees)
    if "k8census" in args.parts:
        probe_k8_census(CS, M, dev)
    if "k2big" in args.parts:
        wide = CS.build_wide_items(M, random.Random(1), CS.WIDE_BINDINGS,
                                   placements, [c.name for c in fleet])
        probe_k2big(CS, wide[:4096], fleet, dev, trees)
    if "k2launch" in args.parts:
        probe_k2launch(CS, batch, dev, trees)
    if "k2census" in args.parts:
        probe_k2census(CS, M, fleet, placements, dev)
    if "k7" in args.parts:
        probe_k7(CS, items, fleet, dev, trees)
    if "k13" in args.parts:
        probe_k13(CS, dev, trees)
    if "k12" in args.parts:
        probe_k12(CS, M, dev, trees)
    return 0


if __name__ == "__main__":
    sys.exit(main())
