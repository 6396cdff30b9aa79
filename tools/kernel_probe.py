#!/usr/bin/env python3
"""Probe of the port's K3 compact and K2 schedule_rows (std tier) on one
CUDA card, at chip_smoke phase 2's shape.

Run from the root of a checkout, on a machine with a card and nvcc:

    python3 tools/kernel_probe.py

It builds the first forward chunk of chip_smoke's workload (bench.py's
config-5 mix, seed 0: 4096 bindings x 8192 lanes), solves it, and
prints, after the card's name and power limit:

  - K3: the wrapper's CUDA-event ms; its yardsticks, torch.nonzero and a
    gather on a mask built outside the timed call (the one chip_smoke
    used before) and with the mask built inside it (the same function);
    and torch.sum over rep, a plain read of it at the card's practical
    rate;
  - K3 shapes: compact.cu rebuilt with other steps per warp and blocks
    per SM (constants substituted into the same source), each held
    against compact_plain and timed, called directly;
  - K2 std: wave 0's stream operations (prepare, K4, finish; CUDA events
    around each launch) and a clock64 profile of the prepare kernel
    (markers substituted into schedule_rows.cu), in cycles per row.

The variant libraries build into a temporary directory.  Exits non-zero
without a card, or when a variant disagrees with its plain version.
"""

from __future__ import annotations

import ctypes
import os
import random
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

#: compact.cu shapes: (steps per warp, blocks an SM)
K3_SHAPES = ((8, 4), (12, 3), (16, 2), (24, 2))
#: K2 std prepare phases between the clock64 markers
K2_PHASES = ("pass 1", "histogram passes", "collect", "fill", "union",
             "lane info + rank sort", "lane math + write")


def build_variant(kernels, src, subs, name, out_dir):
    """compact.cu / schedule_rows.cu with `subs` substituted, built with
    nvcc into out_dir; returns the loaded library."""
    text = open(src).read()
    for old, new in subs:
        if text.count(old) != 1:
            raise AssertionError(f"{name}: {old!r} is not in {src} once")
        text = text.replace(old, new)
    cu = os.path.join(out_dir, f"{name}.cu")
    so = os.path.join(out_dir, f"lib{name}.so")
    with open(cu, "w") as fh:
        fh.write(text)
    out = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-I",
                          str(kernels.CSRC), "-o", so, cu],
                         capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{out.stdout}{out.stderr}")
    regs = [ln.strip() for ln in (out.stdout + out.stderr).splitlines()
            if "registers" in ln]
    print(f"{name}: {regs[-1] if regs else ''}", flush=True)
    return ctypes.CDLL(so)


def entry(lib, name):
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as CS
    from karmada_tpu_torch.estimator.general import GeneralEstimator
    from karmada_tpu_torch.ops import kernels
    from karmada_tpu_torch.ops import solver as S
    from karmada_tpu_torch.ops import tensors as T

    dev = torch.device("cuda", 0)
    CS.phase_device()
    kernels.build()
    M = CS.models()
    rng = random.Random(0)
    fleet = CS.build_fleet(M, rng, 5000)
    placements = CS.build_placements(M, rng, [c.name for c in fleet])
    items = CS.build_bindings(M, rng, 4096, placements)
    batch = T.encode_batch(items, T.ClusterIndex.build(fleet),
                           GeneralEstimator())
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

        split = CS.stage_ms(kernels, wave, 20)
        print("K2 std wave 0: " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in split.items()), flush=True)
        mark = ("if (threadIdx.x == 0) kt_prof[row.slot * 8 + (%d)] = "
                "clock64();\n")
        lib = build_variant(kernels, src2, [
            ('#include "rows.cuh"\n', '#include "rows.cuh"\n'
             "__device__ long long kt_prof[4096 * 8];\n"
             'extern "C" int kt_prof_read(long long* h) { return '
             "(int)cudaMemcpyFromSymbol(h, kt_prof, sizeof(kt_prof)); }\n"),
            ("  load_row<NT>(a, b, row, s.pidx, s.pval, s.eidx);\n",
             "  load_row<NT>(a, b, row, s.pidx, s.pval, s.eidx);\n  "
             + mark % 0),
            ("  if (threadIdx.x < ng) {\n    const int g = threadIdx.x;",
             "  " + mark % 1
             + "  if (threadIdx.x < ng) {\n    const int g = threadIdx.x;"),
            ("  // the collect pass: each", "  " + mark % 2
             + "  // the collect pass: each"),
            ("  // the fill: lax.top_k takes", "  " + mark % 3
             + "  // the fill: lax.top_k takes"),
            ("  // ordered union of the members, NT", "  " + mark % 4
             + "  // ordered union of the members, NT"),
            ("    else U = gather_lanes_std<T>(a, row, s, wsum);\n  }\n",
             "    else U = gather_lanes_std<T>(a, row, s, wsum);\n  }\n  "
             + mark % 5),
            ("  // 3. the lane math (JAX _assign_lanes)", "  " + mark % 6
             + "  // 3. the lane math (JAX _assign_lanes)"),
            ("    a.web_n[row.slot] = (use_seats && run_webster) ? target : 0;",
             "    a.web_n[row.slot] = (use_seats && run_webster) ? target : 0;"
             "\n    kt_prof[row.slot * 8 + 7] = clock64();")],
            "schedule_rows_prof", tmp)
        saved = {e: kernels._FNS[e] for e in ("schedule_rows_prepare",
                                              "schedule_rows_finish")}
        try:
            for e in saved:
                kernels._FNS[e] = entry(lib, "kt_" + e)
            ref = tuple(t.clone() for t in out)
            wave()
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(out, ref)):
                raise AssertionError("the profiled K2 disagrees")
            h = np.zeros(4096 * 8, np.int64)
            fn = lib.kt_prof_read
            fn.argtypes = [ctypes.c_void_p]
            if fn(ctypes.c_void_p(h.ctypes.data)):
                raise RuntimeError("reading the profile failed")
        finally:
            kernels._FNS.update(saved)
    h = h.reshape(4096, 8)[:Bw][db.b_valid[:Bw].cpu().numpy()]
    d = np.diff(h, axis=1)
    for i, name in enumerate(K2_PHASES):
        print(f"K2 std prepare, {name}: mean {d[:, i].mean():.0f} cycles, "
              f"p90 {np.percentile(d[:, i], 90):.0f}, max {d[:, i].max()}",
              flush=True)
    rows = h[:, 7] - h[:, 0]
    print(f"K2 std prepare, a row: mean {rows.mean():.0f} cycles, max "
          f"{rows.max()} ({len(rows)} rows)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
