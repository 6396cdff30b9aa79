// K1 capacity: GeneralEstimator maximum replicas per request class.
//
// Replaces karmada_tpu/ops/solver.py: _capacity_estimates plus the
// accurate-override decrement of wave_step (est_override - used_sets).
// One thread per (class q, cluster c) of est int64[Q+1, C]; row Q is the
// no-requirements row.  The min over the R resources runs in registers.
//
// Bound on the card: bytes (each thread reads its cluster's R capacity
// and used values and writes one int64; a few int64 divides per resource).
// Design: threads of a warp take neighbouring clusters so the [Q, C]
// planes are read and written coalesced; the [C, R] rows are small.
// The ceil trick -((-avail) // 1000) runs on avail - used, which can be
// negative, so it uses floordiv, not C's truncating `/`.
//
// The kernel and its launch live here so that two libraries enqueue it:
// capacity.cu's kt_capacity (the standalone call, spread phase A) and
// schedule_rows.cu, whose wave entries enqueue the wave's est before the
// wave's first K2 launch from one argument block.
#pragma once

#include "common.cuh"

struct CapacityArgs {
  const i64* req_milli;              // [Q, R]
  const unsigned char* req_is_cpu;   // [R]
  const i64* req_pods;               // [Q]
  const i64* avail_milli;            // [C, R]
  const i64* used_milli;             // [C, R]
  const unsigned char* has_alloc;    // [C, R]
  const i64* pods_allowed;           // [C]
  const i64* used_pods;              // [C]
  const unsigned char* has_summary;  // [C]
  const i64* est_override;           // [Q, C]
  const i64* used_sets;              // [Q, C]
  i64* est;                          // [Q + 1, C]
  i64 Q, R, C;
};

__global__ void capacity_kernel(CapacityArgs a) {
  const i64 t = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (a.Q + 1) * a.C) return;
  const i64 q = t / a.C, c = t % a.C;
  const i64 pods_eff = maxll(a.pods_allowed[c] - a.used_pods[c], 0);
  const bool live = a.has_summary[c] && pods_eff > 0;
  if (q == a.Q) {
    a.est[t] = live ? minll(pods_eff, KT_MAX_INT32) : 0;
    return;
  }
  i64 est = KT_MAX_INT64;
  for (i64 r = 0; r < a.R; ++r) {
    const i64 req = a.req_milli[q * a.R + r];
    if (req <= 0) continue;  // unrequested resources are inert
    const i64 av = a.avail_milli[c * a.R + r] - a.used_milli[c * a.R + r];
    const i64 unit = a.req_is_cpu[r] ? av : -floordiv(-av, 1000);
    const i64 cnt = (a.has_alloc[c * a.R + r] && unit > 0)
                        ? floordiv(unit, maxll(req, 1)) : 0;
    est = minll(est, cnt);
  }
  est = minll(est, floordiv(pods_eff, maxll(a.req_pods[q], 1)));
  est = live ? est : 0;
  est = minll(maxll(est, 0), KT_MAX_INT32);
  const i64 ovr = a.est_override[q * a.C + c];
  if (ovr >= 0) est = maxll(ovr - a.used_sets[q * a.C + c], 0);
  a.est[t] = est;
}

inline int launch_capacity(const CapacityArgs& a, cudaStream_t stream) {
  const i64 n = (a.Q + 1) * a.C;
  if (n <= 0) return 0;
  const int nt = 256;
  capacity_kernel<<<(unsigned)((n + nt - 1) / nt), nt, 0, stream>>>(a);
  return (int)cudaGetLastError();
}
