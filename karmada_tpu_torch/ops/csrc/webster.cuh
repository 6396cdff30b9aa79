// Closed-form Sainte-Lague (Webster) allocation for one block.
//
// Replaces karmada_tpu/ops/solver.py: webster_divide (the JAX program's
// integer threshold bisection plus one-shot tie-block award).  One thread
// block solves one allocation problem over L lanes; lanes are strided over
// the block's threads and every bisection step is one block reduction.
//
// Semantics (bit-exact with the JAX program): w clamped to [0, 2^34-1] and
// s0 to [0, 2^25-1] on active lanes; n_eff = clamp(n, 0, 2^25-1) when the
// total weight is positive, else 0.  Candidate "s-th seat of lane i" has
// priority q = (w << 28) // (2s+1); the n_eff best candidates under
// (q desc, seat asc, rank asc) are awarded: a bisection finds the threshold
// t*, every candidate with q > t* is awarded, and a second bisection on the
// tie key seat*L + rank awards the r remaining seats of the q == t* block.
//
// Bound on the card: operations (two ~40-60 step bisections, each a pass
// of int64 divides over L lanes plus a block reduction); the lanes of a
// K2 row live in shared memory, so device-memory traffic is negligible.
// Design: no sort and no per-seat loop; the n_eff == 0 and r == 0 cases
// (rows that run no division, or no tie block) skip the bisections.
#pragma once

#include "common.cuh"

#define KT_QBITS 28
#define KT_W_CAP ((1LL << 34) - 1)
#define KT_N_CAP ((1LL << 25) - 1)

struct WebsterLane {
  i64 wq, s0;
  bool pos;
};

__device__ __forceinline__ WebsterLane webster_lane(const i64* w,
                                                    const i64* s0,
                                                    const unsigned char* act,
                                                    int i) {
  WebsterLane l;
  const bool a = act[i] != 0;
  const i64 wi = a ? clampll(w[i], 0, KT_W_CAP) : 0;
  l.s0 = (a && s0 != nullptr) ? clampll(s0[i], 0, KT_N_CAP) : 0;
  l.wq = shl(wi, KT_QBITS);
  l.pos = a && wi > 0;
  return l;
}

__device__ __forceinline__ i64 webster_count_above(const WebsterLane& l,
                                                   i64 n_eff, i64 t) {
  if (!l.pos) return 0;
  const i64 m = ((l.wq / (t + 1)) + 1) >> 1;  // wq >= 0, t >= 0
  return minll(maxll(m - l.s0, 0), n_eff);
}

// seats[i] for i < L.  w/s0/active/rank may live in shared or global
// memory; s0 may be null (all zero).  `red` is 33 int64 of shared memory.
template <int NT>
__device__ void webster_block(i64 n, const i64* w, const i64* s0,
                              const unsigned char* active, const i64* rank,
                              int L, i64* seats, i64* red) {
  i64 tw = 0;
  for (int i = threadIdx.x; i < L; i += NT) {
    const bool a = active[i] != 0;
    tw += a ? clampll(w[i], 0, KT_W_CAP) : 0;
  }
  const i64 totw = block_sum<NT>(tw, red);
  const i64 n_eff = totw > 0 ? clampll(n, 0, KT_N_CAP) : 0;
  if (n_eff == 0) {
    // every count clips to 0: seats stay s0
    for (int i = threadIdx.x; i < L; i += NT) {
      const WebsterLane l = webster_lane(w, s0, active, i);
      seats[i] = active[i] ? l.s0 : 0;
    }
    __syncthreads();
    return;
  }
  i64 mx = 0;
  for (int i = threadIdx.x; i < L; i += NT)
    mx = maxll(mx, webster_lane(w, s0, active, i).wq);
  const i64 hi0 = maxll(block_max<NT>(mx, red), 1);

  auto cnt = [&](i64 t) -> i64 {
    i64 c = 0;
    for (int i = threadIdx.x; i < L; i += NT)
      c += webster_count_above(webster_lane(w, s0, active, i), n_eff, t);
    return block_sum<NT>(c, red);
  };
  // 1. threshold bisection: smallest t with cnt(t) <= n_eff
  i64 lo = 0, hi = hi0;
  while (hi - lo > 1) {
    const i64 mid = (lo + hi) >> 1;
    if (cnt(mid) > n_eff) lo = mid; else hi = mid;
  }
  const i64 t_star = cnt(0) <= n_eff ? 0 : hi;
  // 2. full award above the threshold
  i64 fsum = 0;
  for (int i = threadIdx.x; i < L; i += NT)
    fsum += webster_count_above(webster_lane(w, s0, active, i), n_eff, t_star);
  const i64 r = n_eff - block_sum<NT>(fsum, red);
  // 3. tie block at q == t*: the r smallest keys seat*L + rank
  const i64 tm1 = maxll(t_star - 1, 0);
  auto cnt_key_lane = [&](int i, i64 K) -> i64 {
    const WebsterLane l = webster_lane(w, s0, active, i);
    const i64 full = webster_count_above(l, n_eff, t_star);
    const i64 k = t_star > 0 ? webster_count_above(l, n_eff, tm1) - full : 0;
    const i64 base = l.s0 + full;
    const i64 c = floordiv(K - 1 - rank[i], (i64)L) - base + 1;
    return minll(maxll(c, 0), k);
  };
  i64 k_star = 0;
  if (r > 0) {
    lo = 0;
    hi = (1LL << 27) * (i64)L;
    while (hi - lo > 1) {
      const i64 mid = (lo + hi) >> 1;
      i64 c = 0;
      for (int i = threadIdx.x; i < L; i += NT) c += cnt_key_lane(i, mid);
      if (block_sum<NT>(c, red) >= r) hi = mid; else lo = mid;
    }
    k_star = hi;
  }
  for (int i = threadIdx.x; i < L; i += NT) {
    const WebsterLane l = webster_lane(w, s0, active, i);
    const i64 full = webster_count_above(l, n_eff, t_star);
    const i64 award = r > 0 ? cnt_key_lane(i, k_star) : 0;
    seats[i] = active[i] ? l.s0 + full + award : 0;
  }
  __syncthreads();
}
