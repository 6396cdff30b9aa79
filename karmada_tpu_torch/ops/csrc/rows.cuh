// The per-row prologue K2 schedule_rows, K5 spread_group_info, K6
// spread_pick, K7 explain_rows and K8 shortlist_topk share, the COO
// bitmaps K2 and K7 use, and the block sort K2 and K8 use.
//
// Replaces the dense [B, C] planes the JAX programs build before their
// per-row math -- karmada_tpu/ops/solver.py _schedule_core (the prev/evict
// COO scatter, feasibility and avail_cal of wave_step) and
// karmada_tpu/ops/spread.py _spread_planes -- by one lane at a time: a
// block loads its row's scalars and prev/evict COO entries into shared
// memory once, and lane_info() gives any lane's feasibility, previous
// presence and replicas and calibrated availability from the est row of
// the row's class.  No [B, C] plane is written to device memory.
//
// The argument structs of the three kernels name their operands alike
// (cluster_valid, deleting, api_ok, pl_mask, pl_tol_bypass, est,
// placement_id, gvk_id, class_id, replicas, nw_shortcut, prev_idx,
// prev_val, evict_idx, C, Q, Kp, Ke), so the helpers are templates on it.
#pragma once

#include "common.cuh"

constexpr int LANE_BITS = 21;
constexpr i64 LANE_MASK = (1LL << LANE_BITS) - 1;
constexpr int AVAIL_BITS = 34;
constexpr i64 AVAIL_CAP = (1LL << AVAIL_BITS) - 1;

struct Row {
  i64 b, slot, pid, gvk, cid, n;
  int strategy, n_prev, n_evict;
  bool has_sc, ignore, uid_desc, fresh, nw, nw_shortcut;
  i64 sc_min, sc_max;
  const int* pidx;   // the row's prev lanes (n_prev, shared memory)
  const i64* pval;   // and their replicas
  const int* eidx;   // the row's eviction lanes (n_evict)
};

struct LaneInfo {
  bool feas, pp, ev;  // feasible; previously assigned here; evicting here
  i64 pr, ac;         // previous replicas; calibrated availability
};

// Row b's plane scalars and COO entries.  pidx/pval/eidx are shared memory
// of at least Kp / Kp / Ke entries; every thread of the block calls.  The
// entries land in arbitrary order: lane_info sums them, order-free.
template <int NT, class A>
__device__ void load_row(const A& a, i64 b, Row& row, int* pidx, i64* pval,
                         int* eidx) {
  __shared__ int n_prev, n_evict;
  row.b = b;
  row.pid = a.placement_id[b];
  row.gvk = a.gvk_id[b];
  row.cid = a.class_id[b] >= 0 ? a.class_id[b] : a.Q;
  row.n = a.replicas[b];
  row.nw_shortcut = a.nw_shortcut[b];
  if (threadIdx.x == 0) { n_prev = 0; n_evict = 0; }
  __syncthreads();
  for (i64 j = threadIdx.x; j < a.Kp; j += NT) {
    const int c = a.prev_idx[b * a.Kp + j];
    if (c >= 0) {
      const int e = atomicAdd(&n_prev, 1);
      pidx[e] = c;
      pval[e] = a.prev_val[b * a.Kp + j];
    }
  }
  for (i64 j = threadIdx.x; j < a.Ke; j += NT) {
    const int c = a.evict_idx[b * a.Ke + j];
    if (c >= 0) eidx[atomicAdd(&n_evict, 1)] = c;
  }
  __syncthreads();
  row.n_prev = n_prev;
  row.n_evict = n_evict;
  row.pidx = pidx;
  row.pval = pval;
  row.eidx = eidx;
  __syncthreads();  // n_prev / n_evict may be reused by a later call
}

// The row's prev and evict lanes in [lo, lo + 32 * words) as bitmaps in
// shared memory: `bits` holds 2 * words words, lane c is bit (c - lo) % 32
// of word (c - lo) / 32, the evict bitmap after the prev one.  A lane's
// bit is the OR of its entries, so duplicate prev lanes and a lane that is
// both prev and evict come out exact; a bitmap answers "is c a prev /
// evict lane", not the prev replicas (those still sum the entries).
// Every thread of the block calls; the bitmaps are complete on return.
// K2 (schedule_rows.cu plane_bits: all C lanes at once) and K7
// (explain.cu: BITS_TILE lanes at a time) share it.
template <int NT>
__device__ void row_bits(const Row& row, i64 lo, int words, unsigned* bits) {
  for (int i = threadIdx.x; i < 2 * words; i += NT) bits[i] = 0;
  __syncthreads();
  const i64 span = (i64)words * 32;
  for (int e = threadIdx.x; e < row.n_prev; e += NT) {
    const i64 c = row.pidx[e] - lo;
    if (c >= 0 && c < span) atomicOr(&bits[c >> 5], 1u << (c & 31));
  }
  for (int e = threadIdx.x; e < row.n_evict; e += NT) {
    const i64 c = row.eidx[e] - lo;
    if (c >= 0 && c < span)
      atomicOr(&bits[words + (c >> 5)], 1u << (c & 31));
  }
  __syncthreads();
}

template <class A>
__device__ __forceinline__ LaneInfo lane_info(const A& a, const Row& row,
                                              i64 c) {
  LaneInfo l;
  l.pp = false;
  l.pr = 0;
  for (int e = 0; e < row.n_prev; ++e)
    if (row.pidx[e] == c) { l.pp = true; l.pr += row.pval[e]; }
  l.ev = false;
  for (int e = 0; e < row.n_evict; ++e) l.ev |= row.eidx[e] == c;
  const i64 est_b = a.est[row.cid * a.C + c];
  l.ac = est_b == KT_MAX_INT32 ? row.n : est_b;
  if (row.nw_shortcut) l.ac = KT_MAX_INT32;
  const i64 pc = row.pid * a.C + c;
  l.feas = a.cluster_valid[c] && !a.deleting[c] && a.pl_mask[pc] &&
           (a.pl_tol_bypass[pc] || l.pp) &&
           (a.api_ok[row.gvk * a.C + c] || l.pp) && !l.ev;
  return l;
}

// The spreadconstraint sortClusters order (score desc, avail desc, name
// asc) packed into one key; infeasible lanes sort last (spread.py _sort_key).
__device__ __forceinline__ i64 spread_key(i64 score, i64 avail, i64 name_rank,
                                          bool feasible) {
  if (!feasible) return KT_MAX_INT64;
  return shl(200 - score, AVAIL_BITS + LANE_BITS) |
         shl(AVAIL_CAP - clampll(avail, 0, AVAIL_CAP), LANE_BITS) | name_rank;
}

// The compare-exchange stages (k, j) of block_sort for k = k0, 2 k0, ..
// k1 and each k's j < min(k, 32), in registers: a warp holds 32
// consecutive entries, so j < 32 pairs lanes of one warp (shuffles, no
// barrier).  The entries are read from and written back to key / idx;
// the caller syncs the block before and after.
template <int NT>
__device__ __forceinline__ void warp_stages(i64* key, int* idx, int N,
                                            int k0, int k1) {
  const int lane = threadIdx.x & 31;
  for (int i0 = threadIdx.x - lane; i0 < N; i0 += NT) {
    const int i = i0 + lane;
    const bool live = i < N;  // N < 32: lanes past N pair among themselves
    i64 k_ = live ? key[i] : 0;
    int x = live ? idx[i] : 0;
    for (int k = k0; k <= k1; k <<= 1) {
      for (int j = min(k >> 1, 16); j > 0; j >>= 1) {
        const i64 ko = __shfl_xor_sync(KT_FULL_MASK, k_, j);
        const int xo = __shfl_xor_sync(KT_FULL_MASK, x, j);
        const bool gt = k_ > ko || (k_ == ko && x > xo);
        // the pair's lower entry keeps the minimum where (i & k) == 0
        const bool keep_min = ((i & j) == 0) == ((i & k) == 0);
        if (gt == keep_min) { k_ = ko; x = xo; }
      }
    }
    if (live) { key[i] = k_; idx[i] = x; }
  }
}

// In-place ascending bitonic sort of N (a power of two) entries (key,
// idx), ordered by (key, idx).  idx is distinct, so the order is total:
// the result equals a stable sort by key of lanes idx -- the tie order of
// lax.top_k and argsort that K2's and K8's selections need.  The buffers
// are shared or device memory of this block.  The stages whose partners
// lie in one warp (j < 32) run in registers (warp_stages), the rest
// through the buffers with a block barrier each: for N = 2,048, 21
// barriers' worth of buffer stages and 7 register phases in place of 66
// buffer stages.
template <int NT>
__device__ void block_sort(i64* key, int* idx, int N) {
  warp_stages<NT>(key, idx, N, 2, min(N, 32));
  __syncthreads();
  for (int k = 64; k <= N; k <<= 1) {
    for (int j = k >> 1; j >= 32; j >>= 1) {
      for (int i = threadIdx.x; i < N; i += NT) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const i64 ka = key[i], kb = key[ixj];
          const int ia = idx[i], ib = idx[ixj];
          const bool gt = ka > kb || (ka == kb && ia > ib);
          if (gt == ((i & k) == 0)) {
            key[i] = kb; key[ixj] = ka;
            idx[i] = ib; idx[ixj] = ia;
          }
        }
      }
      __syncthreads();
    }
    warp_stages<NT>(key, idx, N, k, k);
    __syncthreads();
  }
}
