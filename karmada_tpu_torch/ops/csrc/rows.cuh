// The per-row prologue K2 schedule_rows, K5 spread_group_info, K6
// spread_pick, K7 explain_rows and K8 shortlist_topk share, the block sort
// K2 and K8 use, and the top-k selection K2 and K8 share.
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

// In-place ascending bitonic sort of N (a power of two) entries (key,
// idx), ordered by (key, idx).  idx is distinct, so the order is total:
// the result equals a stable sort by key of lanes idx -- the tie order of
// lax.top_k and argsort that K2's and K8's selections need.  The buffers
// are shared or device memory of this block.
template <int NT>
__device__ void block_sort(i64* key, int* idx, int N) {
  for (int k = 2; k <= N; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
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
  }
}

// lax.top_k's index set over ng key arrays of n lanes each (keys[g * n +
// c], shared or device memory): array g keeps its kg largest keys (kg = k0
// for g == 0, else k1).  The non-negative keys of one array must be
// distinct; -1 marks an ineligible lane.  cnt[g] is array g's count of
// non-negative keys (the caller counts them as it writes the keys).  An
// 8-pass radix select finds thr[g], the kg-th largest key (0 when every
// non-negative key fits); with `fill`, cut[g] is the last of the
// lowest-index -1 lanes that fill an array short of kg, as lax.top_k
// breaks ties (without it cut stays -1).  On return lane c is a member of
// array g iff (key >= 0 ? key >= thr[g] : c <= cut[g]).  thr, cut, rem:
// shared, ng entries; hist: shared, ng * 256 ints; wsum: NT / 32 ints.
// Every thread of the block calls.
template <int NT>
__device__ void topk_select(const i64* keys, i64 n, int ng, int k0, int k1,
                            const int* cnt, i64* thr, i64* cut, int* rem,
                            int* hist, int* wsum, bool fill) {
  if (threadIdx.x < ng) {
    thr[threadIdx.x] = 0;
    cut[threadIdx.x] = -1;
    rem[threadIdx.x] = threadIdx.x == 0 ? k0 : k1;
  }
  __syncthreads();
  for (int shift = 56; shift >= 0; shift -= 8) {
    for (int i = threadIdx.x; i < ng * 256; i += NT) hist[i] = 0;
    __syncthreads();
    const u64 high = shift >= 56 ? 0ULL : (~0ULL << (shift + 8));
    for (i64 c = threadIdx.x; c < n; c += NT) {
      for (int g = 0; g < ng; ++g) {
        const int kg = g == 0 ? k0 : k1;
        if (cnt[g] <= kg) continue;
        const i64 k = keys[g * n + c];
        if (k < 0 || (((u64)k ^ (u64)thr[g]) & high) != 0) continue;
        atomicAdd(&hist[g * 256 + (int)(((u64)k >> shift) & 255)], 1);
      }
    }
    __syncthreads();
    if (threadIdx.x < ng) {
      const int g = threadIdx.x;
      const int kg = g == 0 ? k0 : k1;
      if (cnt[g] > kg) {
        int cum = 0;
        for (int d = 255; d >= 0; --d) {
          const int h = hist[g * 256 + d];
          if (cum + h >= rem[g]) {
            rem[g] -= cum;
            thr[g] = (i64)((u64)thr[g] | ((u64)d << shift));
            break;
          }
          cum += h;
        }
      }
    }
    __syncthreads();
  }
  if (!fill) return;
  // the lowest-index lanes with key -1, for arrays short of kg
  for (int g = 0; g < ng; ++g) {
    const int kg = g == 0 ? k0 : k1;
    const int need = kg - cnt[g];
    if (need <= 0) continue;
    int seen = 0;
    for (i64 base = 0; base < n && seen < need; base += NT) {
      const i64 c = base + threadIdx.x;
      const bool f = c < n && keys[g * n + c] == -1;
      int total;
      const int pre = block_scan_flag<NT>(f, wsum, &total);
      if (f && seen + pre + 1 == need) cut[g] = c;
      seen += total;
    }
    __syncthreads();
  }
}
