// What K5 spread_group_info and K6 spread_pick share: their argument
// fields, a row's spread planes per lane, the per-group key slots, the
// selection of the k least keys of a row and the clock64 marks of a
// profile build.
//
// Replaces the per-binding prologue of karmada_tpu/ops/spread.py
// (_spread_planes :166-219 and the _sort_key order of _group_info_one /
// _pick_one): a block computes its row's planes lane by lane (rows.cuh's
// lane math), four consecutive lanes a thread at a time with every
// operand load of those lanes issued before any is used (16-byte vector
// loads where the wrapper found the operands aligned) -- a lane's loads
// are independent, so a pass over the row waits for one round trip to L2
// per four lanes, not one per operand.  Neither kernel sorts the row:
// what the JAX programs read off the sorted order (a group's least keys,
// the k least keys across groups) comes from per-group key slots and a
// selection.
//
// The key is unique per feasible lane (its low LANE_BITS bits are the
// lane's name_rank, distinct per cluster, below C < 2^LANE_BITS), so a
// minimum names its lane and a threshold on the key takes exactly the
// lanes below it: the order is the least key, then the least lane, as in
// the stable sorts of the JAX programs.  NO_KEY (all ones below the sign
// bit) is no lane's key; it marks a lane outside the order.
#pragma once

#include "rows.cuh"

constexpr int NT = 256;
constexpr int LPT = 4;  // consecutive lanes a thread loads together
constexpr u64 KEY_SIGN = 1ULL << 63;
constexpr i64 NO_KEY = KT_MAX_INT64;

// the operands every spread kernel reads (rows.cuh names), in the order of
// kernels.SPREAD_TENSOR_FIELDS
#define KT_SPREAD_FIELDS                                                  \
  const unsigned char* cluster_valid; /* [C] */                           \
  const unsigned char* deleting;      /* [C] */                           \
  const i64* name_rank;               /* [C] */                           \
  const unsigned char* api_ok;        /* [Gv, C] */                       \
  const unsigned char* pl_mask;       /* [P, C] */                        \
  const unsigned char* pl_tol_bypass; /* [P, C] */                        \
  const i64* pl_extra_score;          /* [P, C] */                        \
  const int* placement_id;            /* [B] */                           \
  const int* gvk_id;                  /* [B] */                           \
  const int* class_id;                /* [B] */                           \
  const i64* replicas;                /* [B] */                           \
  const unsigned char* nw_shortcut;   /* [B] */                           \
  const int* prev_idx;                /* [B, Kp] */                       \
  const int* prev_val;                /* [B, Kp] */                       \
  const int* evict_idx;               /* [B, Ke] */                       \
  const i64* est;                     /* [Q + 1, C] raw snapshot */       \
  const int* group_id;                /* [C], -1: no group */

// a lane's operands, loaded together (every index is in range, so nothing
// waits on a condition)
struct LaneIn {
  unsigned char cv, del, pm, tol, api;
  int gid;
  i64 est, xs, nr;
};

// Without a.use_extra (the wrapper's promise that the placements' extra
// scores are 0) the extra-score row is not read.
template <class A>
__device__ __forceinline__ LaneIn lane_load(const A& a, const Row& row,
                                            i64 c) {
  const i64 pc = row.pid * a.C + c;
  LaneIn in;
  in.cv = __ldg(a.cluster_valid + c);
  in.del = __ldg(a.deleting + c);
  in.pm = __ldg(a.pl_mask + pc);
  in.tol = __ldg(a.pl_tol_bypass + pc);
  in.api = __ldg(a.api_ok + row.gvk * a.C + c);
  in.gid = __ldg(a.group_id + c);
  in.est = __ldg(a.est + row.cid * a.C + c);
  in.xs = a.use_extra ? __ldg(a.pl_extra_score + pc) : 0;
  in.nr = __ldg(a.name_rank + c);
  return in;
}

// lanes c0..c0+LPT-1 of a row (c0 a multiple of LPT, below C): 16-byte
// vector loads when `vec` (C a multiple of LPT, the operands aligned),
// else one load a lane for the lanes below C
template <class A>
__device__ __forceinline__ void lane_load4(const A& a, const Row& row, i64 c0,
                                           bool vec, LaneIn* in) {
  if (!vec) {
#pragma unroll
    for (int k = 0; k < LPT; ++k)
      if (c0 + k < a.C) in[k] = lane_load(a, row, c0 + k);
    return;
  }
  const i64 pc = row.pid * a.C + c0;
  const uchar4 cv = __ldg((const uchar4*)(a.cluster_valid + c0));
  const uchar4 del = __ldg((const uchar4*)(a.deleting + c0));
  const uchar4 pm = __ldg((const uchar4*)(a.pl_mask + pc));
  const uchar4 tol = __ldg((const uchar4*)(a.pl_tol_bypass + pc));
  const uchar4 api = __ldg((const uchar4*)(a.api_ok + row.gvk * a.C + c0));
  const int4 gid = __ldg((const int4*)(a.group_id + c0));
  const i64* est = a.est + row.cid * a.C + c0;
  const longlong2 e0 = __ldg((const longlong2*)est);
  const longlong2 e1 = __ldg((const longlong2*)(est + 2));
  longlong2 x0 = make_longlong2(0, 0), x1 = x0;
  if (a.use_extra) {
    x0 = __ldg((const longlong2*)(a.pl_extra_score + pc));
    x1 = __ldg((const longlong2*)(a.pl_extra_score + pc + 2));
  }
  const longlong2 n0 = __ldg((const longlong2*)(a.name_rank + c0));
  const longlong2 n1 = __ldg((const longlong2*)(a.name_rank + c0 + 2));
  in[0] = {cv.x, del.x, pm.x, tol.x, api.x, gid.x, e0.x, x0.x, n0.x};
  in[1] = {cv.y, del.y, pm.y, tol.y, api.y, gid.y, e0.y, x0.y, n0.y};
  in[2] = {cv.z, del.z, pm.z, tol.z, api.z, gid.z, e1.x, x1.x, n1.x};
  in[3] = {cv.w, del.w, pm.w, tol.w, api.w, gid.w, e1.y, x1.y, n1.y};
}

struct SpreadLane {
  bool feas;
  i64 avail, score;  // avail_sel (availability plus prev replicas), score
};

// rows.cuh lane_info + the spread score, on loaded operands
template <class A>
__device__ __forceinline__ SpreadLane lane_eval(const A& a, const Row& row,
                                                i64 c, const LaneIn& in) {
  bool pp = false, ev = false;
  i64 pr = 0;
  for (int e = 0; e < row.n_prev; ++e)
    if (row.pidx[e] == c) { pp = true; pr += row.pval[e]; }
  for (int e = 0; e < row.n_evict; ++e) ev |= row.eidx[e] == c;
  i64 ac = in.est == KT_MAX_INT32 ? row.n : in.est;
  if (row.nw_shortcut) ac = KT_MAX_INT32;
  SpreadLane s;
  s.feas = (in.cv != 0) & (in.del == 0) & (in.pm != 0) & ((in.tol != 0) | pp) &
           ((in.api != 0) | pp) & !ev;
  s.avail = ac + (pp ? pr : 0);
  s.score = ((row.n_prev > 0 && pp) ? 100 : 0) + in.xs;
  return s;
}

template <class A>
__device__ __forceinline__ SpreadLane spread_lane(const A& a, const Row& row,
                                                  i64 c) {
  return lane_eval(a, row, c, lane_load(a, row, c));
}

// int64 sum over the warp, wrapping like XLA's: three 22-bit pieces, each
// summed exactly in 32 bits (32 lanes x 2^22 < 2^32), recombined modulo
// 2^64.  Every lane of the warp calls.
__device__ __forceinline__ i64 warp_sum(i64 x) {
  const u64 u = (u64)x;
  const u64 s0 = __reduce_add_sync(KT_FULL_MASK, (unsigned)(u & 0x3FFFFF));
  const u64 s1 =
      __reduce_add_sync(KT_FULL_MASK, (unsigned)((u >> 22) & 0x3FFFFF));
  const u64 s2 = __reduce_add_sync(KT_FULL_MASK, (unsigned)(u >> 44));
  return (i64)(s0 + (s1 << 22) + (s2 << 44));
}

// *p = min(*p, v) on shared or device memory; returns the value the next
// slot of a cascade is offered: the one *p held if v took its place, else
// v.  It reads first, so the common case (v not smaller) takes no atomic.
// Offering every key to slot 0 and what each slot returns to the next
// leaves slot i with the (i+1)-th least key offered, whatever the order
// of the offers (each offer passes exactly one value on; a slot keeps
// only its least).
__device__ __forceinline__ i64 push_key(i64* p, i64 v) {
  i64 cur = *(volatile i64*)p;
  while (v < cur) {
    const i64 prev = (i64)atomicCAS((u64*)p, (u64)cur, (u64)v);
    if (prev == cur) return cur;
    cur = prev;
  }
  return v;
}

template <int NT_>
__device__ __forceinline__ i64 block_min(i64 v, i64* red) {
  for (int o = 16; o > 0; o >>= 1)
    v = minll(v, __shfl_down_sync(KT_FULL_MASK, v, o));
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) red[wid] = v;
  __syncthreads();
  if (wid == 0) {
    v = lane < NT_ / 32 ? red[lane] : KT_MAX_INT64;
    for (int o = 16; o > 0; o >>= 1)
      v = minll(v, __shfl_down_sync(KT_FULL_MASK, v, o));
    if (lane == 0) red[32] = v;
  }
  __syncthreads();
  return red[32];
}

// -- the k least keys ---------------------------------------------------------
// The least T such that exactly k of the keys key_of(c) (c < n; NO_KEY:
// lane c is not admitted) are <= T, for 1 <= k <= the admitted count; the
// admitted keys are distinct and lie in [lo, hi] (the passes start at the
// highest byte where lo and hi differ).  A most-significant-digit radix
// select on the keys with the sign bit flipped, 8 bits a pass: a pass
// histograms the admitted keys that share the prefix found so far, one
// warp finds the digit that holds the k-th, and a digit whose keys are
// all taken ends the select early.  A warp whose admitted keys share one
// digit adds them with one atomic.  hist: 256 ints of shared memory; sh:
// 2 int64 of shared memory.  Every thread of the block calls.
template <class K>
__device__ i64 select_smallest(K key_of, i64 n, i64 k, i64 lo, i64 hi,
                               int* hist, i64* sh) {
  const u64 ulo = (u64)lo ^ KEY_SIGN, uhi = (u64)hi ^ KEY_SIGN;
  if (ulo == uhi) return lo;  // one admitted key
  int shift = ((63 - __clzll((long long)(ulo ^ uhi))) >> 3) << 3;
  u64 prefix = shift >= 56 ? 0ULL : ulo & (~0ULL << (shift + 8));
  const int lane = threadIdx.x & 31;
  for (;; shift -= 8) {
    const u64 high = shift >= 56 ? 0ULL : ~0ULL << (shift + 8);
    for (int i = threadIdx.x; i < 256; i += NT) hist[i] = 0;
    __syncthreads();
    for (i64 base = 0; base < n; base += NT) {
      const i64 c = base + threadIdx.x;
      bool e = false;
      unsigned d = 0;
      if (c < n) {
        const i64 key = key_of(c);
        const u64 u = (u64)key ^ KEY_SIGN;
        e = key != NO_KEY && ((u ^ prefix) & high) == 0;
        d = (unsigned)(u >> shift) & 255u;
      }
      const unsigned act = __ballot_sync(KT_FULL_MASK, e);
      if (!act) continue;
      const unsigned d0 = __shfl_sync(KT_FULL_MASK, d, __ffs(act) - 1);
      if (!__ballot_sync(KT_FULL_MASK, e && d != d0)) {
        if (lane == __ffs(act) - 1) atomicAdd(&hist[d0], __popc(act));
      } else if (e) {
        atomicAdd(&hist[d], 1);
      }
    }
    __syncthreads();
    if (threadIdx.x < 32) {
      // lane l holds digits 8l..8l+7; the lane whose run holds the k-th
      // walks its run
      int h[8], s = 0;
      for (int j = 0; j < 8; ++j) { h[j] = hist[lane * 8 + j]; s += h[j]; }
      int incl = s;
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(KT_FULL_MASK, incl, o);
        if (lane >= o) incl += t;
      }
      int before = incl - s;
      if (before < k && k <= incl) {
        for (int j = 0; j < 8; ++j) {
          if (k <= before + h[j]) {
            sh[0] = lane * 8 + j;
            sh[1] = ((k - before) << 32) | (i64)h[j];  // rank in bin, size
            break;
          }
          before += h[j];
        }
      }
    }
    __syncthreads();
    const u64 d = (u64)sh[0];
    const i64 rank = sh[1] >> 32, size = sh[1] & 0xFFFFFFFF;
    __syncthreads();
    prefix |= d << shift;
    k = rank;
    if (size == k || shift == 0) {
      const u64 low = shift == 0 ? 0ULL : (1ULL << shift) - 1;
      return (i64)((prefix | low) ^ KEY_SIGN);
    }
  }
}

// dynamic shared memory regions, each 16-byte aligned
__host__ __device__ inline size_t spread_align(size_t x) {
  return (x + 15) & ~(size_t)15;
}

template <class K, class A>
int launch_spread(K kernel, const A* a, size_t smem, void* stream) {
  if (a->B <= 0) return 0;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)a->B, NT, smem, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}
