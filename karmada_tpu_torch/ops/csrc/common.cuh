// Shared helpers of the port's kernels: int64 arithmetic with the JAX
// program's semantics (floor division, wrapping shifts) and block-wide
// reductions / scans for a fixed block size.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

typedef long long i64;
typedef unsigned long long u64;

#define KT_MAX_INT32 2147483647LL
#define KT_MAX_INT64 9223372036854775807LL
#define KT_FULL_MASK 0xffffffffu

// clock64 marks of a block's phases, compiled in only with
// -DKT_PROFILE=<blocks> (tools/kernel_probe.py k5k6, k8, k2big): KT_MARK(k)
// syncs the block, then its thread 0 writes clock64() into slot k (0 to
// KT_PROF_SLOTS - 1; a source may define more than 8 before its first
// include) of the block's row of kt_prof; kt_prof_read copies the rows to
// the host.
#ifndef KT_PROF_SLOTS
#define KT_PROF_SLOTS 8
#endif
#ifdef KT_PROFILE
__device__ long long kt_prof[KT_PROFILE * KT_PROF_SLOTS];
extern "C" int kt_prof_read(long long* h) {
  return (int)cudaMemcpyFromSymbol(h, kt_prof, sizeof(kt_prof));
}
#define KT_MARK(k)                                                \
  do {                                                            \
    __syncthreads();                                              \
    if (threadIdx.x == 0 && blockIdx.x < KT_PROFILE)              \
      kt_prof[blockIdx.x * KT_PROF_SLOTS + (k)] = clock64();      \
  } while (0)
#else
#define KT_MARK(k) \
  do {             \
  } while (0)
#endif

// Python/JAX `//`: rounds toward minus infinity (C's `/` truncates).
__device__ __forceinline__ i64 floordiv(i64 a, i64 b) {
  i64 q = a / b;
  i64 r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) --q;
  return q;
}

// floor(a / d) by an FP64 reciprocal (K4 and K13 share it), exact for 0 <= a < 2^63 and
// 1 <= d <= 2^62 + 1.  inv is RN(RN(1 / d) * (1 - 2^-49)): with each
// rounding within 2^-53 relative, a * inv stays below a / d and above
// (a / d)(1 - 2^-48), so the truncated estimate q never exceeds the
// quotient and misses it by at most (a / d) 2^-48 + 1 <= 2^15 + 1.  The
// remainder a - q d is then in [0, 2^15 + 2d), below 2^64; the same
// estimate on it misses by at most 1, leaving a remainder in [0, 2d) and
// one compare.
struct Recip {
  u64 d;
  double inv;
};

__device__ __forceinline__ Recip make_recip(u64 d) {
  Recip r;
  r.d = d;
  r.inv = __dmul_rn(__drcp_rn(__ull2double_rn(d)), 1.0 - 0x1p-49);
  return r;
}

__device__ __forceinline__ u64 udiv(u64 a, const Recip& r) {
  u64 q = __double2ull_rz(__dmul_rn(__ull2double_rn(a), r.inv));
  u64 rem = a - q * r.d;
  const u64 q1 = __double2ull_rz(__dmul_rn(__ull2double_rn(rem), r.inv));
  q += q1;
  rem -= q1 * r.d;
  return q + (rem >= r.d ? 1 : 0);
}

// Python's x // d for any int64 x and d >= 1 (d <= 2^62 + 1): for x < 0,
// x // d = -((-x - 1) // d) - 1, and -x - 1 = ~x never overflows.  One
// division and selects, no branch.
__device__ __forceinline__ i64 floordiv_r(i64 x, const Recip& r) {
  const bool neg = x < 0;
  const i64 q = (i64)udiv((u64)(neg ? ~x : x), r);
  return neg ? -q - 1 : q;
}

// int64 left shift that wraps like XLA's (signed overflow is UB in C++).
__device__ __forceinline__ i64 shl(i64 a, int s) {
  return (i64)((u64)a << s);
}

__device__ __forceinline__ i64 clampll(i64 x, i64 lo, i64 hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ i64 minll(i64 a, i64 b) { return a < b ? a : b; }
__device__ __forceinline__ i64 maxll(i64 a, i64 b) { return a > b ? a : b; }

// Block-wide sum / max of one int64 per thread.  `red` is 33 int64 of
// shared memory; every thread of the block must call (the result is
// returned to all of them).  Sums wrap like int64 adds in XLA.
template <int NT>
__device__ __forceinline__ i64 block_sum(i64 v, i64* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(KT_FULL_MASK, v, o);
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) red[wid] = v;
  __syncthreads();
  if (wid == 0) {
    v = lane < NT / 32 ? red[lane] : 0;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(KT_FULL_MASK, v, o);
    if (lane == 0) red[32] = v;
  }
  __syncthreads();
  return red[32];
}

template <int NT>
__device__ __forceinline__ i64 block_max(i64 v, i64* red) {
  for (int o = 16; o > 0; o >>= 1)
    v = maxll(v, __shfl_down_sync(KT_FULL_MASK, v, o));
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) red[wid] = v;
  __syncthreads();
  if (wid == 0) {
    v = lane < NT / 32 ? red[lane] : (i64)(-KT_MAX_INT64 - 1);
    for (int o = 16; o > 0; o >>= 1)
      v = maxll(v, __shfl_down_sync(KT_FULL_MASK, v, o));
    if (lane == 0) red[32] = v;
  }
  __syncthreads();
  return red[32];
}

// Exclusive prefix (in thread order) of one 0/1 flag per thread, plus the
// block total.  `wsum` is NT/32 ints of shared memory.
template <int NT>
__device__ __forceinline__ int block_scan_flag(bool flag, int* wsum,
                                               int* total) {
  const unsigned ball = __ballot_sync(KT_FULL_MASK, flag);
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int wpre = __popc(ball & ((1u << lane) - 1u));
  __syncthreads();
  if (lane == 0) wsum[wid] = __popc(ball);
  __syncthreads();
  int off = 0, tot = 0;
  for (int w = 0; w < NT / 32; ++w) {
    if (w < wid) off += wsum[w];
    tot += wsum[w];
  }
  *total = tot;
  return off + wpre;
}

// Exclusive prefix (in thread order) of one int64 per thread.  `wbuf` is
// 33 int64 of shared memory.
template <int NT>
__device__ __forceinline__ i64 block_scan_excl(i64 v, i64* wbuf) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  i64 incl = v;
  for (int o = 1; o < 32; o <<= 1) {
    i64 t = __shfl_up_sync(KT_FULL_MASK, incl, o);
    if (lane >= o) incl += t;
  }
  __syncthreads();
  if (lane == 31) wbuf[wid] = incl;
  __syncthreads();
  i64 off = 0;
  for (int w = 0; w < wid; ++w) off += wbuf[w];
  return off + incl - v;
}
