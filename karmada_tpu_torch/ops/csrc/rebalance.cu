// K13 rebalance_score: the rebalance plane's per-cluster detect score.
//
// Replaces karmada_tpu/ops/rebalance_detect.py: score_kernel (a jitted
// XLA program over [C] lanes).  Inputs committed, capacity int64[C],
// valid bool[C]; threshold_milli and spread_tol_milli are arguments (JAX
// compiled one program per value) -> drain_need, over_milli, div_milli
// int64[C].
//
// Bound on the card: bytes (17 B read and 24 B written per lane, ~0.2 MB
// at C = 5,000), far below one launch's fixed cost: the kernel is launch
// bound.  Design: ONE block of NT threads.  Pass 1 strides over the lanes
// and sums the clamped committed and capacity; a block reduction makes
// the two fleet totals; pass 2 re-reads the lanes (L1/L2-resident) and
// writes the three outputs.  Integer sums are associative, so the result
// does not depend on the block size.  Multiplies go through unsigned
// 64-bit so an overflow wraps as XLA's int64 does (signed overflow is
// undefined in C++); divisions are floor divisions, as `//`.
#include "common.cuh"

constexpr int NT = 1024;
constexpr i64 OVER_SATURATED = 1LL << 30;

struct ScoreArgs {
  const i64* committed;
  const i64* capacity;
  const unsigned char* valid;
  i64* drain_need;
  i64* over_milli;
  i64* div_milli;
  i64 C, threshold_milli, spread_tol_milli;
};

__device__ __forceinline__ i64 mulw(i64 a, i64 b) {
  return (i64)((u64)a * (u64)b);
}

__device__ __forceinline__ i64 subw(i64 a, i64 b) {
  return (i64)((u64)a - (u64)b);
}

__device__ __forceinline__ i64 addw(i64 a, i64 b) {
  return (i64)((u64)a + (u64)b);
}

__global__ void __launch_bounds__(NT) rebalance_score_kernel(ScoreArgs a) {
  __shared__ i64 red[33];
  i64 s_com = 0, s_cap = 0;
  for (i64 i = threadIdx.x; i < a.C; i += NT) {
    const bool v = a.valid[i] != 0;
    s_com = addw(s_com, v ? maxll(a.committed[i], 0) : 0);
    s_cap = addw(s_cap, v ? maxll(a.capacity[i], 0) : 0);
  }
  // every thread gets both totals back (block_sum syncs around red)
  const i64 total_com = block_sum<NT>(s_com, red);
  const i64 total_cap = block_sum<NT>(s_cap, red);
  const i64 thr = a.threshold_milli, tol = a.spread_tol_milli;
  for (i64 i = threadIdx.x; i < a.C; i += NT) {
    const bool v = a.valid[i] != 0;
    const i64 cap = v ? maxll(a.capacity[i], 0) : 0;
    const i64 com = v ? maxll(a.committed[i], 0) : 0;
    const i64 over = cap > 0 ? floordiv(mulw(com, 1000), maxll(cap, 1))
                             : (com > 0 ? OVER_SATURATED : 0);
    const i64 allowed = floordiv(mulw(cap, thr), 1000);
    const i64 over_need = maxll(subw(com, allowed), 0);
    const i64 share = total_com > 0
        ? floordiv(mulw(com, 1000), maxll(total_com, 1)) : 0;
    const i64 fair = total_cap > 0
        ? floordiv(mulw(cap, 1000), maxll(total_cap, 1)) : 0;
    const i64 div = subw(share, fair);
    const i64 spread_allowed = floordiv(mulw(addw(fair, tol), total_com),
                                        1000);
    const i64 spread_need = div > tol ? maxll(subw(com, spread_allowed), 0)
                                      : 0;
    a.drain_need[i] = v ? maxll(over_need, spread_need) : 0;
    a.over_milli[i] = over;
    a.div_milli[i] = div;
  }
}

extern "C" int kt_rebalance_score(const ScoreArgs* a, void* stream) {
  if (a->C <= 0) return 0;
  rebalance_score_kernel<<<1, NT, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}
