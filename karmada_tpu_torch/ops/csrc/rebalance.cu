// K13 rebalance_score: the rebalance plane's per-cluster detect score.
//
// Replaces karmada_tpu/ops/rebalance_detect.py: score_kernel (a jitted
// XLA program over [C] lanes).  Inputs committed, capacity int64[C],
// valid bool[C]; threshold_milli and spread_tol_milli are arguments (JAX
// compiled one program per value) -> drain_need, over_milli, div_milli
// int64[C] (the rows of one [3, C] output).
//
// Bound on the card: bytes (17 B read and 24 B written per lane, ~0.2 MB
// at C = 5,000), far below one launch's fixed cost: the call, not the
// kernel, is what costs.  Design:
//  * ONE launch of one thread block cluster: a block per 2 * NT lanes, up
//    to CLUSTER_MAX blocks (two lanes a thread where it allows: a lane's
//    divisions are a long dependent chain); a single block up to 2 * NT.  Pass 1
//    loads each thread's lanes (up to LPT, coalesced across the cluster)
//    into registers, clamped, and sums them; a block reduction of both
//    totals at once, then every block of the cluster adds all blocks'
//    partials through distributed shared memory.  Pass 2 computes from
//    the registers; lanes beyond the cluster's registers (C > CLUSTER_MAX
//    * NT * LPT) are read again from global memory.  Integer sums are
//    associative, so the result does not depend on the shape.
//  * Divisions by a reciprocal (common.cuh Recip / floordiv_r: exact for
//    every int64 numerator and a divisor up to 2^62 + 1): the two by the
//    fleet totals made once per block, the one by a lane's capacity per
//    lane; a larger divisor takes floordiv.  Multiplies and adds go through unsigned 64-bit so an
//    overflow wraps as XLA's int64 does (signed overflow is undefined in
//    C++); divisions are floor divisions, as `//`.
//  * The call (kt_rebalance_score) takes an int64 ScoreCall block (ops/
//    rebalance_detect.py): from host inputs (`staged`) it copies them
//    into the workspace's pinned buffer, uploads them with one copy,
//    launches, copies the three outputs back with one copy and
//    synchronises the stream; with `timed` it records the workspace's
//    two events around the launch and returns their time.
#include <cooperative_groups.h>
#include <cstring>

#include "common.cuh"

namespace cg = cooperative_groups;

constexpr int NT = 512;
constexpr int LPT = 4;          // lanes a thread keeps in registers
constexpr int CLUSTER_MAX = 8;  // portable cluster size
constexpr i64 OVER_SATURATED = 1LL << 30;
constexpr i64 RECIP_MAX = (1LL << 62) + 1;  // floordiv_r's divisor bound

struct ScoreArgs {
  const i64* committed;
  const i64* capacity;
  const unsigned char* valid;
  i64* out;  // [3, C]: drain_need, over_milli, div_milli
  i64 C, threshold_milli, spread_tol_milli;
};

// One K13 call as ops/rebalance_detect.py lays out its int64 block
// (kernels.SCORE_CALL).  The C entry writes ev0, ev1 (made at the first
// timed call) and kernel_ns.
struct ScoreCall {
  i64 committed, capacity, valid;  // device, or host addresses (staged)
  i64 out;                         // device int64 [3, C]
  i64 C, threshold_milli, spread_tol_milli;
  i64 staged;      // 1: inputs from the host, outputs back into `pin`
  i64 dbuf;        // device buffer: staged inputs, then the outputs
  i64 pin;         // pinned buffer of the same layout (score_layout)
  i64 pin_bytes;
  i64 timed;       // 1: kernel_ns between ev0 and ev1 around the launch
  i64 ev0, ev1;    // cudaEvent_t of the workspace
  i64 kernel_ns;
};
static_assert(sizeof(ScoreCall) == 15 * sizeof(i64), "ScoreCall layout");

__device__ __forceinline__ i64 mulw(i64 a, i64 b) {
  return (i64)((u64)a * (u64)b);
}

__device__ __forceinline__ i64 subw(i64 a, i64 b) {
  return (i64)((u64)a - (u64)b);
}

__device__ __forceinline__ i64 addw(i64 a, i64 b) {
  return (i64)((u64)a + (u64)b);
}

// x // d for a d > 0: by its reciprocal `r` where that is exact
__device__ __forceinline__ i64 div_total(i64 x, i64 d, const Recip& r) {
  return d <= RECIP_MAX ? floordiv_r(x, r) : floordiv(x, d);
}

// lane i's clamped committed and capacity (0 on an invalid lane)
__device__ __forceinline__ void load_lane(const ScoreArgs& a, i64 i,
                                          bool& v, i64& com, i64& cap) {
  const unsigned char ok = a.valid[i];  // three independent loads
  const i64 c = a.committed[i], k = a.capacity[i];
  v = ok != 0;
  com = v ? maxll(c, 0) : 0;
  cap = v ? maxll(k, 0) : 0;
}

__device__ __forceinline__ void score_lane(const ScoreArgs& a, i64 i, bool v,
                                           i64 com, i64 cap, i64 total_com,
                                           i64 total_cap, const Recip& rc,
                                           const Recip& rp) {
  const i64 thr = a.threshold_milli, tol = a.spread_tol_milli;
  const i64 over = cap > 0
                       ? div_total(mulw(com, 1000), cap, make_recip(cap))
                       : (com > 0 ? OVER_SATURATED : 0);
  const i64 allowed = floordiv(mulw(cap, thr), 1000);
  const i64 over_need = maxll(subw(com, allowed), 0);
  const i64 share =
      total_com > 0 ? div_total(mulw(com, 1000), total_com, rc) : 0;
  const i64 fair =
      total_cap > 0 ? div_total(mulw(cap, 1000), total_cap, rp) : 0;
  const i64 div = subw(share, fair);
  const i64 spread_allowed = floordiv(mulw(addw(fair, tol), total_com), 1000);
  const i64 spread_need =
      div > tol ? maxll(subw(com, spread_allowed), 0) : 0;
  a.out[i] = v ? maxll(over_need, spread_need) : 0;
  a.out[a.C + i] = over;
  a.out[2 * a.C + i] = div;
}

__global__ void __launch_bounds__(NT)
    rebalance_score_kernel(const __grid_constant__ ScoreArgs a) {
  __shared__ i64 red[2 * (NT / 32)];
  __shared__ i64 part[2];  // this block's totals, read by the cluster
  KT_MARK(0);
  const i64 T = (i64)gridDim.x * NT;
  const i64 g = (i64)blockIdx.x * NT + threadIdx.x;
  // the thread's lanes in registers: clamped values, valid bits
  i64 lc[LPT], lp[LPT];
  unsigned vm = 0;
  i64 s_com = 0, s_cap = 0;
#pragma unroll
  for (int j = 0; j < LPT; ++j) {
    const i64 i = g + j * T;
    bool v = false;
    lc[j] = lp[j] = 0;
    if (i < a.C) load_lane(a, i, v, lc[j], lp[j]);
    vm |= (unsigned)v << j;
  }
#pragma unroll
  for (int j = 0; j < LPT; ++j) {
    s_com = addw(s_com, lc[j]);
    s_cap = addw(s_cap, lp[j]);
  }
  for (i64 i = g + LPT * T; i < a.C; i += T) {
    bool v;
    i64 com, cap;
    load_lane(a, i, v, com, cap);
    s_com = addw(s_com, com);
    s_cap = addw(s_cap, cap);
  }
  KT_MARK(1);
  // both block totals in one reduction (wrapping adds)
  for (int o = 16; o > 0; o >>= 1) {
    s_com = addw(s_com, __shfl_xor_sync(KT_FULL_MASK, s_com, o));
    s_cap = addw(s_cap, __shfl_xor_sync(KT_FULL_MASK, s_cap, o));
  }
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  if (lane == 0) {
    red[wid] = s_com;
    red[NT / 32 + wid] = s_cap;
  }
  __syncthreads();
  if (wid == 0) {
    s_com = lane < NT / 32 ? red[lane] : 0;
    s_cap = lane < NT / 32 ? red[NT / 32 + lane] : 0;
    for (int o = 16; o > 0; o >>= 1) {
      s_com = addw(s_com, __shfl_xor_sync(KT_FULL_MASK, s_com, o));
      s_cap = addw(s_cap, __shfl_xor_sync(KT_FULL_MASK, s_cap, o));
    }
    if (lane == 0) {
      part[0] = s_com;
      part[1] = s_cap;
    }
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every block's partials written and visible
  i64 total_com = 0, total_cap = 0;
  for (unsigned r = 0; r < cluster.num_blocks(); ++r) {
    const i64* q = cluster.map_shared_rank(part, r);
    total_com = addw(total_com, q[0]);
    total_cap = addw(total_cap, q[1]);
  }
  cluster.sync();  // no block leaves while another reads its partials
  const Recip rc = make_recip((u64)(total_com > 0 ? total_com : 1));
  const Recip rp = make_recip((u64)(total_cap > 0 ? total_cap : 1));
  KT_MARK(2);
#pragma unroll
  for (int j = 0; j < LPT; ++j) {
    const i64 i = g + j * T;
    if (i < a.C)
      score_lane(a, i, (vm >> j) & 1u, lc[j], lp[j], total_com, total_cap,
                 rc, rp);
  }
  for (i64 i = g + LPT * T; i < a.C; i += T) {
    bool v;
    i64 com, cap;
    load_lane(a, i, v, com, cap);
    score_lane(a, i, v, com, cap, total_com, total_cap, rc, rp);
  }
  KT_MARK(3);
}

static i64 align16(i64 n) { return (n + 15) / 16 * 16; }

static cudaError_t launch_score(const ScoreArgs& a, cudaStream_t st) {
  // two lanes a thread where the cluster allows: each lane's divisions
  // are a long dependent chain, so lanes go wide, not deep
  i64 blocks = (a.C + 2 * NT - 1) / (2 * NT);
  if (blocks > CLUSTER_MAX) blocks = CLUSTER_MAX;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks, 1, 1);
  cfg.blockDim = dim3(NT, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, rebalance_score_kernel, a);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// One K13 call (ops/rebalance_detect.py).  With `staged` the inputs are
// host addresses: copied into `pin` at the layout committed (8C),
// capacity (8C), valid (C, padded to 16 bytes), then the outputs (24C),
// uploaded into dbuf by one copy, the outputs copied back into `pin`
// after the kernel and the stream synchronised.
extern "C" int kt_rebalance_score(i64* blk, void* stream) {
  ScoreCall& c = *(ScoreCall*)blk;
  if (c.C <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  ScoreArgs a;
  a.committed = (const i64*)c.committed;
  a.capacity = (const i64*)c.capacity;
  a.valid = (const unsigned char*)c.valid;
  a.out = (i64*)c.out;
  a.C = c.C;
  a.threshold_milli = c.threshold_milli;
  a.spread_tol_milli = c.spread_tol_milli;
  cudaError_t e;
  const i64 o_out = align16(17 * c.C);
  if (c.staged) {
    if (o_out + 24 * c.C > c.pin_bytes) return (int)cudaErrorInvalidValue;
    char* h = (char*)c.pin;
    memcpy(h, (const void*)c.committed, (size_t)(8 * c.C));
    memcpy(h + 8 * c.C, (const void*)c.capacity, (size_t)(8 * c.C));
    memcpy(h + 16 * c.C, (const void*)c.valid, (size_t)c.C);
    e = cudaMemcpyAsync((void*)c.dbuf, h, (size_t)(17 * c.C),
                        cudaMemcpyHostToDevice, st);
    if (e != cudaSuccess) return (int)e;
    a.committed = (const i64*)c.dbuf;
    a.capacity = (const i64*)(c.dbuf + 8 * c.C);
    a.valid = (const unsigned char*)(c.dbuf + 16 * c.C);
    a.out = (i64*)(c.dbuf + o_out);
  }
  if (c.timed) {
    i64* evs[2] = {&c.ev0, &c.ev1};
    for (i64* ev : evs) {
      if (*ev == 0) {
        cudaEvent_t x;
        e = cudaEventCreate(&x);
        if (e != cudaSuccess) return (int)e;
        *ev = (i64)x;
      }
    }
    e = cudaEventRecord((cudaEvent_t)c.ev0, st);
    if (e != cudaSuccess) return (int)e;
  }
  e = launch_score(a, st);
  if (e != cudaSuccess) return (int)e;
  if (c.timed) {
    e = cudaEventRecord((cudaEvent_t)c.ev1, st);
    if (e != cudaSuccess) return (int)e;
  }
  if (c.staged) {
    e = cudaMemcpyAsync((char*)c.pin + o_out, (const void*)a.out,
                        (size_t)(24 * c.C), cudaMemcpyDeviceToHost, st);
    if (e != cudaSuccess) return (int)e;
    e = cudaStreamSynchronize(st);
    if (e != cudaSuccess) return (int)e;
  }
  if (c.timed) {
    e = cudaEventSynchronize((cudaEvent_t)c.ev1);
    if (e != cudaSuccess) return (int)e;
    float ms = 0.f;
    e = cudaEventElapsedTime(&ms, (cudaEvent_t)c.ev0, (cudaEvent_t)c.ev1);
    if (e != cudaSuccess) return (int)e;
    c.kernel_ns = (i64)((double)ms * 1e6);
  }
  return 0;
}

// Destroys a workspace's events (block fields ev0, ev1) once its work is
// done.
extern "C" int kt_score_free(i64* blk, void*) {
  ScoreCall& c = *(ScoreCall*)blk;
  int rc = 0;
  i64* evs[2] = {&c.ev0, &c.ev1};
  for (i64* ev : evs) {
    if (*ev == 0) continue;
    cudaError_t r = cudaEventSynchronize((cudaEvent_t)*ev);
    if (r == cudaSuccess) r = cudaEventDestroy((cudaEvent_t)*ev);
    if (r != cudaSuccess && rc == 0) rc = (int)r;
    *ev = 0;
  }
  return rc;
}
