// K3 compact: row-major COO extraction of the dense chunk result.
//
// Replaces karmada_tpu/ops/solver.py: _compact_of (fused into
// schedule_compact / schedule_compact_donated).  mask[b, c] =
// (wanted_sel | rep > 0) with wanted_sel = sel (keep_sel) or
// sel & non_workload[b]; outputs idx int32 (flat b*C + c, ascending),
// val int32 (rep cast) and nnz int64.
//
// Bound on the card: bytes -- rep (int64) and sel read once, the COO
// written once.  Design: one launch, a single-pass stream compaction over
// the flat B*C index with decoupled look-back.  A block takes the next
// tile of TILE consecutive flat positions from a global counter (tiles are
// handed out in order, so every tile a block waits on belongs to a block
// that is running or done: forward progress without ordered scheduling).
// Each warp owns WARP_SPAN consecutive positions, loaded as 16-byte pairs
// of rep (a warp step covers 64 positions with fully coalesced loads), all
// STEPS loads in flight before the first is used, and keeps the wanted
// flags as ballots and the values in registers; the block publishes its
// aggregate in its tile-status word, warp 0 looks back over its
// predecessors' words until an inclusive prefix closes the sum, publishes
// its own inclusive prefix, and every warp then writes its run.  rep is
// read once, so the kernel moves the bound's bytes.  What keeps it above
// the bound is how many bytes an SM keeps in flight while its blocks also
// take tile ids, look back and write: 12 steps a warp at 80 registers
// (three blocks an SM) did best of the shapes tried (PERF.md §6); a
// persistent, double-buffered (cp.async) block and one tile per warp did
// worse, as their look-backs wait on tiles that other blocks only hold.
// The last tile writes nnz.  The status words and the tile counter are
// cleared by one cudaMemsetAsync on the same stream before the launch (no
// epoch tags).  The output holds B*C slots, so it cannot overflow: the JAX
// path's nnz-escalation re-solve has no counterpart.
#include "common.cuh"

constexpr int NT = 256;
constexpr int STEPS = 12;                   // 64-position steps per warp
constexpr int WARP_SPAN = STEPS * 64;       // 768 positions per warp
constexpr int TILE = (NT / 32) * WARP_SPAN; // 6,144 positions per tile
constexpr u64 FLAG_AGG = 1ULL << 62, FLAG_PFX = 2ULL << 62;
constexpr u64 VALUE_MASK = (1ULL << 62) - 1;

struct CompactArgs {
  const i64* rep;                     // [B, C], 16-byte aligned
  const unsigned char* sel;           // [B, C], 2-byte aligned
  const unsigned char* non_workload;  // [B]
  int* idx;                           // [B * C]
  int* val;                           // [B * C]
  i64* state;   // [state_len]: tile counter, nnz, one status word a tile
  i64 B, C, keep_sel, state_len;
};

__device__ __forceinline__ u64 load_status(const i64* p) {
  return *(const volatile u64*)p;
}

__device__ __forceinline__ void store_status(i64* p, u64 v) {
  *(volatile u64*)p = v;
}

__global__ void __launch_bounds__(NT, 3) compact_kernel(CompactArgs a) {
  __shared__ unsigned tile_sh;
  __shared__ int warp_tot[NT / 32];
  __shared__ i64 excl_sh;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  if (threadIdx.x == 0) tile_sh = atomicAdd((unsigned*)a.state, 1u);
  __syncthreads();
  const i64 tile = tile_sh;
  const i64 N = a.B * a.C;
  const i64 seg = tile * TILE + (i64)wid * WARP_SPAN;
  // the warp's first row, and the non_workload flags of its 32 rows from
  // there as one ballot (a span of 512 positions covers them when C >=
  // 17; rows past them are read one by one)
  const i64 wb0 = seg / a.C;
  const unsigned nw_bits = __ballot_sync(
      KT_FULL_MASK, wb0 + lane < a.B && a.non_workload[wb0 + lane]);
  auto nw_of = [&](i64 b) -> bool {
    return b - wb0 < 32 ? (nw_bits >> (b - wb0)) & 1u : a.non_workload[b];
  };
  // the lane's first position seg + 2 * lane, its row b (found from wb0
  // by steps of C: no division) and the start of row b + 1
  i64 o = seg + 2 * lane;
  i64 b = wb0, next_row = (wb0 + 1) * a.C;
  unsigned m0[STEPS], m1[STEPS];
  int v0[STEPS], v1[STEPS];
  unsigned s01[STEPS];
  // every load of the warp's span issued before any is used
  if (seg + WARP_SPAN <= N) {
#pragma unroll
    for (int j = 0; j < STEPS; ++j) {
      const longlong2 r = __ldcs((const longlong2*)(a.rep + o + 64 * j));
      const uchar2 s = *(const uchar2*)(a.sel + o + 64 * j);
      v0[j] = (int)r.x; v1[j] = (int)r.y;
      m0[j] = r.x > 0; m1[j] = r.y > 0;
      s01[j] = s.x | (s.y << 8);
    }
  } else {
#pragma unroll
    for (int j = 0; j < STEPS; ++j) {
      const i64 p = o + 64 * j;
      const i64 r0 = p < N ? a.rep[p] : 0, r1 = p + 1 < N ? a.rep[p + 1] : 0;
      v0[j] = (int)r0; v1[j] = (int)r1;
      m0[j] = r0 > 0; m1[j] = r1 > 0;
      s01[j] = (p < N ? a.sel[p] : 0) | ((p + 1 < N ? a.sel[p + 1] : 0) << 8);
    }
  }
#pragma unroll
  for (int j = 0; j < STEPS; ++j, o += 64) {
    while (o >= next_row) { ++b; next_row += a.C; }
    bool f0 = m0[j], f1 = m1[j];
    // sel counts where it is kept, or on a non-workload row; s01 is 0
    // past the end, so b and b1 stay inside the batch when read
    if ((s01[j] & 0xff) && !f0) f0 = a.keep_sel || nw_of(b);
    if ((s01[j] >> 8) && !f1)
      f1 = a.keep_sel || nw_of(o + 1 >= next_row ? b + 1 : b);
    m0[j] = __ballot_sync(KT_FULL_MASK, f0);
    m1[j] = __ballot_sync(KT_FULL_MASK, f1);
  }
  int wcount = 0;
#pragma unroll
  for (int j = 0; j < STEPS; ++j) wcount += __popc(m0[j]) + __popc(m1[j]);
  if (lane == 0) warp_tot[wid] = wcount;
  __syncthreads();
  int woff = 0, agg = 0;
  for (int w = 0; w < NT / 32; ++w) {
    if (w < wid) woff += warp_tot[w];
    agg += warp_tot[w];
  }
  i64* status = a.state + 2;
  if (wid == 0) {
    i64 excl = 0;
    if (tile == 0) {
      if (lane == 0) store_status(status, FLAG_PFX | (u64)agg);
    } else {
      if (lane == 0) store_status(status + tile, FLAG_AGG | (u64)agg);
      // look back in windows of 32 predecessors, nearest first
      for (i64 look = tile - 1;; look -= 32) {
        const i64 t = look - lane;
        u64 w = t >= 0 ? load_status(status + t) : FLAG_PFX;
        while (__any_sync(KT_FULL_MASK, (w >> 62) == 0))
          if ((w >> 62) == 0) w = load_status(status + t);
        const unsigned pfx = __ballot_sync(KT_FULL_MASK, (w >> 62) == 2);
        // sum the words up to and including the nearest inclusive prefix
        const int stop = pfx ? __ffs(pfx) - 1 : 31;
        i64 v = lane <= stop ? (i64)(w & VALUE_MASK) : 0;
        for (int d = 16; d > 0; d >>= 1) v += __shfl_down_sync(KT_FULL_MASK, v, d);
        excl += __shfl_sync(KT_FULL_MASK, v, 0);
        if (pfx) break;
      }
      if (lane == 0) store_status(status + tile, FLAG_PFX | (u64)(excl + agg));
    }
    if (lane == 0) excl_sh = excl;
  }
  __syncthreads();
  // every warp writes its run in order: step j's pairs, lane by lane
  const unsigned lt = (1u << lane) - 1u;
  i64 out = excl_sh + woff;
  o = seg + 2 * lane;
#pragma unroll
  for (int j = 0; j < STEPS; ++j, o += 64) {
    const int pre = __popc(m0[j] & lt) + __popc(m1[j] & lt);
    const bool f0 = (m0[j] >> lane) & 1u, f1 = (m1[j] >> lane) & 1u;
    if (f0) { a.idx[out + pre] = (int)o; a.val[out + pre] = v0[j]; }
    if (f1) {
      a.idx[out + pre + f0] = (int)(o + 1);
      a.val[out + pre + f0] = v1[j];
    }
    out += __popc(m0[j]) + __popc(m1[j]);
  }
  if (threadIdx.x == 0 && (tile + 1) * TILE >= N) a.state[1] = excl_sh + agg;
}

extern "C" int kt_compact(const CompactArgs* a, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const i64 N = a->B * a->C;
  const i64 tiles = (N + TILE - 1) / TILE;
  if (2 + tiles > a->state_len) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaMemsetAsync(a->state, 0, (size_t)(2 + tiles) * 8, s);
  if (e != cudaSuccess) return (int)e;
  if (tiles == 0) return 0;
  compact_kernel<<<(unsigned)tiles, NT, 0, s>>>(*a);
  return (int)cudaGetLastError();
}
