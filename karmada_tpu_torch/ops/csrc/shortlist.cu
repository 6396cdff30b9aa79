// K8 shortlist_topk and K9 group_sums: the tier-1 kernels of the
// hierarchical two-tier solve (ops/shortlist).
//
// K8 replaces karmada_tpu/ops/shortlist.py _shortlist_core (jitted as
// shortlist_topk) after its capacity estimate, which K1 computes on the
// raw snapshot: one thread block per profile row (a distinct (placement,
// GVK, request class) of the chunk), threads over the cluster lanes.  Per
// lane the rows.cuh prologue gives feasibility, previous presence and
// availability (the caller passes an all-false non-workload shortcut: the
// tier-1 score never applies it), and the lane's packed key is
//   prev bit << 60 | clip(avail, 0, 2^34-1) << 26 | group pref << 21
//   | (2^21 - 1 - name_rank),
// or -1 where the lane is not eligible (neither feasible nor previously
// assigned, or the row is padding).  rows.cuh topk_select (the radix
// select K2's lane gather uses) finds the k largest keys; they are
// distinct (the lane sits in the low 21 bits), so the k members sorted by
// key descending are exactly lax.top_k's first k entries, and every other
// output slot is -1 (the ties of lax.top_k fall only among -1 keys).
// fcount is the row's eligible-lane count.
//
// Bound on the card: bytes -- the placement planes, est rows and the
// cluster planes read once per row, the [B, k] candidates written.  The
// radix select reads the key row 8 times: rows up to SMEM_LANES lanes
// (16,384: 128 KB of int64 keys) keep it in shared memory, wider rows (up
// to 2^21 lanes) in a device-memory scratch [B, C] of the same layout.
// The members sort (bitonic, next power of two >= k entries) is always in
// shared memory.  Design: simple and right first -- a chunk has few
// profile rows (8 padded rows in the megafleet cycle), so most SMs idle.
//
// K9 replaces karmada_tpu/ops/shortlist.py _group_sums: the segment sum of
// the capacity proxy by group id into G + 1 buckets (groupless lanes, any
// negative id, in bucket G; ids beyond G dropped, as segment_sum drops
// them; sums wrap as int64 adds do).  Bound: bytes (the two [C] planes
// read once, G + 1 sums written) -- nanoseconds at C = 10,000-16,384, so
// the launch is the cost and the design is one launch that writes every
// bin: the wrapper allocates its output with torch.empty and launches no
// fill kernel.  The launch is one thread block cluster of GS_CLUSTER
// blocks of GS_NT threads (Hopper): each block strides over its share of
// the lanes and keeps the bins in its own dynamic shared memory (u64,
// shared-memory 64-bit atomics); after a cluster barrier the blocks sum
// the GS_CLUSTER copies of each bin through distributed shared memory and
// write it.  (One block, tried first, was slower than the PyTorch
// yardstick on the megafleet's round-robin layout: one SM's shared-memory
// atomics take every add, and each warp walks its lanes in sequence.)
// Lanes of one group that share a warp (fleets laid out by region) are
// summed in the warp first (__match_any_sync and a shuffle tree over the
// peers) and added by one atomic.  When G + 1 bins do not fit the shared
// memory a block can opt into, the blocks walk the bins in tiles of
// GS_TILE_BINS, reading the lanes once per tile; integer sums do not
// depend on order, so every path is exact.
#include <cooperative_groups.h>

#include "rows.cuh"

namespace cg = cooperative_groups;

constexpr int NT = 256;
constexpr int GROUP_BITS = 5;

struct TopkArgs {
  const unsigned char* cluster_valid;  // [C]
  const unsigned char* deleting;       // [C]
  const i64* name_rank;                // [C]
  const unsigned char* api_ok;         // [G, C]
  const unsigned char* pl_mask;        // [P, C]
  const unsigned char* pl_tol_bypass;  // [P, C]
  const i64* group_pref;               // [C]
  const unsigned char* b_valid;        // [B]
  const int* placement_id;             // [B]
  const int* gvk_id;                   // [B]
  const int* class_id;                 // [B]
  const i64* replicas;                 // [B]
  const unsigned char* nw_shortcut;    // [B], all false
  const int* prev_idx;                 // [B, Kp]
  const int* prev_val;                 // [B, Kp]
  const int* evict_idx;                // [B, Ke]
  const i64* est;                      // [Q + 1, C]
  i64* scratch;                        // [B, C] keys when !smem
  int* cand;                           // [B, k]
  int* fcount;                         // [B]
  i64 B, C, Q, Kp, Ke, k, nk, smem;    // nk: power of two >= k
};

__global__ void __launch_bounds__(NT) shortlist_topk(TopkArgs a) {
  extern __shared__ __align__(16) char smem_raw[];
  __shared__ i64 thr[1], cut[1];
  __shared__ int cnt[1], rem[1], n_mem;
  __shared__ int hist[256];
  __shared__ int wsum[NT / 32];
  __shared__ i64 red[33];
  i64* mkey = (i64*)smem_raw;
  i64* pval = mkey + a.nk;
  i64* skeys = pval + a.Kp;
  int* midx = (int*)(skeys + (a.smem ? a.C : 0));
  int* pidx = midx + a.nk;
  int* eidx = pidx + a.Kp;
  const i64 b = blockIdx.x;
  const i64 C = a.C;
  Row row;
  row.slot = b;
  load_row<NT>(a, b, row, pidx, pval, eidx);
  i64* keys = a.smem ? skeys : a.scratch + b * C;
  const bool valid = a.b_valid[b];
  i64 my = 0;
  for (i64 c = threadIdx.x; c < C; c += NT) {
    const LaneInfo l = lane_info(a, row, c);
    i64 key = -1;
    if (valid && (l.feas || l.pp)) {
      key = shl(l.pp ? 1 : 0, AVAIL_BITS + GROUP_BITS + LANE_BITS) |
            shl(clampll(l.ac, 0, AVAIL_CAP), GROUP_BITS + LANE_BITS) |
            shl(a.group_pref[c], LANE_BITS) | (LANE_MASK - a.name_rank[c]);
      ++my;
    }
    keys[c] = key;
  }
  const i64 total = block_sum<NT>(my, red);
  if (threadIdx.x == 0) { cnt[0] = (int)total; n_mem = 0; }
  __syncthreads();
  topk_select<NT>(keys, C, 1, (int)a.k, (int)a.k, cnt, thr, cut, rem, hist,
                  wsum, false);
  // the members (min(fcount, k) of them), then sorted best first
  for (i64 c = threadIdx.x; c < C; c += NT) {
    const i64 key = keys[c];
    if (key >= 0 && key >= thr[0]) {
      const int e = atomicAdd(&n_mem, 1);
      mkey[e] = -key;
      midx[e] = (int)c;
    }
  }
  __syncthreads();
  const int m = n_mem;
  for (i64 i = m + threadIdx.x; i < a.nk; i += NT) {
    mkey[i] = KT_MAX_INT64;
    midx[i] = (int)(C + i);
  }
  __syncthreads();
  block_sort<NT>(mkey, midx, (int)a.nk);
  for (i64 j = threadIdx.x; j < a.k; j += NT)
    a.cand[b * a.k + j] = j < m ? midx[j] : -1;
  if (threadIdx.x == 0) a.fcount[b] = cnt[0];
}

extern "C" int kt_shortlist_topk(const TopkArgs* a, void* stream) {
  if (a->B <= 0) return 0;
  const size_t smem = (size_t)a->nk * 12 + (size_t)a->Kp * 12 +
                      (size_t)a->Ke * 4 + (a->smem ? (size_t)a->C * 8 : 0);
  cudaError_t e = cudaFuncSetAttribute(
      shortlist_topk, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  shortlist_topk<<<(unsigned)a->B, NT, smem, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

struct GroupSumArgs {
  const int* group_id;  // [C]
  const i64* cap;       // [C]
  i64* out;             // [G + 1], every bin written
  i64 C, G;
};

constexpr int GS_NT = 1024;
constexpr int GS_CLUSTER = 8;  // blocks of the one cluster (portable size)
// bins of one shared-memory tile: 227 KB a block can opt into, in u64
// (ops/kernels.py GROUP_SUM_TILE_BINS)
constexpr i64 GS_TILE_BINS = 232448 / 8;

// Sum `x` over the lanes of this warp whose mask bit is in `peers` (the
// lanes holding the same key, this one included); the lowest peer gets
// the group's sum.  Every lane of the warp must call it.  A tree over
// the peers' ranks: in round k each lane adds the value of its next
// remaining peer, then the peers whose rank has bit k set drop out.
__device__ __forceinline__ u64 reduce_peers(unsigned peers, u64 x) {
  const int lane = threadIdx.x & 31;
  int rank = __popc(peers & ((1u << lane) - 1u));
  peers &= 0xfffffffeu << lane;  // the peers above this lane
  while (__any_sync(KT_FULL_MASK, peers != 0)) {
    const int next = __ffs(peers);
    const u64 t = __shfl_sync(KT_FULL_MASK, x, (next - 1) & 31);
    if (next) x += t;
    peers &= ~__ballot_sync(KT_FULL_MASK, rank & 1);
    rank >>= 1;
  }
  return x;
}

__global__ void __cluster_dims__(GS_CLUSTER, 1, 1) __launch_bounds__(GS_NT)
    group_sums(GroupSumArgs a) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  extern __shared__ u64 bins[];
  const i64 nb = a.G + 1;
  const int lane = threadIdx.x & 31;
  const i64 stride = (i64)GS_CLUSTER * GS_NT;
  const i64 warp0 = (i64)rank * GS_NT + (i64)(threadIdx.x >> 5) * 32;
  for (i64 t0 = 0; t0 < nb; t0 += GS_TILE_BINS) {
    const i64 tn = nb - t0 < GS_TILE_BINS ? nb - t0 : GS_TILE_BINS;
    for (i64 i = threadIdx.x; i < tn; i += GS_NT) bins[i] = 0;
    __syncthreads();
    // a warp-uniform loop, so every lane reaches the warp intrinsics
    for (i64 base = warp0; base < a.C; base += stride) {
      const i64 c = base + lane;
      i64 key = -1;  // -1: nothing to add (past C, dropped, other tile)
      u64 v = 0;
      if (c < a.C) {
        const int g = a.group_id[c];
        const i64 gid = g >= 0 ? (i64)g : a.G;
        if (gid <= a.G && gid >= t0 && gid < t0 + tn) {
          key = gid - t0;
          v = (u64)a.cap[c];
        }
      }
      const unsigned peers = __match_any_sync(KT_FULL_MASK, key);
      v = reduce_peers(peers, v);
      if (key >= 0 && lane == __ffs(peers) - 1) atomicAdd(&bins[key], v);
    }
    // every block's bins complete and visible to the cluster
    cluster.sync();
    for (i64 i = (i64)rank * GS_NT + threadIdx.x; i < tn; i += stride) {
      u64 sum = 0;
      for (int r = 0; r < GS_CLUSTER; ++r)
        sum += cluster.map_shared_rank(bins, r)[i];
      a.out[t0 + i] = (i64)sum;
    }
    // no block zeroes its bins (or exits) while another still reads them
    cluster.sync();
  }
}

extern "C" int kt_group_sums(const GroupSumArgs* a, void* stream) {
  if (a->G < 0) return (int)cudaErrorInvalidValue;
  const i64 nb = a->G + 1;
  const size_t smem = (size_t)(nb < GS_TILE_BINS ? nb : GS_TILE_BINS) * 8;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        group_sums, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  group_sums<<<GS_CLUSTER, GS_NT, smem, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}
