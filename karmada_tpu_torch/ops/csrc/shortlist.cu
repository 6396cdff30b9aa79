// K8 shortlist_topk and K9 group_sums: the tier-1 kernels of the
// hierarchical two-tier solve (ops/shortlist).
//
// K8 replaces karmada_tpu/ops/shortlist.py _shortlist_core (jitted as
// shortlist_topk), its capacity estimate included: one launch per call,
// one profile row (a distinct (placement, GVK, request class) of the
// chunk) per thread block cluster of TK_CLUSTER blocks.  A lane's key is
//   prev bit << 60 | clip(avail, 0, 2^34-1) << 26 | group pref << 21
//   | (2^21 - 1 - name_rank)
// where the lane is eligible (feasible or previously assigned, on a valid
// row), else -1; avail is the row's class capacity on the raw snapshot
// (_capacity_estimates with the override rows, no used triple: row Q for
// class -1, MAX_INT32 read as the row's replicas), computed here per
// eligible lane -- no est plane, no K1 launch.  The keys of a row's
// eligible lanes are distinct (the lane sits in the low 21 bits), so the
// k largest sorted descending are exactly lax.top_k's first k entries;
// every other slot is -1, and fcount is the eligible-lane count.
//
// Design (Hopper): the row's lanes split into TK_CLUSTER slices, one a
// block, so a chunk's 8-16 rows use ~64-128 of the 132 SMs where one
// block a row used 8-16.
//   1. lane pass: each block keys its slice and appends the eligible
//      (key, lane) pairs to its buffer (shared memory while a slice fits
//      TK_SLICE_SMEM lanes, else a [B, C] device-memory scratch); its
//      count and the OR / AND of its keys meet the other blocks' through
//      distributed shared memory, so every block knows fcount and the
//      bits all eligible keys share.
//   2. select: fcount <= k (the main path: 50 eligible lanes a row) takes
//      every pair.  Otherwise a radix select over the cluster, from the
//      highest bit that varies, 8 bits a pass: each block histograms its
//      survivors, the blocks sum the TK_CLUSTER histograms through
//      distributed shared memory (two buffers, one cluster barrier a
//      pass), find the same boundary digit, send the pairs above it to
//      the leader and compact the boundary digit's pairs in place, so a
//      pass reads only the previous pass's survivors.  It ends when the
//      boundary digit completes k.
//   3. members: each block appends its members (exactly min(k, fcount)
//      in all) to the leader block's buffer by warp-aggregated atomics on
//      the leader's count; after a cluster barrier the leader sorts them
//      (bitonic, rows.cuh block_sort, next power of two >= the count) and
//      writes cand and fcount.  The others have exited: nothing reads
//      their shared memory after that barrier.
// Bound on the card: bytes -- the placement planes, the [C] and [C, R]
// snapshot planes, the override rows of the rows' classes and group_pref
// read once per row, the [B, k] candidates written; the capacity's int64
// divisions run only on eligible lanes.
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

constexpr int GROUP_BITS = 5;
constexpr int TK_NT = 256;        // threads a block: one per histogram bin
constexpr int TK_CLUSTER = 8;     // blocks a row (ops/kernels.py TOPK_CLUSTER)
constexpr int TK_IT = 8;          // survivors a thread holds per chunk
constexpr int TK_LN = 4;          // lanes a thread keys per step
constexpr i64 TK_SLICE_SMEM = 8192;  // lanes a block keeps in shared memory
static_assert(TK_NT == 256 && TK_CLUSTER <= 32,
              "one thread a histogram bin, a warp reads the blocks");

struct TopkArgs {
  const unsigned char* cluster_valid;  // [C]
  const unsigned char* deleting;       // [C]
  const i64* name_rank;                // [C]
  const unsigned char* api_ok;         // [G, C]
  const unsigned char* pl_mask;        // [P, C]
  const unsigned char* pl_tol_bypass;  // [P, C]
  const i64* pods_allowed;             // [C]
  const unsigned char* has_summary;    // [C]
  const i64* avail_milli;              // [C, R]
  const unsigned char* has_alloc;      // [C, R]
  const i64* req_milli;                // [Q, R]
  const unsigned char* req_is_cpu;     // [R]
  const i64* req_pods;                 // [Q]
  const i64* est_override;             // [Q, C]
  const unsigned char* b_valid;        // [B]
  const int* placement_id;             // [B]
  const int* gvk_id;                   // [B]
  const int* class_id;                 // [B]
  const i64* replicas;                 // [B]
  const int* prev_idx;                 // [B, Kp]
  const int* evict_idx;                // [B, Ke]
  const i64* group_pref;               // [C]
  i64* skey;                           // [B, C] pairs when !smem
  int* slane;                          // [B, C]
  int* cand;                           // [B, k]
  int* fcount;                         // [B]
  i64 B, C, Q, R, Kp, Ke, k, nk, smem;  // nk: power of two >= k
};

// The capacity of class cid (Q: the no-requirements row) on lane c of the
// raw snapshot: ops/solver.py capacity_plain with a zero used triple.
// avail > 0 makes the non-cpu ceil and the floor divisions C's `/`.
__device__ __forceinline__ i64 lane_capacity(const TopkArgs& a, i64 cid,
                                             i64 c) {
  if (cid < a.Q) {
    const i64 ovr = a.est_override[cid * a.C + c];
    if (ovr >= 0) return ovr;
  }
  const i64 pods = a.pods_allowed[c];
  if (!a.has_summary[c] || pods <= 0) return 0;
  if (cid == a.Q) return minll(pods, KT_MAX_INT32);
  i64 est = pods / maxll(a.req_pods[cid], 1);
  for (i64 r = 0; r < a.R; ++r) {
    const i64 req = a.req_milli[cid * a.R + r];
    if (req <= 0) continue;  // unrequested resources are inert
    const i64 av = a.avail_milli[c * a.R + r];
    i64 cnt = 0;
    if (a.has_alloc[c * a.R + r] && av > 0) {
      const i64 unit = a.req_is_cpu[r] ? av : av / 1000 + (av % 1000 != 0);
      cnt = unit / req;
    }
    est = minll(est, cnt);
  }
  return minll(est, KT_MAX_INT32);
}

// Append (key, lane) where `take` holds, warp-aggregated: one atomic on
// *count a warp; pairs past `cap` are dropped (distinct keys never reach
// it).  Every lane of the warp calls.  `count`, `keys`, `lanes` may be
// another block's shared memory (distributed shared memory).
__device__ __forceinline__ void append_pair(bool take, i64 key, int lane_c,
                                            int* count, i64* keys,
                                            int* lanes, i64 cap) {
  const unsigned bal = __ballot_sync(KT_FULL_MASK, take);
  if (!bal) return;
  const int lane = threadIdx.x & 31, first = __ffs(bal) - 1;
  int base = 0;
  if (lane == first) base = atomicAdd(count, __popc(bal));
  base = __shfl_sync(KT_FULL_MASK, base, first);
  const int pos = base + __popc(bal & ((1u << lane) - 1u));
  if (take && pos < cap) {
    keys[pos] = key;
    lanes[pos] = lane_c;
  }
}

__global__ void __cluster_dims__(TK_CLUSTER, 1, 1) __launch_bounds__(TK_NT)
    shortlist_topk(TopkArgs a) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const i64 b = blockIdx.x / TK_CLUSTER;
  const i64 C = a.C;
  const i64 per = (C + TK_CLUSTER - 1) / TK_CLUSTER;
  const i64 c0 = minll(C, rank * per), c1 = minll(C, c0 + per);
  // dynamic: the leader's members (fkey holds -key), this block's slice
  // pairs (when smem), the row's prev and evict lanes
  extern __shared__ __align__(16) char smem_raw[];
  i64* fkey = (i64*)smem_raw;
  i64* skey = fkey + a.nk;
  int* flane = (int*)(skey + (a.smem ? per : 0));
  int* slane = flane + a.nk;
  int* pidx = slane + (a.smem ? per : 0);
  int* eidx = pidx + a.Kp;
  __shared__ int hist[2][256];
  __shared__ int gh[256];
  __shared__ u64 w_or[TK_NT / 32], w_and[TK_NT / 32];
  __shared__ u64 st_or, st_and, g_or, g_and;
  __shared__ int st_n, g_n, f_n, n_keep, n_prev, n_evict;
  __shared__ int sel_d, sel_cum, sel_exact;
  KT_MARK(0);
  i64* keys = a.smem ? skey : a.skey + b * C + c0;
  int* lanes = a.smem ? slane : a.slane + b * C + c0;
  const bool valid = a.b_valid[b];
  const i64 pid = a.placement_id[b], gvk = a.gvk_id[b];
  const i64 cid = a.class_id[b] >= 0 ? a.class_id[b] : a.Q;
  const i64 n = a.replicas[b];
  if (tid == 0) { n_prev = 0; n_evict = 0; st_n = 0; f_n = 0; }
  __syncthreads();
  for (i64 j = tid; j < a.Kp; j += TK_NT) {
    const int c = a.prev_idx[b * a.Kp + j];
    if (c >= 0) pidx[atomicAdd(&n_prev, 1)] = c;
  }
  for (i64 j = tid; j < a.Ke; j += TK_NT) {
    const int c = a.evict_idx[b * a.Ke + j];
    if (c >= 0) eidx[atomicAdd(&n_evict, 1)] = c;
  }
  __syncthreads();
  const int np = n_prev, ne = n_evict;

  // 1. lane pass: the slice's eligible pairs, their count, OR and AND.
  // TK_LN lanes a thread a step, every operand load of the step issued
  // before any is used (no short circuit): the pass is load latency
  u64 my_or = 0, my_and = ~0ULL;
  if (valid) {
    for (i64 base = c0; base < c1; base += TK_NT * TK_LN) {  // uniform
      unsigned char cv[TK_LN], dl[TK_LN], pm[TK_LN], tb[TK_LN], ap[TK_LN];
#pragma unroll
      for (int u = 0; u < TK_LN; ++u) {
        const i64 c = base + u * TK_NT + tid;
        const i64 cc = c < c1 ? c : c0;  // a lane of the slice
        cv[u] = a.cluster_valid[cc];
        dl[u] = a.deleting[cc];
        pm[u] = a.pl_mask[pid * C + cc];
        tb[u] = a.pl_tol_bypass[pid * C + cc];
        ap[u] = a.api_ok[gvk * C + cc];
      }
#pragma unroll
      for (int u = 0; u < TK_LN; ++u) {
        const i64 c = base + u * TK_NT + tid;
        bool pp = false, ev = false;
        for (int e = 0; e < np; ++e) pp |= pidx[e] == c;
        for (int e = 0; e < ne; ++e) ev |= eidx[e] == c;
        const bool feas = cv[u] & !dl[u] & pm[u] & (tb[u] | pp) &
                          (ap[u] | pp) & !ev;
        const bool el = c < c1 && (feas || pp);
        i64 key = 0;
        if (el) {
          const i64 est = lane_capacity(a, cid, c);
          const i64 av =
              clampll(est == KT_MAX_INT32 ? n : est, 0, AVAIL_CAP);
          key = shl(pp ? 1 : 0, AVAIL_BITS + GROUP_BITS + LANE_BITS) |
                shl(av, GROUP_BITS + LANE_BITS) |
                shl(a.group_pref[c], LANE_BITS) |
                (LANE_MASK - a.name_rank[c]);
          my_or |= (u64)key;
          my_and &= (u64)key;
        }
        append_pair(el, key, (int)c, &st_n, keys, lanes, per);
      }
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    my_or |= __shfl_xor_sync(KT_FULL_MASK, my_or, o);
    my_and &= __shfl_xor_sync(KT_FULL_MASK, my_and, o);
  }
  if ((tid & 31) == 0) { w_or[tid >> 5] = my_or; w_and[tid >> 5] = my_and; }
  __syncthreads();
  if (tid == 0) {
    u64 o = 0, an = ~0ULL;
    for (int w = 0; w < TK_NT / 32; ++w) { o |= w_or[w]; an &= w_and[w]; }
    st_or = o;
    st_and = an;
  }
  // every block's count, OR and AND (and the leader's zero member count),
  // read by one thread a block and reduced in the warp
  cluster.sync();
  if (tid < 32) {
    u64 o = 0, an = ~0ULL;
    int cnt = 0;
    if (tid < TK_CLUSTER) {
      o = *cluster.map_shared_rank(&st_or, tid);
      an = *cluster.map_shared_rank(&st_and, tid);
      cnt = *cluster.map_shared_rank(&st_n, tid);
    }
    for (int off = 16; off > 0; off >>= 1) {
      o |= __shfl_xor_sync(KT_FULL_MASK, o, off);
      an &= __shfl_xor_sync(KT_FULL_MASK, an, off);
      cnt += __shfl_xor_sync(KT_FULL_MASK, cnt, off);
    }
    if (tid == 0) {
      g_or = o;
      g_and = an;
      g_n = cnt;
    }
  }
  __syncthreads();
  KT_MARK(1);
  const int total = g_n, ns0 = st_n;
  int* lead_n = cluster.map_shared_rank(&f_n, 0);
  i64* lead_key = cluster.map_shared_rank(fkey, 0);
  int* lead_lane = cluster.map_shared_rank(flane, 0);
  const i64 k = a.k;

  // one pass over this block's pairs [0, ns): with emit, the pairs whose
  // digit at ps is above pd (or, with ge, at least pd; every pair when
  // ps < 0) go to the leader; with keep, those equal to pd stay
  // (compacted in place); with hs >= 0 the staying pairs' digit at hs
  // (every pair's when ps < 0) is counted into hb.  A chunk
  // of TK_NT * TK_IT pairs is loaded before any of it is written back,
  // and a chunk's writes land below its end, so no pair is overwritten
  // before it is read.
  auto pass = [&](int ns, int ps, int pd, bool ge, bool emit, bool keep,
                  int hs, int* hb) {
    for (int base = 0; base < ns; base += TK_NT * TK_IT) {
      i64 kk[TK_IT];
      int ll[TK_IT];
#pragma unroll
      for (int j = 0; j < TK_IT; ++j) {
        const int i = base + j * TK_NT + tid;
        kk[j] = i < ns ? keys[i] : -1;
        ll[j] = i < ns ? lanes[i] : 0;
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < TK_IT; ++j) {
        const bool in = kk[j] >= 0;
        const int dp = ps >= 0 ? (int)((kk[j] >> ps) & 255) : 0;
        const bool mem =
            emit && in && (ps < 0 || dp > pd || (ge && dp == pd));
        const bool stay = in && keep && ps >= 0 && dp == pd;
        append_pair(mem, -kk[j], ll[j], lead_n, lead_key, lead_lane, a.nk);
        if (keep && ps >= 0)
          append_pair(stay, kk[j], ll[j], &n_keep, keys, lanes, per);
        if (hs >= 0 && in && (ps < 0 || stay))
          atomicAdd(&hb[(kk[j] >> hs) & 255], 1);
      }
    }
  };

  // 2. select
  if (total <= k) {
    pass(ns0, -1, 0, false, true, false, -1, nullptr);  // every pair
  } else {
    const u64 diff = g_or ^ g_and;  // != 0: more than k distinct keys
    const int top = 63 - __clzll((i64)diff);
    int s = top > 7 ? top - 7 : 0, ps = -1, pd = 0, cur = 0, rem = (int)k;
    int ns = ns0;
    while (true) {
      hist[cur][tid] = 0;
      if (tid == 0) n_keep = 0;
      __syncthreads();
      // classify against the previous digit (members out, equals kept),
      // histogram the kept pairs' digit at s
      pass(ns, ps, pd, false, ps >= 0, ps >= 0, s, hist[cur]);
      __syncthreads();
      if (ps >= 0) ns = n_keep;
      cluster.sync();  // every block's histogram of this pass
      int g = 0;
      for (int r = 0; r < TK_CLUSTER; ++r)
        g += cluster.map_shared_rank(hist[cur], r)[tid];
      gh[tid] = g;
      __syncthreads();
      if (tid < 32) {
        // lane l holds digits 255 - 8l down to 248 - 8l
        const int lane = tid;
        int loc = 0;
        for (int j = 0; j < 8; ++j) loc += gh[255 - 8 * lane - j];
        int incl = loc;
        for (int o = 1; o < 32; o <<= 1) {
          const int t = __shfl_up_sync(KT_FULL_MASK, incl, o);
          if (lane >= o) incl += t;
        }
        const unsigned hit = __ballot_sync(KT_FULL_MASK, incl >= rem);
        if (lane == __ffs(hit) - 1) {
          int cum = incl - loc;
          for (int j = 0; j < 8; ++j) {
            const int d = 255 - 8 * lane - j, h = gh[d];
            if (cum + h >= rem) {
              sel_d = d;
              sel_cum = cum;
              sel_exact = cum + h == rem || s == 0;
              break;
            }
            cum += h;
          }
        }
      }
      __syncthreads();
      const int d = sel_d;
      if (sel_exact) {
        pass(ns, s, d, true, true, false, -1, nullptr);  // digit >= d
        break;
      }
      rem -= sel_cum;
      ps = s;
      pd = d;
      s = s >= 8 ? s - 8 : 0;
      cur ^= 1;
    }
  }
  KT_MARK(2);
  // 3. every member in the leader's buffer
  cluster.sync();
  KT_MARK(3);
  if (rank != 0) {
    KT_MARK(4);
    KT_MARK(5);
    return;
  }
  const int m = min(f_n, (int)k);  // min(k, fcount) for distinct keys
  int N = 1;
  while (N < m) N <<= 1;
  for (int i = m + tid; i < N; i += TK_NT) {
    fkey[i] = KT_MAX_INT64;
    flane[i] = (int)(C + i);
  }
  __syncthreads();
  block_sort<TK_NT>(fkey, flane, N);
  KT_MARK(4);
  for (i64 j = tid; j < k; j += TK_NT)
    a.cand[b * k + j] = j < m ? flane[j] : -1;
  if (tid == 0) a.fcount[b] = total;
  KT_MARK(5);
}

extern "C" int kt_shortlist_topk(const TopkArgs* a, void* stream) {
  if (a->B <= 0) return 0;
  const i64 per = (a->C + TK_CLUSTER - 1) / TK_CLUSTER;
  if (a->smem && per > TK_SLICE_SMEM) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)a->nk * 12 + (a->smem ? (size_t)per * 12 : 0) +
                      (size_t)(a->Kp + a->Ke) * 4;
  cudaError_t e = cudaFuncSetAttribute(
      shortlist_topk, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  shortlist_topk<<<(unsigned)(a->B * TK_CLUSTER), TK_NT, smem,
                   (cudaStream_t)stream>>>(*a);
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
