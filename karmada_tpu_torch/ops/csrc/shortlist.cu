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
// the capacity proxy by group id into G + 1 buckets (groupless lanes in
// bucket G; ids beyond G dropped, as segment_sum drops them), one thread
// per lane with 64-bit integer atomics -- exact and order-free.  Bound:
// bytes (the two [C] planes read once).
#include "rows.cuh"

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
  block_sort<NT, false, false>(nullptr, mkey, midx, (int)a.nk);
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
  i64* out;             // [G + 1], zeroed by the caller
  i64 C, G;
};

__global__ void group_sums(GroupSumArgs a) {
  const i64 c = (i64)blockIdx.x * NT + threadIdx.x;
  if (c >= a.C) return;
  const int g = a.group_id[c];
  const i64 gid = g >= 0 ? g : a.G;
  if (gid > a.G) return;
  atomicAdd((u64*)&a.out[gid], (u64)a.cap[c]);
}

extern "C" int kt_group_sums(const GroupSumArgs* a, void* stream) {
  if (a->C <= 0) return 0;
  const unsigned blocks = (unsigned)((a->C + NT - 1) / NT);
  group_sums<<<blocks, NT, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}
