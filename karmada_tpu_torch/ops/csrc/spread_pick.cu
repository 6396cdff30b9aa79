// K6 spread_pick: the cluster pick of phase B of the device spread plane,
// one thread block per live spread row.
//
// Replaces karmada_tpu/ops/spread.py: _pick_one (:251-280), vmapped inside
// spread_assign_compact (:289), with the planes of _spread_planes
// (:166-219).  Per row: the lanes' planes on the fly from the raw-snapshot
// est row (rows.cuh), the sort by spread key (spread.cuh), then
// select_clusters_by_region.go:27-118 -- the least-key member of each
// chosen group, and the rest_cnt least-key remaining members of the chosen
// groups counted across groups in global key order, rest_cnt =
// max(min(members, cluster_max) - groups picked, 0).  Writes pick bool
// [B, C] in cluster-lane order on the card: phase B's assignment reads it
// as each row's placement mask, and it never reaches the host.
//
// Bound on the card: the key sort (log^2 N bitonic passes in shared
// memory) and the lane planes; device memory is one read of the rows'
// operands and one write of the pick row.  Design: the first member of
// each chosen group is an atomicMin of its sorted position into firstpos
// [B, G] in device memory (G is unbounded, so shared memory is not sized
// by it); the rest take a block scan over the sorted positions.
#include "spread.cuh"

struct SpreadPickArgs {
  KT_SPREAD_FIELDS
  const unsigned char* chosen;  // [B, G]
  const i64* cluster_max;       // [B]
  i64* sort_key;                // [B, N] device-memory sort path only
  int* sort_idx;                // [B, N]
  int* sort_gid;                // [B, N]
  int* firstpos;                // [B, G], filled with N
  unsigned char* pick;          // [B, C]
  i64 B, C, Q, Kp, Ke, G, N, smem;
};

__global__ void __launch_bounds__(NT) spread_pick_kernel(SpreadPickArgs a) {
  extern __shared__ __align__(16) char smem_raw[];
  __shared__ i64 red[33];
  __shared__ int wsum[NT / 32];
  const i64 b = blockIdx.x;
  const SortBufs s = spread_carve(a, smem_raw, b);
  Row row;
  load_row<NT>(a, b, row, s.pidx, s.pval, s.eidx);
  sort_lanes<false>(a, row, s, red);

  const int N = (int)a.N;
  const i64 G = a.G;
  const unsigned char* chosen = a.chosen + b * G;
  int* first = a.firstpos + b * G;
  auto in_chosen = [&](int p) { return s.g[p] < G && chosen[s.g[p]]; };
  // 1. the first member of each chosen group, in key order
  i64 members = 0;
  for (int p = threadIdx.x; p < N; p += NT) {
    if (in_chosen(p)) {
      ++members;
      atomicMin(&first[s.g[p]], p);
    }
  }
  const i64 total = block_sum<NT>(members, red);
  __syncthreads();
  i64 firsts = 0;
  for (int p = threadIdx.x; p < N; p += NT)
    firsts += in_chosen(p) && __ldcg(&first[s.g[p]]) == p;
  const i64 n_selected = block_sum<NT>(firsts, red);
  const i64 rest = maxll(minll(total, a.cluster_max[b]) - n_selected, 0);
  // 2. the remaining members in key order up to rest, and the pick row
  int seen = 0;
  for (int base = 0; base < N; base += NT) {
    const int p = base + threadIdx.x;
    bool is_first = false, cand = false;
    if (p < N && in_chosen(p)) {
      is_first = __ldcg(&first[s.g[p]]) == p;
      cand = !is_first;
    }
    int n_cand;
    const int pre = block_scan_flag<NT>(cand, wsum, &n_cand);
    if (p < N) {
      const int c = s.idx[p];
      if (c < a.C)
        a.pick[b * a.C + c] = is_first || (cand && seen + pre < rest);
    }
    seen += n_cand;
  }
}

extern "C" int kt_spread_pick(const SpreadPickArgs* a, void* stream) {
  return launch_spread(spread_pick_kernel, a, stream);
}
