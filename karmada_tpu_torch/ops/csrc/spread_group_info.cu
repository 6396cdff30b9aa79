// K5 spread_group_info: phase A of the device spread plane, one thread
// block per spread row.
//
// Replaces karmada_tpu/ops/spread.py: spread_group_info (:222) with
// _group_info_one (:81-158) vmapped over the rows and _spread_planes
// (:166-219).  Per row: the lanes' planes on the fly from the raw-snapshot
// est row of the row's class (rows.cuh), the (group, key) sort
// (spread.cuh), then the segmented prefix walk of group_clusters.go
// :141-333 -- per group the member count, availability and score sums,
// the Duplicated score (members fitting the replicas), and the Divided
// walk: the first sorted position where the running member count reaches
// max(cluster_min, region_min) and the running availability reaches
// ceil(replicas / region_min), with the exhausted-walk branch when no
// position does.  Outputs score_g, avail_g, value_g [B, G] (zeroed by the
// wrapper; a group with no feasible member stays 0) and feas_any [B].
//
// Bound on the card: the sort (log^2 N bitonic passes over the row's
// lanes in shared memory) and the lane planes, each recomputed from est,
// pl_mask, api_ok and the COO entries in four passes; device-memory
// traffic is one read of those rows.  Design: the group axis G is
// unbounded (region or label-value count), so nothing in shared memory is
// sized by it -- each thread walks a contiguous run of sorted positions,
// a segmented carry between runs joins them, and a segment's results are
// written at its first qualifying position (an atomicMin into firstpos)
// and at its end, into [B, G] arrays in device memory.
#include "spread.cuh"

constexpr i64 WEIGHT_UNIT = 1000;

struct SpreadInfoArgs {
  KT_SPREAD_FIELDS
  const i64* region_min;            // [B]
  const i64* cluster_min;           // [B]
  const unsigned char* duplicated;  // [B]
  i64* sort_key;                    // [B, N] device-memory sort path only
  int* sort_idx;                    // [B, N]
  int* sort_gid;                    // [B, N]
  int* firstpos;                    // [B, G], filled with N
  i64* segbuf;                      // [B, G, 4] zeros: score sum, Duplicated
                                    // score, cum score / count at firstpos
  i64* score_g;                     // [B, G] zeros
  i64* avail_g;                     // [B, G] zeros
  i64* value_g;                     // [B, G] zeros
  unsigned char* feas_any;          // [B]
  i64 B, C, Q, Kp, Ke, G, N, smem;
};

// running sums of one segment: members, availability, score, members
// fitting the replicas, and their score
struct Sums {
  i64 cnt, av, sc, nfit, fitsc;
  __device__ void zero() { cnt = av = sc = nfit = fitsc = 0; }
  __device__ void add(const SpreadLane& l, i64 replicas) {
    cnt += 1;
    av += l.avail;
    sc += l.score;
    if (l.avail >= replicas) { nfit += 1; fitsc += l.score; }
  }
  __device__ void add(const Sums& o) {
    cnt += o.cnt; av += o.av; sc += o.sc; nfit += o.nfit; fitsc += o.fitsc;
  }
};

__global__ void __launch_bounds__(NT) spread_group_info_kernel(SpreadInfoArgs a) {
  extern __shared__ __align__(16) char smem_raw[];
  __shared__ i64 red[33];
  __shared__ Sums run_of[NT];       // each thread's run: sums since its last
  __shared__ bool starts_in[NT];    // segment start (whole run if none)
  const i64 b = blockIdx.x;
  const SortBufs s = spread_carve(a, smem_raw, b);
  Row row;
  load_row<NT>(a, b, row, s.pidx, s.pval, s.eidx);
  const bool any = sort_lanes<true>(a, row, s, red);
  if (threadIdx.x == 0) a.feas_any[b] = any;

  const int N = (int)a.N;
  const i64 G = a.G;
  const i64 reps = row.n;
  const i64 rmin = a.region_min[b];
  const i64 target = rmin > 0 ? -floordiv(-reps, maxll(rmin, 1)) : reps;
  const i64 cmin = maxll(a.cluster_min[b], rmin);
  const int per = (N + NT - 1) / NT;
  const int p0 = min((int)threadIdx.x * per, N);
  const int p1 = min(p0 + per, N);
  auto seg_start = [&](int p) { return p == 0 || s.g[p] != s.g[p - 1]; };

  // 1. each thread's run aggregate
  Sums x;
  x.zero();
  bool started = false;
  for (int p = p0; p < p1; ++p) {
    if (seg_start(p)) { started = true; x.zero(); }
    if (s.g[p] < G) x.add(spread_lane(a, row, s.idx[p]), reps);
  }
  run_of[threadIdx.x] = x;
  starts_in[threadIdx.x] = started;
  __syncthreads();
  // 2. segmented exclusive scan over the runs: each run's carry-in
  if (threadIdx.x == 0) {
    Sums carry;
    carry.zero();
    for (int t = 0; t < NT; ++t) {
      const Sums own = run_of[t];
      run_of[t] = carry;
      if (starts_in[t]) carry = own; else carry.add(own);
    }
  }
  __syncthreads();
  const Sums carry_in = run_of[threadIdx.x];

  // 3. the walk: a segment's first qualifying position, and its totals at
  //    its end
  Sums c = carry_in;
  for (int p = p0; p < p1; ++p) {
    if (seg_start(p)) c.zero();
    const i64 g = s.g[p];
    if (g >= G) continue;
    c.add(spread_lane(a, row, s.idx[p]), reps);
    if (c.cnt >= cmin && c.av >= target) atomicMin(&a.firstpos[b * G + g], p);
    if (p == N - 1 || s.g[p + 1] != g) {
      const i64 o = b * G + g;
      a.value_g[o] = c.cnt;
      a.avail_g[o] = c.av;
      a.segbuf[o * 4] = c.sc;
      a.segbuf[o * 4 + 1] =
          c.nfit > 0 ? c.nfit * WEIGHT_UNIT + floordiv(c.fitsc, c.nfit) : 0;
    }
  }
  __syncthreads();
  // 4. the running sums at each segment's first qualifying position
  c = carry_in;
  for (int p = p0; p < p1; ++p) {
    if (seg_start(p)) c.zero();
    const i64 g = s.g[p];
    if (g >= G) continue;
    c.add(spread_lane(a, row, s.idx[p]), reps);
    if (__ldcg(&a.firstpos[b * G + g]) == p) {
      a.segbuf[(b * G + g) * 4 + 2] = c.sc;
      a.segbuf[(b * G + g) * 4 + 3] = c.cnt;
    }
  }
  __syncthreads();
  // 5. the group scores
  const bool dup = a.duplicated[b];
  for (i64 g = threadIdx.x; g < G; g += NT) {
    const i64 o = b * G + g;
    const i64 value = a.value_g[o];
    if (value <= 0) continue;
    const i64* sb = a.segbuf + o * 4;
    i64 score;
    if (dup) {
      score = sb[1];
    } else if (__ldcg(&a.firstpos[o]) < N) {
      score = target * WEIGHT_UNIT + floordiv(sb[2], maxll(sb[3], 1));
    } else {
      // exhausted walk (group_clusters.go:300-308): only insufficient
      // availability demotes the score
      const i64 mean = floordiv(sb[0], maxll(value, 1));
      const i64 avail = a.avail_g[o];
      score = (avail >= target ? target : avail) * WEIGHT_UNIT + mean;
    }
    a.score_g[o] = score;
  }
}

extern "C" int kt_spread_group_info(const SpreadInfoArgs* a, void* stream) {
  return launch_spread(spread_group_info_kernel, a, stream);
}
