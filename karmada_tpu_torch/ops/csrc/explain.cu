// K7 explain_rows: the explain plane of one wave's binding rows, one
// thread block per row, threads over the row's cluster lanes.
//
// Replaces karmada_tpu/ops/solver.py _explain_verdict and _explain_outcome
// as the explain variant of _schedule_core's wave_step calls them (after
// the wave's assignment, against the wave's capacity estimate), and the
// explain tail of karmada_tpu/ops/spread.py spread_assign_compact (the
// SPREAD instantiation).  Per (row, lane) it recomputes the stage
// predicates from the rows.cuh prologue K2 shares (load_row, lane_info):
// toleration, API enablement, eviction, deleting/padding lanes,
// feasibility and previous presence, avail_cal from the est row of the
// row's class (with the MAX_INT32 -> replicas and non-workload shortcut
// substitutions), and reads the row's selection and status from K2's
// dense outputs.  It writes
//   verdict [B, C]  the static placement fail bits | the stage bits
//                   (obs/decisions layout; 0 on invalid rows),
//   score   [B, C]  the locality (+ plugin) score clipped to int32,
//   avail   [B, C]  avail_cal clipped to int32,
//   outcome [B]     status | (1 + dominant lowest-set-bit stage) << 8,
//                   counted over cluster_valid lanes, first maximum wins,
//                   UNSCHEDULABLE always classified as capacity.
// SPREAD (phase B of the spread plane): the fail bits are one row per
// binding (the real placement's, gathered by the caller), est is the raw
// snapshot's, and a lane counts as selected only where the pick AND the
// assignment selected it.
//
// Bound on the card: bytes -- three int32 [B, C] planes written, the
// row's placement planes and est row read; a handful of integer
// operations per lane.  Design: simple and right first -- the nine stage
// counters of a row are per-thread registers summed by block reductions;
// nothing is sorted.
#include "rows.cuh"

constexpr int NT = 256;
constexpr int N_BITS = 9;
constexpr int BIT_CAPACITY = 6;
constexpr int V_API = 1 << 0, V_TOLERATION = 1 << 1, V_EVICTION = 1 << 4,
              V_CAPACITY = 1 << 6, V_NOT_SELECTED = 1 << 7,
              V_CLUSTER_GONE = 1 << 8;
constexpr int STATUS_UNSCHEDULABLE = 2;

struct ExplainArgs {
  const unsigned char* cluster_valid;  // [C]
  const unsigned char* deleting;       // [C]
  const unsigned char* api_ok;         // [G, C]
  const unsigned char* pl_mask;        // [P, C]
  const unsigned char* pl_tol_bypass;  // [P, C]
  const i64* pl_extra_score;           // [P, C]
  const unsigned char* b_valid;        // [B]
  const int* placement_id;             // [B]
  const int* gvk_id;                   // [B]
  const int* class_id;                 // [B]
  const i64* replicas;                 // [B]
  const unsigned char* non_workload;   // [B]
  const unsigned char* nw_shortcut;    // [B]
  const int* prev_idx;                 // [B, Kp]
  const int* prev_val;                 // [B, Kp]
  const int* evict_idx;                // [B, Ke]
  const i64* est;                      // [Q + 1, C]
  const int* fail_bits;                // [P, C]; SPREAD: [B, C]
  const unsigned char* sel;            // [B, C]
  const unsigned char* pick;           // [B, C], SPREAD only
  const int* status;                   // [B]
  int* verdict;                        // [B, C]
  int* score;                          // [B, C]
  int* avail;                          // [B, C]
  int* outcome;                        // [B]
  i64 r0, r1, C, Q, Kp, Ke;
};

template <bool SPREAD>
__global__ void __launch_bounds__(NT) explain_rows(ExplainArgs a) {
  extern __shared__ __align__(16) char smem_raw[];
  __shared__ i64 red[33];
  i64* pval = (i64*)smem_raw;
  int* pidx = (int*)(pval + a.Kp);
  int* eidx = pidx + a.Kp;
  const i64 b = a.r0 + blockIdx.x;
  const i64 C = a.C;
  Row row;
  row.slot = blockIdx.x;
  load_row<NT>(a, b, row, pidx, pval, eidx);
  const bool valid = a.b_valid[b];
  const bool workload = !a.non_workload[b] && !row.nw_shortcut;
  const int st = a.status[b];
  const bool unsched = st == STATUS_UNSCHEDULABLE;
  const bool has_prev = row.n_prev > 0;
  const int* fb = a.fail_bits + (SPREAD ? b : row.pid) * C;
  i64 cnt[N_BITS];
  for (int k = 0; k < N_BITS; ++k) cnt[k] = 0;
  for (i64 c = threadIdx.x; c < C; c += NT) {
    const LaneInfo l = lane_info(a, row, c);
    const i64 pc = row.pid * C + c;
    int v = fb[c];
    if (!(a.pl_tol_bypass[pc] || l.pp)) v |= V_TOLERATION;
    if (!(a.api_ok[row.gvk * C + c] || l.pp)) v |= V_API;
    if (l.ev) v |= V_EVICTION;
    if (!(a.cluster_valid[c] && !a.deleting[c])) v |= V_CLUSTER_GONE;
    if ((l.ac <= 0 || (unsched && l.feas)) && workload) v |= V_CAPACITY;
    bool sl = a.sel[b * C + c];
    if (SPREAD) sl = sl && a.pick[b * C + c];
    if (l.feas && !sl && !unsched) v |= V_NOT_SELECTED;
    if (!valid) v = 0;
    const i64 sc = ((has_prev && l.pp) ? 100 : 0) + a.pl_extra_score[pc];
    a.verdict[b * C + c] = v;
    a.score[b * C + c] = (int)clampll(sc, 0, KT_MAX_INT32);
    a.avail[b * C + c] = (int)clampll(l.ac, 0, KT_MAX_INT32);
    if (a.cluster_valid[c] && v != 0) {
      const int low = __ffs(v) - 1;  // the lowest set bit
      for (int k = 0; k < N_BITS; ++k) cnt[k] += low == k;
    }
  }
  i64 best = 0;
  int dom = 0;
  for (int k = 0; k < N_BITS; ++k) {
    const i64 t = block_sum<NT>(cnt[k], red);
    if (t > best) { best = t; dom = k; }  // argmax: the first maximum
  }
  if (threadIdx.x == 0) {
    int code = best > 0 ? dom + 1 : 0;
    if (unsched) code = BIT_CAPACITY + 1;
    a.outcome[b] = st | (code << 8);
  }
}

template <bool SPREAD>
int launch(const ExplainArgs* a, void* stream) {
  const i64 rows = a->r1 - a->r0;
  if (rows <= 0) return 0;
  const size_t smem = (size_t)a->Kp * 12 + (size_t)a->Ke * 4;
  cudaError_t e = cudaFuncSetAttribute(
      explain_rows<SPREAD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  explain_rows<SPREAD>
      <<<(unsigned)rows, NT, smem, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

extern "C" int kt_explain_rows(const ExplainArgs* a, void* stream) {
  return launch<false>(a, stream);
}

extern "C" int kt_explain_rows_spread(const ExplainArgs* a, void* stream) {
  return launch<true>(a, stream);
}
