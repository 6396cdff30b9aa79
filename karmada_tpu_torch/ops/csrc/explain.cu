// K7 explain_rows: the explain plane of one wave's binding rows, one
// thread block per row, threads over the row's cluster lanes.
//
// Replaces karmada_tpu/ops/solver.py _explain_verdict and _explain_outcome
// as the explain variant of _schedule_core's wave_step calls them (after
// the wave's assignment, against the wave's capacity estimate), and the
// explain tail of karmada_tpu/ops/spread.py spread_assign_compact (the
// SPREAD instantiation).  Per (row, lane) it recomputes the stage
// predicates K2 computes (rows.cuh): toleration, API enablement,
// eviction, deleting/padding lanes, feasibility and previous presence,
// avail_cal from the est row of the row's class (with the MAX_INT32 ->
// replicas and non-workload shortcut substitutions), and reads the row's
// selection and status from K2's dense outputs.  It writes
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
// Bound on the card: bytes -- three int32 [B, C] planes written (50 MB
// at 512 x 8,192), the row's placement planes and est row read; a handful
// of integer operations per lane.  Design, for that bound:
//   * prev and evict membership from shared-memory bitmaps of the row's
//     COO entries (rows.cuh row_bits, BITS_TILE lanes at a time): a lane
//     costs two bit tests, not a loop over the row's entries (K7 reads
//     only membership, never the prev sum, so a bitmap is exact);
//   * four consecutive lanes a thread: 4-byte loads of the byte planes,
//     16-byte loads of fail_bits and est (and the extra scores, read only
//     with use_extra: the wrapper's promise that they are not all 0),
//     16-byte streaming stores of the three planes (the host reads them
//     later): the wrapper refuses a C that is not a multiple of 4 or a
//     plane off a 16-byte boundary (the encoder pads C to a power of two
//     >= 8 and the planes are fresh allocations);
//   * the nine stage counters as 7-bit fields of one 64-bit word a thread
//     (flushed to int32 registers every 16 steps), reduced by warp
//     reductions and one shared-memory pass: one block barrier per row.
#include "rows.cuh"

constexpr int NT = 256;
constexpr int MIN_BLOCKS = 4;
constexpr int N_BITS = 9;
constexpr int BIT_CAPACITY = 6;
constexpr int V_API = 1 << 0, V_TOLERATION = 1 << 1, V_EVICTION = 1 << 4,
              V_CAPACITY = 1 << 6, V_NOT_SELECTED = 1 << 7,
              V_CLUSTER_GONE = 1 << 8;
constexpr int STATUS_UNSCHEDULABLE = 2;
// lanes of one pair of row_bits bitmaps (8 KB of shared memory)
constexpr int BITS_TILE = 32768;
constexpr int BITS_WORDS = BITS_TILE / 32;
// counter steps (4 lanes each) between flushes of the 7-bit fields
constexpr int FLUSH_STEPS = 16;
static_assert(4 * FLUSH_STEPS < 128, "a 7-bit field holds a flush's lanes");

// Field order: kernels.ExplainArgs (tests/test_torch_rows_args.py holds
// the two against each other).
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
  i64 use_extra;  // 0: the extra scores are all 0 and not read
};

// What one row's lanes read besides their own operands.
struct RowPlanes7 {
  const unsigned char *mask, *tol, *api, *sel, *pick;
  const int* fb;
  const i64 *est, *extra;
  int *verdict, *score, *avail;
  i64 n;
  bool valid, workload, unsched, has_prev, nw_shortcut;
};

// One lane's verdict (returned), score and avail, from its operands and
// its prev / evict bits: the first design's lane_info arithmetic.
__device__ __forceinline__ int lane_verdict(const RowPlanes7& r, bool cv,
                                            bool del, bool mask, bool tol,
                                            bool api, bool sl, int fb,
                                            i64 est, i64 xs, bool pp,
                                            bool ev, int* score, int* avail) {
  i64 ac = est == KT_MAX_INT32 ? r.n : est;
  if (r.nw_shortcut) ac = KT_MAX_INT32;
  const bool feas = cv & !del & mask & (tol | pp) & (api | pp) & !ev;
  int v = fb;
  if (!(tol | pp)) v |= V_TOLERATION;
  if (!(api | pp)) v |= V_API;
  if (ev) v |= V_EVICTION;
  if (!(cv & !del)) v |= V_CLUSTER_GONE;
  if (((ac <= 0) | (r.unsched & feas)) & r.workload) v |= V_CAPACITY;
  if (feas & !sl & !r.unsched) v |= V_NOT_SELECTED;
  if (!r.valid) v = 0;
  *score = (int)clampll(((r.has_prev & pp) ? 100 : 0) + xs, 0,
                        KT_MAX_INT32);
  *avail = (int)clampll(ac, 0, KT_MAX_INT32);
  return v;
}

// The lane's contribution to the stage counters: one in the 7-bit field
// of its verdict's lowest set bit, on cluster_valid lanes (a lowest bit
// past the nine stages counts nowhere).
__device__ __forceinline__ u64 count_field(bool cv, int v) {
  const int low = __ffs(v) - 1;
  return (cv && low >= 0 && low < N_BITS) ? 1ULL << (7 * low) : 0ULL;
}

__device__ __forceinline__ void flush(u64& acc, int* cnt) {
#pragma unroll
  for (int k = 0; k < N_BITS; ++k) cnt[k] += (int)((acc >> (7 * k)) & 127);
  acc = 0;
}

// Lanes [t0, t1) of the row, four consecutive lanes a thread a step (the
// wrapper's promise: t0, t1 and C multiples of 4, every plane 16-byte
// aligned); pb / eb: the tile's prev / evict bitmaps (row_bits).
template <bool SPREAD>
__device__ __forceinline__ void lanes(const ExplainArgs& a,
                                          const RowPlanes7& r,
                                          const unsigned* pb,
                                          const unsigned* eb, i64 t0,
                                          i64 t1, int* cnt) {
  u64 acc = 0;
  int steps = 0;
  for (i64 c = t0 + 4 * threadIdx.x; c < t1; c += 4 * NT) {
    const uchar4 cv = *(const uchar4*)(a.cluster_valid + c);
    const uchar4 del = *(const uchar4*)(a.deleting + c);
    const uchar4 mk = *(const uchar4*)(r.mask + c);
    const uchar4 tl = *(const uchar4*)(r.tol + c);
    const uchar4 ap = *(const uchar4*)(r.api + c);
    uchar4 sl = __ldcs((const uchar4*)(r.sel + c));
    if (SPREAD) {
      const uchar4 pk = __ldcs((const uchar4*)(r.pick + c));
      sl.x &= pk.x; sl.y &= pk.y; sl.z &= pk.z; sl.w &= pk.w;
    }
    const int4 fb = *(const int4*)(r.fb + c);
    const longlong2 e0 = *(const longlong2*)(r.est + c);
    const longlong2 e1 = *(const longlong2*)(r.est + c + 2);
    longlong2 x0 = make_longlong2(0, 0), x1 = x0;
    if (r.extra != nullptr) {
      x0 = *(const longlong2*)(r.extra + c);
      x1 = *(const longlong2*)(r.extra + c + 2);
    }
    const int i = (int)(c - t0);
    const unsigned pw = (pb[i >> 5] >> (i & 31)) & 15u;
    const unsigned ew = (eb[i >> 5] >> (i & 31)) & 15u;
    int4 v, sc, av;
    v.x = lane_verdict(r, cv.x, del.x, mk.x, tl.x, ap.x, sl.x, fb.x, e0.x,
                       x0.x, pw & 1, ew & 1, &sc.x, &av.x);
    v.y = lane_verdict(r, cv.y, del.y, mk.y, tl.y, ap.y, sl.y, fb.y, e0.y,
                       x0.y, pw & 2, ew & 2, &sc.y, &av.y);
    v.z = lane_verdict(r, cv.z, del.z, mk.z, tl.z, ap.z, sl.z, fb.z, e1.x,
                       x1.x, pw & 4, ew & 4, &sc.z, &av.z);
    v.w = lane_verdict(r, cv.w, del.w, mk.w, tl.w, ap.w, sl.w, fb.w, e1.y,
                       x1.y, pw & 8, ew & 8, &sc.w, &av.w);
    __stcs((int4*)(r.verdict + c), v);
    __stcs((int4*)(r.score + c), sc);
    __stcs((int4*)(r.avail + c), av);
    acc += count_field(cv.x, v.x) + count_field(cv.y, v.y) +
           count_field(cv.z, v.z) + count_field(cv.w, v.w);
    if (++steps == FLUSH_STEPS) {
      flush(acc, cnt);
      steps = 0;
    }
  }
  flush(acc, cnt);
}

// clock64 points of a -DKT_PROFILE build (tools/kernel_probe.py k7): 0
// the row's start, 1 load_row done, 2 the first tile's bitmaps built, 3
// every lane written, 4 the outcome written
template <bool SPREAD>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
    explain_rows(const __grid_constant__ ExplainArgs a) {
  extern __shared__ __align__(16) char smem_raw[];
  __shared__ unsigned bits[2 * BITS_WORDS];
  __shared__ int wcnt[NT / 32][N_BITS];
  KT_MARK(0);
  i64* pval = (i64*)smem_raw;
  int* pidx = (int*)(pval + a.Kp);
  int* eidx = pidx + a.Kp;
  const i64 b = a.r0 + blockIdx.x;
  const i64 C = a.C;
  Row row;
  row.slot = blockIdx.x;
  load_row<NT>(a, b, row, pidx, pval, eidx);
  KT_MARK(1);
  const int st = a.status[b];
  RowPlanes7 r;
  r.mask = a.pl_mask + row.pid * C;
  r.tol = a.pl_tol_bypass + row.pid * C;
  r.api = a.api_ok + row.gvk * C;
  r.sel = a.sel + b * C;
  r.pick = SPREAD ? a.pick + b * C : nullptr;
  r.fb = a.fail_bits + (SPREAD ? b : row.pid) * C;
  r.est = a.est + row.cid * C;
  r.extra = a.use_extra ? a.pl_extra_score + row.pid * C : nullptr;
  r.verdict = a.verdict + b * C;
  r.score = a.score + b * C;
  r.avail = a.avail + b * C;
  r.n = row.n;
  r.valid = a.b_valid[b];
  r.workload = !a.non_workload[b] && !row.nw_shortcut;
  r.unsched = st == STATUS_UNSCHEDULABLE;
  r.has_prev = row.n_prev > 0;
  r.nw_shortcut = row.nw_shortcut;
  int cnt[N_BITS];
#pragma unroll
  for (int k = 0; k < N_BITS; ++k) cnt[k] = 0;
  for (i64 t0 = 0; t0 < C; t0 += BITS_TILE) {
    const i64 t1 = minll(C, t0 + BITS_TILE);
    const int words = (int)((t1 - t0 + 31) / 32);
    if (t0 > 0) __syncthreads();  // the previous tile's bits are read
    row_bits<NT>(row, t0, words, bits);
    if (t0 == 0) KT_MARK(2);
    lanes<SPREAD>(a, r, bits, bits + words, t0, t1, cnt);
  }
  KT_MARK(3);
  // the row's counters: warp sums, then one pass of warp 0 over them
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < N_BITS; ++k) {
    const int t = (int)__reduce_add_sync(KT_FULL_MASK, (unsigned)cnt[k]);
    if (lane == 0) wcnt[wid][k] = t;
  }
  __syncthreads();
  if (wid == 0) {
    unsigned tot = 0;
    if (lane < N_BITS)
      for (int w = 0; w < NT / 32; ++w) tot += (unsigned)wcnt[w][lane];
    const unsigned best = __reduce_max_sync(KT_FULL_MASK, tot);
    // argmax: the first maximum
    const int dom = __ffs(__ballot_sync(KT_FULL_MASK,
                                        lane < N_BITS && tot == best)) - 1;
    if (lane == 0) {
      int code = best > 0 ? dom + 1 : 0;
      if (r.unsched) code = BIT_CAPACITY + 1;
      a.outcome[b] = st | (code << 8);
    }
  }
  KT_MARK(4);
}

// The dynamic shared memory (load_row's COO entries) a launch needs,
// allowed once per device and size whatever the size (the block's static
// bitmaps count against the default 48 KB too): a `static` in this
// library (not an inline in a shared header, whose one copy every library
// including it would share).
template <bool SPREAD>
static int allow_smem(size_t smem) {
  constexpr int MAX_DEVICES = 64;
  static size_t allowed[MAX_DEVICES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (smem <= allowed[dev]) return 0;
  e = cudaFuncSetAttribute(explain_rows<SPREAD>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  allowed[dev] = smem;
  return 0;
}

template <bool SPREAD>
int launch(const ExplainArgs* a, void* stream) {
  const i64 rows = a->r1 - a->r0;
  if (rows <= 0) return 0;
  const size_t smem = (size_t)a->Kp * 12 + (size_t)a->Ke * 4;
  const int e = allow_smem<SPREAD>(smem);
  if (e != 0) return e;
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
