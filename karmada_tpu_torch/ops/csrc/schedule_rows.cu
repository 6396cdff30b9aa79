// K2 schedule_rows: one wave's binding rows, one thread block per row, on
// either lane tier.
//
// Replaces karmada_tpu/ops/solver.py: _schedule_one with _gather_lanes,
// _assign_lanes, _select_by_cluster, _locality_score and webster_divide
// (vmapped over the wave's rows), the per-row prologue of wave_step
// (feasibility, avail_cal, the prev/evict COO scatter; rows.cuh) and its
// consumption charge (used += max(rep - prev, 0) per resource, pod and
// class) -- for the std lane tier (_TIERS["std"]) and the big one
// (_TIERS["big"], the ROUTE_DEVICE_BIG / SPREAD_BIG sub-solves).
//
// Per row:
//   1. scalars, and the row's prev/evict COO entries into shared memory
//      (no dense [B, C] prev/evict planes);
//   2. the lane set: every lane when C <= DIRECT_MAX (528 std, 4224 big),
//      else the union of top-G_PREV by prev key and top-G_TOPK by each of
//      three (four with plugin scores) packed keys (16 / 128 std, 128 /
//      1024 big), each group's members as lax.top_k finds them.  Works for
//      any C up to 2^21.  Neither tier keeps a key in device memory: the
//      select (select_lanes) recomputes every lane's keys (lane_planes,
//      rows.cuh lane_info's result) on each pass over C -- from the wave's
//      est row, the [P, C] and [C] planes and the row's COO entries, which
//      every row of the wave shares in L2 -- and narrows each group by a
//      radix select with filtering: one pass counts each group's keys and
//      reduces their OR and AND (the bits above the highest one that
//      varies are common), a histogram pass per 8-bit digit below it until
//      the boundary bucket holds at most SEL_SHARE keys, one pass that
//      collects that bucket into shared memory where the group's threshold
//      is found, a fill scan for groups short of k, and one pass for the
//      ordered union (membership words by warp ballot);
//   3. the lane math on those lanes (<= LMAX: 656 std, 5248 big): locality
//      score, selection by packed key (bitonic sort of (key, lane) pairs =
//      a stable argsort) and the capacity swap loop, strategy and mode,
//      Aggregated capacity-descending prefix (sort + scan); the row's
//      Webster problem (ranks densified in rank_eff order) goes to device
//      memory;
//   -- K4 webster_batch (webster.cuh) solves every row's problem --
//   4. schedule_rows_finish: the dense rep/sel row (wide Duplicated /
//      selection formulas over all lanes, then the gathered lanes) and
//      status, and the row's new consumption added into used_* with 64-bit
//      integer atomics (exact and order-free).  Lane feasibility is
//      recomputed with lane_planes (est is fixed for the wave and
//      lane_planes reads no used_*).
//
// One C call a launch slice (kt_schedule_rows_wave, and its big twin)
// enqueues the slice's work on one stream from one argument block: with
// fill_est first K1 (capacity.cuh) into est -- the wave's capacity from
// the block's snapshot and used_* pointers -- then the prepare kernel, K4
// (webster.cuh) on the rows' Webster problems, and the finish kernel.
// The wrapper sets fill_est on a wave's first launch slice only, so a wave
// launched in slices (the big tier's `work` bound) reads the est of the
// wave's start in every slice, as the JAX program's wave does, though
// each slice's finish charges used_*.  The argument block's per-slice
// buffers (web_*, wk_*, seats, the s0 zero plane, K4's wide-row scratch,
// the big tier's `work`) belong to one chunk's waves, which run in order
// on one stream.
//
// Bound on the card: at 4096 x 8192 the dense output (rep int64 + sel)
// dominates the bytes; the bisections of Webster and the sorts are
// block-local operations.  Design: one block per row keeps every row's
// control flow independent (rows diverge in strategy and loop counts).
// The std tier keeps a row's lane working set and sort buffer in shared
// memory, 48 KB a block at Kp = Ke = 4 (work_bytes(656) 35,424 B, of
// which the select's histograms and candidates borrow 15,360 B before
// the lane math runs, and sort_bytes 12,352 B), so four blocks fit on an
// SM and a 512-row wave runs in one round.  The big tier's working set
// (~283 KB at 5,248 lanes) exceeds a block's 227 KB, so it lives in a
// per-row scratch in device memory (`work`; at sub-batch row counts it
// stays in L2), and shared memory holds the (key, lane) sort buffer
// (8,192 entries, 96 KB), whose key half lends the select its histograms
// and candidates until the first sort, and the COO entries.
#define KT_PROF_SLOTS 16
#include <atomic>

#include "capacity.cuh"
#include "rows.cuh"
#include "webster.cuh"

constexpr int NG_MAX = 5;
constexpr int STRAT_DUPLICATED = 0, STRAT_STATIC = 1, STRAT_DYNAMIC = 2,
              STRAT_AGGREGATED = 3;
constexpr int STATUS_OK = 0, STATUS_FIT_ERROR = 1, STATUS_UNSCHEDULABLE = 2,
              STATUS_NO_CLUSTER = 3;

// gather geometry per lane tier (solver.py TIERS): LMAX = G_PREV + 5 *
// G_TOPK gathered lanes at most, SORTN a power of two >= LMAX; WORK_SMEM:
// the lane working set in shared memory (else the device-memory `work`
// scratch); NT: threads a row; MIN_BLOCKS: blocks an SM must hold at once;
// BITS_LANES: up to this many lanes the passes over C find a lane's prev
// and evict entries in shared-memory bitmaps of the row's COO entries
// (rows.cuh row_bits; else by a loop over the entries -- the std tier's
// rows hold at most 16 prev entries, the big tier's up to 128)
template <int G_PREV_, int G_TOPK_, int DIRECT_MAX_, bool WORK_SMEM_,
          int NT_, int MIN_BLOCKS_, int BITS_LANES_>
struct Tier {
  static constexpr int G_PREV = G_PREV_;
  static constexpr int G_TOPK = G_TOPK_;
  static constexpr int DIRECT_MAX = DIRECT_MAX_;
  static constexpr int LMAX = G_PREV_ + NG_MAX * G_TOPK_;
  static constexpr int SORTN = LMAX <= 1024 ? 1024 : 8192;
  static constexpr bool WORK_SMEM = WORK_SMEM_;
  static constexpr int NT = NT_;
  static constexpr int MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr int BITS_LANES = BITS_LANES_;
};
using TierStd = Tier<16, 128, 528, true, 256, 4, 0>;
using TierBig = Tier<128, 1024, 4224, false, 1024, 1, 1 << 18>;
static_assert(TierStd::LMAX == 656 && TierBig::LMAX == 5248, "lane geometry");
static_assert(TierBig::SORTN >= TierBig::LMAX, "sort buffer");

// candidates one group of select_lanes holds in shared memory
constexpr int SEL_SHARE = 256;

struct RowsArgs {
  const unsigned char* cluster_valid;  // [C]
  const unsigned char* deleting;       // [C]
  const i64* name_rank;                // [C]
  const unsigned char* api_ok;         // [G, C]
  const i64* req_milli;                // [Q, R]
  const unsigned char* req_is_cpu;     // [R]
  const i64* req_pods;                 // [Q]
  const unsigned char* pl_mask;        // [P, C]
  const unsigned char* pl_tol_bypass;  // [P, C]
  const int* pl_strategy;              // [P]
  const i64* pl_static_w;              // [P, C]
  const unsigned char* pl_has_cluster_sc;  // [P]
  const int* pl_sc_min;                // [P]
  const int* pl_sc_max;                // [P]
  const unsigned char* pl_ignore_avail;  // [P]
  const i64* pl_extra_score;           // [P, C]
  const unsigned char* b_valid;        // [B]
  const int* placement_id;             // [B]
  const int* gvk_id;                   // [B]
  const int* class_id;                 // [B]
  const i64* replicas;                 // [B]
  const unsigned char* uid_desc;       // [B]
  const unsigned char* fresh;          // [B]
  const unsigned char* non_workload;   // [B]
  const unsigned char* nw_shortcut;    // [B]
  const int* prev_idx;                 // [B, Kp]
  const int* prev_val;                 // [B, Kp]
  const int* evict_idx;                // [B, Ke]
  // the snapshot K1 reads (fill_est)
  const i64* avail_milli;              // [C, R]
  const unsigned char* has_alloc;      // [C, R]
  const i64* pods_allowed;             // [C]
  const unsigned char* has_summary;    // [C]
  const i64* est_override;             // [Q, C]
  const i64* est;                      // [Q + 1, C]
  i64* used_milli;                     // [C, R]
  i64* used_pods;                      // [C]
  i64* used_sets;                      // [Q, C]
  i64* rep;                            // [B, C]
  unsigned char* sel;                  // [B, C]
  int* status;                         // [B]
  char* work;                          // [rows, work_bytes] big tier only
  // per-row work of one launch slice ([rows] / [rows, LMAX]): the Webster
  // problems K4 solves (s0: zeros), its seats and wide-row scratch, and
  // what the finish step needs
  i64* web_n;
  i64* web_w;
  const i64* web_s0;
  unsigned char* web_active;
  i64* web_rank;
  i64* seats;
  unsigned char* web_scratch;          // null unless LMAX > KT_SMEM_LANES
  int* wk_lane;
  i64* wk_base;
  i64* wk_prev;
  unsigned char* wk_sel;
  unsigned char* wk_feas;
  int* wk_U;
  int* wk_flags;
  // fill_est: the wave entry first enqueues K1 into est (the wave's
  // capacity from the snapshot minus used_*), once before a wave's first
  // launch slice
  i64 r0, r1, C, Q, R, Kp, Ke, use_extra, charge, fill_est;
};

constexpr int FLAG_OK = 1 << 8, FLAG_SEATS = 1 << 9, FLAG_DUP_WIDE = 1 << 10,
              FLAG_HAS_SC = 1 << 11, FLAG_VALID = 1 << 12;

// one row's working memory: the lane arrays (`work`: shared memory on the
// std tier, device memory on the big tier) and the sort buffer and COO
// entries (`sort`: always shared memory).  The select's histograms and
// candidates borrow shared memory that is idle until the lane math: the
// int64 lane arrays on the std tier, the sort buffer's keys on the big
// tier (the gather precedes both).  Lane ids, positions and ranks are
// int32 (< 2^21 lanes).
struct Smem {
  i64 *avail_cal, *prev_rep, *w, *skey, *pval, *cand;
  int *nr, *rank_w, *rest_pos, *lane, *pos, *order, *sidx, *pidx, *eidx,
      *hist;
  unsigned char *feas, *pp, *sel, *in_sel, *active, *inc;
  unsigned* bits;  // plane_bits' bitmaps after the COO entries, or null
};

__host__ __device__ inline size_t work_bytes(int lmax) {
  return ((size_t)3 * lmax * 8 + (size_t)6 * lmax * 4 + (size_t)6 * lmax +
          15) / 16 * 16;
}

__host__ __device__ inline size_t sort_bytes(int sortn, i64 Kp, i64 Ke) {
  return (size_t)(sortn + Kp) * 8 + (size_t)(sortn + Kp + Ke) * 4;
}

// the plane_bits bitmaps' bytes for C lanes on tier T (0: none)
template <class T>
__host__ __device__ inline size_t bits_bytes(i64 C) {
  return C > T::DIRECT_MAX && C <= T::BITS_LANES ? (size_t)(C + 31) / 32 * 8
                                                 : 0;
}

// the select's histograms and candidates
constexpr size_t SEL_BYTES =
    (size_t)NG_MAX * 256 * 4 + (size_t)NG_MAX * SEL_SHARE * 8;
static_assert(SEL_BYTES <= (size_t)3 * TierStd::LMAX * 8,
              "the std select's histograms and candidates fit the lane arrays");
static_assert(SEL_BYTES <= (size_t)TierBig::SORTN * 8,
              "the big select's histograms and candidates fit the sort keys");
static_assert(TierStd::NT <= NG_MAX * 256 && TierBig::NT <= NG_MAX * 256,
              "the union's membership words fit the histograms");

template <class T>
__device__ inline Smem carve(char* work, char* sort, i64 Kp, i64 Ke,
                            i64 C) {
  constexpr int lmax = T::LMAX, sortn = T::SORTN;
  Smem s;
  i64* p = (i64*)work;
  s.avail_cal = p; p += lmax;
  s.prev_rep = p; p += lmax;
  s.w = p; p += lmax;
  int* q = (int*)p;
  s.nr = q; q += lmax;
  s.rank_w = q; q += lmax;
  s.rest_pos = q; q += lmax;
  s.lane = q; q += lmax;
  s.pos = q; q += lmax;
  s.order = q; q += lmax;
  unsigned char* u = (unsigned char*)q;
  s.feas = u; u += lmax;
  s.pp = u; u += lmax;
  s.sel = u; u += lmax;
  s.in_sel = u; u += lmax;
  s.active = u; u += lmax;
  s.inc = u; u += lmax;
  p = (i64*)sort;
  s.skey = p; p += sortn;
  s.pval = p; p += Kp;
  q = (int*)p;
  s.sidx = q; q += sortn;
  s.pidx = q; q += Kp;
  s.eidx = q; q += Ke;
  s.bits = bits_bytes<T>(C) ? (unsigned*)q : nullptr;
  char* sel = T::WORK_SMEM ? work : (char*)s.skey;
  s.hist = (int*)sel;
  s.cand = (i64*)(sel + NG_MAX * 256 * 4);
  return s;
}

// Stable ascending argsort of key(0..U) (ties by lane index; rows.cuh
// block_sort): pos[i] is lane i's rank, order[p] the lane at rank p.
// U <= the tier's SORTN.
template <int NT, class K>
__device__ void block_argsort(int U, Smem& s, K key) {
  int N = 2;
  while (N < U) N <<= 1;
  for (int i = threadIdx.x; i < N; i += NT) {
    s.skey[i] = i < U ? key(i) : KT_MAX_INT64;
    s.sidx[i] = i;
  }
  __syncthreads();
  block_sort<NT>(s.skey, s.sidx, N);
  for (int p = threadIdx.x; p < U; p += NT) {
    s.order[p] = s.sidx[p];
    s.pos[s.sidx[p]] = p;
  }
  __syncthreads();
}

__device__ __forceinline__ i64 rank_eff_of(const RowsArgs& a, const Row& row,
                                           i64 c) {
  const i64 nr = a.name_rank[c];
  return row.uid_desc ? a.C - 1 - nr : nr;
}

// One row's [P, C], [G, C] and [Q + 1, C] plane rows, for the passes over
// every lane (lane_planes, lane_keys), and its plane_bits bitmaps (pbits,
// ebits; null: none)
struct RowPlanes {
  const unsigned char *mask, *tol, *api;
  const i64 *est, *static_w, *extra;
  const unsigned *pbits, *ebits;
};

__device__ __forceinline__ RowPlanes row_planes(const RowsArgs& a,
                                                const Row& row) {
  const i64 pc = row.pid * a.C;
  return {a.pl_mask + pc, a.pl_tol_bypass + pc, a.api_ok + row.gvk * a.C,
          a.est + row.cid * a.C, a.pl_static_w + pc, a.pl_extra_score + pc,
          nullptr, nullptr};
}

// The row's prev and evict bitmaps over all its C lanes (rows.cuh
// row_bits; `bits`: 2 * ceil(C / 32) words of shared memory), into P;
// every thread of the block calls.
template <int NT>
__device__ void plane_bits(const Row& row, i64 C, unsigned* bits,
                           RowPlanes& P) {
  const int words = (int)((C + 31) / 32);
  row_bits<NT>(row, 0, words, bits);
  P.pbits = bits;
  P.ebits = bits + words;
}

// rows.cuh lane_info for the passes over C, with the same result: every
// load issued up front, on no condition but the row's, and the
// feasibility test without short circuits, so a lane costs one round
// trip to L2, not one per test.  *nr receives the lane's name rank, *sw
// its static weight on a StaticWeight row (else 0).
__device__ __forceinline__ LaneInfo lane_planes(const RowsArgs& a,
                                             const Row& row,
                                             const RowPlanes& P, int c,
                                             i64* nr, i64* sw) {
  const bool valid = a.cluster_valid[c], del = a.deleting[c];
  const bool mask = P.mask[c], tol = P.tol[c], api = P.api[c];
  const i64 est_b = P.est[c];
  *nr = a.name_rank[c];
  *sw = row.strategy == STRAT_STATIC ? P.static_w[c] : 0;
  LaneInfo l;
  l.pr = 0;
  if (P.pbits != nullptr) {
    // the entries' lanes from the bitmaps; a prev lane sums its entries
    l.pp = (P.pbits[c >> 5] >> (c & 31)) & 1u;
    l.ev = (P.ebits[c >> 5] >> (c & 31)) & 1u;
    if (l.pp)
      for (int e = 0; e < row.n_prev; ++e)
        if (row.pidx[e] == c) l.pr += row.pval[e];
  } else {
    l.pp = false;
    for (int e = 0; e < row.n_prev; ++e)
      if (row.pidx[e] == c) { l.pp = true; l.pr += row.pval[e]; }
    l.ev = false;
    for (int e = 0; e < row.n_evict; ++e) l.ev |= row.eidx[e] == c;
  }
  l.ac = est_b == KT_MAX_INT32 ? row.n : est_b;
  if (row.nw_shortcut) l.ac = KT_MAX_INT32;
  l.feas = valid & !del & mask & (tol | l.pp) & (api | l.pp) & !l.ev;
  return l;
}

// Every group's packed gather key of lane c at once (k[g], g < ng; the
// rest untouched; -1: ineligible), from lane_planes: JAX _gather_lanes'
// keys.
__device__ __forceinline__ void lane_keys(const RowsArgs& a, const Row& row,
                                          const RowPlanes& P, bool has_prev,
                                          int ng, int c, i64* k) {
  i64 nr, sw;
  const LaneInfo l = lane_planes(a, row, P, c, &nr, &sw);
  const i64 xs = ng > 4 ? P.extra[c] : 0;
  const i64 avail_sel = l.ac + (l.pp ? l.pr : 0);
  const i64 by_name = LANE_MASK - nr;
  k[0] = l.pp ? by_name : -1;
  const i64 wg = row.strategy == STRAT_STATIC ? sw : avail_sel;
  const i64 wq = shl(clampll(wg, 0, AVAIL_CAP), LANE_BITS);
  const i64 aq = shl(clampll(avail_sel, 0, AVAIL_CAP), LANE_BITS);
  k[1] = l.feas ? wq | (LANE_MASK - (row.uid_desc ? a.C - 1 - nr : nr)) : -1;
  k[2] = l.feas ? wq | by_name : -1;
  k[3] = l.feas ? aq | by_name : -1;
  if (ng > 4) {
    const i64 score = ((has_prev && l.pp) ? 100 : 0) + xs;
    k[4] = l.feas ? shl(clampll(score, 0, 255), AVAIL_BITS + LANE_BITS) |
                        aq | by_name
                  : -1;
  }
}

// f(k) with the keys k (lane_keys) of every lane c < C, the block's NT
// threads striding over the lanes two at a time: a thread computes both
// lanes' keys before either call, so the loads of two lanes are in flight
// together.
template <int NT, class F>
__device__ __forceinline__ void for_lane_keys(const RowsArgs& a,
                                              const Row& row,
                                              const RowPlanes& P,
                                              bool has_prev, int ng, F f) {
  const int C = (int)a.C;
  for (int c = threadIdx.x; c < C; c += 2 * NT) {
    const int c1 = c + NT;
    i64 k0[NG_MAX], k1[NG_MAX];
    lane_keys(a, row, P, has_prev, ng, c, k0);
    if (c1 < C) lane_keys(a, row, P, has_prev, ng, c1, k1);
    f(k0);
    if (c1 < C) f(k1);
  }
}

// the select's per-group state (select_lanes)
constexpr int SEL_DONE = 0, SEL_FILL = 1, SEL_REFINE = 2, SEL_COLLECT = 3;

// Step 2 of the gather path: the union of the groups' top-k lanes into
// s.lane (ascending); returns its size.  lax.top_k's index sets without a
// key in device memory: a group's threshold thr[g] is its kg-th largest
// key, found by narrowing a prefix `pre` of the key's bits above `shift`
// (the candidates: eligible keys that share it) until at most SEL_SHARE
// candidates remain, which one more pass collects into shared memory.  A
// group with at most kg eligible keys takes them all (thr 0) and, short
// of kg, the lowest-index -1 lanes up to cut[g] (lax.top_k's tie order).
// Non-negative keys of one group are distinct (their low 21 bits hold the
// lane's rank), so every candidate set holds the threshold once.
template <class T>
__device__ int select_lanes(const RowsArgs& a, const Row& row, Smem& s,
                            int* wsum) {
  constexpr int G_PREV = T::G_PREV, G_TOPK = T::G_TOPK, NT = T::NT;
  const int ng = a.use_extra ? 5 : 4;
  const bool has_prev = row.n_prev > 0;
  RowPlanes P = row_planes(a, row);
  if (s.bits != nullptr) plane_bits<NT>(row, a.C, s.bits, P);
  const int C = (int)a.C;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  __shared__ int cnt[NG_MAX], rem[NG_MAX], shift[NG_MAX], state[NG_MAX],
      ccount[NG_MAX];
  __shared__ u64 kor[NG_MAX], kand[NG_MAX], pre[NG_MAX];
  __shared__ i64 thr[NG_MAX], cut[NG_MAX];
  if (threadIdx.x < NG_MAX) {
    cnt[threadIdx.x] = 0;
    kor[threadIdx.x] = 0;
    kand[threadIdx.x] = ~0ULL;
  }
  __syncthreads();
  // pass 1: each group's eligible count, and the OR / AND of its keys
  {
    int my_cnt[NG_MAX] = {0, 0, 0, 0, 0};
    u64 my_or[NG_MAX] = {0, 0, 0, 0, 0};
    u64 my_and[NG_MAX] = {~0ULL, ~0ULL, ~0ULL, ~0ULL, ~0ULL};
    for_lane_keys<NT>(a, row, P, has_prev, ng, [&](const i64* k) {
#pragma unroll
      for (int g = 0; g < NG_MAX; ++g)
        if (g < ng && k[g] >= 0) {
          ++my_cnt[g];
          my_or[g] |= (u64)k[g];
          my_and[g] &= (u64)k[g];
        }
    });
#pragma unroll
    for (int g = 0; g < NG_MAX; ++g) {
      if (g >= ng) break;
      for (int o = 16; o > 0; o >>= 1) {
        my_cnt[g] += __shfl_xor_sync(KT_FULL_MASK, my_cnt[g], o);
        my_or[g] |= __shfl_xor_sync(KT_FULL_MASK, my_or[g], o);
        my_and[g] &= __shfl_xor_sync(KT_FULL_MASK, my_and[g], o);
      }
      if (lane == 0 && my_cnt[g] > 0) {
        atomicAdd(&cnt[g], my_cnt[g]);
        atomicOr((unsigned long long*)&kor[g], my_or[g]);
        atomicAnd((unsigned long long*)&kand[g], my_and[g]);
      }
    }
  }
  __syncthreads();
  KT_MARK(1);
  if (threadIdx.x < ng) {
    const int g = threadIdx.x;
    const int kg = g == 0 ? G_PREV : G_TOPK;
    thr[g] = 0;
    cut[g] = -1;
    rem[g] = kg;
    if (cnt[g] > kg) {
      // the bits above the highest one that varies are common to all
      const u64 diff = kor[g] ^ kand[g];
      const int sh = diff ? 64 - __clzll((long long)diff) : 0;
      shift[g] = sh;
      pre[g] = sh ? kand[g] & ~((1ULL << sh) - 1) : kand[g];
      state[g] = (cnt[g] <= SEL_SHARE || sh == 0) ? SEL_COLLECT : SEL_REFINE;
    } else {
      state[g] = cnt[g] < kg ? SEL_FILL : SEL_DONE;
    }
  }
  __syncthreads();
  int* hist = s.hist;
  // histogram passes: each refining group takes the next digit (up to 8
  // bits) below its prefix
  for (;;) {
    bool refine[NG_MAX];
    bool any = false;
#pragma unroll
    for (int g = 0; g < NG_MAX; ++g) {
      refine[g] = g < ng && state[g] == SEL_REFINE;
      any |= refine[g];
    }
    if (!any) break;
    int sh[NG_MAX], lo[NG_MAX];
    u64 pf[NG_MAX];
#pragma unroll
    for (int g = 0; g < NG_MAX; ++g) {
      sh[g] = refine[g] ? shift[g] : 0;
      lo[g] = sh[g] > 8 ? sh[g] - 8 : 0;
      pf[g] = refine[g] ? pre[g] >> sh[g] : 0;
    }
    for (int i = threadIdx.x; i < ng * 256; i += NT)
      if (refine[i >> 8]) hist[i] = 0;
    __syncthreads();
    for_lane_keys<NT>(a, row, P, has_prev, ng, [&](const i64* k) {
#pragma unroll
      for (int g = 0; g < NG_MAX; ++g)
        if (refine[g] && k[g] >= 0 && ((u64)k[g] >> sh[g]) == pf[g])
          atomicAdd(&hist[g * 256 + (int)(((u64)k[g] >> lo[g]) &
                                          ((1u << (sh[g] - lo[g])) - 1u))],
                    1);
    });
    __syncthreads();
    // warp g walks group g's bins from the top: lane j holds bins
    // 8j..8j+7; the bin where the count from the top reaches rem[g]
    if (wid < ng && refine[wid]) {
      const int g = wid;
      int loc[8], sum = 0;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        loc[q] = hist[g * 256 + lane * 8 + q];
        sum += loc[q];
      }
      int incl = sum;  // bins at and above this lane's
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_down_sync(KT_FULL_MASK, incl, o);
        if (lane + o < 32) incl += t;
      }
      const int r = rem[g];
      int above = incl - sum;
      if (above < r && r <= incl) {
        for (int q = 7; q >= 0; --q) {
          if (above + loc[q] >= r) {
            rem[g] = r - above;
            pre[g] |= (u64)(lane * 8 + q) << lo[g];
            shift[g] = lo[g];
            state[g] = (loc[q] <= SEL_SHARE || lo[g] == 0) ? SEL_COLLECT
                                                           : SEL_REFINE;
            break;
          }
          above += loc[q];
        }
      }
    }
    __syncthreads();
  }
  KT_MARK(2);
  // the collect pass: each selecting group's candidates into shared
  // memory, then the one with rem[g] - 1 larger candidates is thr[g]
  bool coll[NG_MAX];
  bool any_coll = false;
#pragma unroll
  for (int g = 0; g < NG_MAX; ++g) {
    coll[g] = g < ng && state[g] == SEL_COLLECT;
    any_coll |= coll[g];
  }
  if (any_coll) {
    int sh[NG_MAX];
    u64 pf[NG_MAX];
#pragma unroll
    for (int g = 0; g < NG_MAX; ++g) {
      sh[g] = coll[g] ? shift[g] : 0;
      pf[g] = coll[g] ? pre[g] >> sh[g] : 0;
    }
    if (threadIdx.x < NG_MAX) ccount[threadIdx.x] = 0;
    __syncthreads();
    i64* cand = s.cand;
    for_lane_keys<NT>(a, row, P, has_prev, ng, [&](const i64* k) {
#pragma unroll
      for (int g = 0; g < NG_MAX; ++g)
        if (coll[g] && k[g] >= 0 && ((u64)k[g] >> sh[g]) == pf[g]) {
          const int at = atomicAdd(&ccount[g], 1);
          if (at < SEL_SHARE) cand[g * SEL_SHARE + at] = k[g];
        }
    });
    __syncthreads();
    for (int i = threadIdx.x; i < ng * SEL_SHARE; i += NT) {
      const int g = i / SEL_SHARE;
      const int m = min(ccount[g], SEL_SHARE);
      if (!coll[g] || i - g * SEL_SHARE >= m) continue;
      const i64 k = cand[i];
      int larger = 0;
      for (int j = 0; j < m; ++j) larger += cand[g * SEL_SHARE + j] > k;
      if (larger == rem[g] - 1) thr[g] = k;
    }
  }
  KT_MARK(3);
  // the fill: lax.top_k takes the lowest-index -1 lanes of a group short
  // of kg; the scan stops once every such group has its cut
  {
    int need[NG_MAX], seen[NG_MAX];
    bool open = false;
#pragma unroll
    for (int g = 0; g < NG_MAX; ++g) {
      need[g] = (g < ng && state[g] == SEL_FILL)
                    ? (g == 0 ? G_PREV : G_TOPK) - cnt[g] : 0;
      seen[g] = 0;
      open |= need[g] > 0;
    }
    for (i64 base = 0; open && base < a.C; base += NT) {
      const i64 c = base + threadIdx.x;
      i64 k[NG_MAX] = {0, 0, 0, 0, 0};
      if (c < a.C) lane_keys(a, row, P, has_prev, ng, (int)c, k);
      open = false;
#pragma unroll
      for (int g = 0; g < NG_MAX; ++g) {
        if (seen[g] >= need[g]) continue;
        const bool f = c < a.C && k[g] == -1;
        int total;
        const int p = block_scan_flag<NT>(f, wsum, &total);
        if (f && seen[g] + p + 1 == need[g]) cut[g] = c;
        seen[g] += total;
        open |= seen[g] < need[g];
      }
    }
  }
  __syncthreads();
  KT_MARK(4);
  // ordered union of the members, NT * 32 lanes a chunk: warp ballots
  // give one membership word per 32 consecutive lanes (word t: lanes
  // base + 32t ..), then one scan over the words places each word's lanes
  auto member = [&](int c) -> bool {
    if (c >= C) return false;
    i64 k[NG_MAX];
    lane_keys(a, row, P, has_prev, ng, c, k);
    bool m = false;
#pragma unroll
    for (int g = 0; g < NG_MAX; ++g)
      if (g < ng) m |= k[g] >= 0 ? k[g] >= thr[g] : c <= cut[g];
    return m;
  };
  __shared__ i64 ubuf[33];
  __shared__ int utotal;
  unsigned* words = (unsigned*)hist;  // NT words; the histograms are done
  int U = 0;
  for (int base = 0; base < C; base += NT * 32) {
    __syncthreads();
    for (int q = 0; q < 32; q += 2) {
      const int c0 = base + q * NT + (int)threadIdx.x, c1 = c0 + NT;
      const bool m0 = member(c0), m1 = member(c1);
      const unsigned w0 = __ballot_sync(KT_FULL_MASK, m0);
      const unsigned w1 = __ballot_sync(KT_FULL_MASK, m1);
      if (lane == 0) {
        words[q * (NT / 32) + wid] = w0;
        words[(q + 1) * (NT / 32) + wid] = w1;
      }
    }
    __syncthreads();
    unsigned w = words[threadIdx.x];
    const int n_w = __popc(w);
    int at = U + (int)block_scan_excl<NT>(n_w, ubuf);
    if (threadIdx.x == NT - 1) utotal = at - U + n_w;
    for (; w; w &= w - 1) s.lane[at++] = base + 32 * threadIdx.x + __ffs(w) - 1;
    __syncthreads();
    U += utotal;
  }
  __syncthreads();
  return U;
}

// Steps 1-3: the row's lane set and lane math up to its Webster problem
// (web_*), plus what step 4 needs (wk_*).
template <class T>
__global__ void __launch_bounds__(T::NT, T::MIN_BLOCKS)
    schedule_rows_prepare(RowsArgs a) {
  constexpr int LMAX = T::LMAX, NT = T::NT;
  extern __shared__ __align__(16) char smem_raw[];
  __shared__ i64 red[33];
  __shared__ int wsum[NT / 32];
  const i64 slot = blockIdx.x;
  Smem s = carve<T>(
      T::WORK_SMEM ? smem_raw : a.work + slot * work_bytes(LMAX),
      T::WORK_SMEM ? smem_raw + work_bytes(LMAX) : smem_raw, a.Kp, a.Ke,
      a.C);
  Row row;
  row.slot = slot;
  const i64 b = a.r0 + slot;
  const i64 C = a.C;
  if (!a.b_valid[b]) {
    // host-owned / padding rows: no Webster problem, finish writes zeros
    const i64 wo = row.slot * LMAX;
    for (int i = threadIdx.x; i < LMAX; i += NT) {
      a.web_w[wo + i] = 0;
      a.web_active[wo + i] = 0;
      a.web_rank[wo + i] = i;
    }
    if (threadIdx.x == 0) { a.web_n[row.slot] = 0; a.wk_flags[row.slot] = 0; }
    return;
  }
  // 1. the row's scalars and prev / evict COO entries
  load_row<NT>(a, b, row, s.pidx, s.pval, s.eidx);
  KT_MARK(0);
  row.strategy = a.pl_strategy[row.pid];
  row.has_sc = a.pl_has_cluster_sc[row.pid];
  row.sc_min = a.pl_sc_min[row.pid];
  row.sc_max = a.pl_sc_max[row.pid];
  row.ignore = a.pl_ignore_avail[row.pid];
  row.uid_desc = a.uid_desc[b];
  row.fresh = a.fresh[b];
  row.nw = a.non_workload[b];

  // 2. the lane set
  const bool direct = C <= T::DIRECT_MAX;
  int U;
  if (direct) {
    U = (int)C;
    for (int i = threadIdx.x; i < U; i += NT) s.lane[i] = i;
    __syncthreads();
  } else {
    U = select_lanes<T>(a, row, s, wsum);
  }
  KT_MARK(5);
  for (int i = threadIdx.x; i < U; i += NT) {
    const i64 c = s.lane[i];
    const LaneInfo l = lane_info(a, row, c);
    s.feas[i] = l.feas;
    s.pp[i] = l.pp;
    s.prev_rep[i] = l.pr;
    s.avail_cal[i] = l.ac;
    s.nr[i] = (int)a.name_rank[c];
  }
  __syncthreads();
  KT_MARK(6);
  // the lanes' ranks, densified in rank_eff order
  block_argsort<NT>(U, s,
                    [&](int i) { return rank_eff_of(a, row, s.lane[i]); });
  for (int i = threadIdx.x; i < U; i += NT) s.rank_w[i] = s.pos[i];
  __syncthreads();
  KT_MARK(7);
  // what the lane math reads and the working set does not keep
  auto avail = [&](int i) -> i64 {
    return s.avail_cal[i] + (s.pp[i] ? s.prev_rep[i] : 0);
  };
  auto static_w = [&](int i) -> i64 {
    return a.pl_static_w[row.pid * C + s.lane[i]];
  };

  // 3. the lane math (JAX _assign_lanes)
  i64 t_fc = 0, t_pp = 0;
  for (int i = threadIdx.x; i < U; i += NT) { t_fc += s.feas[i]; t_pp += s.pp[i]; }
  const i64 fcount = block_sum<NT>(t_fc, red);
  const bool has_prev = block_sum<NT>(t_pp, red) > 0;
  bool unsched_sel = false;
  if (row.has_sc) {
    // selection by cluster: packed key (score desc, avail desc, name asc)
    block_argsort<NT>(U, s, [&](int i) -> i64 {
      if (!s.feas[i]) return KT_MAX_INT64;
      const i64 score = ((has_prev && s.pp[i]) ? 100 : 0) +
                        a.pl_extra_score[row.pid * C + s.lane[i]];
      const i64 ac = clampll(avail(i), 0, AVAIL_CAP);
      return shl(200 - score, AVAIL_BITS + LANE_BITS) |
             shl(AVAIL_CAP - ac, LANE_BITS) | s.nr[i];
    });
    KT_MARK(8);
    const i64 need = minll(row.sc_max, fcount);
    for (int i = threadIdx.x; i < U; i += NT) {
      s.in_sel[i] = s.feas[i] && s.pos[i] < need;
      s.rest_pos[i] = s.pos[i];
    }
    __syncthreads();
    auto total_sel = [&]() -> i64 {
      i64 t = 0;
      for (int i = threadIdx.x; i < U; i += NT) t += s.in_sel[i] ? avail(i) : 0;
      return block_sum<NT>(t, red);
    };
    if (!row.ignore) {
      __shared__ i64 wbest[NT / 32];
      __shared__ int ibest[NT / 32];
      for (i64 update_id = need - 1;; --update_id) {
        if (!(total_sel() < row.n && update_id >= 0)) break;
        const int cur = s.order[update_id];
        // argmax of the candidate key, first index on ties
        i64 bv = -2;
        int bi = 0x7fffffff;
        for (int i = threadIdx.x; i < U; i += NT) {
          const i64 cand =
              (s.feas[i] && !s.in_sel[i])
                  ? (shl(clampll(avail(i), 0, AVAIL_CAP), LANE_BITS) |
                     (LANE_MASK - clampll(s.rest_pos[i], 0, LANE_MASK)))
                  : -1;
          if (cand > bv) { bv = cand; bi = i; }
        }
        for (int o = 16; o > 0; o >>= 1) {
          const i64 ov = __shfl_down_sync(KT_FULL_MASK, bv, o);
          const int oi = __shfl_down_sync(KT_FULL_MASK, bi, o);
          if (ov > bv || (ov == bv && oi < bi)) { bv = ov; bi = oi; }
        }
        if ((threadIdx.x & 31) == 0) {
          wbest[threadIdx.x >> 5] = bv;
          ibest[threadIdx.x >> 5] = bi;
        }
        __syncthreads();
        if (threadIdx.x == 0) {
          for (int wi = 1; wi < NT / 32; ++wi)
            if (wbest[wi] > bv || (wbest[wi] == bv && ibest[wi] < bi)) {
              bv = wbest[wi];
              bi = ibest[wi];
            }
          if (bv >= 0 && avail(bi) > avail(cur)) {
            s.in_sel[bi] = 1;
            s.in_sel[cur] = 0;
            s.rest_pos[cur] = s.rest_pos[bi];
          }
        }
        __syncthreads();
      }
    }
    KT_MARK(9);
    const i64 tot = total_sel();
    unsched_sel = fcount < row.sc_min || (!row.ignore && tot < row.n);
    for (int i = threadIdx.x; i < U; i += NT) s.sel[i] = s.in_sel[i];
  } else {
    for (int i = threadIdx.x; i < U; i += NT) s.sel[i] = s.feas[i];
  }
  __syncthreads();
  i64 t_sc = 0, t_as = 0;
  for (int i = threadIdx.x; i < U; i += NT) {
    t_sc += s.sel[i];
    t_as += (s.sel[i] && s.pp[i]) ? s.prev_rep[i] : 0;
  }
  const i64 sel_count = block_sum<NT>(t_sc, red);
  const i64 assigned = block_sum<NT>(t_as, red);
  const i64 n = row.n;
  const bool is_dynamic =
      row.strategy == STRAT_DYNAMIC || row.strategy == STRAT_AGGREGATED;
  const bool scale_down = is_dynamic && !row.fresh && assigned > n;
  const bool scale_up = is_dynamic && !row.fresh && assigned < n;
  const bool steady_eq = is_dynamic && !row.fresh && assigned == n;
  const bool is_fresh = is_dynamic && row.fresh;
  const bool is_static = row.strategy == STRAT_STATIC;
  bool static_pos = false;
  if (is_static) {
    i64 t = 0;
    for (int i = threadIdx.x; i < U; i += NT) t += static_w(i) * s.sel[i];
    static_pos = block_sum<NT>(t, red) > 0;
  }
  i64 t_w = 0;
  for (int i = threadIdx.x; i < U; i += NT) {
    const i64 sl = s.sel[i];
    const i64 sched = (s.sel[i] && s.pp[i]) ? s.prev_rep[i] : 0;
    i64 w = 0;
    if (is_static) w = static_pos ? static_w(i) * sl : sl;
    if (is_fresh) w = s.avail_cal[i] * sl + sched;
    if (scale_up) w = s.avail_cal[i] * sl;
    if (scale_down) w = s.pp[i] ? s.prev_rep[i] : 0;
    s.w[i] = w;
    s.active[i] = scale_down ? s.pp[i] : s.sel[i];
    t_w += w;
  }
  i64 target = is_static ? n : 0;
  if (is_fresh || scale_down) target = n;
  if (scale_up) target = n - assigned;
  const bool unsched_div = is_dynamic && block_sum<NT>(t_w, red) < target;
  // Aggregated: trim to the capacity-descending prefix reaching target
  if (row.strategy == STRAT_AGGREGATED && (is_fresh || scale_up || scale_down)) {
    __syncthreads();
    KT_MARK(10);
    block_argsort<NT>(U, s, [&](int i) -> i64 {
      if (!s.active[i]) return KT_MAX_INT64;
      const bool prior = scale_up && s.pp[i] && s.sel[i] && s.prev_rep[i] > 0;
      return shl(prior ? 0 : 1, AVAIL_BITS + LANE_BITS) |
             shl(AVAIL_CAP - clampll(s.w[i], 0, AVAIL_CAP), LANE_BITS) | s.nr[i];
    });
    KT_MARK(11);
    // exclusive cumsum of active w in sorted order, each thread a chunk
    const int per = (U + NT - 1) / NT;
    const int p0 = threadIdx.x * per;
    i64 local = 0;
    for (int p = p0; p < p0 + per && p < U; ++p) {
      const int i = s.order[p];
      local += s.active[i] ? s.w[i] : 0;
    }
    i64 run = block_scan_excl<NT>(local, red);
    for (int p = p0; p < p0 + per && p < U; ++p) {
      const int i = s.order[p];
      s.inc[i] = run < target;
      run += s.active[i] ? s.w[i] : 0;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < U; i += NT) {
      if (!s.inc[i]) { s.w[i] = 0; s.active[i] = 0; }
    }
    __syncthreads();
  }
  KT_MARK(12);
  const bool run_webster =
      !row.nw && (is_static || ((is_fresh || scale_up || scale_down) && !unsched_div));
  int status = STATUS_OK;
  if (fcount == 0) status = STATUS_FIT_ERROR;
  else if (unsched_sel || unsched_div) status = STATUS_UNSCHEDULABLE;
  else if (sel_count == 0) status = STATUS_NO_CLUSTER;
  const bool ok = status == STATUS_OK;
  const bool is_dup = row.strategy == STRAT_DUPLICATED;
  // rep = base + seats, except Duplicated (n * sel), non-workload and
  // failed rows (0): only then do the seats matter
  const bool use_seats = ok && !row.nw && !is_dup;
  const bool base_keep = scale_up || steady_eq;
  const i64 wo = row.slot * LMAX;
  for (int i = threadIdx.x; i < LMAX; i += NT) {
    const bool live = i < U;
    const bool sl = live && s.sel[i];
    const i64 sched = (sl && s.pp[i]) ? s.prev_rep[i] : 0;
    i64 base = 0;
    if (use_seats) base = base_keep ? sched : 0;
    else if (is_dup && ok && !row.nw) base = n * (i64)sl;
    a.web_w[wo + i] = live ? s.w[i] : 0;
    a.web_active[wo + i] = live && s.active[i];
    a.web_rank[wo + i] = live ? s.rank_w[i] : i;
    a.wk_base[wo + i] = base;
    a.wk_sel[wo + i] = sl && ok;
    a.wk_prev[wo + i] = live ? s.prev_rep[i] : 0;
    a.wk_feas[wo + i] = live && s.feas[i];
    a.wk_lane[wo + i] = live ? s.lane[i] : -1;
  }
  if (threadIdx.x == 0) {
    a.web_n[row.slot] = (use_seats && run_webster) ? target : 0;
    a.wk_U[row.slot] = U;
    a.wk_flags[row.slot] = status | (ok ? FLAG_OK : 0) |
                           (use_seats ? FLAG_SEATS : 0) |
                           (is_dup && !row.has_sc && ok && !row.nw ? FLAG_DUP_WIDE : 0) |
                           (row.has_sc ? FLAG_HAS_SC : 0) | FLAG_VALID;
  }
  KT_MARK(13);
}

// Step 4, after K4 solved the rows' Webster problems (seats): the dense
// rep/sel row -- wide formulas over every lane, then the gathered lanes
// (the same global addresses, ordered by the barrier) -- the status, and
// the row's new consumption max(rep - prev, 0) added into used_* with
// 64-bit integer atomics (exact and order-free).
template <class T>
__global__ void __launch_bounds__(T::NT) schedule_rows_finish(RowsArgs a) {
  constexpr int LMAX = T::LMAX, NT = T::NT;
  const i64 slot = blockIdx.x;
  const i64 b = a.r0 + slot;
  const i64 C = a.C;
  i64* rep_row = a.rep + b * C;
  unsigned char* sel_row = a.sel + b * C;
  const int flags = a.wk_flags[slot];
  if (!(flags & FLAG_VALID)) {
    // host-owned / padding rows: no result, no consumption
    for (i64 c = threadIdx.x; c < C; c += NT) { rep_row[c] = 0; sel_row[c] = 0; }
    if (threadIdx.x == 0) a.status[b] = STATUS_OK;
    return;
  }
  const int U = a.wk_U[slot];
  const bool ok = flags & FLAG_OK;
  const bool use_seats = flags & FLAG_SEATS;
  const bool dup_wide = flags & FLAG_DUP_WIDE;
  const bool has_sc = flags & FLAG_HAS_SC;
  const i64 n = a.replicas[b];
  const i64 wo = slot * LMAX;
  const bool direct = C <= T::DIRECT_MAX;
  // a lane's feasibility: the direct path's lane set is every lane, in
  // order; on the gather path it is recomputed (lane_planes, on the row's
  // COO entries in shared memory)
  extern __shared__ __align__(16) char smem_raw[];
  Row row;
  RowPlanes P{};
  if (!direct && (dup_wide || (!has_sc && ok))) {
    i64* pval = (i64*)smem_raw;
    int* pidx = (int*)(pval + a.Kp);
    load_row<NT>(a, b, row, pidx, pval, pidx + a.Kp);
    row.strategy = a.pl_strategy[row.pid];
    P = row_planes(a, row);
    if (bits_bytes<T>(C))
      plane_bits<NT>(row, C, (unsigned*)(pidx + a.Kp + a.Ke), P);
  }
  auto feas_at = [&](i64 c) -> bool {
    if (direct) return a.wk_feas[wo + c];
    i64 nr, sw;
    return lane_planes(a, row, P, (int)c, &nr, &sw).feas;
  };
  for (i64 c = threadIdx.x; c < C; c += NT) {
    const bool f = (dup_wide || (!has_sc && ok)) ? feas_at(c) : false;
    rep_row[c] = (dup_wide && f) ? n : 0;
    sel_row[c] = !has_sc && ok && f;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < U; i += NT) {
    const i64 c = a.wk_lane[wo + i];
    if (!dup_wide)
      rep_row[c] = a.wk_base[wo + i] + (use_seats ? a.seats[wo + i] : 0);
    if (has_sc) sel_row[c] = a.wk_sel[wo + i];
  }
  if (threadIdx.x == 0) a.status[b] = flags & 0xff;
  if (!a.charge) return;
  // new consumption max(rep - prev, 0), added per resource / pod / class
  const i64 cid = a.class_id[b] >= 0 ? a.class_id[b] : a.Q;
  const bool has_class = cid < a.Q;
  const i64 pods_per = has_class ? a.req_pods[cid] : 1;
  auto charge = [&](i64 c, i64 delta) {
    if (delta <= 0) return;
    if (has_class) {
      for (i64 r = 0; r < a.R; ++r) {
        const i64 req = a.req_milli[cid * a.R + r] * (a.req_is_cpu[r] ? 1 : 1000);
        if (req != 0)
          atomicAdd((u64*)&a.used_milli[c * a.R + r], (u64)(delta * req));
      }
      atomicAdd((u64*)&a.used_sets[cid * C + c], (u64)delta);
    }
    atomicAdd((u64*)&a.used_pods[c], (u64)(delta * pods_per));
  };
  if (dup_wide) {
    // every feasible lane holds n: its prev from the row's COO entries
    for (i64 c = threadIdx.x; c < C; c += NT) {
      if (!feas_at(c)) continue;
      i64 pr = 0;
      for (i64 j = 0; j < a.Kp; ++j)
        if (a.prev_idx[b * a.Kp + j] == c) pr += a.prev_val[b * a.Kp + j];
      charge(c, n - pr);
    }
  } else {
    for (int i = threadIdx.x; i < U; i += NT) {
      const i64 rep = a.wk_base[wo + i] + (use_seats ? a.seats[wo + i] : 0);
      charge(a.wk_lane[wo + i], rep - a.wk_prev[wo + i]);
    }
  }
}

// Kernel's dynamic shared memory limit raised to at least `bytes`, the
// attribute set only when a launch needs more than any before it (one
// cached limit per kernel; a stale reading only sets it again).
template <auto Kernel>
static cudaError_t allow_smem(size_t bytes) {
  static std::atomic<size_t> allowed{0};
  if (bytes <= allowed.load(std::memory_order_relaxed)) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) allowed.store(bytes, std::memory_order_relaxed);
  return e;
}

// One launch slice: K1 (fill_est), the prepare kernel, K4 on the rows'
// Webster problems, the finish kernel, in order on one stream.  An empty
// slice enqueues K1 alone (fill_est) or nothing.
template <class T>
int launch_wave(const RowsArgs* a, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (a->fill_est) {
    // K1 for the wave, from the same argument block (capacity.cuh)
    const CapacityArgs c{a->req_milli,    a->req_is_cpu,   a->req_pods,
                         a->avail_milli,  a->used_milli,   a->has_alloc,
                         a->pods_allowed, a->used_pods,    a->has_summary,
                         a->est_override, a->used_sets,    (i64*)a->est,
                         a->Q,            a->R,            a->C};
    const int e = launch_capacity(c, st);
    if (e != 0) return e;
  }
  const i64 rows = a->r1 - a->r0;
  if (rows <= 0) return 0;
  const size_t smem = sort_bytes(T::SORTN, a->Kp, a->Ke) +
                      bits_bytes<T>(a->C) +
                      (T::WORK_SMEM ? work_bytes(T::LMAX) : 0);
  cudaError_t e = allow_smem<schedule_rows_prepare<T>>(smem);
  if (e != cudaSuccess) return (int)e;
  schedule_rows_prepare<T><<<(unsigned)rows, T::NT, smem, st>>>(*a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const WebsterArgs w{a->web_n,    a->web_w,    a->web_s0,
                      a->web_active, a->web_rank, a->seats,
                      a->web_scratch, rows,      T::LMAX};
  const int ew = launch_webster(w, st);
  if (ew != 0) return ew;
  // the row's COO entries and bitmaps (feasibility recomputed on the
  // gather path)
  const size_t fsmem = (size_t)a->Kp * 12 + a->Ke * 4 + bits_bytes<T>(a->C);
  e = allow_smem<schedule_rows_finish<T>>(fsmem);
  if (e != cudaSuccess) return (int)e;
  schedule_rows_finish<T><<<(unsigned)rows, T::NT, fsmem, st>>>(*a);
  return (int)cudaGetLastError();
}

extern "C" int kt_schedule_rows_wave(const RowsArgs* a, void* stream) {
  return launch_wave<TierStd>(a, stream);
}

extern "C" int kt_schedule_rows_big_wave(const RowsArgs* a, void* stream) {
  return launch_wave<TierBig>(a, stream);
}
