// K12 dirty_codes: the incremental solve's per-slot dirty classification.
//
// Replaces karmada_tpu/ops/dirty.py: dirty_kernel (_dirty_core).  Per slot
// of the binding-row slot store: the previous assignment's feasibility
// under the current planes (lanes_ok & pl_mask & ~evicted on each prev
// lane), `assigned` = the replicas on feasible prev lanes, `sensitive` =
// not non-workload and (Dynamic/Aggregated and (fresh or assigned !=
// replicas), or spread-constrained), `flip_hit` = the placement's mask
// covers a feasibility-flip lane, `rv_hit` = the slot is in the rv-churn
// list, `route_hit` = route != ROUTE_DEVICE.  Output byte: DIRTY |
// SENSITIVE << 1 | CONSUMER << 2.
//
// Bound on the card: bytes (~66 B read and 1 B written per slot; 69 MB at
// cap = 2^20, ~0.02 ms at 3.35 TB/s), less where the store's rows fix
// their verdict early (below).  Design: ONE launch, no scratch, no
// memset, nothing a block builds before its slots.  A slot a thread,
// many blocks, and a lean body (27-29 registers: full occupancy), which
// hides the dependent loads; the shapes tried before it -- a persistent
// grid with a shared placement table and rv bitmap, several slots a
// thread with their loads pipelined -- held more registers and ran
// slower (PERF.md section 6, "What was hard").
//  * The placement flags (flip, dyn, sc) need no launch or table of
//    their own: the lanes of a warp that share a placement
//    (__match_any_sync; consecutive slots mostly do) split its F probes
//    of pl_mask between them and OR them by a ballot, whatever P.
//  * A slot reads only what its verdict needs: placement_id and route;
//    then non_workload; a route hit, a non-workload row, a
//    spread-constrained row, a non-Dynamic row and a fresh Dynamic row
//    are decided there.  Only the remaining rows read replicas and their
//    Kp prev_idx / prev_val and Ke evict_idx entries, four lanes and
//    four values a 16-byte load when `vec` (Kp and Ke positive multiples
//    of 4, the three planes 16-byte aligned; the wrapper checks), a lane
//    a load otherwise.
//  * rv hits need no device scratch: after a barrier each block writes
//    code 7 over its own slots in the rv list (their rows were read as
//    any other).  The list comes ascending (dirty_codes: ops/dirty.
//    normalise_rv on the host; dirty_kernel: a sort of its device
//    operand), and a warp finds the block's run by a 32-ary search, so a
//    block reads its run and not the list: the settle cycle after an
//    adopt hands over every live row's slot (1,000,000 in chip_smoke's
//    phase 9), a steady cycle ~2,000.  Pads and slots >= cap never hit;
//    a duplicate writes the same byte twice.
//  * The call (kt_dirty_codes) takes an int64 DirtyCall block (the
//    workspace's, ops/dirty.py _Workspace): from host inputs (`staged`)
//    it copies the flip lanes, the rv list and region_sc into the
//    workspace's pinned buffer and uploads them with one cudaMemcpyAsync;
//    after the kernel, with host_out, one cudaMemcpyAsync copies the
//    codes into pinned memory.  A staged call synchronises the stream
//    before it returns, so the next one may reuse the pinned buffer.
#include <cstring>

#include "common.cuh"

// threads a block, a slot each, and the blocks an SM must hold (the
// register budget: 8 x 256 threads is full occupancy at <= 32 registers)
constexpr int NT = 256;
constexpr int MIN_BLOCKS = 8;
constexpr int ROUTE_DEVICE = 0;
constexpr int STRAT_DYNAMIC = 2;
constexpr int STRAT_AGGREGATED = 3;
constexpr unsigned char PL_FLIP = 1, PL_DYN = 2, PL_SC = 4;
constexpr unsigned char CODE_ALL = 7;

// The kernel's parameters.
struct DirtyArgs {
  const int* placement_id;               // [cap]
  const i64* replicas;                   // [cap]
  const unsigned char* fresh;            // [cap]
  const unsigned char* non_workload;     // [cap]
  const int* route;                      // [cap]
  const int* prev_idx;                   // [cap, Kp]
  const int* prev_val;                   // [cap, Kp]
  const int* evict_idx;                  // [cap, Ke]
  const unsigned char* cluster_valid;    // [C]
  const unsigned char* deleting;         // [C]
  const unsigned char* pl_mask;          // [P, C]
  const int* pl_strategy;                // [P]
  const unsigned char* pl_has_cluster_sc;  // [P]
  const unsigned char* pl_has_region_sc;   // [P]
  const i64* flip_lanes;                 // [F], -1 pads never flip
  const i64* rv_slots;                   // [S] ascending, -1 pads
  unsigned char* out;                    // [cap]
  i64 cap, C, P, Kp, Ke, F, S;
  i64 vec;
};

// One K12 call as ops/dirty.py _Workspace lays out its int64 block
// (kernels.DIRTY_CALL).  The C entry writes nothing into it.
struct DirtyCall {
  i64 fields[13];  // placement_id .. pl_has_cluster_sc (DirtyArgs order)
  i64 region_sc;   // [P] bool; with `staged` a host address
  i64 flips;       // int64 [F]; with `staged` a host address
  i64 rv;          // int64 [S] ascending; with `staged` a host address
  i64 out;         // device uint8 [cap]
  i64 host_out;    // pinned uint8 [cap], 0: the codes stay on the card
  i64 cap, C, P, Kp, Ke, F, S;
  i64 vec;
  i64 staged;      // 1: upload region_sc, flips and rv through `pin`
  i64 dbuf;        // device buffer the staged inputs land in
  i64 pin;         // pinned staging buffer of pin_bytes
  i64 pin_bytes;
};
static_assert(sizeof(DirtyCall) == 30 * sizeof(i64), "DirtyCall layout");

__device__ __forceinline__ int4 ld4(const int* p) {
  return __ldg((const int4*)p);
}

// flip / dyn / sc of each lane's placement p.  The lanes of a warp that
// share p (__match_any_sync; consecutive slots mostly do) split its F
// probes of pl_mask[p, flip lane] between them and OR them by a ballot;
// every lane of the warp must call it.
__device__ __forceinline__ unsigned char warp_flags(const DirtyArgs& a,
                                                    int p) {
  const unsigned grp = __match_any_sync(KT_FULL_MASK, p);
  const int lane = threadIdx.x & 31;
  const int rank = __popc(grp & ((1u << lane) - 1u));
  const int n = __popc(grp);
  const unsigned char* row = a.pl_mask + (i64)p * a.C;
  bool probe = false;
#pragma unroll 1
  for (i64 j = rank; j < a.F; j += n) {
    const i64 fl = __ldg(a.flip_lanes + j);
    probe |= fl >= 0 && fl < a.C && __ldg(row + fl) != 0;
  }
  const bool flip = (__ballot_sync(KT_FULL_MASK, probe) & grp) != 0u;
  const int st = __ldg(a.pl_strategy + p);
  unsigned char f = flip ? PL_FLIP : 0;
  if (st == STRAT_DYNAMIC || st == STRAT_AGGREGATED) f |= PL_DYN;
  if (__ldg(a.pl_has_cluster_sc + p) || __ldg(a.pl_has_region_sc + p))
    f |= PL_SC;
  return f;
}

// li among row[0, n) (-1 pads never match a real lane)
__device__ __forceinline__ bool in_row(const int* row, i64 n, bool vec,
                                       int li) {
  bool hit = false;
  if (vec) {
#pragma unroll 1
    for (i64 e = 0; e < n; e += 4) {
      const int4 v = ld4(row + e);
      hit |= (v.x == li) | (v.y == li) | (v.z == li) | (v.w == li);
    }
  } else {
#pragma unroll 1
    for (i64 e = 0; e < n; ++e) hit |= __ldg(row + e) == li;
  }
  return hit;
}

// prev lane li (>= 0) of a row counts: valid, not deleting, in the
// placement's mask and not evicted
__device__ __forceinline__ bool counts(const DirtyArgs& a,
                                       const unsigned char* mask,
                                       const int* erow, bool vec, int li) {
  return __ldg(a.cluster_valid + li) && !__ldg(a.deleting + li) &&
         __ldg(mask + li) && !in_row(erow, a.Ke, vec, li);
}

// the replicas of slot s on feasible prev lanes (mask: its placement's
// row).  A lean loop keeps the registers low and the occupancy high,
// which hides the loads; with vec a row's prev lanes and values come four
// at a time in 16-byte loads.
__device__ __forceinline__ i64 assigned_of(const DirtyArgs& a, i64 s,
                                           const unsigned char* mask) {
  const bool vec = a.vec != 0;
  const int* prow = a.prev_idx + s * a.Kp;
  const int* vrow = a.prev_val + s * a.Kp;
  const int* erow = a.evict_idx + s * a.Ke;
  i64 assigned = 0;
  if (vec) {
#pragma unroll 1
    for (i64 k = 0; k < a.Kp; k += 4) {
      const int4 l = ld4(prow + k), v = ld4(vrow + k);
      if (l.x >= 0 && counts(a, mask, erow, vec, l.x)) assigned += v.x;
      if (l.y >= 0 && counts(a, mask, erow, vec, l.y)) assigned += v.y;
      if (l.z >= 0 && counts(a, mask, erow, vec, l.z)) assigned += v.z;
      if (l.w >= 0 && counts(a, mask, erow, vec, l.w)) assigned += v.w;
    }
    return assigned;
  }
#pragma unroll 1
  for (i64 k = 0; k < a.Kp; ++k) {
    const int li = __ldg(prow + k);
    if (li >= 0 && counts(a, mask, erow, vec, li))  // -1: absent lane
      assigned += __ldg(vrow + k);
  }
  return assigned;
}

// first index in rv[lo, hi) whose value is >= key (rv ascending); every
// lane of the calling warp gets it
__device__ __forceinline__ i64 warp_lower_bound(const i64* rv, i64 lo,
                                                i64 hi, i64 key) {
  const int lane = threadIdx.x & 31;
  while (hi - lo > 32) {
    const i64 step = (hi - lo + 31) / 32;
    const i64 i = lo + lane * step;
    const bool below = i < hi && __ldg(rv + i) < key;
    const int n = __popc(__ballot_sync(KT_FULL_MASK, below));
    if (n == 0) return lo;
    const i64 nhi = lo + (i64)n * step;
    lo += (i64)(n - 1) * step + 1;
    hi = nhi < hi ? nhi : hi;
  }
  const i64 i = lo + lane;
  const bool below = i < hi && __ldg(rv + i) < key;
  return lo + __popc(__ballot_sync(KT_FULL_MASK, below));
}

__global__ void __launch_bounds__(NT, MIN_BLOCKS)
    dirty_kernel(const __grid_constant__ DirtyArgs a) {
  const int t = threadIdx.x;
  const i64 t0 = (i64)blockIdx.x * NT;
  const i64 t1 = t0 + NT < a.cap ? t0 + NT : a.cap;
  const i64 s = t0 + t;
  KT_MARK(0);
  const bool live = s < t1;
  // the scalars; the flags of every lane's placement (all lanes take part)
  const int pid = live ? __ldg(a.placement_id + s) : 0;
  const unsigned char f = warp_flags(a, pid);
  if (live) {
    unsigned char code = CODE_ALL;  // a route hit: sens_out
    if (__ldg(a.route + s) == ROUTE_DEVICE) {
      const bool flip = f & PL_FLIP;
      if (__ldg(a.non_workload + s)) {
        code = flip ? 1 : 0;  // never sensitive, never a consumer
      } else if (f & PL_SC) {
        code = CODE_ALL;
      } else if (!(f & PL_DYN)) {
        code = flip ? 5 : 0;  // a re-solve may move replicas
      } else if (__ldg(a.fresh + s)) {
        code = CODE_ALL;
      } else {
        // only these rows read replicas and their prev / evict rows
        const i64 assigned = assigned_of(a, s, a.pl_mask + (i64)pid * a.C);
        code = assigned != __ldg(a.replicas + s) ? CODE_ALL
                                                  : (flip ? 1 : 0);
      }
    }
    a.out[s] = code;
  }
  KT_MARK(1);
  if (a.S > 0) {
    // the rv hits of the block's slots: code 7, written after the block's
    // codes (the barrier orders the writes)
    __syncthreads();
    if (t < 32) {
      for (i64 i = warp_lower_bound(a.rv_slots, 0, a.S, t0) + t;; i += 32) {
        const i64 e = i < a.S ? __ldg(a.rv_slots + i) : KT_MAX_INT64;
        if (e < t1) a.out[e] = CODE_ALL;  // e >= t0 after the search
        if (!__all_sync(KT_FULL_MASK, e < t1)) break;
      }
    }
  }
  KT_MARK(2);
}

// One K12 call (ops/dirty.py): the kernel's parameters from the block;
// with `staged`, the flip lanes, the rv list and region_sc (host
// addresses) are copied into `pin` as int64 flips, int64 rv, then
// region_sc, and uploaded into dbuf by one copy.  With host_out the codes
// are copied into it.  A staged call, or one with host_out, synchronises
// the stream before it returns.
extern "C" int kt_dirty_codes(i64* blk, void* stream) {
  DirtyCall& c = *(DirtyCall*)blk;
  cudaStream_t st = (cudaStream_t)stream;
  DirtyArgs a;
  memcpy(&a, c.fields, sizeof(c.fields));
  a.pl_has_region_sc = (const unsigned char*)c.region_sc;
  a.flip_lanes = (const i64*)c.flips;
  a.rv_slots = (const i64*)c.rv;
  a.out = (unsigned char*)c.out;
  a.cap = c.cap;
  a.C = c.C;
  a.P = c.P;
  a.Kp = c.Kp;
  a.Ke = c.Ke;
  a.F = c.F;
  a.S = c.S;
  a.vec = c.vec;
  cudaError_t e;
  if (c.staged) {
    const i64 o_rv = c.F * 8, o_reg = o_rv + c.S * 8, n = o_reg + c.P;
    if (n > c.pin_bytes) return (int)cudaErrorInvalidValue;
    char* h = (char*)c.pin;
    memcpy(h, (const void*)c.flips, (size_t)c.F * 8);
    memcpy(h + o_rv, (const void*)c.rv, (size_t)c.S * 8);
    memcpy(h + o_reg, (const void*)c.region_sc, (size_t)c.P);
    if (n > 0) {
      e = cudaMemcpyAsync((void*)c.dbuf, h, (size_t)n, cudaMemcpyHostToDevice,
                          st);
      if (e != cudaSuccess) return (int)e;
    }
    a.flip_lanes = (const i64*)c.dbuf;
    a.rv_slots = (const i64*)(c.dbuf + o_rv);
    a.pl_has_region_sc = (const unsigned char*)(c.dbuf + o_reg);
  }
  if (c.cap > 0) {
    dirty_kernel<<<(unsigned)((c.cap + NT - 1) / NT), NT, 0, st>>>(a);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (c.host_out && c.cap > 0) {
    e = cudaMemcpyAsync((void*)c.host_out, (const void*)c.out, (size_t)c.cap,
                        cudaMemcpyDeviceToHost, st);
    if (e != cudaSuccess) return (int)e;
  }
  if (c.staged || c.host_out) {
    e = cudaStreamSynchronize(st);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}
