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
// cap = 2^20, ~0.02 ms at 3.35 TB/s).  Design: flip_hit depends only on
// the placement, so a small first launch folds the flip lanes into one
// flag byte per placement (with the per-placement dynamic and spread
// flags) and marks the valid rv slots (-1 pads never write, where JAX
// scatters max(False) onto slot 0); the main launch takes one thread per
// slot, reads its Kp prev and Ke evict lanes and writes one byte.
#include "common.cuh"

constexpr int NT = 256;
constexpr int ROUTE_DEVICE = 0;
constexpr int STRAT_DYNAMIC = 2;
constexpr int STRAT_AGGREGATED = 3;
constexpr unsigned char PL_FLIP = 1, PL_DYN = 2, PL_SC = 4;

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
  const i64* flip_lanes;                 // [F], -1 padded
  const i64* rv_slots;                   // [S], -1 padded
  unsigned char* pl_flags;               // [P] scratch
  unsigned char* rv_mark;                // [cap] scratch, zeroed
  unsigned char* out;                    // [cap]
  i64 cap, C, P, Kp, Ke, F, S;
};

__global__ void __launch_bounds__(NT) prep_kernel(DirtyArgs a) {
  const i64 t = (i64)blockIdx.x * NT + threadIdx.x;
  if (t < a.P) {
    unsigned char f = 0;
    for (i64 j = 0; j < a.F; ++j) {
      const i64 fl = a.flip_lanes[j];
      if (fl >= 0 && fl < a.C && a.pl_mask[t * a.C + fl]) {
        f = PL_FLIP;
        break;
      }
    }
    const int st = a.pl_strategy[t];
    if (st == STRAT_DYNAMIC || st == STRAT_AGGREGATED) f |= PL_DYN;
    if (a.pl_has_cluster_sc[t] || a.pl_has_region_sc[t]) f |= PL_SC;
    a.pl_flags[t] = f;
  }
  if (t < a.S) {
    const i64 s = a.rv_slots[t];
    if (s >= 0 && s < a.cap) a.rv_mark[s] = 1;
  }
}

__global__ void __launch_bounds__(NT) dirty_kernel(DirtyArgs a) {
  for (i64 s = (i64)blockIdx.x * NT + threadIdx.x; s < a.cap;
       s += (i64)gridDim.x * NT) {
    const i64 p = a.placement_id[s];
    const unsigned char* mask = a.pl_mask + p * a.C;
    i64 assigned = 0;
    for (i64 k = 0; k < a.Kp; ++k) {
      const int li = a.prev_idx[s * a.Kp + k];
      if (li < 0) continue;  // absent lane: never feasible, never evicted
      bool evicted = false;
      for (i64 e = 0; e < a.Ke; ++e)
        evicted |= a.evict_idx[s * a.Ke + e] == li;  // -1 pads never match
      if (a.cluster_valid[li] && !a.deleting[li] && mask[li] && !evicted)
        assigned += a.prev_val[s * a.Kp + k];
    }
    const unsigned char f = a.pl_flags[p];
    const bool dyn = f & PL_DYN;
    const bool nw = a.non_workload[s] != 0;
    const bool sensitive =
        !nw && ((dyn && (a.fresh[s] || assigned != a.replicas[s])) ||
                (f & PL_SC));
    const bool sens_out =
        sensitive || a.rv_mark[s] || a.route[s] != ROUTE_DEVICE;
    const bool dirty = sens_out || (f & PL_FLIP);
    const bool consumer = sens_out || (dirty && !dyn && !nw);
    a.out[s] = (unsigned char)(dirty | (sens_out << 1) | (consumer << 2));
  }
}

extern "C" int kt_dirty_codes(const DirtyArgs* a, void* stream) {
  if (a->cap <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const i64 m = a->P > a->S ? a->P : a->S;
  if (m > 0) {
    prep_kernel<<<(unsigned)((m + NT - 1) / NT), NT, 0, st>>>(*a);
    const int rc = (int)cudaGetLastError();
    if (rc) return rc;
  }
  i64 g = (a->cap + NT - 1) / NT;
  if (g > 65535 * 4) g = 65535 * 4;
  dirty_kernel<<<(unsigned)g, NT, 0, st>>>(*a);
  return (int)cudaGetLastError();
}
