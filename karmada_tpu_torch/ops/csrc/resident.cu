// K10 scatter_lanes and K11 gather_rows: the resident plane's indexed
// copies.
//
// K10 replaces karmada_tpu/ops/resident_update.py: scatter_rows,
// scatter_cols and scatter_rows_cow (dst[lanes] = rows, dst[:, lanes] =
// cols).  One launch applies a table of up to KT_SCATTER_FIELDS entries:
// a mirror sync scatters every changed field of the plane at once (12
// slot-store fields, up to 9 cluster-side ones), and the single-field
// calls are one-entry tables.  Entry i views its dst as [outer, D,
// inner] with the lane axis D, and its new values as the contiguous
// [outer, L, inner] block at base + vals; its L lanes (int64) are at
// base + lanes.  The wrapper stages every entry's lanes and values in one
// host buffer (16-byte aligned segments, one H2D copy) and passes base =
// the staged buffer's address with byte offsets, or base = 0 with the
// operands' own addresses.  Row mode (outer = 1) serves the C-leading
// cluster tensors and the cap-leading slot store, column mode (inner = 1)
// the [Q, C] / [G, C] planes; the element size (1, 4 or 8 bytes) is per
// entry, so one launch serves bool, int32 and int64 fields.  The table
// rides in the kernel's parameter block (__grid_constant__): no copy of
// it goes to device memory.  The kernel takes any L, so nothing pads the
// lane list and no lane is written twice; duplicate lanes a caller does
// pass must carry equal values (the order they land in is not fixed).
// The JAX package's copy-on-write flavour exists only to avoid a donation
// stall behind an in-flight gather; on one CUDA stream a scatter is
// ordered after every gather enqueued before it, and K11 writes fresh
// output buffers, so the port scatters in place.
//
// K11 replaces karmada_tpu/ops/resident_gather.py: gather_batch and
// sub_gather_batch.  Per batch row b with slot s = slots[b]: the twelve
// solver binding fields gathered from the slot store, b_valid computed on
// the card (s >= 0 and route[s] == ROUTE_DEVICE, and not drop[b] in the
// sub flavour), pad rows (s < 0) written with the host assemble's fill
// values.  The sub flavour (lane_inv non-null) remaps prev/evict lanes
// into a shortlist sub-vocabulary: an out-of-union lane becomes -1 and its
// prev value 0.
//
// Bound on the card: bytes for both (each element is read once and
// written once; a few hundred bytes per churned lane for K10, ~70 B per
// row for K11).  Both are launch-bound at the main path's sizes, so K10's
// design is about launches: one per sync instead of one per field, and
// K11's about its launch path (ops/resident_gather.py): the mirror set
// checked once, GatherArgs an int64 block whose mirror pointers are filled
// once per set, the twelve outputs carved from one device slab per call,
// and from host slots the inputs uploaded into the front of that slab by
// one non-blocking copy from pinned memory.  The kernel takes its inputs
// and outputs wherever the pointers say.
// Design: one thread per element (K10, over the table's running element
// starts, as in a multi-tensor apply) or per (row, column) (K11),
// consecutive threads on consecutive addresses of one entry's values or
// of the output, so those accesses coalesce; the dst writes are as
// scattered as the lanes, the K11 reads as the slots.
#include "common.cuh"

constexpr int NT = 256;
constexpr int ROUTE_DEVICE = 0;
// entries of one K10 launch (ops/kernels.py SCATTER_FIELDS)
constexpr int KT_SCATTER_FIELDS = 16;

// One table entry; every field is 8 bytes, in the order of the wrapper's
// descriptor columns (ops/resident_update.py DESC_COLUMNS).
struct ScatterEntry {
  i64 dst;    // address of dst's first element
  i64 lanes;  // byte offset of the int64 [L] lane list from base
  i64 vals;   // byte offset of the [outer, L, inner] values from base
  i64 outer, D, inner, L;
  i64 elem;   // element size in bytes: 1, 4 or 8
  i64 start;  // running element start: outer * L * inner summed over
              // the table's entries before this one
};

struct ScatterTable {
  i64 base;   // staged buffer address (0: the offsets are addresses)
  i64 n;      // entries used
  ScatterEntry e[KT_SCATTER_FIELDS];
};

__global__ void __launch_bounds__(NT)
    scatter_kernel(const __grid_constant__ ScatterTable a, i64 total) {
  int i = 0;
  for (i64 t = (i64)blockIdx.x * NT + threadIdx.x; t < total;
       t += (i64)gridDim.x * NT) {
    while (i + 1 < a.n && t >= a.e[i + 1].start) ++i;
    const ScatterEntry& d = a.e[i];
    const i64 r = t - d.start;
    const i64 per = d.L * d.inner;
    const i64 o = r / per;
    const i64 q = r - o * per;
    const i64 l = q / d.inner;
    const i64 j = q - l * d.inner;
    const i64 lane = ((const i64*)(a.base + d.lanes))[l];
    const i64 at = (o * d.D + lane) * d.inner + j;
    const char* src = (const char*)(a.base + d.vals);
    switch (d.elem) {
      case 1: ((unsigned char*)d.dst)[at] = ((const unsigned char*)src)[r];
        break;
      case 4: ((int*)d.dst)[at] = ((const int*)src)[r]; break;
      default: ((i64*)d.dst)[at] = ((const i64*)src)[r]; break;
    }
  }
}

static unsigned grid_for(i64 n) {
  const i64 g = (n + NT - 1) / NT;
  return (unsigned)(g < 65535 * 4 ? g : 65535 * 4);
}

// `h` is the host table: base, n, then n entries of 9 int64 each.
extern "C" int kt_scatter_lanes(const i64* h, void* stream) {
  ScatterTable a;
  a.base = h[0];
  a.n = h[1];
  if (a.n <= 0) return 0;
  if (a.n > KT_SCATTER_FIELDS) return (int)cudaErrorInvalidValue;
  const ScatterEntry* src = (const ScatterEntry*)(h + 2);
  for (int i = 0; i < KT_SCATTER_FIELDS; ++i) {
    if (i < a.n) {
      a.e[i] = src[i];
      const i64 el = a.e[i].elem;
      if ((el != 1 && el != 4 && el != 8) || a.e[i].L <= 0 ||
          a.e[i].outer <= 0 || a.e[i].inner <= 0)
        return (int)cudaErrorInvalidValue;
    } else {
      a.e[i] = ScatterEntry{};
    }
  }
  if (a.e[0].start != 0) return (int)cudaErrorInvalidValue;
  const ScatterEntry& last = a.e[a.n - 1];
  const i64 total = last.start + last.outer * last.L * last.inner;
  scatter_kernel<<<grid_for(total), NT, 0, (cudaStream_t)stream>>>(a, total);
  return (int)cudaGetLastError();
}

// Slot-store fields in resident_gather.GATHER_FIELDS order, then the
// outputs in OUT_FIELDS order (ops/solver._BINDING_FIELDS).
struct GatherArgs {
  const i64* slots;                 // [B], -1 = padding row
  const int* lane_inv;              // [C] or null (plain flavour)
  const unsigned char* drop;        // [B] or null
  const int* s_placement_id;        // [cap]
  const int* s_gvk_id;
  const int* s_class_id;
  const i64* s_replicas;
  const unsigned char* s_uid_desc;
  const unsigned char* s_fresh;
  const unsigned char* s_non_workload;
  const unsigned char* s_nw_shortcut;
  const int* s_route;
  const int* s_prev_idx;            // [cap, Kp]
  const int* s_prev_val;            // [cap, Kp]
  const int* s_evict_idx;           // [cap, Ke]
  unsigned char* b_valid;           // [B]
  int* placement_id;
  int* gvk_id;
  int* class_id;
  i64* replicas;
  unsigned char* uid_desc;
  unsigned char* fresh;
  unsigned char* non_workload;
  unsigned char* nw_shortcut;
  int* prev_idx;                    // [B, Kp]
  int* prev_val;                    // [B, Kp]
  int* evict_idx;                   // [B, Ke]
  i64 B, Kp, Ke;
};

__device__ __forceinline__ int remap(const GatherArgs& a, int lane) {
  if (a.lane_inv == nullptr || lane < 0) return lane;
  return a.lane_inv[lane];
}

// Thread (b, j): j == 0 writes the row's scalar fields, j in [1, 1 + Kp)
// prev column j - 1, the rest evict column j - 1 - Kp.
__global__ void __launch_bounds__(NT) gather_kernel(GatherArgs a) {
  const i64 W = 1 + a.Kp + a.Ke;
  const i64 n = a.B * W;
  for (i64 t = (i64)blockIdx.x * NT + threadIdx.x; t < n;
       t += (i64)gridDim.x * NT) {
    const i64 b = t / W;
    const i64 j = t - b * W;
    const i64 s = a.slots[b];
    const bool ok = s >= 0;
    if (j == 0) {
      bool valid = ok && a.s_route[s] == ROUTE_DEVICE;
      if (a.drop != nullptr && a.drop[b]) valid = false;
      a.b_valid[b] = valid;
      a.placement_id[b] = ok ? a.s_placement_id[s] : 0;
      a.gvk_id[b] = ok ? a.s_gvk_id[s] : 0;
      a.class_id[b] = ok ? a.s_class_id[s] : -1;
      a.replicas[b] = ok ? a.s_replicas[s] : 0;
      a.uid_desc[b] = ok ? a.s_uid_desc[s] : 0;
      a.fresh[b] = ok ? a.s_fresh[s] : 0;
      a.non_workload[b] = ok ? a.s_non_workload[s] : 0;
      a.nw_shortcut[b] = ok ? a.s_nw_shortcut[s] : 0;
    } else if (j <= a.Kp) {
      const i64 k = j - 1;
      const int lane = remap(a, ok ? a.s_prev_idx[s * a.Kp + k] : -1);
      a.prev_idx[b * a.Kp + k] = lane;
      // the sub flavour zeroes the value of a lane outside the union
      const bool keep = ok && (a.lane_inv == nullptr || lane >= 0);
      a.prev_val[b * a.Kp + k] = keep ? a.s_prev_val[s * a.Kp + k] : 0;
    } else {
      const i64 k = j - 1 - a.Kp;
      a.evict_idx[b * a.Ke + k] =
          remap(a, ok ? a.s_evict_idx[s * a.Ke + k] : -1);
    }
  }
}

extern "C" int kt_gather_rows(const GatherArgs* a, void* stream) {
  const i64 n = a->B * (1 + a->Kp + a->Ke);
  if (n <= 0) return 0;
  gather_kernel<<<grid_for(n), NT, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}
