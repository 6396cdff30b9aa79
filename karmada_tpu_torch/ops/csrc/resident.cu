// K10 scatter_lanes and K11 gather_rows: the resident plane's indexed
// copies.
//
// K10 replaces karmada_tpu/ops/resident_update.py: scatter_rows,
// scatter_cols and scatter_rows_cow (dst[lanes] = rows, dst[:, lanes] =
// cols).  dst is viewed as [outer, D, inner] with the lane axis D; src is
// the contiguous [outer, L, inner] block of new values.  Row mode
// (outer = 1) serves the C-leading cluster tensors and the cap-leading
// slot store, column mode (inner = 1) the [Q, C] / [G, C] planes.  The
// element size (1, 4 or 8 bytes) is a template argument, so one kernel
// serves bool, int32 and int64.  Callers pad the lane list by repeating
// the last (lane, value) pair: duplicate writes carry equal values, so
// the order they land in does not matter.  The JAX package's copy-on-write
// flavour exists only to avoid a donation stall behind an in-flight
// gather; on one CUDA stream a scatter is ordered after every gather
// enqueued before it, and K11 writes fresh output buffers, so the port
// scatters in place.
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
// row for K11).  Design: one thread per element (K10) or per (row,
// column) (K11), consecutive threads on consecutive addresses of the
// output, so the writes coalesce; the reads are as scattered as the lanes
// or slots are.
#include "common.cuh"

constexpr int NT = 256;
constexpr int ROUTE_DEVICE = 0;

struct ScatterArgs {
  void* dst;          // [outer, D, inner] elements of elem bytes
  const void* src;    // [outer, L, inner]
  const i64* lanes;   // [L], each in [0, D)
  i64 outer, D, inner, L, elem;
};

template <typename T>
__global__ void __launch_bounds__(NT) scatter_kernel(ScatterArgs a) {
  const i64 n = a.outer * a.L * a.inner;
  const i64 per = a.L * a.inner;
  T* dst = (T*)a.dst;
  const T* src = (const T*)a.src;
  for (i64 t = (i64)blockIdx.x * NT + threadIdx.x; t < n;
       t += (i64)gridDim.x * NT) {
    const i64 o = t / per;
    const i64 r = t - o * per;
    const i64 l = r / a.inner;
    const i64 i = r - l * a.inner;
    dst[(o * a.D + a.lanes[l]) * a.inner + i] = src[t];
  }
}

static unsigned grid_for(i64 n) {
  const i64 g = (n + NT - 1) / NT;
  return (unsigned)(g < 65535 * 4 ? g : 65535 * 4);
}

extern "C" int kt_scatter_lanes(const ScatterArgs* a, void* stream) {
  const i64 n = a->outer * a->L * a->inner;
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned g = grid_for(n);
  switch (a->elem) {
    case 1: scatter_kernel<unsigned char><<<g, NT, 0, s>>>(*a); break;
    case 4: scatter_kernel<int><<<g, NT, 0, s>>>(*a); break;
    case 8: scatter_kernel<i64><<<g, NT, 0, s>>>(*a); break;
    default: return (int)cudaErrorInvalidValue;
  }
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
