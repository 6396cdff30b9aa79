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
// K11's about its launch path: one C call a dispatch (kt_gather_rows) on
// the mirror set's workspace (ops/resident_gather.py _Plan: an int64
// GatherCall block with the mirror pointers and the outputs' slab
// offsets filled once), which from host inputs also stages them through
// the workspace's ring of pinned buffers and uploads them into the front
// of the call's output slab (see kt_gather_rows).
// Design: K10 one thread per element (over the table's running element
// starts, as in a multi-tensor apply), consecutive threads on
// consecutive addresses of one entry's values, so those reads coalesce;
// the dst writes are as scattered as the lanes.  K11 GATHER_ROWS rows a
// block: its first warp a row a thread (every scalar field's load issued
// before any store), the other threads the rows' prev / evict columns,
// consecutive threads on consecutive output addresses; 32-bit index
// arithmetic; the slot-store reads are as scattered as the slots.
#include <cstring>

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
// outputs in OUT_FIELDS order (ops/solver._BINDING_FIELDS): the kernel's
// parameters.
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

static_assert(sizeof(GatherArgs) == 30 * sizeof(i64), "GatherArgs layout");

// staging buffers a mirror set's workspace cycles through
constexpr int GATHER_RING = 4;

// One K11 call as resident_gather._Plan lays out its int64 block
// (kernels.GatherCall): the kernel's inputs, the mirrors, the outputs as
// byte offsets into the call's device slab, then the call and the
// workspace's staging ring.  The C entry writes only `next`.
struct GatherCall {
  i64 slots, lane_inv, drop;  // addresses; with `staged` host addresses
  i64 mirrors[12];            // GATHER_FIELDS order
  i64 out_off[12];            // OUT_FIELDS order, bytes from `slab`
  i64 B, Kp, Ke;
  i64 slab;                   // the call's device slab
  i64 staged;                 // 1: stage the inputs through the ring
  i64 n_inv;                  // lane_inv's entries (staged sub flavour)
  i64 ring;                   // pinned: GATHER_RING buffers of ring_bytes
  i64 ring_bytes;
  i64 next;                   // the buffer the next staged call takes
  i64 done[GATHER_RING];      // cudaEvent_t: each buffer's last copy
};
static_assert(sizeof(GatherCall) == (36 + GATHER_RING) * sizeof(i64),
              "GatherCall layout");

__device__ __forceinline__ int remap(const GatherArgs& a, int lane) {
  if (a.lane_inv == nullptr || lane < 0) return lane;
  return a.lane_inv[lane];
}

// rows a K11 block gathers; its first warp writes their scalar fields
// (thread t: row r0 + t, every field), the other threads their prev and
// evict columns, flattened row-major over the block's rows (consecutive
// threads on consecutive output addresses).  32-bit indices: a batch has
// fewer than 2^31 rows and entries.
constexpr int GATHER_ROWS = 32;

__global__ void __launch_bounds__(NT)
    gather_kernel(const __grid_constant__ GatherArgs a) {
  const int B = (int)a.B, Kp = (int)a.Kp, Ke = (int)a.Ke;
  const int r0 = blockIdx.x * GATHER_ROWS;
  const int rows = min(GATHER_ROWS, B - r0);
  const int t = threadIdx.x;
  if (t < GATHER_ROWS) {
    if (t >= rows) return;
    const int b = r0 + t;
    const i64 s = a.slots[b];
    const bool ok = s >= 0;
    const i64 q = ok ? s : 0;
    // every load issued before any store: one round trip a row
    const int route = a.s_route[q], pid = a.s_placement_id[q],
              gvk = a.s_gvk_id[q], cid = a.s_class_id[q];
    const i64 rep = a.s_replicas[q];
    const unsigned char ud = a.s_uid_desc[q], fr = a.s_fresh[q],
                        nw = a.s_non_workload[q], ns = a.s_nw_shortcut[q];
    const bool dropped = a.drop != nullptr && a.drop[b];
    a.b_valid[b] = ok && route == ROUTE_DEVICE && !dropped;
    a.placement_id[b] = ok ? pid : 0;
    a.gvk_id[b] = ok ? gvk : 0;
    a.class_id[b] = ok ? cid : -1;
    a.replicas[b] = ok ? rep : 0;
    a.uid_desc[b] = ok ? ud : 0;
    a.fresh[b] = ok ? fr : 0;
    a.non_workload[b] = ok ? nw : 0;
    a.nw_shortcut[b] = ok ? ns : 0;
    return;
  }
  constexpr int STEP = NT - GATHER_ROWS;
  for (int e = t - GATHER_ROWS; e < rows * Kp; e += STEP) {
    const int r = e / Kp, k = e - r * Kp;
    const i64 s = a.slots[r0 + r];
    const bool ok = s >= 0;
    const int lane = remap(a, ok ? a.s_prev_idx[s * Kp + k] : -1);
    // the sub flavour zeroes the value of a lane outside the union
    const bool keep = ok && (a.lane_inv == nullptr || lane >= 0);
    const i64 o = (i64)r0 * Kp + e;
    a.prev_idx[o] = lane;
    a.prev_val[o] = keep ? a.s_prev_val[s * Kp + k] : 0;
  }
  for (int e = t - GATHER_ROWS; e < rows * Ke; e += STEP) {
    const int r = e / Ke, k = e - r * Ke;
    const i64 s = a.slots[r0 + r];
    a.evict_idx[(i64)r0 * Ke + e] =
        remap(a, s >= 0 ? a.s_evict_idx[s * Ke + k] : -1);
  }
}

static i64 align16(i64 n) { return (n + 15) / 16 * 16; }

// One K11 dispatch (resident_gather._launch): the kernel's parameters from
// the block; with `staged`, the host inputs (slots; lane_inv and drop in
// the sub flavour) are copied into the ring's next buffer -- once the
// event of that buffer's last copy has completed -- in the slab's input
// layout (each 16-byte aligned, slots first: resident_gather._staged_len)
// and uploaded into the front of the slab by one copy; the event is
// recorded after it.  Two calls in flight never share a buffer: a buffer
// is taken again only GATHER_RING staged calls later, and only after its
// copy is done.
extern "C" int kt_gather_rows(i64* blk, void* stream) {
  GatherCall& c = *(GatherCall*)blk;
  if (c.B <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const i64 base = c.slab;
  GatherArgs a;
  // the inputs and mirrors as they lie in the block, then the outputs
  memcpy(&a, &c.slots, 15 * sizeof(i64));
  i64 outs[12];
  for (int i = 0; i < 12; ++i) outs[i] = base + c.out_off[i];
  memcpy(&a.b_valid, outs, sizeof(outs));
  a.B = c.B;
  a.Kp = c.Kp;
  a.Ke = c.Ke;
  cudaEvent_t done = nullptr;
  if (c.staged) {
    const int i = (int)c.next;
    done = (cudaEvent_t)c.done[i];
    if (done == nullptr) return (int)cudaErrorInvalidResourceHandle;
    cudaError_t e = cudaEventSynchronize(done);
    if (e != cudaSuccess) return (int)e;
    const i64 o_inv = align16(c.B * 8);
    const i64 o_drop = o_inv + (c.lane_inv ? align16(c.n_inv * 4) : 0);
    const i64 n = c.lane_inv ? o_drop + align16(c.B) : o_inv;
    if (n > c.ring_bytes) return (int)cudaErrorInvalidValue;
    char* h = (char*)(c.ring + i * c.ring_bytes);
    memcpy(h, (const void*)c.slots, (size_t)c.B * 8);
    a.slots = (const i64*)base;
    if (c.lane_inv) {
      memcpy(h + o_inv, (const void*)c.lane_inv, (size_t)c.n_inv * 4);
      memcpy(h + o_drop, (const void*)c.drop, (size_t)c.B);
      a.lane_inv = (const int*)(base + o_inv);
      a.drop = (const unsigned char*)(base + o_drop);
    }
    e = cudaMemcpyAsync((void*)base, h, (size_t)n, cudaMemcpyHostToDevice,
                        st);
    if (e != cudaSuccess) return (int)e;
    e = cudaEventRecord(done, st);
    if (e != cudaSuccess) return (int)e;
    c.next = (i + 1) % GATHER_RING;
  }
  const unsigned grid = (unsigned)((c.B + GATHER_ROWS - 1) / GATHER_ROWS);
  gather_kernel<<<grid, NT, 0, st>>>(a);
  return (int)cudaGetLastError();
}

// The ring's events, made once per workspace (block fields `done`).
extern "C" int kt_gather_ring_init(i64* blk, void*) {
  GatherCall& c = *(GatherCall*)blk;
  for (int i = 0; i < GATHER_RING; ++i) {
    cudaEvent_t e;
    const cudaError_t r =
        cudaEventCreateWithFlags(&e, cudaEventDisableTiming);
    if (r != cudaSuccess) return (int)r;
    c.done[i] = (i64)e;
  }
  c.next = 0;
  return 0;
}

// Waits for the ring's copies and destroys its events: the workspace's
// pinned buffers may then be released.
extern "C" int kt_gather_ring_free(i64* blk, void*) {
  GatherCall& c = *(GatherCall*)blk;
  int rc = 0;
  for (int i = 0; i < GATHER_RING; ++i) {
    cudaEvent_t e = (cudaEvent_t)c.done[i];
    if (e == nullptr) continue;
    cudaError_t r = cudaEventSynchronize(e);
    if (r == cudaSuccess) r = cudaEventDestroy(e);
    if (r != cudaSuccess && rc == 0) rc = (int)r;
    c.done[i] = 0;
  }
  return rc;
}
