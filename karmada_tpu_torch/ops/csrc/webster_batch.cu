// K4 webster_batch: the Webster allocation of K2's rows on its own, one
// problem row per warp or per block.
//
// Replaces karmada_tpu/ops/solver.py: webster_divide_batch (the vmapped
// webster_divide).  Inputs n int64[B]; w, s0, rank int64[B, L]; active
// bool[B, L] -> seats int64[B, L].
//
// Bound on the card: bytes, one read of the inputs and one write of seats
// (webster.cuh); the kernel's time is the latency of its searches'
// dependent group reductions.
//
// Design (webster.cuh has the row's): rows of up to KT_WARP_LANES lanes
// (K2's std tier, 656) run a row per warp, four to a block, with no block
// barrier; wider rows (the big tier, 5,248) a row per 512-thread block.  A
// row's lanes live in shared memory (KT_LANE_BYTES each) up to
// KT_SMEM_LANES lanes, in the caller's device-memory scratch beyond
// (kt_webster_layout gives the wrapper both numbers).  The library also
// exports kt_webster_floordiv, the division helper alone, for the card
// tests.
#include "webster.cuh"

constexpr int KT_WARP_LANES = 1024;
constexpr int KT_WARP_ROWS = 4;
constexpr int KT_SMEM_LANES = 8192;
constexpr int NT_WIDE = 512;

struct WebsterArgs {
  const i64* n;
  const i64* w;
  const i64* s0;
  const unsigned char* active;
  const i64* rank;
  i64* seats;
  unsigned char* scratch;  // B * L * KT_LANE_BYTES bytes, or null
  i64 B, L;
};

template <int NT, int R>
__global__ void __launch_bounds__(NT * R) webster_rows(WebsterArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ u64 red[2 * (NT / 32)];
  const int g = threadIdx.x / NT;
  const i64 b = (i64)blockIdx.x * R + g;
  if (b >= a.B) return;  // R > 1 only with NT == 32: no block barrier
  const i64 row_bytes = a.L * KT_LANE_BYTES;
  unsigned char* buf = a.scratch != nullptr ? a.scratch + b * row_bytes
                                            : smem + g * row_bytes;
  const i64 off = b * a.L;
  webster_row<NT>(a.n[b], a.w + off, a.s0 + off, a.active + off,
                  a.rank + off, a.seats + off, a.L, make_recip((u64)a.L),
                  buf, red);
}

template <typename K>
static cudaError_t allow_smem(K kernel) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              KT_SMEM_LANES * KT_LANE_BYTES);
}

extern "C" int kt_webster_batch(const WebsterArgs* a, void* stream) {
  if (a->B <= 0 || a->L <= 0) return 0;
  if ((a->L > KT_SMEM_LANES) != (a->scratch != nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const size_t row_bytes = (size_t)a->L * KT_LANE_BYTES;
  if (a->L <= KT_WARP_LANES) {
    static const cudaError_t ok = allow_smem(webster_rows<32, KT_WARP_ROWS>);
    if (ok != cudaSuccess) return (int)ok;
    const unsigned grid = (unsigned)((a->B + KT_WARP_ROWS - 1) / KT_WARP_ROWS);
    webster_rows<32, KT_WARP_ROWS>
        <<<grid, 32 * KT_WARP_ROWS, KT_WARP_ROWS * row_bytes, s>>>(*a);
  } else {
    static const cudaError_t ok = allow_smem(webster_rows<NT_WIDE, 1>);
    if (ok != cudaSuccess) return (int)ok;
    webster_rows<NT_WIDE, 1><<<(unsigned)a->B, NT_WIDE,
                               a->scratch ? 0 : row_bytes, s>>>(*a);
  }
  return (int)cudaGetLastError();
}

// {KT_SMEM_LANES, KT_LANE_BYTES}: the wrapper sizes a wide row's scratch
// by them.
extern "C" void kt_webster_layout(long long* out) {
  out[0] = KT_SMEM_LANES;
  out[1] = KT_LANE_BYTES;
}

// q[i] = a[i] // d[i] (Python floor division) through floordiv_r: any
// int64 a, 1 <= d <= 2^62 + 1.
struct FloordivArgs {
  const i64* a;
  const i64* d;
  i64* q;
  i64 n;
};

__global__ void __launch_bounds__(256) floordiv_kernel(FloordivArgs f) {
  const i64 i = (i64)blockIdx.x * 256 + threadIdx.x;
  if (i < f.n) f.q[i] = floordiv_r(f.a[i], make_recip((u64)f.d[i]));
}

extern "C" int kt_webster_floordiv(const FloordivArgs* f, void* stream) {
  if (f->n <= 0) return 0;
  floordiv_kernel<<<(unsigned)((f->n + 255) / 256), 256, 0,
                    (cudaStream_t)stream>>>(*f);
  return (int)cudaGetLastError();
}
