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
// Design (webster.cuh has the row's and the launch, which K2's wave
// entries share): rows of up to KT_WARP_LANES lanes (K2's std tier, 656)
// run a row per warp, four to a block, with no block barrier; wider rows
// (the big tier, 5,248) a row per 512-thread block.  A row's lanes live in
// shared memory (KT_LANE_BYTES each) up to KT_SMEM_LANES lanes, in the
// caller's device-memory scratch beyond (kt_webster_layout gives the
// wrapper both numbers).  The library also exports kt_webster_floordiv,
// the division helper alone, for the card tests.
#include "webster.cuh"

extern "C" int kt_webster_batch(const WebsterArgs* a, void* stream) {
  return launch_webster(*a, (cudaStream_t)stream);
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
