// K4 webster_batch: the Webster allocation of K2 on its own, one block per
// problem row.
//
// Replaces karmada_tpu/ops/solver.py: webster_divide_batch (the vmapped
// webster_divide).  Inputs n int64[B]; w, s0, rank int64[B, L]; active
// bool[B, L] -> seats int64[B, L].
//
// Bound on the card: operations (see webster.cuh); bytes are one read of
// the inputs and one write of seats.  Design: the lanes stay in device
// memory and are re-read each bisection step; a row's few KB stay in L1.
#include "webster.cuh"

constexpr int NT = 256;

struct WebsterArgs {
  const i64* n;
  const i64* w;
  const i64* s0;
  const unsigned char* active;
  const i64* rank;
  i64* seats;
  i64 B, L;
};

__global__ void __launch_bounds__(NT) webster_batch_kernel(WebsterArgs a) {
  __shared__ i64 red[33];
  const i64 b = blockIdx.x;
  const i64 off = b * a.L;
  webster_block<NT>(a.n[b], a.w + off, a.s0 + off, a.active + off,
                    a.rank + off, (int)a.L, a.seats + off, red);
}

extern "C" int kt_webster_batch(const WebsterArgs* a, void* stream) {
  if (a->B <= 0 || a->L <= 0) return 0;
  webster_batch_kernel<<<(unsigned)a->B, NT, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}
