// K14 probe_mm and K15 marker_affine: the device lifecycle's two kernels.
//
// K14 replaces karmada_tpu/utils/deviceprobe.py: _PROBE_SNIPPET's
// jax.jit(lambda a: a @ a) on a 128 x 128 bf16 matrix of ones.  The probe
// subprocess (utils/deviceprobe.py) launches it on every visible card to
// show that the port's own kernel path works there: the nvcc build, the
// ctypes load and a launch on the current stream.  A library matmul would
// pass on a card whose kernels cannot build.  Input a bf16[n, n] -> c =
// a @ a, bf16[n, n], each entry a float32 sum rounded once to bf16 (round
// to nearest even), as XLA's bf16 dot accumulates.
//
// Bound on the card: at n = 128 neither bytes (64 KiB) nor operations
// (4.2 MFLOP) -- the launch.  At n = 1,024 operations, 2 n^3 = 2.1 GFLOP,
// over the bf16 tensor-core rate.  The kernel is the simple one the probe
// needs, not a fast one: a 16 x 16 output tile a block, a thread an entry,
// the k loop over 16-wide tiles of A's rows and of A's columns staged in
// shared memory (as float32), one fused multiply-add a step on the CUDA
// cores.
//
// K15 replaces karmada_tpu/obs/devprof.py: capture_profile's marker op,
// jax.jit(lambda a: a * 2 + 1)(jnp.arange(128)).  It stamps a kernel that
// a profiler trace can be searched for into the capture window
// (obs/devprof.py); a torch elementwise op would show up as a generic
// elementwise_kernel.  Input a int64[n] (jnp.arange's dtype under the JAX
// package's x64 config) -> out[i] = a[i] * 2 + 1, wrapping on overflow as
// the JAX program does.  Bound: bytes, one
// read of a and one write of out; at n = 128 the launch.  A thread an
// element.  Both kernels are extern "C", so the trace shows their names
// unmangled.
#include "common.cuh"

#include <cuda_bf16.h>

#define PM_TILE 16
#define MA_THREADS 256

struct ProbeMmArgs {
  const __nv_bfloat16* a;
  __nv_bfloat16* c;
  i64 n;
};

extern "C" __global__ void __launch_bounds__(PM_TILE * PM_TILE)
    probe_mm_kernel(ProbeMmArgs p) {
  __shared__ float rows[PM_TILE][PM_TILE];  // A[row tile, k tile]
  __shared__ float cols[PM_TILE][PM_TILE];  // A[k tile, column tile]
  const int tx = threadIdx.x, ty = threadIdx.y;
  const i64 n = p.n;
  const i64 row = (i64)blockIdx.y * PM_TILE + ty;
  const i64 col = (i64)blockIdx.x * PM_TILE + tx;
  float acc = 0.f;
  for (i64 k0 = 0; k0 < n; k0 += PM_TILE) {
    const i64 ka = k0 + tx, kb = k0 + ty;
    rows[ty][tx] =
        (row < n && ka < n) ? __bfloat162float(p.a[row * n + ka]) : 0.f;
    cols[ty][tx] =
        (kb < n && col < n) ? __bfloat162float(p.a[kb * n + col]) : 0.f;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < PM_TILE; ++k) acc = fmaf(rows[ty][k], cols[k][tx], acc);
    __syncthreads();
  }
  if (row < n && col < n) p.c[row * n + col] = __float2bfloat16_rn(acc);
}

extern "C" int kt_probe_mm(const ProbeMmArgs* p, void* stream) {
  if (p->n <= 0) return 0;
  const unsigned tiles = (unsigned)((p->n + PM_TILE - 1) / PM_TILE);
  probe_mm_kernel<<<dim3(tiles, tiles), dim3(PM_TILE, PM_TILE), 0,
                    (cudaStream_t)stream>>>(*p);
  return (int)cudaGetLastError();
}

struct MarkerArgs {
  const i64* a;
  i64* out;
  i64 n;
};

// Unsigned arithmetic: the product wraps as the JAX program's does (signed
// overflow is undefined in C++).
extern "C" __global__ void __launch_bounds__(MA_THREADS)
    marker_affine_i64(const i64* a, i64* out, i64 n) {
  const i64 i = (i64)blockIdx.x * MA_THREADS + threadIdx.x;
  if (i < n) out[i] = (i64)((u64)a[i] * 2ull + 1ull);
}

extern "C" int kt_marker_affine(const MarkerArgs* m, void* stream) {
  if (m->n <= 0) return 0;
  const unsigned blocks = (unsigned)((m->n + MA_THREADS - 1) / MA_THREADS);
  marker_affine_i64<<<blocks, MA_THREADS, 0, (cudaStream_t)stream>>>(
      (const i64*)m->a, (i64*)m->out, m->n);
  return (int)cudaGetLastError();
}
