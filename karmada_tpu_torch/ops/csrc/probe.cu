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
// (4.2 MFLOP) -- the launch.  At n = 1,024 operations, 2 n^3 = 2.1 GFLOP
// over the bf16 tensor-core rate (989 TFLOP/s): 0.0022 ms.  The design is
// Hopper's GEMM shape at its smallest: a 128 x 64 output tile a block (128
// blocks at n = 1,024, about one wave on 132 SMs); a ring of PM_STAGES
// stages in dynamic shared memory, each A[m0:+128, k0:+64] and
// A[k0:+64, n0:+64] as 64 x 64 boxes in the 128-byte swizzle; one producer
// thread (its own warp) keeps TMA loads (cp.async.bulk.tensor.2d) in
// flight on full / empty mbarrier pairs; two consumer warpgroups, 64 rows
// each, run wgmma.mma_async m64n64k16 (bf16 x bf16 -> fp32 accumulators in
// registers) on the stages that arrived.  Both operands are boxes of one
// tensor map over A: the A operand is K-major, the B operand (k rows, n
// contiguous) MN-major, read with wgmma's transpose bit for 16-bit B.
// TMA needs 16-byte global strides, so the kernel takes n % 8 == 0 only
// (the wrapper raises otherwise); it zero-fills boxes past the edge, so
// a ragged n needs no masking but the epilogue's.  The map is encoded per
// call with cuTensorMapEncodeTiled, reached through
// cudaGetDriverEntryPoint (nothing links -lcuda), and passed as a
// __grid_constant__ parameter.  Epilogue: each fp32 sum rounded once to
// bf16 (round to nearest even), stored as packed bf16x2.
//
// K15 replaces karmada_tpu/obs/devprof.py: capture_profile's marker op,
// jax.jit(lambda a: a * 2 + 1)(jnp.arange(128)).  It stamps a kernel that
// a profiler trace can be searched for into the capture window
// (obs/devprof.py); a torch elementwise op would show up as a generic
// elementwise_kernel.  Input a int64[n] (jnp.arange's dtype under the JAX
// package's x64 config) -> out[i] = a[i] * 2 + 1, wrapping on overflow as
// the JAX program does.  Bound: bytes, one read of a and one write of
// out; at n = 128 the launch, so its C entry does no more than the
// launch: no Python device context (it switches the device only when the
// operand's is not current), a grid sized once per card.  16-byte
// vectors, MA_VEC of them a thread a step, grid-stride over MA_BLOCKS_SM
// blocks an SM at most; a scalar head when `a` sits 8 bytes off a 16-byte
// boundary, a scalar tail for the odd element, scalar stores when `out`
// is aligned otherwise.  Both kernels are extern "C", so a trace shows
// their names unmangled.
#include "common.cuh"

#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>

typedef unsigned int u32;

constexpr int MAX_DEVICES = 64;

// Makes `dev` the calling thread's current device for the scope when it
// is not already, and restores the previous one after.
struct DeviceScope {
  int prev = -1;
  int err = 0;
  explicit DeviceScope(int dev) {
    int cur = 0;
    cudaError_t e = cudaGetDevice(&cur);
    if (e == cudaSuccess && cur != dev) {
      e = cudaSetDevice(dev);
      if (e == cudaSuccess) prev = cur;
    }
    err = (int)e;
    if (dev < 0 || dev >= MAX_DEVICES) err = (int)cudaErrorInvalidDevice;
  }
  ~DeviceScope() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

// -- K14 ---------------------------------------------------------------------

constexpr int PM_BM = 128, PM_BN = 64, PM_BK = 64, PM_STAGES = 4;
constexpr int PM_CONSUMERS = 2;  // warpgroups, 64 rows of the tile each
constexpr int PM_THREADS = 128 * PM_CONSUMERS + 32;  // + the producer warp
constexpr int PM_BOX = 64;                           // a TMA box: 64 x 64
constexpr int PM_BOX_BYTES = PM_BOX * PM_BOX * 2;
constexpr int PM_STAGE_BYTES = 3 * PM_BOX_BYTES;     // A's two boxes, B's
// the ring, 1,024 bytes to align it (the swizzle's atom), the barriers
constexpr int PM_SMEM = PM_STAGES * PM_STAGE_BYTES + 1024 + 2 * PM_STAGES * 8;

struct ProbeMmArgs {
  const __nv_bfloat16* a;
  __nv_bfloat16* c;
  i64 n;
  i64 device;
};

__device__ __forceinline__ u32 smem_addr(const void* p) {
  return (u32)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(u32 bar, u32 count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(u32 bar, u32 bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(u32 bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Waits until the barrier's phase of this parity has completed.  A wait
// past PM_MAX_POLLS polls (seconds; a stage lands in microseconds) traps,
// so a broken pipeline fails its launch instead of holding the card.
constexpr u32 PM_MAX_POLLS = 1u << 26;

__device__ __forceinline__ void mbar_wait(u32 bar, u32 parity) {
  u32 done = 0;
  for (u32 polls = 0; !done; ++polls) {
    if (polls == PM_MAX_POLLS) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One 64 x 64 box of the map at (x = inner coordinate, y = row) into
// shared memory, its bytes counted on `bar`.
__device__ __forceinline__ void tma_box(u32 dst, const CUtensorMap* map,
                                        u32 bar, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"((u64)map), "r"(bar), "r"(x), "r"(y)
      : "memory");
}

// wgmma's shared-memory matrix descriptor for the 128-byte swizzle:
// start address, leading and stride byte offsets in 16-byte units.
__device__ __forceinline__ u64 smem_desc(u32 addr, u32 lbo, u32 sbo) {
  return (u64)((addr & 0x3FFFF) >> 4) | ((u64)lbo << 16) |
         ((u64)sbo << 32) | (1ull << 62);
}

__device__ __forceinline__ void acc_fence(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += A(64 x 16, K-major) * B(16 x 64, MN-major: transpose bit set).
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], u64 da,
                                                u64 db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

extern "C" __global__ void __launch_bounds__(PM_THREADS)
    probe_mm_kernel(const __grid_constant__ CUtensorMap map,
                    __nv_bfloat16* __restrict__ c, int n) {
  extern __shared__ unsigned char pm_raw[];
  const u32 raw = smem_addr(pm_raw);
  unsigned char* ring = pm_raw + ((1024 - (raw & 1023)) & 1023);
  u64* full = (u64*)(ring + PM_STAGES * PM_STAGE_BYTES);
  u64* empty = full + PM_STAGES;
  const int tid = threadIdx.x, wg = tid / 128;
  const int m0 = blockIdx.y * PM_BM, n0 = blockIdx.x * PM_BN;
  const int ktiles = (n + PM_BK - 1) / PM_BK;
  if (tid == 0) {
    for (int s = 0; s < PM_STAGES; ++s) {
      mbar_init(smem_addr(&full[s]), 1);
      mbar_init(smem_addr(&empty[s]), PM_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (wg == PM_CONSUMERS) {  // the producer warp: one thread issues
    if (tid == 128 * PM_CONSUMERS) {
      for (int kt = 0; kt < ktiles; ++kt) {
        const int s = kt % PM_STAGES;
        if (kt >= PM_STAGES)
          mbar_wait(smem_addr(&empty[s]), (kt / PM_STAGES - 1) & 1);
        const u32 bar = smem_addr(&full[s]);
        const u32 st = smem_addr(ring + s * PM_STAGE_BYTES);
        const int k0 = kt * PM_BK;
        mbar_expect_tx(bar, PM_STAGE_BYTES);
        tma_box(st, &map, bar, k0, m0);  // A[m0:+64, k0:+64]
        tma_box(st + PM_BOX_BYTES, &map, bar, k0, m0 + PM_BOX);
        tma_box(st + 2 * PM_BOX_BYTES, &map, bar, n0, k0);  // B operand
      }
    }
    return;
  }
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < ktiles; ++kt) {
    const int s = kt % PM_STAGES;
    mbar_wait(smem_addr(&full[s]), (kt / PM_STAGES) & 1);
    const u32 st = smem_addr(ring + s * PM_STAGE_BYTES);
    const u32 a_rows = st + wg * PM_BOX_BYTES, b_tile = st + 2 * PM_BOX_BYTES;
    acc_fence(acc);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < PM_BK / 16; ++kk) {
      // A: 16 k a step are 32 bytes along its swizzled 128-byte rows, the
      // 8-row groups 1,024 bytes apart; B: 16 k a step are 16 rows of 128
      // bytes, its 8-row groups 1,024 bytes apart (one 64-wide n atom)
      wgmma_m64n64k16(acc, smem_desc(a_rows + kk * 32, 1, 64),
                      smem_desc(b_tile + kk * 2048, 64, 64));
    }
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    acc_fence(acc);
    if (tid % 128 == 0) mbar_arrive(smem_addr(&empty[s]));
  }
  // wgmma's fp32 fragment: warp w of the warpgroup holds rows 16 w + l / 4
  // and + 8 (l the lane), columns 8 j + 2 (l % 4) + {0, 1} in d[4 j ..]
  const int w = (tid % 128) / 32, l = tid % 32;
  const int row = m0 + wg * 64 + w * 16 + l / 4;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = n0 + 8 * j + 2 * (l % 4);
    if (col >= n) continue;  // n % 8 == 0: a pair never straddles the edge
    if (row < n)
      *(__nv_bfloat162*)(c + (i64)row * n + col) =
          __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
    if (row + 8 < n)
      *(__nv_bfloat162*)(c + (i64)(row + 8) * n + col) =
          __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up once through the runtime.
static EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = (EncodeTiled)p;
  }
  return fn;
}

// Returns a CUDA error code: cudaErrorInvalidValue for an n that is not a
// multiple of 8, an A off a 16-byte boundary or a map the encoder refuses;
// cudaErrorNotSupported when the runtime finds no cuTensorMapEncodeTiled.
extern "C" int kt_probe_mm(const ProbeMmArgs* p, void* stream) {
  const i64 n = p->n;
  if (n <= 0) return 0;
  if (n % 8 != 0 || n >= (1LL << 30) || ((uintptr_t)p->a & 15) != 0)
    return (int)cudaErrorInvalidValue;
  DeviceScope scope((int)p->device);
  if (scope.err != 0) return scope.err;
  static bool allowed[MAX_DEVICES];
  if (!allowed[p->device]) {
    const cudaError_t e = cudaFuncSetAttribute(
        probe_mm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        PM_SMEM);
    if (e != cudaSuccess) return (int)e;
    allowed[p->device] = true;
  }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap map;
  const cuuint64_t dims[2] = {(cuuint64_t)n, (cuuint64_t)n};
  const cuuint64_t strides[1] = {(cuuint64_t)n * 2};
  const cuuint32_t box[2] = {PM_BOX, PM_BOX};
  const cuuint32_t unit[2] = {1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, (void*)p->a, dims,
             strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((n + PM_BN - 1) / PM_BN),
                  (unsigned)((n + PM_BM - 1) / PM_BM));
  probe_mm_kernel<<<grid, PM_THREADS, PM_SMEM, (cudaStream_t)stream>>>(
      map, p->c, (int)n);
  return (int)cudaGetLastError();
}

// -- K15 ---------------------------------------------------------------------

constexpr int MA_THREADS = 256;
constexpr int MA_VEC = 4;        // 16-byte vectors a thread a step
constexpr int MA_BLOCKS_SM = 4;  // blocks an SM at most (grid-stride)

struct MarkerArgs {
  const i64* a;
  i64* out;
  i64 n;
  i64 device;
};

// Unsigned arithmetic: the product wraps as the JAX program's does (signed
// overflow is undefined in C++).
__device__ __forceinline__ i64 affine(i64 x) {
  return (i64)((u64)x * 2ull + 1ull);
}

// head (0 or 1): the elements before `a`'s first 16-byte boundary;
// out_vec: out + head is 16-byte aligned too.
extern "C" __global__ void __launch_bounds__(MA_THREADS)
    marker_affine_i64(const i64* __restrict__ a, i64* __restrict__ out,
                      i64 n, i64 head, int out_vec) {
  const i64 t = (i64)blockIdx.x * MA_THREADS + threadIdx.x;
  const i64 stride = (i64)gridDim.x * MA_THREADS;
  const i64 nv = (n - head) / 2;
  if (t < head) out[t] = affine(a[t]);
  if (t == 0 && ((n - head) & 1)) out[n - 1] = affine(a[n - 1]);
  const longlong2* av = (const longlong2*)(a + head);
  i64* ob = out + head;
  for (i64 v0 = t; v0 < nv; v0 += stride * MA_VEC) {
    longlong2 x[MA_VEC];
#pragma unroll
    for (int u = 0; u < MA_VEC; ++u) {
      const i64 v = v0 + u * stride;
      if (v < nv) x[u] = __ldg(av + v);
    }
#pragma unroll
    for (int u = 0; u < MA_VEC; ++u) {
      const i64 v = v0 + u * stride;
      if (v >= nv) continue;
      longlong2 y;
      y.x = affine(x[u].x);
      y.y = affine(x[u].y);
      if (out_vec) {
        ((longlong2*)ob)[v] = y;
      } else {
        ob[2 * v] = y.x;
        ob[2 * v + 1] = y.y;
      }
    }
  }
}

extern "C" int kt_marker_affine(const MarkerArgs* m, void* stream) {
  const i64 n = m->n;
  if (n <= 0) return 0;
  if ((((uintptr_t)m->a | (uintptr_t)m->out) & 7) != 0)
    return (int)cudaErrorMisalignedAddress;
  DeviceScope scope((int)m->device);
  if (scope.err != 0) return scope.err;
  static int sms[MAX_DEVICES];
  if (sms[m->device] == 0) {
    const cudaError_t e = cudaDeviceGetAttribute(
        &sms[m->device], cudaDevAttrMultiProcessorCount, (int)m->device);
    if (e != cudaSuccess) return (int)e;
  }
  const i64 head = ((uintptr_t)m->a & 15) ? 1 : 0;
  const int out_vec = (((uintptr_t)(m->out + head)) & 15) == 0;
  const i64 per_block = (i64)MA_THREADS * MA_VEC;
  i64 blocks = ((n - head) / 2 + per_block - 1) / per_block;
  if (blocks > (i64)sms[m->device] * MA_BLOCKS_SM)
    blocks = (i64)sms[m->device] * MA_BLOCKS_SM;
  if (blocks < 1) blocks = 1;
  marker_affine_i64<<<(unsigned)blocks, MA_THREADS, 0,
                      (cudaStream_t)stream>>>(m->a, m->out, n, head,
                                              out_vec);
  return (int)cudaGetLastError();
}
