// K3 compact: row-major COO extraction of the dense chunk result.
//
// Replaces karmada_tpu/ops/solver.py: _compact_of (fused into
// schedule_compact / schedule_compact_donated).  mask[b, c] =
// (wanted_sel | rep > 0) with wanted_sel = sel (keep_sel) or
// sel & non_workload[b]; outputs idx int32 (flat b*C + c, ascending),
// val int32 (rep cast), and offsets int64[B+1] whose last entry is nnz.
//
// Bound on the card: bytes (rep and sel are read twice, once to count and
// once to write; the COO is written once).  Design: three launches on the
// stream -- per-row counts (one block per row), one block scanning the
// counts into row offsets, then one block per row writing its run in
// order with a ballot scan per tile.  The output is sized for B*C entries,
// so it cannot overflow: the JAX path's nnz-escalation re-solve has no
// counterpart.
#include "common.cuh"

constexpr int NT = 256;

struct CompactArgs {
  const i64* rep;                     // [B, C]
  const unsigned char* sel;           // [B, C]
  const unsigned char* non_workload;  // [B]
  int* idx;                           // [B * C]
  int* val;                           // [B * C]
  i64* offsets;                       // [B + 1]
  i64 B, C, keep_sel;
};

__device__ __forceinline__ bool wanted(const CompactArgs& a, bool nw, i64 o) {
  return (a.sel[o] && (a.keep_sel || nw)) || a.rep[o] > 0;
}

__global__ void __launch_bounds__(NT) count_kernel(CompactArgs a) {
  __shared__ i64 red[33];
  const i64 b = blockIdx.x;
  const bool nw = a.non_workload[b] != 0;
  i64 n = 0;
  for (i64 c = threadIdx.x; c < a.C; c += NT) n += wanted(a, nw, b * a.C + c);
  n = block_sum<NT>(n, red);
  if (threadIdx.x == 0) a.offsets[b + 1] = n;
}

__global__ void __launch_bounds__(1024) scan_kernel(CompactArgs a) {
  __shared__ i64 wbuf[33];
  __shared__ i64 carry;
  if (threadIdx.x == 0) { carry = 0; a.offsets[0] = 0; }
  __syncthreads();
  for (i64 base = 0; base < a.B; base += 1024) {
    const i64 b = base + threadIdx.x;
    const i64 v = b < a.B ? a.offsets[b + 1] : 0;
    const i64 ex = block_scan_excl<1024>(v, wbuf);
    const i64 c0 = carry;
    __syncthreads();
    if (b < a.B) a.offsets[b + 1] = c0 + ex + v;
    if (threadIdx.x == 1023) carry = c0 + ex + v;
    __syncthreads();
  }
}

__global__ void __launch_bounds__(NT) write_kernel(CompactArgs a) {
  __shared__ int wsum[NT / 32];
  const i64 b = blockIdx.x;
  const bool nw = a.non_workload[b] != 0;
  i64 out = a.offsets[b];
  for (i64 base = 0; base < a.C; base += NT) {
    const i64 c = base + threadIdx.x;
    const i64 o = b * a.C + c;
    const bool f = c < a.C && wanted(a, nw, o);
    int total;
    const int pre = block_scan_flag<NT>(f, wsum, &total);
    if (f) {
      a.idx[out + pre] = (int)o;
      a.val[out + pre] = (int)a.rep[o];
    }
    out += total;
  }
}

extern "C" int kt_compact(const CompactArgs* a, void* stream) {
  if (a->B <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  count_kernel<<<(unsigned)a->B, NT, 0, s>>>(*a);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  scan_kernel<<<1, 1024, 0, s>>>(*a);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  write_kernel<<<(unsigned)a->B, NT, 0, s>>>(*a);
  return (int)cudaGetLastError();
}
