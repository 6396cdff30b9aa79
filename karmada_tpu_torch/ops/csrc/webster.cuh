// Closed-form Sainte-Lague (Webster) allocation of one problem row by a
// group of NT threads: one warp (NT = 32, no block barrier) or the whole
// block (NT = 512).
//
// Replaces karmada_tpu/ops/solver.py: webster_divide (the JAX program's
// integer threshold bisection plus one-shot tie-block award).
//
// Semantics (bit-exact with the JAX program): w clamped to [0, 2^34-1] and
// s0 to [0, 2^25-1] on active lanes; n_eff = clamp(n, 0, 2^25-1) when the
// total weight is positive, else 0.  Candidate "s-th seat of lane i" has
// priority q = (w << 28) // (2s+1); cnt(t) counts, per lane clamped to
// n_eff, the candidates with s >= s0 and q > t.  t* is the least t with
// cnt(t) <= n_eff (0 when cnt(0) <= n_eff); every candidate with q > t* is
// awarded; when t* > 0 the r = n_eff - cnt(t*) remaining seats go to the
// tie block q == t* in order of the key seat*L + rank, the least key K*
// whose count reaches r found by a second bisection.
//
// Bound on the card: bytes -- one read of w, s0 and active (17 bytes a
// lane; rank only on tie lanes) and one write of seats (8) -- at the
// card's memory rate; the operations (a compare per positive lane and
// search point, a division per kept lane and search point) over its peak
// rate come to far less.  What keeps the kernel above that bound is
// latency: each search round is a chain of dependent reductions.
//
// Design.  A search for the least point where a monotone predicate holds
// returns the same point whatever bracket it starts from, as long as the
// predicate fails at the bracket's low end and holds at its high end, and
// whatever points it tests inside.  So the brackets below are tighter
// than the JAX program's, each search tests several points a round
// (least_holding), and the results are bit for bit its own:
//  1. Lanes loaded once: one read of w, s0, active per lane (the loads of
//     KT_LOAD_UNROLL chunks in flight together, no branch among them);
//     every lane's default seats (s0 when active, else 0) are written
//     there, and the positive lanes are compacted (wq, s0, lane index,
//     then their first candidate f = wq // (2 s0 + 1)) into the row's
//     shared memory, or into a device-memory scratch when a row's lanes
//     do not fit.
//  2. Select (when P, the positive lanes, exceed n_eff): G, the
//     (n_eff+1)-th largest first candidate with its low bits cleared, by a
//     search over the keys f >> shift (compares only; shift drops the
//     bits every f has zero -- f = w << 28 when s0 = 0 -- or the bits
//     below the top 32).  n_eff + 1 lanes have a candidate >= G, so
//     cnt(G - 1) > n_eff and t* >= G: a lane whose first candidate is
//     below G has no candidate >= t*, never counts at the thresholds still
//     searched, takes no seat above t* and none of the tie block.  Those
//     lanes are dropped; the rest (K, the kept lanes) are compacted in
//     place.
//  3. Threshold search over (G - 1, F_1], F_1 the largest first candidate
//     (cnt(F_1) = 0), on the kept lanes only.  A point's lanes divide by
//     the same t + 1: one FP64 reciprocal per point, each quotient
//     corrected to the exact floor (common.cuh udiv).
//  4. Tie search, only when r > 0 and t* > 0, over (0, H] with H the
//     largest tie key + 1 (capped by the JAX program's 2^27 L): the tie
//     candidates number cnt(t* - 1) - cnt(t*) > r, all with keys below H,
//     so the count reaches r at H.  The key's floor division by L uses the
//     launch's one reciprocal, floor semantics kept for negative
//     numerators (K - 1 - rank < 0).
// Counts are summed in 32 bits, each partial saturated at the bound its
// predicate compares with (n_eff + 1, or r): every term is >= 0, so the
// predicate is unchanged, and a sum the result uses exactly (cnt(t*) <=
// n_eff) never saturates.
#pragma once

#include "common.cuh"

#define KT_QBITS 28
#define KT_W_CAP ((1LL << 34) - 1)
#define KT_N_CAP ((1LL << 25) - 1)
// bytes of one lane's arrays: f (later rank), wq (later the tie count k),
// s0 (later base = s0 + full), the lane index
#define KT_LANE_BYTES 24

typedef unsigned int u32;

// JAX _count_above of one positive lane: #{s in [s0, s0 + n) : wq // (2s
// + 1) > t}, with d the reciprocal of t + 1.
__device__ __forceinline__ u32 count_above(u64 wq, u32 s0, u32 n,
                                           const Recip& d) {
  const i64 c = (i64)((udiv(wq, d) + 1) >> 1) - (i64)s0;
  return c <= 0 ? 0u : (c >= (i64)n ? n : (u32)c);
}

// JAX cnt_key of one lane: its tie candidates (seats base .. base + k - 1)
// whose key seat * L + rank is below K, clip((K - 1 - rank) // L - base +
// 1, 0, k), in int64 that wraps like XLA's.
__device__ __forceinline__ u32 tie_count(i64 K, u64 rank, u32 base, u64 k,
                                         const Recip& rL) {
  const i64 fl = floordiv_r((i64)((u64)K - 1 - rank), rL);
  const i64 c = (i64)((u64)fl - base + 1);
  return (u32)clampll(c, 0, (i64)k);
}

// -- group primitives: a warp (NT == 32) or the block ---------------------
// `red` is 2 * NT / 32 u64 of shared memory (NT > 32), used in turns by
// `par` so that one barrier per reduction suffices.

template <int NT>
__device__ __forceinline__ void group_sync() {
  if constexpr (NT == 32) __syncwarp(); else __syncthreads();
}

// max (OR when `bits`) of one u64 per thread over the group
template <int NT>
__device__ __forceinline__ u64 group_max(u64 v, bool bits, u64* red,
                                         int& par) {
  for (int o = 16; o > 0; o >>= 1) {
    const u64 x = __shfl_xor_sync(KT_FULL_MASK, v, o);
    v = bits ? (v | x) : max(v, x);
  }
  if constexpr (NT == 32) {
    return v;
  } else {
    u64* slot = red + par * (NT / 32);
    par ^= 1;
    if ((threadIdx.x & 31) == 0) slot[threadIdx.x >> 5] = v;
    __syncthreads();
    v = 0;
#pragma unroll
    for (int w = 0; w < NT / 32; ++w)
      v = bits ? (v | slot[w]) : max(v, slot[w]);
    return v;
  }
}

// Sum of one u32 <= cap per thread (cap < 2^26), saturated at cap.
template <int NT>
__device__ __forceinline__ u32 group_sum(u32 v, u32 cap, u64* red,
                                         int& par) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(KT_FULL_MASK, v, o);
  v = min(v, cap);
  if constexpr (NT == 32) {
    return v;
  } else {
    u64* slot = red + par * (NT / 32);
    par ^= 1;
    if ((threadIdx.x & 31) == 0) slot[threadIdx.x >> 5] = v;
    __syncthreads();
    u64 s = 0;
#pragma unroll
    for (int w = 0; w < NT / 32; ++w) s += slot[w];
    return (u32)min(s, (u64)cap);
  }
}

// Exclusive prefix of one flag per thread in thread order; *total gets the
// group's count.
template <int NT>
__device__ __forceinline__ u32 group_scan(bool flag, u32* total, u64* red,
                                          int& par) {
  const unsigned ball = __ballot_sync(KT_FULL_MASK, flag);
  const int lane = threadIdx.x & 31;
  const u32 pre = __popc(ball & ((1u << lane) - 1u));
  if constexpr (NT == 32) {
    *total = __popc(ball);
    return pre;
  } else {
    u64* slot = red + par * (NT / 32);
    par ^= 1;
    if (lane == 0) slot[threadIdx.x >> 5] = __popc(ball);
    __syncthreads();
    const int wid = threadIdx.x >> 5;
    u32 off = 0, tot = 0;
#pragma unroll
    for (int w = 0; w < NT / 32; ++w) {
      const u32 c = (u32)slot[w];
      off += w < wid ? c : 0;
      tot += c;
    }
    *total = tot;
    return off + pre;
  }
}

// Subgroup size for a search over `lanes` lanes: about `per` lanes a
// thread of a subgroup (a power of two within the warp); the block's
// subgroups are its warps.
template <int NT>
__device__ __forceinline__ u32 subgroup(u32 lanes, u32 per) {
  if constexpr (NT > 32) return 32;
  const u32 want = (lanes + per - 1) / per;
  return want <= 1 ? 1u : min(32u, 1u << (32 - __clz(want - 1)));
}

// The least x in (lo, hi] where `holds` does, for a predicate monotone in
// x that fails at lo and holds at hi (the group's searches).  Each round
// tests T = NT / S points that split (lo, hi] into about T + 1 parts, one
// point per subgroup of S threads: count(x, first, stride) is a thread's
// partial count over the lanes first, first + stride, ... (saturated at
// cap), summed over the subgroup; holds(sum) is the predicate there.  The
// points that fail precede the points that hold, so the first that holds
// and the last that fails bound the next round: log2(T + 1) bits a round.
// The result does not depend on where the points fall, only on their
// order and on each lying in (lo, hi), so they are placed in FP64: lo +
// trunc((hi - lo) (k + 1) / (T + 1)), clamped to [lo + 1, hi - 1] --
// monotone in k, and the search narrows every round.
template <int NT, typename Count, typename Holds>
__device__ u64 least_holding(u64 lo, u64 hi, u32 S, u32 cap, Count count,
                             Holds holds, u64* red, int& par) {
  const u32 tid = threadIdx.x % NT;
  const u32 T = NT / S, g = tid / S, sl = tid % S;
  const double step = __ddiv_rn(1.0, (double)(T + 1));
  while (hi - lo > 1) {
    const u64 D = hi - lo;
    const double Dd = __ull2double_rn(D);
    auto point = [&](u32 k) {
      const u64 o = __double2ull_rz(
          __dmul_rn(Dd, __dmul_rn(step, (double)(k + 1))));
      return lo + min(max(o, (u64)1), D - 1);
    };
    u32 c = count(point(g), sl, S);
    for (u32 o = S >> 1; o > 0; o >>= 1)
      c = min(c + __shfl_xor_sync(KT_FULL_MASK, c, o), cap);
    const bool h = holds(c);
    u32 fail;  // points that fail
    if constexpr (NT == 32) {
      fail = T - __popc(__ballot_sync(KT_FULL_MASK, h && sl == 0));
    } else {
      u64* slot = red + par * (NT / 32);
      par ^= 1;
      if (sl == 0) slot[g] = h;
      __syncthreads();
      fail = 0;
#pragma unroll
      for (int w = 0; w < NT / 32; ++w) fail += slot[w] ? 0u : 1u;
    }
    const u64 nlo = fail > 0 ? point(fail - 1) : lo;
    hi = fail < T ? point(fail) : hi;
    lo = nlo;
  }
  return hi;
}

// chunks of NT lanes whose loads a thread of the first pass has in flight
// together
#define KT_LOAD_UNROLL 8

// Sum of lane(j) over j = first, first + stride, ... below `count`,
// saturated at cap (lane(j) <= 2^25).  Four lanes at a time in straight-
// line code: a lane past the end repeats the group's first and counts 0,
// so no branch splits the group and the four lanes' loads and division
// chains run together.
template <typename Lane>
__device__ __forceinline__ u32 sum_lanes(u32 first, u32 stride, u32 count,
                                         u32 cap, Lane lane) {
  u32 c = 0;
  for (u32 j0 = first; j0 < count; j0 += 4 * stride) {
    u32 part = 0;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const u32 j = j0 + u * stride;
      const u32 v = lane(j < count ? j : j0);
      part += j < count ? v : 0u;
    }
    c = min(c + part, cap);
  }
  return c;
}

// Seats of one row into `seats` (w/s0/active/rank/seats point at the
// row); `buf` holds KT_LANE_BYTES * L bytes (shared or device memory),
// `rL` is the reciprocal of L.  Every thread of the group calls it.
template <int NT>
__device__ void webster_row(i64 n_in, const i64* w, const i64* s0,
                            const unsigned char* active, const i64* rank,
                            i64* seats, i64 L, const Recip& rL,
                            unsigned char* buf, u64* red) {
  const u32 tid = threadIdx.x % NT;
  u64* f = (u64*)buf;
  u64* wq = f + L;
  u32* s0v = (u32*)(wq + L);
  u32* idx = s0v + L;
  int par = 0;

  // 1. lanes, once: default seats, positive lanes compacted
  u32 P = 0;
  for (i64 base = 0; base < L; base += KT_LOAD_UNROLL * NT) {
    i64 wr[KT_LOAD_UNROLL], sr[KT_LOAD_UNROLL];
    bool ar[KT_LOAD_UNROLL];
#pragma unroll
    for (int u = 0; u < KT_LOAD_UNROLL; ++u) {
      const i64 i = base + u * NT + tid;
      ar[u] = i < L && active[i] != 0;
      wr[u] = i < L ? w[i] : 0;
      sr[u] = i < L ? s0[i] : 0;
    }
#pragma unroll
    for (int u = 0; u < KT_LOAD_UNROLL; ++u) {
      const i64 i = base + u * NT + tid;
      const i64 wi = ar[u] ? clampll(wr[u], 0, KT_W_CAP) : 0;
      const u32 s0i = ar[u] ? (u32)clampll(sr[u], 0, KT_N_CAP) : 0u;
      if (i < L) seats[i] = s0i;
      const bool pos = wi > 0;
      u32 tot;
      const u32 at = P + group_scan<NT>(pos, &tot, red, par);
      if (pos) {
        wq[at] = (u64)wi << KT_QBITS;
        s0v[at] = s0i;
        idx[at] = (u32)i;
      }
      P += tot;
    }
  }
  const u32 n = P > 0 ? (u32)clampll(n_in, 0, KT_N_CAP) : 0u;
  if (n == 0) return;  // every lane keeps its default seats
  group_sync<NT>();
  // first candidates (a division only where s0 > 0)
  u64 fmax = 0, fbits = 0;
  for (u32 j = tid; j < P; j += NT) {
    const u64 fj = s0v[j] == 0 ? wq[j] : wq[j] / (2 * (u64)s0v[j] + 1);
    f[j] = fj;
    fmax = max(fmax, fj);
    fbits |= fj;
  }
  fmax = group_max<NT>(fmax, false, red, par);
  fbits = group_max<NT>(fbits, true, red, par);
  group_sync<NT>();

  // 2. select and drop the lanes below G: keys are f >> shift, shift the
  // bits every f has zero below (f = w << 28 when s0 = 0) or that leave 32
  u64 G = 0;
  u32 K = P;
  if (P > n) {
    const int shift =
        max(__ffsll((long long)fbits) - 1, 32 - __clzll((long long)fmax));
    // the least x with #(key >= x) <= n, one past the (n+1)-th largest key
    const u64 past = least_holding<NT>(
        0, (fmax >> shift) + 1, subgroup<NT>(P, 16), n + 1,
        [&](u64 x, u32 first, u32 stride) {
          return sum_lanes(first, stride, P, n + 1, [&](u32 j) {
            return (f[j] >> shift) >= x ? 1u : 0u;
          });
        },
        [&](u32 c) { return c <= n; }, red, par);
    G = (past - 1) << shift;
    K = 0;
    for (u32 base = 0; base < P; base += NT) {
      const u32 j = base + tid;
      bool keep = false;
      u64 wqj = 0;
      u32 s0j = 0, ij = 0;
      if (j < P) {
        keep = f[j] >= G;
        wqj = wq[j];
        s0j = s0v[j];
        ij = idx[j];
      }
      u32 tot;
      const u32 at = K + group_scan<NT>(keep, &tot, red, par);
      group_sync<NT>();  // the chunk is read before it is written over
      if (keep) {
        wq[at] = wqj;
        s0v[at] = s0j;
        idx[at] = ij;
      }
      K += tot;
    }
    group_sync<NT>();
  }

  // 3. threshold search on the kept lanes
  auto cnt = [&](u64 t, u32 first, u32 stride) -> u32 {
    const Recip d = make_recip(t + 1);
    return sum_lanes(first, stride, K, n + 1, [&](u32 j) {
      return count_above(wq[j], s0v[j], n, d);
    });
  };
  u64 t_star = 0;
  if (G > 0 || group_sum<NT>(cnt(0, tid, NT), n + 1, red, par) > n)
    t_star = least_holding<NT>(G > 0 ? G - 1 : 0, fmax, subgroup<NT>(K, 8),
                               n + 1, cnt, [&](u32 c) { return c <= n; },
                               red, par);
  group_sync<NT>();  // every count is read before base and k overwrite it

  // 4. full award above t*; the tie block at q == t* (t* > 0)
  const Recip d0 = make_recip(t_star + 1);
  const Recip d1 = make_recip(t_star > 0 ? t_star : 1);
  u32 fs = 0;
  for (u32 j = tid; j < K; j += NT) {
    const u32 full = count_above(wq[j], s0v[j], n, d0);
    const u32 k =
        t_star > 0 ? count_above(wq[j], s0v[j], n, d1) - full : 0u;
    fs = min(fs + full, n + 1);
    s0v[j] += full;  // base
    wq[j] = k;
  }
  const u32 r = n - group_sum<NT>(fs, n + 1, red, par);
  i64 k_star = 0;
  const bool tie = r > 0 && t_star > 0;
  if (tie) {
    const i64 khi = (1LL << 27) * L;
    u64 kmax = 0;  // the largest tie key + 2^63 (order-preserving)
    for (u32 j = tid; j < K; j += NT) {
      const i64 rk = rank[idx[j]];
      f[j] = (u64)rk;
      if (wq[j] > 0) {
        const u64 key = (u64)(s0v[j] + wq[j] - 1) * (u64)L + (u64)rk;
        kmax = max(kmax, key ^ (1ULL << 63));
      }
    }
    group_sync<NT>();
    const i64 key_max =
        (i64)(group_max<NT>(kmax, false, red, par) ^ (1ULL << 63));
    const i64 hi = key_max < khi ? key_max + 1 : khi;
    k_star = (i64)least_holding<NT>(
        0, hi < 1 ? 1 : (u64)hi, subgroup<NT>(K, 8), r,
        [&](u64 x, u32 first, u32 stride) {
          return sum_lanes(first, stride, K, r, [&](u32 j) {
            return tie_count((i64)x, f[j], s0v[j], wq[j], rL);
          });
        },
        [&](u32 c) { return c >= r; }, red, par);
  }
  for (u32 j = tid; j < K; j += NT) {
    const u32 award = tie ? tie_count(k_star, f[j], s0v[j], wq[j], rL) : 0u;
    seats[idx[j]] = (i64)s0v[j] + award;
  }
}

// K4's launch, from one argument block: webster_batch.cu's
// kt_webster_batch (K4 alone) and schedule_rows.cu's wave entries (K4
// between K2's prepare and finish kernels, in one C call) enqueue it.
// Rows of up to KT_WARP_LANES lanes (K2's std tier, 656) run a row per
// warp, KT_WARP_ROWS to a block, with no block barrier; wider rows (the
// big tier, 5,248) a row per NT_WIDE-thread block.  A row's lanes live
// in shared memory up to KT_SMEM_LANES lanes, in the caller's
// device-memory scratch beyond.
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
static cudaError_t webster_allow_smem(K kernel) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              KT_SMEM_LANES * KT_LANE_BYTES);
}

// static: each library that includes this header keeps its own copy, and
// with it its own once-per-kernel attribute flags below (an inline
// function's static locals would be one object across the libraries of a
// process, set for the first library's kernels only)
static int launch_webster(const WebsterArgs& a, cudaStream_t s) {
  if (a.B <= 0 || a.L <= 0) return 0;
  if ((a.L > KT_SMEM_LANES) != (a.scratch != nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t row_bytes = (size_t)a.L * KT_LANE_BYTES;
  if (a.L <= KT_WARP_LANES) {
    static const cudaError_t ok =
        webster_allow_smem(webster_rows<32, KT_WARP_ROWS>);
    if (ok != cudaSuccess) return (int)ok;
    const unsigned grid = (unsigned)((a.B + KT_WARP_ROWS - 1) / KT_WARP_ROWS);
    webster_rows<32, KT_WARP_ROWS>
        <<<grid, 32 * KT_WARP_ROWS, KT_WARP_ROWS * row_bytes, s>>>(a);
  } else {
    static const cudaError_t ok = webster_allow_smem(webster_rows<NT_WIDE, 1>);
    if (ok != cudaSuccess) return (int)ok;
    webster_rows<NT_WIDE, 1><<<(unsigned)a.B, NT_WIDE,
                               a.scratch ? 0 : row_bytes, s>>>(a);
  }
  return (int)cudaGetLastError();
}
