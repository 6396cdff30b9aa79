// K5 spread_group_info: phase A of the device spread plane, one thread
// block per spread row.
//
// Replaces karmada_tpu/ops/spread.py: spread_group_info (:222) with
// _group_info_one (:81-158) vmapped over the rows and _spread_planes
// (:166-219).  Per row, group_clusters.go :141-333: per group the member
// count, availability and score sums, the Duplicated score (members
// fitting the replicas), and the Divided walk -- the first member, in key
// order, where the running member count reaches cmin = max(cluster_min,
// region_min) and the running availability reaches target =
// ceil(replicas / region_min), with the exhausted-walk branch when no
// member does.  Outputs score_g, avail_g, value_g [B, G] (every element
// written; a group with no feasible member is 0) and feas_any [B].
//
// Bound on the card: device-memory traffic is one read of the operand rows
// (est, pl_mask, api_ok, ... mostly from L2) and the [B, G] outputs; the
// work is one key per lane and a few steps of the walk.  Design: no sort
// and no per-lane buffer.
//   1. One coalesced pass computes each lane's planes and key once (LPT
//      lanes a thread, loads issued together; spread.cuh) and adds each
//      member into its group's sums -- with up to WARP_GROUPS groups a
//      warp sums each group present in it (__reduce_add_sync) and one lane
//      adds that into shared memory, so 8 groups do not serialize a
//      warp's atomics; with more, each member adds its own -- and offers
//      its key to the group's TOP least-key slots (spread.cuh push_key)
//      when it is below the last.  Everything but the Divided walk's stop
//      is order-free and is done.
//   2. Per group, one thread: a group with no member or in a Duplicated
//      row skips the walk; fewer members than cmin, or a total
//      availability below the target with every member's availability
//      non-negative, exhausts it; else the walk runs over the TOP slots --
//      a slot's key holds its lane's availability and score whenever they
//      fit the key's fields, which pass 1 checks per member.  The main
//      path's walks stop at the 2nd or 3rd member (PERF.md §6).
//   3. A group whose walk outruns its slots (or whose keys do not decode)
//      takes the long-walk branch, one group at a time: the next
//      WALK_CHUNK least keys of the group (a radix select, the lanes'
//      planes recomputed each pass), collected with their (avail, score)
//      into shared-memory records, sorted by key and scanned; chunk after
//      chunk until the group qualifies or is exhausted.  Exact, and in the
//      same kernel.
// A group's state lives in shared memory up to INFO_SMEM_GROUPS groups and
// in a per-row device-memory scratch beyond (G is unbounded: region or
// label-value count); the wrapper chooses, and sizes the scratch by
// kt_spread_info_layout.
#include "spread.cuh"

constexpr i64 WEIGHT_UNIT = 1000;
// least keys a group keeps from pass 1, and the members a chunk of the
// long-walk branch sorts
constexpr int TOP = 4;
constexpr int WALK_CHUNK = 128;
// groups up to which pass 1 sums a warp's members per group first
constexpr i64 WARP_GROUPS = 32;
// per-group state, struct of arrays with stride G
enum {
  F_CNT,    // members | members fitting the replicas << 32
  F_AV,     // availability sum
  F_SC,     // score sum; in a Duplicated row, of the members fitting
  F_WCNT,   // the walk's running count, availability and score
  F_WAV,
  F_WSC,
  F_LO,     // the long walk's next key bound (members with key >= it)
  F_ST,     // the walk's state
  F_NODEC,  // 1 where a member's key does not hold its avail and score
  F_TOP,    // TOP slots: the group's least keys, ascending
  GF = F_TOP + TOP
};
enum { ST_LONG = 0, ST_QUAL = 1, ST_EXH = 2, ST_SKIP = 3 };

struct SpreadInfoArgs {
  KT_SPREAD_FIELDS
  const i64* region_min;            // [B]
  const i64* cluster_min;           // [B]
  const unsigned char* duplicated;  // [B]
  i64* groups;                      // [B, GF, G] wide group axis only
  i64* score_g;                     // [B, G]
  i64* avail_g;                     // [B, G]
  i64* value_g;                     // [B, G]
  unsigned char* feas_any;          // [B]
  i64 B, C, Q, Kp, Ke, G, vec, use_extra, grp_smem;
};

__host__ __device__ inline size_t info_smem_bytes(const SpreadInfoArgs& a) {
  return spread_align(a.grp_smem ? (size_t)a.G * GF * 8 : 0) +
         spread_align((size_t)WALK_CHUNK * 24) +
         spread_align((size_t)a.Kp * 12 + (size_t)a.Ke * 4);
}

__device__ __forceinline__ i64 mul_unit(i64 x) {
  return (i64)((u64)x * (u64)WEIGHT_UNIT);
}

// whether a key holds its lane's avail and score: avail in its 34-bit
// field, 200 - score in its 9-bit one
__device__ __forceinline__ bool key_decodes(i64 avail, i64 score) {
  return avail >= 0 && avail <= AVAIL_CAP && score <= 200 && score >= -311;
}

__global__ void __launch_bounds__(NT, 3)
    spread_group_info_kernel(SpreadInfoArgs a) {
  extern __shared__ __align__(16) char smem_raw[];
  __shared__ i64 red[33];
  __shared__ i64 sh[4];
  const i64 b = blockIdx.x;
  const i64 C = a.C, G = a.G;
  char* p = smem_raw;
  i64* gs = a.grp_smem ? (i64*)p : a.groups + b * G * GF;
  p += spread_align(a.grp_smem ? (size_t)G * GF * 8 : 0);
  // the long-walk records (key, avail, score); the select's histogram
  // shares the region
  i64* rkey = (i64*)p;
  i64* rav = rkey + WALK_CHUNK;
  i64* rsc = rav + WALK_CHUNK;
  int* hist = (int*)p;
  p += spread_align((size_t)WALK_CHUNK * 24);
  i64* pval = (i64*)p;
  int* pidx = (int*)(pval + a.Kp);
  int* eidx = pidx + a.Kp;
  i64* cnt_g = gs + F_CNT * G;
  i64* av_g = gs + F_AV * G;
  i64* sc_g = gs + F_SC * G;
  i64* wcnt_g = gs + F_WCNT * G;
  i64* wav_g = gs + F_WAV * G;
  i64* wsc_g = gs + F_WSC * G;
  i64* lo_g = gs + F_LO * G;
  i64* st_g = gs + F_ST * G;
  i64* nodec_g = gs + F_NODEC * G;
  i64* top_g = gs + F_TOP * G;  // slot i of group g: top_g[i * G + g]

  KT_MARK(0);
  for (i64 g = threadIdx.x; g < G; g += NT) {
    cnt_g[g] = av_g[g] = sc_g[g] = 0;
    wcnt_g[g] = wav_g[g] = wsc_g[g] = 0;
    nodec_g[g] = 0;
    for (int i = 0; i < TOP; ++i) top_g[i * G + g] = NO_KEY;
  }
  Row row;
  load_row<NT>(a, b, row, pidx, pval, eidx);  // its syncs order the init
  const i64 reps = row.n;
  const i64 rmin = a.region_min[b];
  const i64 target = rmin > 0 ? -floordiv(-reps, maxll(rmin, 1)) : reps;
  const i64 cmin = maxll(a.cluster_min[b], rmin);
  const bool dup = a.duplicated[b];

  // 1. every lane once: the group sums and least keys
  const bool vec = a.vec, per_warp = G <= WARP_GROUPS;
  const unsigned lane = threadIdx.x & 31;
  bool any = false;
  for (i64 base = 0; base < C; base += (i64)NT * LPT) {
    const i64 c0 = base + (i64)threadIdx.x * LPT;
    LaneIn in[LPT];
    if (c0 < C) lane_load4(a, row, c0, vec, in);
#pragma unroll
    for (int k = 0; k < LPT; ++k) {
      const i64 c = c0 + k;
      bool mem = false, fits = false;
      int g = 0;
      i64 av = 0, sc = 0;
      if (c < C) {
        const SpreadLane l = lane_eval(a, row, c, in[k]);
        any |= l.feas;
        g = in[k].gid;
        mem = l.feas && g >= 0;
        if (mem) {
          fits = l.avail >= reps;
          av = l.avail;
          sc = l.score;
          if (!dup) {
            i64 v = spread_key(sc, av, in[k].nr, true);
            if (v < *(volatile i64*)&top_g[(TOP - 1) * G + g])
              for (int i = 0; i < TOP && v != NO_KEY; ++i)
                v = push_key(&top_g[i * G + g], v);
            if (!key_decodes(av, sc)) nodec_g[g] = 1;
          }
        }
      }
      const i64 xs = dup && !fits ? 0 : sc;
      if (per_warp) {
        const unsigned fitb = __ballot_sync(KT_FULL_MASK, fits);
        unsigned todo = __ballot_sync(KT_FULL_MASK, mem);
        while (todo) {
          const int src = __ffs(todo) - 1;
          const int gl = __shfl_sync(KT_FULL_MASK, g, src);
          const bool mine = mem && g == gl;
          const unsigned m = __ballot_sync(KT_FULL_MASK, mine);
          const i64 s_av = warp_sum(mine ? av : 0);
          const i64 s_sc = warp_sum(mine ? xs : 0);
          if ((int)lane == src) {
            atomicAdd((u64*)&cnt_g[gl],
                      (u64)__popc(m) | ((u64)__popc(m & fitb) << 32));
            atomicAdd((u64*)&av_g[gl], (u64)s_av);
            atomicAdd((u64*)&sc_g[gl], (u64)s_sc);
          }
          todo &= ~m;
        }
      } else if (mem) {
        atomicAdd((u64*)&cnt_g[g], 1ULL | ((u64)fits << 32));
        atomicAdd((u64*)&av_g[g], (u64)av);
        atomicAdd((u64*)&sc_g[g], (u64)xs);
      }
    }
  }
  any = __syncthreads_or(any);
  if (threadIdx.x == 0) a.feas_any[b] = any;
  KT_MARK(1);

  // 2. per group: the sums decide, or the walk over the least keys
  bool long_walk = false;
  for (i64 g = threadIdx.x; g < G; g += NT) {
    const i64 value = cnt_g[g] & 0xFFFFFFFF;
    i64 st;
    if (value == 0 || dup) {
      st = ST_SKIP;
    } else if (value < cmin || (!nodec_g[g] && av_g[g] < target)) {
      st = ST_EXH;  // the running sums cannot qualify
    } else if (nodec_g[g]) {
      st = ST_LONG;
      lo_g[g] = -KT_MAX_INT64 - 1;
    } else {
      i64 wc = 0, wa = 0, ws = 0, last = NO_KEY;
      st = ST_LONG;
      for (int i = 0; i < TOP; ++i) {
        const i64 key = top_g[i * G + g];
        if (key == NO_KEY) break;
        last = key;
        wc += 1;
        wa += AVAIL_CAP - (i64)(((u64)key >> LANE_BITS) & (u64)AVAIL_CAP);
        ws += 200 - (i64)((u64)key >> (AVAIL_BITS + LANE_BITS));
        if (wc >= cmin && wa >= target) { st = ST_QUAL; break; }
      }
      if (st != ST_QUAL && wc == value) st = ST_EXH;
      wcnt_g[g] = wc;
      wav_g[g] = wa;
      wsc_g[g] = ws;
      lo_g[g] = last + 1;
    }
    st_g[g] = st;
    long_walk |= st == ST_LONG;
  }
  long_walk = __syncthreads_or(long_walk);
  KT_MARK(2);

  // 3. the long walks, one group at a time, WALK_CHUNK members a chunk
  while (long_walk) {
    i64 mine = G;
    for (i64 g = threadIdx.x; g < G; g += NT)
      if (st_g[g] == ST_LONG) { mine = g; break; }
    const i64 g = block_min<NT>(mine, red);
    if (g >= G) break;
    i64 lo = lo_g[g];
    i64 left = (cnt_g[g] & 0xFFFFFFFF) - wcnt_g[g];
    while (true) {
      const i64 n = minll(left, WALK_CHUNK);
      // the key of lane c if it is a member of g not yet walked
      auto key_of = [&](i64 c) {
        const SpreadLane l = spread_lane(a, row, c);
        if (!l.feas || a.group_id[c] != g) return NO_KEY;
        const i64 key = spread_key(l.score, l.avail, a.name_rank[c], true);
        return key >= lo ? key : NO_KEY;
      };
      const i64 hi = left <= WALK_CHUNK
                         ? NO_KEY - 1
                         : select_smallest(key_of, C, n, lo, NO_KEY - 1,
                                           hist, sh);
      if (threadIdx.x == 0) sh[2] = 0;
      __syncthreads();
      for (i64 c = threadIdx.x; c < C; c += NT) {
        const SpreadLane l = spread_lane(a, row, c);
        if (!l.feas || a.group_id[c] != g) continue;
        const i64 key = spread_key(l.score, l.avail, a.name_rank[c], true);
        if (key < lo || key > hi) continue;
        const int j = (int)atomicAdd((unsigned long long*)&sh[2], 1ULL);
        rkey[j] = key;
        rav[j] = l.avail;
        rsc[j] = l.score;
      }
      __syncthreads();
      // bitonic sort of the n records by key (pad to a power of two)
      int P = 1;
      while (P < n) P <<= 1;
      for (int i = (int)n + (int)threadIdx.x; i < P; i += NT)
        rkey[i] = NO_KEY;
      __syncthreads();
      for (int k = 2; k <= P; k <<= 1) {
        for (int j = k >> 1; j > 0; j >>= 1) {
          for (int i = threadIdx.x; i < P; i += NT) {
            const int ixj = i ^ j;
            if (ixj > i && ((rkey[i] > rkey[ixj]) == ((i & k) == 0))) {
              const i64 tk = rkey[i]; rkey[i] = rkey[ixj]; rkey[ixj] = tk;
              const i64 ta = rav[i]; rav[i] = rav[ixj]; rav[ixj] = ta;
              const i64 ts = rsc[i]; rsc[i] = rsc[ixj]; rsc[ixj] = ts;
            }
          }
          __syncthreads();
        }
      }
      // scan: the first record where the walk qualifies
      const int t = threadIdx.x;
      const i64 av = t < n ? rav[t] : 0, sc = t < n ? rsc[t] : 0;
      const i64 w0 = wcnt_g[g], a0 = wav_g[g], s0 = wsc_g[g];
      const i64 pav = block_scan_excl<NT>(av, red) + av;
      __syncthreads();
      const i64 psc = block_scan_excl<NT>(sc, red) + sc;
      const bool ok = t < n && w0 + t + 1 >= cmin && a0 + pav >= target;
      const i64 first = block_min<NT>(ok ? (i64)t : KT_MAX_INT64, red);
      const i64 last = first < n ? first : n - 1;
      if (t == last) {
        wcnt_g[g] = w0 + t + 1;
        wav_g[g] = a0 + pav;
        wsc_g[g] = s0 + psc;
        left -= n;
        if (first < n) st_g[g] = ST_QUAL;
        else if (left == 0) st_g[g] = ST_EXH;
        sh[3] = left;
      }
      __syncthreads();
      if (st_g[g] != ST_LONG) break;
      left = sh[3];
      lo = hi + 1;
      __syncthreads();
    }
    __syncthreads();
  }

  KT_MARK(3);

  // 4. the group scores; every element of the row's outputs
  for (i64 g = threadIdx.x; g < G; g += NT) {
    const i64 o = b * G + g;
    const u64 cp = (u64)cnt_g[g];
    const i64 value = (i64)(cp & 0xFFFFFFFF), nfit = (i64)(cp >> 32);
    const i64 avail = av_g[g];
    i64 score = 0;
    if (value > 0) {
      if (dup) {
        score = nfit > 0 ? mul_unit(nfit) + floordiv(sc_g[g], nfit) : 0;
      } else if (st_g[g] == ST_QUAL) {
        score = mul_unit(target) + floordiv(wsc_g[g], maxll(wcnt_g[g], 1));
      } else {
        // exhausted walk (group_clusters.go:300-308): only insufficient
        // availability demotes the score
        score = mul_unit(avail >= target ? target : avail) +
                floordiv(sc_g[g], maxll(value, 1));
      }
    }
    a.value_g[o] = value;
    a.avail_g[o] = avail;
    a.score_g[o] = score;
  }
  KT_MARK(4);
}

extern "C" int kt_spread_group_info(const SpreadInfoArgs* a, void* stream) {
  return launch_spread(spread_group_info_kernel, a, info_smem_bytes(*a),
                       stream);
}

// {GF}: the int64 fields of a group's state; the wrapper sizes the
// [B, GF, G] scratch of a wide group axis by it.
extern "C" void kt_spread_info_layout(long long* out) { out[0] = GF; }
