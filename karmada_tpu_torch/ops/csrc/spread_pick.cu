// K6 spread_pick: the cluster pick of phase B of the device spread plane,
// one thread block per live spread row.
//
// Replaces karmada_tpu/ops/spread.py: _pick_one (:251-280), vmapped inside
// spread_assign_compact (:289), with the planes of _spread_planes
// (:166-219).  Per row, select_clusters_by_region.go:27-118: the least-key
// member of each chosen group, and the rest least-key remaining members of
// the chosen groups counted across groups in global key order, rest =
// max(min(members, cluster_max) - groups picked, 0).  Writes pick bool
// [B, C] in cluster-lane order on the card (every lane): phase B's
// assignment reads it as each row's placement mask, and it never reaches
// the host.
//
// Bound on the card: the [B, C] pick write and one read of the operand
// rows (mostly from L2); the work is one key per lane and the selection.
// Design: no sort.
//   1. One coalesced pass computes each lane's planes and key once (LPT
//      lanes a thread, loads issued together; spread.cuh), keeps the key
//      of each chosen-group member in a row buffer (NO_KEY elsewhere),
//      takes each group's least key into a per-group slot (the key is
//      unique, so it names the group's first member).
//   2. rest comes from the member count and the groups that hold one.
//   3. When rest is short of the remaining members, the rest-th least
//      remaining key (a group's first member is not remaining): rest
//      rounds of a block minimum when rest is at most PICK_ROUNDS (the
//      main path's rows: 4-5), else a radix select over the buffer
//      (spread.cuh select_smallest).
//   4. One coalesced pass writes the pick: a remaining member at or below
//      that key, or the key of its group's slot.
// The key buffer lives in shared memory up to SPREAD_SMEM_LANES lanes (3
// blocks an SM) and in a per-row device-memory scratch beyond; the
// per-group slots and chosen flags in shared memory up to
// PICK_SMEM_GROUPS groups and in device memory beyond (G is unbounded);
// the wrapper chooses.
#include "spread.cuh"

// rest up to which the select runs in rounds of a block minimum (a round
// is a block reduction); beyond, a radix select (a few passes over the
// buffer)
constexpr i64 PICK_ROUNDS = 32;

struct SpreadPickArgs {
  KT_SPREAD_FIELDS
  const unsigned char* chosen;  // [B, G]
  const i64* cluster_max;       // [B]
  i64* keys;                    // [B, C] wide rows only, else null
  i64* gmin;                    // [B, G] wide group axis only, else null
  unsigned char* pick;          // [B, C]
  i64 B, C, Q, Kp, Ke, G, vec, use_extra, key_smem, grp_smem;
};

__host__ __device__ inline size_t pick_smem_bytes(const SpreadPickArgs& a) {
  return spread_align(a.key_smem ? (size_t)a.C * 8 : 0) +
         spread_align(a.grp_smem ? (size_t)a.G * 9 : 0) +
         spread_align(256 * 4) +  // the select's histogram
         spread_align((size_t)a.Kp * 12 + (size_t)a.Ke * 4);
}

__global__ void __launch_bounds__(NT, 3) spread_pick_kernel(SpreadPickArgs a) {
  extern __shared__ __align__(16) char smem_raw[];
  __shared__ i64 red[33];
  __shared__ i64 sh[2];
  const i64 b = blockIdx.x;
  const i64 C = a.C, G = a.G;
  char* p = smem_raw;
  i64* keys = a.key_smem ? (i64*)p : a.keys + b * C;
  p += spread_align(a.key_smem ? (size_t)C * 8 : 0);
  i64* gmin = a.grp_smem ? (i64*)p : a.gmin + b * G;
  unsigned char* chosen = a.grp_smem ? (unsigned char*)(gmin + G)
                                     : (unsigned char*)a.chosen + b * G;
  p += spread_align(a.grp_smem ? (size_t)G * 9 : 0);
  int* hist = (int*)p;
  p += spread_align(256 * 4);
  i64* pval = (i64*)p;
  int* pidx = (int*)(pval + a.Kp);
  int* eidx = pidx + a.Kp;

  KT_MARK(0);
  const i64 cmax = a.cluster_max[b];
  for (i64 g = threadIdx.x; g < G; g += NT) {
    gmin[g] = NO_KEY;
    if (a.grp_smem) chosen[g] = a.chosen[b * G + g];
  }
  Row row;
  load_row<NT>(a, b, row, pidx, pval, eidx);  // its syncs order the init

  // 1. every lane once: the chosen-group members' keys, each group's
  //    least
  const bool vec = a.vec;
  i64 members = 0, kmin = NO_KEY, kmax = -KT_MAX_INT64 - 1;
  for (i64 c0 = (i64)threadIdx.x * LPT; c0 < C; c0 += (i64)NT * LPT) {
    LaneIn in[LPT];
    lane_load4(a, row, c0, vec, in);
    i64 kk[LPT];
#pragma unroll
    for (int k = 0; k < LPT; ++k) {
      const i64 c = c0 + k;
      kk[k] = NO_KEY;
      if (c >= C) continue;
      const SpreadLane l = lane_eval(a, row, c, in[k]);
      const int g = in[k].gid;
      if (l.feas && g >= 0 && chosen[g]) {
        const i64 key = spread_key(l.score, l.avail, in[k].nr, true);
        kk[k] = key;
        ++members;
        kmin = minll(kmin, key);
        kmax = maxll(kmax, key);
        push_key(&gmin[g], key);
      }
    }
    // 16-byte stores: a thread's lanes are 32 bytes apart, so 8-byte ones
    // would conflict on the shared-memory banks
    if (vec) {
      *(longlong2*)(keys + c0) = make_longlong2(kk[0], kk[1]);
      *(longlong2*)(keys + c0 + 2) = make_longlong2(kk[2], kk[3]);
    } else {
      for (int k = 0; k < LPT && c0 + k < C; ++k) keys[c0 + k] = kk[k];
    }
  }
  const i64 total = block_sum<NT>(members, red);
  const i64 lo = block_min<NT>(kmin, red);
  const i64 hi = block_max<NT>(kmax, red);
  KT_MARK(1);

  // 2. the groups picked, rest
  i64 firsts = 0;
  for (i64 g = threadIdx.x; g < G; g += NT) firsts += gmin[g] != NO_KEY;
  const i64 n_sel = block_sum<NT>(firsts, red);
  const i64 rest = maxll(minll(total, cmax) - n_sel, 0);
  KT_MARK(2);

  // 3. the rest-th least key of the remaining members
  const bool take = rest > 0;
  i64 thr = NO_KEY - 1;  // every remaining member
  if (take && rest < total - n_sel) {
    if (rest <= PICK_ROUNDS) {
      // rounds of a block minimum: each thread holds the least remaining
      // key of its lanes above the last one taken; the thread whose key a
      // round takes finds its next
      auto least_from = [&](i64 floor) {
        while (true) {
          i64 m = NO_KEY, lane = 0;
          for (i64 c = threadIdx.x; c < C; c += NT) {
            const i64 key = keys[c];
            if (key >= floor && key < m) { m = key; lane = c; }
          }
          if (m == NO_KEY || m != gmin[__ldg(a.group_id + lane)]) return m;
          floor = m + 1;  // a group's first member: not remaining
        }
      };
      i64 mine = least_from(lo);
      for (i64 r = 1;; ++r) {
        const i64 m = block_min<NT>(mine, red);
        if (r == rest) { thr = m; break; }
        if (mine == m) mine = least_from(m + 1);
      }
    } else {
      auto remaining = [&](i64 c) {
        const i64 key = keys[c];
        if (key == NO_KEY || key == gmin[__ldg(a.group_id + c)])
          return NO_KEY;
        return key;
      };
      thr = select_smallest(remaining, C, rest, lo, hi, hist, sh);
    }
  }
  KT_MARK(3);

  // 4. the pick row, every lane
  for (i64 c0 = (i64)threadIdx.x * LPT; c0 < C; c0 += (i64)NT * LPT) {
    int gid[LPT];
    i64 kk[LPT];
    if (vec) {
      const int4 v = __ldg((const int4*)(a.group_id + c0));
      gid[0] = v.x; gid[1] = v.y; gid[2] = v.z; gid[3] = v.w;
      const longlong2 k0 = *(const longlong2*)(keys + c0);
      const longlong2 k1 = *(const longlong2*)(keys + c0 + 2);
      kk[0] = k0.x; kk[1] = k0.y; kk[2] = k1.x; kk[3] = k1.y;
    } else {
      for (int k = 0; k < LPT; ++k) {
        gid[k] = c0 + k < C ? __ldg(a.group_id + c0 + k) : -1;
        kk[k] = c0 + k < C ? keys[c0 + k] : NO_KEY;
      }
    }
    unsigned char pk[LPT];
#pragma unroll
    for (int k = 0; k < LPT; ++k) {
      const i64 key = kk[k];
      pk[k] = key != NO_KEY && ((take && key <= thr) || key == gmin[gid[k]]);
    }
    unsigned char* out = a.pick + b * C + c0;
    if (vec) {
      *(uchar4*)out = make_uchar4(pk[0], pk[1], pk[2], pk[3]);
    } else {
      for (int k = 0; k < LPT && c0 + k < C; ++k) out[k] = pk[k];
    }
  }
  KT_MARK(4);
}

extern "C" int kt_spread_pick(const SpreadPickArgs* a, void* stream) {
  return launch_spread(spread_pick_kernel, a, pick_smem_bytes(*a), stream);
}
