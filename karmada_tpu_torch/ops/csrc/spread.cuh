// What K5 spread_group_info and K6 spread_pick share: their argument
// fields, a row's spread planes per lane, the sort buffers and the sort of
// a row's lanes by their spread key.
//
// Replaces the per-binding prologue of karmada_tpu/ops/spread.py
// (_spread_planes :166-219 and the _sort_key sort of _group_info_one /
// _pick_one): a block computes its row's planes lane by lane (rows.cuh)
// and sorts the lanes (group, key, lane) -- K5 by group then key, K6 by
// key alone.  The sort buffers take 16 B per lane: shared memory up to
// 8,192 lanes, a per-row scratch in device memory beyond (the wrapper
// chooses; the code is the same).
#pragma once

#include "rows.cuh"

constexpr int NT = 256;

// the operands every spread kernel reads (rows.cuh names), in the order of
// kernels.SPREAD_TENSOR_FIELDS
#define KT_SPREAD_FIELDS                                                  \
  const unsigned char* cluster_valid; /* [C] */                           \
  const unsigned char* deleting;      /* [C] */                           \
  const i64* name_rank;               /* [C] */                           \
  const unsigned char* api_ok;        /* [Gv, C] */                       \
  const unsigned char* pl_mask;       /* [P, C] */                        \
  const unsigned char* pl_tol_bypass; /* [P, C] */                        \
  const i64* pl_extra_score;          /* [P, C] */                        \
  const int* placement_id;            /* [B] */                           \
  const int* gvk_id;                  /* [B] */                           \
  const int* class_id;                /* [B] */                           \
  const i64* replicas;                /* [B] */                           \
  const unsigned char* nw_shortcut;   /* [B] */                           \
  const int* prev_idx;                /* [B, Kp] */                       \
  const int* prev_val;                /* [B, Kp] */                       \
  const int* evict_idx;               /* [B, Ke] */                       \
  const i64* est;                     /* [Q + 1, C] raw snapshot */       \
  const int* group_id;                /* [C], -1: no group */

struct SpreadLane {
  bool feas;
  i64 avail, score;  // avail_sel (availability plus prev replicas), score
};

template <class A>
__device__ __forceinline__ SpreadLane spread_lane(const A& a, const Row& row,
                                                  i64 c) {
  const LaneInfo l = lane_info(a, row, c);
  SpreadLane s;
  s.feas = l.feas;
  s.avail = l.ac + (l.pp ? l.pr : 0);
  s.score = ((row.n_prev > 0 && l.pp) ? 100 : 0) +
            a.pl_extra_score[row.pid * a.C + c];
  return s;
}

struct SortBufs {
  int* g;     // [N] segment: group id, G for infeasible / group-less lanes
  i64* key;   // [N] spread key
  int* idx;   // [N] lane
  int* pidx;  // the row's COO entries (shared memory)
  i64* pval;
  int* eidx;
};

// dynamic shared memory: the COO entries, plus the sort buffers when smem
inline size_t spread_smem_bytes(i64 Kp, i64 Ke, i64 N, bool smem) {
  return (size_t)Kp * 12 + (size_t)Ke * 4 + (smem ? (size_t)N * 16 : 0);
}

template <class A>
__device__ SortBufs spread_carve(const A& a, char* smem_raw, i64 b) {
  SortBufs s;
  i64* p = (i64*)smem_raw;
  s.pval = p; p += a.Kp;
  if (a.smem) { s.key = p; p += a.N; } else { s.key = a.sort_key + b * a.N; }
  int* q = (int*)p;
  s.pidx = q; q += a.Kp;
  s.eidx = q; q += a.Ke;
  if (a.smem) {
    s.idx = q; q += a.N;
    s.g = q; q += a.N;
  } else {
    s.idx = a.sort_idx + b * a.N;
    s.g = a.sort_gid + b * a.N;
  }
  return s;
}

// Fill the sort buffers with every lane's (segment, key, lane) -- lanes
// C..N-1 pad with (G, MAX, lane) -- and sort them: by (segment, key) when
// BY_G, else by key.  Returns whether any lane is feasible.
template <bool BY_G, class A>
__device__ bool sort_lanes(const A& a, const Row& row, const SortBufs& s,
                           i64* red) {
  i64 any = 0;
  for (i64 i = threadIdx.x; i < a.N; i += NT) {
    int g = (int)a.G;
    i64 key = KT_MAX_INT64;
    if (i < a.C) {
      const SpreadLane l = spread_lane(a, row, i);
      key = spread_key(l.score, l.avail, a.name_rank[i], l.feas);
      if (l.feas && a.group_id[i] >= 0) g = a.group_id[i];
      any |= l.feas;
    }
    s.g[i] = g;
    s.key[i] = key;
    s.idx[i] = (int)i;
  }
  __syncthreads();
  block_sort<NT, BY_G>(s.g, s.key, s.idx, (int)a.N);
  return block_sum<NT>(any, red) > 0;
}

template <class K, class A>
int launch_spread(K kernel, const A* a, void* stream) {
  if (a->B <= 0) return 0;
  const size_t smem = spread_smem_bytes(a->Kp, a->Ke, a->N, a->smem != 0);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)a->B, NT, smem, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}
