// Native serial scheduling control — C++ implementation of the reference
// scheduler's algorithmic core, mirroring ops/serial.py step for step (the
// port's copy of the JAX package's native/serial_solver.cc, unchanged but
// for comments):
//
//     findClustersThatFit -> prioritizeClusters -> SelectClusters -> AssignReplicas
//     (reference pkg/scheduler/core/generic_scheduler.go:71-116)
//
// Purpose: BASELINE.md's >=50x north star is measured against a *Go-equivalent*
// serial path.  The Python control in ops/serial.py understates that bar by the
// Python/Go gap; this -O2 compiled control is the honest stand-in, and the
// Scheduler's backend="native".
//
// Scope (exactly the classes ops/serial.py supports on the summary path):
//   * filters: APIEnablement / TaintToleration / ClusterAffinity /
//     SpreadConstraint / ClusterEviction (placement-level predicates arrive
//     precomputed as per-placement reason masks — snapshot-side data, same
//     amortization the device path's EncoderCache performs)
//   * score: ClusterLocality
//   * capacity: GeneralEstimator summary math
//     (pkg/estimator/client/general.go:56-94,294-334)
//   * grouping + selection: cluster sort, region group scores, the
//     findFeasiblePaths DFS (pkg/scheduler/core/spreadconstraint/select_groups.go:102-230),
//     select-by-cluster swap loop (select_clusters_by_cluster.go:25-105)
//   * assignment: Duplicated / StaticWeight / DynamicWeight / Aggregated with
//     Steady scale-up/down and Fresh modes (assignment.go, division_algorithm.go)
//     over the quantized-integer Webster dispenser (ops/webster.py semantics,
//     reference pkg/util/helper/webstermethod.go:112).
//
// Out of scope (callers mark such bindings unsupported before the call):
// resource-model histograms, multi-component sets, weights >= 2^31.
//
// Build: g++ -O2 -std=c++17 -shared -fPIC (native/__init__.py, at first use).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

constexpr int64_t kMaxInt32 = 2147483647LL;
constexpr int kPriorityQBits = 28;  // ops/webster.py PRIORITY_QBITS

// status codes (mirrors the wrapper's STATUS_* constants)
constexpr int32_t kOk = 0;
constexpr int32_t kFitError = 1;
constexpr int32_t kUnschedulable = 2;
constexpr int32_t kNoClusterAvailable = 3;
constexpr int32_t kUnsupported = 4;
constexpr int32_t kOutputOverflow = 5;

// strategy enum (wrapper STRATEGY_*)
constexpr int32_t kDuplicated = 0;
constexpr int32_t kStaticWeight = 1;
constexpr int32_t kDynamicWeight = 2;
constexpr int32_t kAggregated = 3;

// spread field enum (wrapper FIELD_*)
constexpr int32_t kFieldNone = -1;
constexpr int32_t kFieldCluster = 0;
constexpr int32_t kFieldRegion = 1;

constexpr int kWeightUnit = 1000;  // spreadconstraint/group_clusters.go:139
constexpr int64_t kInvalidReplicas = -1;

// Python floor division (rounds toward negative infinity).
inline int64_t py_floordiv(int64_t a, int64_t b) {
  int64_t q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}

// k8s Quantity.Value(): whole units rounded up == -((-m) // 1000) in Python.
inline int64_t ceil_units(int64_t milli) { return -py_floordiv(-milli, 1000); }

struct Snapshot {
  int32_t nC, nR, nG, nP, nQ;
  const int32_t* name_rank;
  const uint8_t* deleting;
  const uint8_t* has_summary;
  const int32_t* region_id;      // -1 == none
  const int32_t* region_rank;    // [n_regions] lexicographic rank of region name
  int32_t n_regions;
  const int64_t* pods_allowed;   // [C]
  const uint8_t* res_is_cpu;     // [R]
  const int64_t* avail_milli;    // [C*R]; <0 covers both missing + exhausted
  const uint8_t* gvk_enabled;    // [G*C]
  const uint8_t* p_taint;        // [P*C] untolerated NoSchedule/NoExecute taint
  const uint8_t* p_reason;       // [P*C] 0 pass / 1 affinity / 3 spread-field
  const int32_t* p_strategy;     // [P]
  const uint8_t* p_ignore_spread;  // [P] should_ignore_spread_constraint
  const uint8_t* p_has_weights;  // [P]
  const int64_t* p_weights;      // [P*C]
  const int32_t* p_spread;       // [P*6] field,min,max x2
  const int64_t* p_extra_score;  // [P*C] out-of-tree plugin score sums
};

struct Binding {
  int32_t placement, gvk, klass;
  int64_t replicas;
  bool fresh, uid_desc, workload, zero_shortcut;
  const int32_t* prev_idx;
  const int64_t* prev_val;
  int32_t n_prev;
  const int32_t* evict_idx;
  int32_t n_evict;
};

struct ClusterDetail {  // serial.py ClusterDetailInfo
  int32_t idx;
  int64_t score;
  int64_t available;    // estimator output + previously-assigned replicas
  int64_t allocatable;  // estimator output alone
};

struct Target {
  int32_t idx;
  int64_t replicas;
};

// ---------------------------------------------------------------------------
// Webster (Sainte-Lague) dispenser — ops/webster.py allocate_webster_seats
// ---------------------------------------------------------------------------

struct HeapEntry {
  int64_t prio;
  int64_t seats;
  int32_t rank;   // lexicographic name rank
  int32_t party;  // index into the parties vector
};

inline int64_t priority_quantized(int64_t votes, int64_t seats) {
  int64_t v = votes < 0 ? 0 : votes;
  return (v << kPriorityQBits) / (2 * seats + 1);
}

// `true` when a should pop AFTER b (a is worse): max-heap on
// (prio asc-inverted, seats desc-inverted, name order).
struct HeapWorse {
  bool desc;
  bool operator()(const HeapEntry& a, const HeapEntry& b) const {
    if (a.prio != b.prio) return a.prio < b.prio;
    if (a.seats != b.seats) return a.seats > b.seats;
    return desc ? a.rank < b.rank : a.rank > b.rank;
  }
};

// Allocates `n` seats among parties (votes, seats start at 0); fills seats[].
void webster_allocate(int64_t n, const std::vector<int32_t>& party_cluster,
                      const std::vector<int64_t>& votes, const Snapshot& S,
                      bool desc, std::vector<int64_t>* seats) {
  size_t P = votes.size();
  seats->assign(P, 0);
  std::vector<HeapEntry> heap;
  heap.reserve(P);
  for (size_t i = 0; i < P; ++i) {
    heap.push_back({priority_quantized(votes[i], 0), 0,
                    S.name_rank[party_cluster[i]], static_cast<int32_t>(i)});
  }
  HeapWorse cmp{desc};
  std::make_heap(heap.begin(), heap.end(), cmp);
  for (int64_t k = 0; k < n; ++k) {
    std::pop_heap(heap.begin(), heap.end(), cmp);
    HeapEntry e = heap.back();
    heap.pop_back();
    int64_t s = ++(*seats)[e.party];
    e.seats = s;
    e.prio = priority_quantized(votes[e.party], s);
    heap.push_back(e);
    std::push_heap(heap.begin(), heap.end(), cmp);
  }
}

// dispense_by_weight with init=None (the only form serial.py uses): returns
// name->seats over the weighted parties; zero weight sum -> empty.
void dispense_by_weight(int64_t n, const std::vector<int32_t>& party_cluster,
                        const std::vector<int64_t>& votes, const Snapshot& S,
                        bool desc, std::vector<Target>* out) {
  out->clear();
  int64_t wsum = 0;
  for (int64_t v : votes) wsum += v;
  if (wsum == 0) return;
  std::vector<int64_t> seats;
  webster_allocate(n, party_cluster, votes, S, desc, &seats);
  out->reserve(votes.size());
  for (size_t i = 0; i < votes.size(); ++i)
    out->push_back({party_cluster[i], seats[i]});
  // serial.py: sorted(result.items()) — ascending name
  std::sort(out->begin(), out->end(), [&S](const Target& a, const Target& b) {
    return S.name_rank[a.idx] < S.name_rank[b.idx];
  });
}

// ---------------------------------------------------------------------------
// GeneralEstimator summary math (general.go:56-94, 294-334)
// ---------------------------------------------------------------------------

int64_t estimator_max_replicas(const Snapshot& S, const int64_t* class_req,
                               int32_t c, int32_t klass) {
  if (!S.has_summary[c]) return 0;
  int64_t maximum = S.pods_allowed[c];
  if (maximum <= 0) return 0;
  if (klass < 0) return std::min(maximum, kMaxInt32);
  const int64_t* req = class_req + static_cast<int64_t>(klass) * S.nR;
  int64_t num = INT64_MAX;  // max_replicas_from_summary
  for (int32_t r = 0; r < S.nR; ++r) {
    int64_t requested = req[r];
    if (requested <= 0) continue;
    int64_t am = S.avail_milli[static_cast<int64_t>(c) * S.nR + r];
    if (am < 0) return 0;  // allocatable missing / exhausted
    int64_t available = S.res_is_cpu[r] ? am : ceil_units(am);
    if (available <= 0) return 0;
    num = std::min(num, available / requested);
  }
  return std::min(std::min(num, maximum), kMaxInt32);
}

// make_cal_available leftover clamp (core/util.go:104-109): MAX_INT32 means
// "no estimator authenticated" -> clamp to spec.replicas.
inline int64_t cal_available_one(const Snapshot& S, const int64_t* class_req,
                                 const Binding& b, int32_t c) {
  if (b.zero_shortcut) return kMaxInt32;  // returned pre-clamp in serial.py
  int64_t v = estimator_max_replicas(S, class_req, c, b.klass);
  if (v == kMaxInt32) return b.replicas;
  return v;
}

// ---------------------------------------------------------------------------
// Spread grouping + selection (spreadconstraint/)
// ---------------------------------------------------------------------------

struct SpreadC {
  int32_t field = kFieldNone;
  int64_t min_groups = 0, max_groups = 0;
};

struct PlacementView {
  int32_t strategy;
  bool has_weights;
  bool ignores_spread;  // select_clusters.go:57-69 (precomputed host-side)
  SpreadC sc[2];
  int n_sc = 0;
  const SpreadC* find(int32_t field) const {
    for (int i = 0; i < n_sc; ++i)
      if (sc[i].field == field) return &sc[i];
    return nullptr;
  }
};

inline bool ignore_spread(const PlacementView& p) { return p.ignores_spread; }
// select_clusters.go:71-80 — Duplicated ignores capacity.
inline bool ignore_available(const PlacementView& p) {
  return p.strategy == kDuplicated;
}
inline bool topology_ignored(const PlacementView& p) {
  if (p.n_sc == 0 || (p.n_sc == 1 && p.sc[0].field == kFieldCluster))
    return true;
  return ignore_spread(p);
}

// spreadconstraint/util.go sortClusters: score desc, available desc, name asc.
void sort_clusters(std::vector<ClusterDetail>* v, const Snapshot& S) {
  std::sort(v->begin(), v->end(),
            [&S](const ClusterDetail& a, const ClusterDetail& b) {
              if (a.score != b.score) return a.score > b.score;
              if (a.available != b.available) return a.available > b.available;
              return S.name_rank[a.idx] < S.name_rank[b.idx];
            });
}

// group_clusters.go:141-218 (clusters pre-sorted score desc).
int64_t calc_group_score_duplicate(const std::vector<ClusterDetail>& cs,
                                   int64_t target) {
  int64_t sum_score = 0, valid = 0;
  for (const auto& c : cs)
    if (c.available >= target) {
      sum_score += c.score;
      ++valid;
    }
  if (valid == 0) return 0;
  return valid * kWeightUnit + sum_score / valid;
}

// group_clusters.go:220-333.
int64_t calc_group_score(const std::vector<ClusterDetail>& cs,
                         const PlacementView& p, int64_t replicas,
                         int64_t min_groups) {
  if (p.strategy == kDuplicated) return calc_group_score_duplicate(cs, replicas);
  // ceil(replicas / min_groups)
  int64_t target = min_groups ? -py_floordiv(-replicas, min_groups) : replicas;
  int64_t cluster_min = 0;
  if (const SpreadC* c = p.find(kFieldCluster)) cluster_min = c->min_groups;
  cluster_min = std::max(cluster_min, min_groups);
  int64_t sum_available = 0, sum_score = 0, valid = 0;
  for (const auto& c : cs) {
    sum_available += c.available;
    sum_score += c.score;
    ++valid;
    if (valid >= cluster_min && sum_available >= target) break;
  }
  if (sum_available < target)
    return sum_available * kWeightUnit +
           sum_score / static_cast<int64_t>(cs.size());
  return target * kWeightUnit + sum_score / valid;
}

// --- findFeasiblePaths DFS (select_groups.go:102-224) ----------------------

struct DfsGroup {
  int32_t region;   // region id (name order via region_rank)
  int64_t value;    // number of clusters in the region
  int64_t weight;   // group score
};

struct DfsPath {
  int32_t id;
  std::vector<DfsGroup> groups;
  int64_t weight, value;
};

struct DfsCtx {
  const std::vector<DfsGroup>* groups;
  const Snapshot* S;
  int64_t min_c, max_c, target;
  std::vector<DfsPath> paths;
  std::vector<DfsGroup> current;
  int32_t next_id = 0;

  void record() {
    DfsPath p;
    p.id = ++next_id;
    p.groups = current;
    // sorted(current, key=(-weight, name))
    const Snapshot& s = *S;
    std::sort(p.groups.begin(), p.groups.end(),
              [&s](const DfsGroup& a, const DfsGroup& b) {
                if (a.weight != b.weight) return a.weight > b.weight;
                return s.region_rank[a.region] < s.region_rank[b.region];
              });
    p.weight = 0;
    p.value = 0;
    for (const auto& g : p.groups) {
      p.weight += g.weight;
      p.value += g.value;
    }
    paths.push_back(std::move(p));
  }

  void dfs(int64_t total, size_t begin) {
    int64_t cur = static_cast<int64_t>(current.size());
    if (total >= target && min_c <= cur && cur <= max_c) {
      record();
      return;
    }
    if (cur >= max_c) return;
    for (size_t i = begin; i < groups->size(); ++i) {
      current.push_back((*groups)[i]);
      dfs(total + (*groups)[i].value, i + 1);
      if (static_cast<int64_t>(groups->size()) == min_c) break;
      current.pop_back();
    }
  }
};

bool match_sub_path(const DfsPath& path, const DfsPath& sub) {
  if (sub.groups.size() >= path.groups.size()) return false;
  for (size_t i = 0; i < sub.groups.size(); ++i)
    if (path.groups[i].region != sub.groups[i].region) return false;
  return true;
}

// Port of selectGroups/findFeasiblePaths/prioritizePaths.
std::vector<DfsGroup> select_groups(std::vector<DfsGroup> groups,
                                    const Snapshot& S, int64_t min_c,
                                    int64_t max_c, int64_t target) {
  if (groups.empty()) return {};
  std::sort(groups.begin(), groups.end(),
            [&S](const DfsGroup& a, const DfsGroup& b) {
              if (a.value != b.value) return a.value < b.value;
              if (a.weight != b.weight) return a.weight > b.weight;
              return S.region_rank[a.region] < S.region_rank[b.region];
            });
  DfsCtx ctx;
  ctx.groups = &groups;
  ctx.S = &S;
  ctx.min_c = min_c;
  ctx.max_c = max_c;
  ctx.target = target;
  ctx.dfs(0, 0);
  if (ctx.paths.empty()) return {};
  if (ctx.paths.size() == 1) return ctx.paths[0].groups;
  std::sort(ctx.paths.begin(), ctx.paths.end(),
            [](const DfsPath& a, const DfsPath& b) {
              if (a.weight != b.weight) return a.weight > b.weight;
              if (a.value != b.value) return a.value > b.value;
              return a.id < b.id;
            });
  const DfsPath* final_p = &ctx.paths[0];
  for (size_t i = 1; i < ctx.paths.size(); ++i)
    if (match_sub_path(*final_p, ctx.paths[i])) final_p = &ctx.paths[i];
  return final_p->groups;
}

// select_clusters_by_cluster.go:32-105 swap loop.
bool select_by_available_resource(std::vector<ClusterDetail>* ret,
                                  std::vector<ClusterDetail>* rest,
                                  int64_t need_replicas) {
  auto total = [](const std::vector<ClusterDetail>& v) {
    int64_t s = 0;
    for (const auto& c : v) s += c.available;
    return s;
  };
  int64_t update_id = static_cast<int64_t>(ret->size()) - 1;
  while (total(*ret) < need_replicas && update_id >= 0) {
    int64_t best_id = -1, best_avail = (*ret)[update_id].available;
    for (size_t i = 0; i < rest->size(); ++i)
      if ((*rest)[i].available > best_avail) {
        best_id = static_cast<int64_t>(i);
        best_avail = (*rest)[i].available;
      }
    if (best_id == -1) {
      --update_id;
      continue;
    }
    std::swap((*ret)[update_id], (*rest)[best_id]);
    --update_id;
  }
  return total(*ret) >= need_replicas;
}

}  // namespace

extern "C" {

// Returns 0 on success (per-binding failures land in out_status), nonzero on
// a structural error.  All array contracts documented in native/__init__.py.
int serial_schedule_batch(
    // clusters
    int32_t nC, const int32_t* name_rank, const uint8_t* deleting,
    const uint8_t* has_summary, const int32_t* region_id,
    const int32_t* region_rank, int32_t n_regions, const int64_t* pods_allowed,
    // capacity
    int32_t nR, const uint8_t* res_is_cpu, const int64_t* avail_milli,
    // api enablement
    int32_t nG, const uint8_t* gvk_enabled,
    // placements
    int32_t nP, const uint8_t* p_taint, const uint8_t* p_reason,
    const int32_t* p_strategy, const uint8_t* p_ignore_spread,
    const uint8_t* p_has_weights, const int64_t* p_weights,
    const int32_t* p_spread, const int64_t* p_extra_score,
    // request classes
    int32_t nQ, const int64_t* class_req,
    // bindings
    int32_t nB, const int32_t* b_placement, const int32_t* b_gvk,
    const int64_t* b_replicas, const int32_t* b_class, const uint8_t* b_fresh,
    const uint8_t* b_uid_desc, const uint8_t* b_workload,
    const uint8_t* b_zero_shortcut, const uint8_t* b_unsupported,
    const int32_t* prev_off, const int32_t* prev_idx, const int64_t* prev_val,
    const int32_t* evict_off, const int32_t* evict_idx,
    // outputs
    int32_t* out_status, int32_t* out_off, int32_t* out_idx, int64_t* out_val,
    int32_t out_cap) {
  Snapshot S{nC, nR, nG, nP, nQ,       name_rank, deleting,
             has_summary, region_id,   region_rank, n_regions,
             pods_allowed, res_is_cpu, avail_milli, gvk_enabled,
             p_taint,      p_reason,   p_strategy, p_ignore_spread,
             p_has_weights, p_weights, p_spread,   p_extra_score};
  (void)nQ;
  int32_t cursor = 0;
  out_off[0] = 0;

  // scratch, reused across bindings
  std::vector<ClusterDetail> details, candidates, rest;
  std::vector<Target> scheduled, available, result, dispensed;
  std::vector<int32_t> party_cluster;
  std::vector<int64_t> votes;
  std::unordered_map<int32_t, int64_t> prev_map;

  for (int32_t b = 0; b < nB; ++b) {
    out_status[b] = kOk;
    result.clear();

    Binding bd{b_placement[b], b_gvk[b],  b_class[b],
               b_replicas[b],  b_fresh[b] != 0, b_uid_desc[b] != 0,
               b_workload[b] != 0, b_zero_shortcut[b] != 0,
               prev_idx + prev_off[b], prev_val + prev_off[b],
               prev_off[b + 1] - prev_off[b], evict_idx + evict_off[b],
               evict_off[b + 1] - evict_off[b]};
    if (b_unsupported[b]) {
      out_status[b] = kUnsupported;
      out_off[b + 1] = cursor;
      continue;
    }

    prev_map.clear();
    for (int32_t j = 0; j < bd.n_prev; ++j) prev_map[bd.prev_idx[j]] = bd.prev_val[j];
    bool has_prev = bd.n_prev > 0;

    const uint8_t* taint_row = p_taint + static_cast<int64_t>(bd.placement) * nC;
    const uint8_t* reason_row = p_reason + static_cast<int64_t>(bd.placement) * nC;
    const uint8_t* enable_row = gvk_enabled + static_cast<int64_t>(bd.gvk) * nC;

    PlacementView pv;
    pv.strategy = p_strategy[bd.placement];
    pv.has_weights = p_has_weights[bd.placement] != 0;
    pv.ignores_spread = p_ignore_spread[bd.placement] != 0;
    const int32_t* sp = p_spread + static_cast<int64_t>(bd.placement) * 6;
    for (int k = 0; k < 2; ++k) {
      if (sp[k * 3] == kFieldNone) continue;
      pv.sc[pv.n_sc].field = sp[k * 3];
      pv.sc[pv.n_sc].min_groups = sp[k * 3 + 1];
      pv.sc[pv.n_sc].max_groups = sp[k * 3 + 2];
      ++pv.n_sc;
    }

    // ---- findClustersThatFit (generic_scheduler.go:119-152) --------------
    details.clear();
    int32_t n_diagnosed = 0;
    for (int32_t c = 0; c < nC; ++c) {
      if (deleting[c]) continue;
      bool targeted = prev_map.count(c) != 0;
      const char* why = nullptr;
      if (!targeted && !enable_row[c]) why = "api";          // APIEnablement
      if (!why && !targeted && taint_row[c]) why = "taint";  // TaintToleration
      if (!why && reason_row[c] == 1) why = "affinity";      // ClusterAffinity
      if (!why && reason_row[c] == 3) why = "spreadfield";   // SpreadConstraint
      if (!why && reason_row[c] == 4) why = "plugin";        // out-of-tree
      if (!why) {                                            // ClusterEviction
        for (int32_t j = 0; j < bd.n_evict; ++j)
          if (bd.evict_idx[j] == c) {
            why = "evicting";
            break;
          }
      }
      if (why) {
        ++n_diagnosed;
        continue;
      }
      // prioritizeClusters: ClusterLocality + out-of-tree plugin sums
      // (pre-clamped on the Python side, scheduler/plugins.py)
      int64_t score = ((has_prev && prev_map.count(c)) ? 100 : 0) +
                      S.p_extra_score[static_cast<int64_t>(bd.placement) * S.nC + c];
      details.push_back({c, score, 0, 0});
    }
    if (details.empty()) {
      out_status[b] = kFitError;
      out_off[b + 1] = cursor;
      (void)n_diagnosed;
      continue;
    }

    // ---- group_clusters_with_score: capacity + sort ----------------------
    for (auto& d : details) {
      d.allocatable = cal_available_one(S, class_req, bd, d.idx);
      auto it = prev_map.find(d.idx);
      d.available = d.allocatable + (it == prev_map.end() ? 0 : it->second);
    }
    sort_clusters(&details, S);

    // region groups (only when topology participates)
    // regions map: region id -> member details, in sorted-cluster order
    std::vector<std::vector<ClusterDetail>> region_members;
    std::vector<int32_t> region_ids_present;
    if (!topology_ignored(pv) && pv.find(kFieldRegion) != nullptr) {
      std::unordered_map<int32_t, size_t> rpos;
      for (const auto& d : details) {
        int32_t r = region_id[d.idx];
        if (r < 0) continue;
        auto it = rpos.find(r);
        if (it == rpos.end()) {
          rpos[r] = region_members.size();
          region_ids_present.push_back(r);
          region_members.emplace_back();
          region_members.back().push_back(d);
        } else {
          region_members[it->second].push_back(d);
        }
      }
    }

    // ---- SelectClusters (select_clusters*.go) ----------------------------
    candidates.clear();
    bool unschedulable = false;
    if (pv.n_sc == 0 || ignore_spread(pv)) {
      candidates = details;
    } else {
      int64_t need = ignore_available(pv) ? kInvalidReplicas : bd.replicas;
      const SpreadC* rsc = pv.find(kFieldRegion);
      const SpreadC* csc = pv.find(kFieldCluster);
      if (rsc != nullptr) {
        // select_clusters_by_region.go:27-118
        if (static_cast<int64_t>(region_members.size()) < rsc->min_groups) {
          unschedulable = true;
        } else {
          int64_t rep = bd.replicas;
          int64_t rmin = rsc->min_groups;
          std::vector<DfsGroup> groups;
          for (size_t g = 0; g < region_members.size(); ++g) {
            int64_t w = calc_group_score(region_members[g], pv, rep, rmin);
            groups.push_back({region_ids_present[g],
                              static_cast<int64_t>(region_members[g].size()), w});
          }
          SpreadC cdef;  // zero-valued when absent (go zero value semantics)
          const SpreadC& cc = csc ? *csc : cdef;
          std::vector<DfsGroup> chosen = select_groups(
              groups, S, rsc->min_groups, rsc->max_groups, cc.min_groups);
          if (chosen.empty()) {
            unschedulable = true;
          } else {
            std::unordered_map<int32_t, size_t> pos;
            for (size_t g = 0; g < region_ids_present.size(); ++g)
              pos[region_ids_present[g]] = g;
            rest.clear();
            for (const auto& g : chosen) {
              const auto& members = region_members[pos[g.region]];
              candidates.push_back(members[0]);
              for (size_t i = 1; i < members.size(); ++i)
                rest.push_back(members[i]);
            }
            int64_t need_cnt =
                static_cast<int64_t>(rest.size() + candidates.size());
            if (need_cnt > cc.max_groups) need_cnt = cc.max_groups;
            int64_t extra = need_cnt - static_cast<int64_t>(candidates.size());
            if (extra > 0) {
              sort_clusters(&rest, S);
              for (int64_t i = 0; i < extra && i < static_cast<int64_t>(rest.size()); ++i)
                candidates.push_back(rest[i]);
            }
          }
        }
      } else if (csc != nullptr) {
        // select_clusters_by_cluster.go:25-105
        int64_t total = static_cast<int64_t>(details.size());
        if (total < csc->min_groups) {
          unschedulable = true;
        } else {
          int64_t need_cnt = total >= csc->max_groups ? csc->max_groups : total;
          if (need == kInvalidReplicas) {
            for (int64_t i = 0; i < need_cnt; ++i) candidates.push_back(details[i]);
          } else {
            candidates.assign(details.begin(),
                              details.begin() + static_cast<size_t>(need_cnt));
            rest.assign(details.begin() + static_cast<size_t>(need_cnt),
                        details.end());
            if (!select_by_available_resource(&candidates, &rest, need)) {
              unschedulable = true;
              candidates.clear();
            }
          }
        }
      } else {
        unschedulable = true;  // "just support cluster and region spread constraint"
      }
    }
    if (unschedulable) {
      out_status[b] = kUnschedulable;
      out_off[b + 1] = cursor;
      continue;
    }
    if (candidates.empty()) {
      out_status[b] = kNoClusterAvailable;
      out_off[b + 1] = cursor;
      continue;
    }

    // ---- AssignReplicas (assignment.go / division_algorithm.go) ----------
    bool drop_zeros = true;
    bool fresh = bd.fresh;
    int32_t strat = pv.strategy;
    if (!bd.workload) {
      // non-workloads & multi-component: propagate to ALL candidates with
      // zero replicas (assign_replicas early return — NOT subject to the
      // strategy paths' replicas>0 drop)
      for (const auto& c : candidates) result.push_back({c.idx, 0});
      drop_zeros = false;
      goto emit;
    }

    if (strat == kDuplicated) {
      for (const auto& c : candidates) result.push_back({c.idx, bd.replicas});
    } else if (strat == kStaticWeight) {
      party_cluster.clear();
      votes.clear();
      const int64_t* wrow =
          p_weights + static_cast<int64_t>(bd.placement) * nC;
      int64_t wsum = 0;
      if (pv.has_weights) {
        for (const auto& c : candidates) {
          int64_t w = wrow[c.idx];
          if (w > 0) {
            party_cluster.push_back(c.idx);
            votes.push_back(w);
            wsum += w;
          }
        }
      }
      if (!pv.has_weights || wsum == 0) {
        // defaulting: all candidates weight 1 (assignment.go:196-198 +
        // getStaticWeightInfoList zero-sum fallback)
        party_cluster.clear();
        votes.clear();
        for (const auto& c : candidates) {
          party_cluster.push_back(c.idx);
          votes.push_back(1);
        }
      }
      dispense_by_weight(bd.replicas, party_cluster, votes, S, bd.uid_desc,
                         &result);
    } else if (strat == kDynamicWeight || strat == kAggregated) {
      // assignByDynamicStrategy (assignment.go:207-238)
      scheduled.clear();
      int64_t assigned = 0;
      {
        std::unordered_map<int32_t, char> cand_set;
        for (const auto& c : candidates) cand_set[c.idx] = 1;
        for (int32_t j = 0; j < bd.n_prev; ++j)
          if (cand_set.count(bd.prev_idx[j])) {
            scheduled.push_back({bd.prev_idx[j], bd.prev_val[j]});
            assigned += bd.prev_val[j];
          }
      }
      int64_t target;
      available.clear();
      if (fresh) {
        // division_algorithm.go:139-166
        target = bd.replicas;
        std::unordered_map<int32_t, int64_t> sched_map;
        for (const auto& t : scheduled) sched_map[t.idx] = t.replicas;
        for (const auto& c : candidates) {
          auto it = sched_map.find(c.idx);
          available.push_back(
              {c.idx, c.allocatable + (it == sched_map.end() ? 0 : it->second)});
        }
        scheduled.clear();
      } else if (assigned > bd.replicas) {
        // scale down: previous result becomes the weights (:103-119)
        target = bd.replicas;
        scheduled.clear();
        for (int32_t j = 0; j < bd.n_prev; ++j)
          available.push_back({bd.prev_idx[j], bd.prev_val[j]});
      } else if (assigned < bd.replicas) {
        // scale up (:121-136)
        target = bd.replicas - assigned;
        for (const auto& c : candidates)
          available.push_back({c.idx, c.allocatable});
      } else {
        for (const auto& t : scheduled) result.push_back(t);
        goto emit;
      }
      {
        // _sort_by_replicas_desc: (-replicas, name)
        std::sort(available.begin(), available.end(),
                  [&S](const Target& a, const Target& b) {
                    if (a.replicas != b.replicas) return a.replicas > b.replicas;
                    return S.name_rank[a.idx] < S.name_rank[b.idx];
                  });
        int64_t avail_sum = 0;
        for (const auto& t : available) avail_sum += t.replicas;
        if (avail_sum < target) {
          out_status[b] = kUnschedulable;
          out_off[b + 1] = cursor;
          continue;
        }
        if (strat == kAggregated) {
          // resort_available (assignment.go:145-172): prior clusters first
          std::unordered_map<int32_t, char> prior;
          for (const auto& t : scheduled)
            if (t.replicas > 0) prior[t.idx] = 1;
          if (!prior.empty()) {
            std::vector<Target> pr, lf;
            for (const auto& t : available)
              (prior.count(t.idx) ? pr : lf).push_back(t);
            available.clear();
            available.insert(available.end(), pr.begin(), pr.end());
            available.insert(available.end(), lf.begin(), lf.end());
          }
          int64_t total = 0;
          size_t cut = available.size();
          for (size_t i = 0; i < available.size(); ++i) {
            total += available[i].replicas;
            if (total >= target) {
              cut = i + 1;
              break;
            }
          }
          available.resize(cut);
        }
        party_cluster.clear();
        votes.clear();
        for (const auto& t : available) {
          party_cluster.push_back(t.idx);
          votes.push_back(t.replicas);
        }
        dispense_by_weight(target, party_cluster, votes, S, bd.uid_desc,
                           &dispensed);
        // merge_target_clusters(scheduled, new): old order first, sums
        result.clear();
        std::unordered_map<int32_t, size_t> rpos;
        for (const auto& t : scheduled) {
          auto it = rpos.find(t.idx);
          if (it == rpos.end()) {
            rpos[t.idx] = result.size();
            result.push_back(t);
          } else {
            result[it->second].replicas += t.replicas;
          }
        }
        for (const auto& t : dispensed) {
          auto it = rpos.find(t.idx);
          if (it == rpos.end()) {
            rpos[t.idx] = result.size();
            result.push_back(t);
          } else {
            result[it->second].replicas += t.replicas;
          }
        }
      }
    } else {
      out_status[b] = kUnschedulable;  // unsupported strategy
      out_off[b + 1] = cursor;
      continue;
    }

  emit:
    for (const auto& t : result) {
      if (drop_zeros && t.replicas <= 0) continue;  // strategy paths drop zeros
      if (cursor >= out_cap) {
        out_status[b] = kOutputOverflow;
        return 1;
      }
      out_idx[cursor] = t.idx;
      out_val[cursor] = t.replicas;
      ++cursor;
    }
    out_off[b + 1] = cursor;
  }
  return 0;
}

}  // extern "C"
