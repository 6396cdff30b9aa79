"""Tier-1 candidate shortlist: the hierarchical two-tier solve.

Counterpart of the JAX package's ``ops/shortlist.py``.  The dense solve is
O(B*C): every binding prices every cluster.  At fleet scale (1M bindings,
10k clusters) the reference's own hierarchy -- group selection before
per-cluster division -- becomes two tiers:

  tier 1 (card)   K8 shortlist_topk, one launch that computes each lane's
                  capacity on the raw snapshot itself, over the chunk's
                  DISTINCT profiles (bindings sharing
                  (placement, GVK, request class) have identical static
                  rows): per profile the top-k cluster lanes by a packed
                  key -- previous-assignment bit, capacity estimate, a
                  coarse per-region capacity rank (K9 group_sums, once per
                  cycle), name order -- and the eligible-lane count.
  tier 2 (card)   the existing solver (ops/solver) over the chunk's
                  candidate-union sub-vocabulary: a [B, C'] problem with
                  C' ~ O(k) instead of C, via the per-chunk lane remap
                  _sub_batch.  The solver's lane math compares name ranks
                  only by order, which the remap preserves, so a covered
                  chunk's result is bit-exact against the dense solve.

A binding is COVERED when its whole eligible lane set (feasible lanes plus
its previous-assignment lanes) fits k.  A chunk with an uncovered binding
widens k and retries; rows whose eligible set outgrows k_max leave the
chunk as a per-binding dense residual (truncation, exact at waves=1) or
drag the chunk back to the dense dispatch.  Every fallback keeps the dense
batch: it costs time and never changes a placement.

K8 and K9 have plain PyTorch versions here (shortlist_topk_plain,
group_sums_plain), taken only for tensors on the CPU.  Counts of
dispatches, rows, widenings, cells and fallbacks go in the module dicts
COUNTS and FALLBACKS (plain ints, reset by reset_for_tests()) and in the
JAX package's karmada_shortlist_* registry families.
"""

from __future__ import annotations

from array import array
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from karmada_tpu_torch.device import resolve_device
from karmada_tpu_torch.obs import decisions as obs_decisions
from karmada_tpu_torch.obs import events as ev
from karmada_tpu_torch.ops import kernels
from karmada_tpu_torch.ops import resident_gather as rg
from karmada_tpu_torch.ops import tensors as T
from karmada_tpu_torch.utils.metrics import REGISTRY
from karmada_tpu_torch.ops.solver import (
    _AVAIL_BITS,
    _AVAIL_CAP,
    _LANE_BITS,
    _LANE_MASK,
    I64,
    DeviceBatch,
    _on_cuda,
    _row_inputs,
    _to_dev,
    _zeros_used,
    capacity_plain,
)
from karmada_tpu_torch.utils.locks import VetLock

# packed score-key geometry: prev-assignment bit above a 34-bit capacity
# field above a 5-bit coarse group-rank field above the 21-bit lane field
# (1+34+5+21 = 61 bits)
_GROUP_BITS = 5
_GROUP_MASK = (1 << _GROUP_BITS) - 1

#: tier-1 work and fallbacks since the last reset_for_tests(): dispatches
#: (K8 launches of _t1_rows, one per memo miss set), rows solved over a
#: sub-vocabulary, widen-and-retry rounds, tier-2 cells (B*C' solved and
#: B*C the dense dispatch would have priced), rows priced at full width by
#: kind (`needed`: their own eligible set or route asked for it;
#: `chunk_drag`: dragged along by a per-chunk fallback)
COUNTS: Dict[str, int] = {
    "dispatches": 0, "rows": 0, "widenings": 0, "cells_solve": 0,
    "cells_dense": 0, "fallback_rows_needed": 0,
    "fallback_rows_chunk_drag": 0}
#: chunks that fell back to the dense dispatch, by reason
FALLBACKS: Dict[str, int] = {
    "uncovered": 0, "mixed_routes": 0, "union_wide": 0, "fused": 0}

SHORTLIST_DISPATCHES = REGISTRY.counter(
    "karmada_shortlist_dispatches_total",
    "Tier-1 shortlist kernel dispatches (one per shortlisted chunk, "
    "plus one per widen retry)",
)
SHORTLIST_ROWS = REGISTRY.counter(
    "karmada_shortlist_rows_total",
    "Binding rows whose tier-2 solve ran over the shortlisted "
    "sub-vocabulary instead of the full cluster axis",
)
SHORTLIST_FALLBACKS = REGISTRY.counter(
    "karmada_shortlist_fallbacks_total",
    "Chunks that fell back to the full dense dispatch, by reason "
    "(uncovered: a binding's eligible set outgrew k even after "
    "widening, with truncation off or unavailable; mixed_routes: the "
    "chunk holds rows the device tier does not own; union_wide: the "
    "candidate union approached the dense width; fused: a fused "
    "resident-gather batch arrived without its fused_src handle, so "
    "the shortlist cannot read binding fields host-side)",
    ("reason",),
)
SHORTLIST_FALLBACK_ROWS = REGISTRY.counter(
    "karmada_shortlist_fallback_rows_total",
    "Binding rows priced at full dense width, by kind: `needed` rows "
    "individually required it (eligible set beyond k_max, or a "
    "non-device route), `chunk_drag` rows were dragged along by a "
    "per-chunk fallback their own eligible set did not ask for — the "
    "per-binding routing win is this kind going to zero",
    ("kind",),
)
SHORTLIST_WIDENINGS = REGISTRY.counter(
    "karmada_shortlist_widenings_total",
    "Widen-and-retry rounds (k doubled because a binding's eligible "
    "lane set did not fit)",
)
SHORTLIST_CELLS = REGISTRY.counter(
    "karmada_shortlist_cells_total",
    "Tier-2 solver cell work, by tier: solve = B*C' actually "
    "dispatched over the sub-vocabulary, dense_equiv = B*C the full "
    "dense dispatch would have priced (their ratio is the measured "
    "cell-work reduction)",
    ("tier",),
)
SHORTLIST_UNION_LANES = REGISTRY.gauge(
    "karmada_shortlist_union_lanes",
    "Cluster lanes in the most recent shortlisted chunk's candidate "
    "union (the tier-2 sub-vocabulary width before pow2 padding)",
)

#: COUNTS key -> (registry family, its labels)
_FAMILY_OF = {
    "dispatches": (SHORTLIST_DISPATCHES, {}),
    "rows": (SHORTLIST_ROWS, {}),
    "widenings": (SHORTLIST_WIDENINGS, {}),
    "cells_solve": (SHORTLIST_CELLS, {"tier": "solve"}),
    "cells_dense": (SHORTLIST_CELLS, {"tier": "dense_equiv"}),
    "fallback_rows_needed": (SHORTLIST_FALLBACK_ROWS, {"kind": "needed"}),
    "fallback_rows_chunk_drag": (SHORTLIST_FALLBACK_ROWS,
                                 {"kind": "chunk_drag"}),
}


def _count(key: str, n: int = 1) -> None:
    """Add `n` to COUNTS[key] and to its registry family."""
    COUNTS[key] += n
    fam, labels = _FAMILY_OF[key]
    fam.inc(float(n), **labels)


@dataclass(frozen=True)
class ShortlistConfig:
    """Tier selection knobs (the JAX Scheduler's shortlist_k= / serve
    --shortlist).

    k: candidate lanes per binding (tier-1 top-k width).
    min_cells: a chunk shortlists only when its dense B*C cell count is at
      least this; <= 0 arms every chunk.
    k_max: widen-and-retry ceiling -- k doubles toward this while any
      binding's eligible set does not fit, then the offending rows are
      truncated out or the chunk falls back.
    union_frac: dense fallback when the candidate union exceeds this
      fraction of the real cluster count.
    truncate: rows whose eligible set exceeds k_max leave the chunk as a
      per-binding dense residual (the pipeline solves them at full width
      against the chunk's starting consumption) instead of dragging the
      chunk dense; the pipeline allows it only at waves=1 without
      keep_sel.
    """

    k: int = 64
    min_cells: int = 1 << 21
    k_max: int = 256
    union_frac: float = 0.5
    truncate: bool = True


# ---------------------------------------------------------------------------
# K8 shortlist_topk
# ---------------------------------------------------------------------------

def topk_keys_plain(db: DeviceBatch, group_pref):
    """Every row's packed tier-1 key plane, int64[B, C]: -1 where the lane
    is not eligible (JAX: _shortlist_core before lax.top_k).  Each lane's
    capacity is capacity_plain's on db's raw snapshot (no used triple)."""
    B = db.B
    zeros = _zeros_used(db)
    est = capacity_plain(db.req_milli, db.req_is_cpu, db.req_pods,
                         db.avail_milli, zeros[0], db.has_alloc,
                         db.pods_allowed, zeros[1], db.has_summary,
                         db.est_override, zeros[2])
    _pid, cid, _pr, prev_present, _ac, feasible, _ev = _row_inputs(
        db, 0, B, est)
    est_b = est[cid]
    avail = torch.clamp(torch.where(est_b == (1 << 31) - 1,
                                    db.replicas[:, None], est_b),
                        0, _AVAIL_CAP)
    eligible = (feasible | prev_present) & db.b_valid[:, None]
    key = ((prev_present.long() << (_AVAIL_BITS + _GROUP_BITS + _LANE_BITS))
           | (avail << (_GROUP_BITS + _LANE_BITS))
           | (group_pref[None, :] << _LANE_BITS)
           | (_LANE_MASK - db.name_rank)[None, :])
    return torch.where(eligible, key, torch.full((), -1, dtype=I64,
                                                 device=key.device))


def shortlist_topk_plain(db: DeviceBatch, group_pref, k: int):
    """The candidate plane of every row of db (JAX: _shortlist_core):
    (cand int32[B, k] -- cluster lanes best first, -1 padded -- and fcount
    int32[B], the eligible-lane count), from topk_keys_plain's keys;
    group_pref int64[C].  k may exceed C (the columns past C are -1)."""
    B, C = db.B, db.C
    key = topk_keys_plain(db, group_pref)
    # lax.top_k: descending, ties (only among -1 keys) to the lowest lane
    srt = torch.sort(key, dim=1, descending=True, stable=True)
    vals, idx = srt.values[:, :k], srt.indices[:, :k]
    cand = torch.where(vals >= 0, idx, -1).to(torch.int32)
    if k > C:
        cand = torch.cat([cand, cand.new_full((B, k - C), -1)], dim=1)
    return cand, (key >= 0).sum(1).to(torch.int32)


def shortlist_topk(db: DeviceBatch, group_pref, k: int):
    """K8 (ops/csrc/shortlist.cu; launch counter "shortlist_topk") on a
    CUDA batch, shortlist_topk_plain on a CPU one; same contract.  One
    launch, no device sync: db's operands are checked once per
    DeviceBatch, group_pref on every call, and the call allocates cand
    and fcount (and, for rows wider than kernels.TOPK_SMEM_LANES, the
    kernel's [B, C] pair scratch)."""
    if not _on_cuda(group_pref, db.b_valid):
        return shortlist_topk_plain(db, group_pref, k)
    B, C = db.B, db.C
    Q, R = db.req_milli.shape
    Kp = db.prev_idx.shape[1]
    Ke = db.evict_idx.shape[1]
    if not 1 <= k <= kernels.TOPK_MAX_K:
        raise ValueError(f"k={k} outside [1, {kernels.TOPK_MAX_K}]")
    t = db.t
    if "topk" not in db.checked:
        P = db.pl_mask.shape[0]
        kernels.check_fields(t, {
            "cluster_valid": (torch.bool, (C,)),
            "deleting": (torch.bool, (C,)), "name_rank": (I64, (C,)),
            "api_ok": (torch.bool, (db.api_ok.shape[0], C)),
            "pl_mask": (torch.bool, (P, C)),
            "pl_tol_bypass": (torch.bool, (P, C)),
            "pods_allowed": (I64, (C,)), "has_summary": (torch.bool, (C,)),
            "avail_milli": (I64, (C, R)), "has_alloc": (torch.bool, (C, R)),
            "req_milli": (I64, (Q, R)), "req_is_cpu": (torch.bool, (R,)),
            "req_pods": (I64, (Q,)), "est_override": (I64, (Q, C)),
            "b_valid": (torch.bool, (B,)),
            "placement_id": (torch.int32, (B,)),
            "gvk_id": (torch.int32, (B,)), "class_id": (torch.int32, (B,)),
            "replicas": (I64, (B,)), "prev_idx": (torch.int32, (B, Kp)),
            "evict_idx": (torch.int32, (B, Ke))})
        db.checked.add("topk")
    kernels.check(group_pref, I64, (C,))
    dev = group_pref.device
    cand = torch.empty((B, k), dtype=torch.int32, device=dev)
    fcount = torch.empty((B,), dtype=torch.int32, device=dev)
    smem = C <= kernels.TOPK_SMEM_LANES
    # the (key, lane) pair scratch of rows wider than shared memory holds
    pair = () if smem else (
        torch.empty((B * C,), dtype=I64, device=dev),
        torch.empty((B * C,), dtype=torch.int32, device=dev))
    nk = T._next_pow2(k, 1)  # noqa: SLF001
    kernels.launch("shortlist", array("q", (  # TopkArgs
        *(t[f].data_ptr() for f in kernels.TOPK_TENSOR_FIELDS),
        group_pref.data_ptr(), *(x.data_ptr() for x in pair),
        *((0, 0) if smem else ()), cand.data_ptr(), fcount.data_ptr(),
        B, C, Q, R, Kp, Ke, k, nk, int(smem))),
        "shortlist_topk", count="shortlist_topk", device=dev.index)
    return cand, fcount


# ---------------------------------------------------------------------------
# K9 group_sums
# ---------------------------------------------------------------------------

def group_sums_plain(group_id, cap_proxy, n_groups: int):
    """Per-group sum of the capacity proxy, int64[n_groups + 1] (JAX:
    _group_sums): groupless lanes (-1) land in the trailing bucket; ids
    beyond it are dropped, as segment_sum drops them."""
    gid = torch.where(group_id >= 0, group_id.long(), n_groups)
    keep = gid <= n_groups
    out = torch.zeros((n_groups + 1,), dtype=I64, device=cap_proxy.device)
    return out.index_add_(0, gid[keep], cap_proxy[keep])


def group_sums(group_id, cap_proxy, n_groups: int):
    """K9 (ops/csrc/shortlist.cu; launch counter "group_sums") on CUDA
    tensors, group_sums_plain on CPU ones; same contract.  One launch: the
    kernel writes every bin, so the output is allocated uninitialised
    (torch.empty, no fill kernel)."""
    if not (group_id.is_cuda or cap_proxy.is_cuda):
        return group_sums_plain(group_id, cap_proxy, n_groups)
    if not (group_id.is_cuda and cap_proxy.is_cuda):
        raise ValueError("group_sums operands on mixed devices")
    if group_id.dtype != torch.int32 or cap_proxy.dtype != I64:
        raise TypeError(f"group_sums operands {group_id.dtype}, "
                        f"{cap_proxy.dtype}: expected int32, int64")
    C = group_id.shape[0]
    if group_id.dim() != 1 or tuple(cap_proxy.shape) != (C,):
        raise ValueError(f"group_sums operands {tuple(group_id.shape)}, "
                         f"{tuple(cap_proxy.shape)}: expected [C], [C]")
    if not (group_id.is_contiguous() and cap_proxy.is_contiguous()):
        raise ValueError("group_sums operands are not contiguous")
    if n_groups < 0:
        raise ValueError(f"n_groups={n_groups} < 0")
    out = cap_proxy.new_empty(n_groups + 1)
    kernels.launch("shortlist", array("q", (  # GroupSumArgs
        group_id.data_ptr(), cap_proxy.data_ptr(), out.data_ptr(), C,
        n_groups)), "group_sums", count="group_sums",
        device=out.get_device())
    return out


# ---------------------------------------------------------------------------
# Memos: the cycle's coarse aggregates and the per-profile tier-1 rows
# ---------------------------------------------------------------------------

# one-slot per-cycle memo for the coarse aggregates: the encoder hands
# back the SAME frozen numpy cluster planes across the chunks of a cycle
# that share a vocabulary (EncoderCache.assembled), so identity keying
# aggregates once per such run.  The memo pins the source arrays it keyed
# on, so a collected id can never alias a fresh plane.
_AGG_MEMO: List[Optional[dict]] = [None]
_AGG_LOCK = VetLock("shortlist.agg")
# per-profile tier-1 memo (see _dispatch_profiles): one master-set slot,
# {(placement, gvk, class, k) -> (cand_row, fcount)} under it, a bounded
# LRU; same pinning discipline
_T1_MEMO: List[Optional[dict]] = [None]
_T1_LOCK = VetLock("shortlist.t1")
_T1_ROWS_CAP = 4096  # LRU bound on cached profile rows per master epoch


def reset_for_tests() -> None:
    """Drop both memos and zero the counters."""
    with _AGG_LOCK:
        _AGG_MEMO[0] = None
    with _T1_LOCK:
        _T1_MEMO[0] = None
    for d in (COUNTS, FALLBACKS):
        for k in d:
            d[k] = 0
    with _AGG_LOCK:
        _LAST.clear()


def cycle_aggregates(batch, device=None) -> dict:
    """The cycle's coarse per-group aggregates, built once from the
    cluster planes: group_cap int64[G+1] (free-pod proxy summed per region
    by K9; trailing bucket = groupless), group_pref int64[C] (the 5-bit
    capacity-rank preference the score key packs -- richer regions rank
    higher), cap_proxy int64[C], and the cluster names they align to."""
    src = (batch.avail_milli, batch.pods_allowed, batch.region_id)
    with _AGG_LOCK:
        memo = _AGG_MEMO[0]
        if (memo is not None and memo["c"] == batch.C
                and all(a is b for a, b in zip(memo["src"], src))):
            return memo
    device = resolve_device(device)
    region_id = (batch.region_id if batch.region_id is not None
                 else np.full(batch.C, -1, np.int32))
    n_groups = len(batch.region_names or [])
    valid = np.asarray(batch.cluster_valid) & ~np.asarray(batch.deleting)
    cap_proxy = np.where(valid, np.asarray(batch.pods_allowed), 0)
    group_cap = group_sums(
        _to_dev(np.ascontiguousarray(region_id, np.int32), device),
        _to_dev(np.ascontiguousarray(cap_proxy, np.int64), device),
        n_groups).cpu().numpy()
    # rank groups by aggregate capacity (desc); the key packs 5 bits
    order = np.argsort(-group_cap, kind="stable")
    rank = np.zeros(n_groups + 1, np.int64)
    rank[order] = np.arange(n_groups + 1)
    pref = _GROUP_MASK - np.minimum(rank, _GROUP_MASK)
    gid = np.where(region_id >= 0, region_id, n_groups)
    memo = {
        "src": src,
        "c": batch.C,
        "group_cap": group_cap,
        "group_pref": np.ascontiguousarray(pref[gid], np.int64),
        "cap_proxy": np.ascontiguousarray(cap_proxy, np.int64),
        "names": tuple(batch.cluster_index.names)
        if batch.cluster_index is not None else (),
        "n_groups": n_groups,
    }
    with _AGG_LOCK:
        _AGG_MEMO[0] = memo
    return memo


# /debug/state shortlist block: last-chunk snapshot + lifetime counters
# guarded-by: _AGG_LOCK; mutators: _note,reset_for_tests
_LAST: Dict[str, object] = {}


def _note(**kw) -> None:
    with _AGG_LOCK:
        _LAST.update(kw)


def state_payload() -> dict:
    """The `shortlist` section of /debug/state (utils/httpserve reads it
    through sys.modules: a plane that never imported the tier pays
    nothing)."""
    with _AGG_LOCK:
        last = dict(_LAST)
    return {
        "dispatches": int(SHORTLIST_DISPATCHES.value()),
        "rows": int(SHORTLIST_ROWS.value()),
        "widenings": int(SHORTLIST_WIDENINGS.value()),
        "fallbacks": int(SHORTLIST_FALLBACKS.total()),
        "last": last,
    }


def _fallback(reason: str, detail: str) -> Tuple[None, dict]:
    """The counted dense-fallback path (a count and a lifecycle-ledger
    event): a shortlisted chunk never changes width silently."""
    FALLBACKS[reason] += 1
    SHORTLIST_FALLBACKS.inc(reason=reason)
    ev.emit(_LEDGER_REF, ev.TYPE_WARNING, ev.REASON_SHORTLIST_FALLBACK,
            f"chunk fell back to the dense solve ({reason}): {detail}",
            origin="shortlist")
    _note(fallback_reason=reason)
    return None, {"fallback": reason, "detail": detail}


#: the ledger timeline of the tier's fallbacks and truncations
_LEDGER_REF = ev.ObjectRef(kind="Scheduler", namespace="", name="shortlist")


def _row_names(part, rows, limit: int = 5) -> str:
    """Name offending binding rows for fallback / truncation messages:
    operators chase bindings by key, not by chunk-local row index."""
    rows = list(rows)
    if part is None:
        return f"{len(rows)} row(s)"
    names = [(obs_decisions.default_key(part[i][0])
              if i < len(part) else f"row {i}") for i in rows[:limit]]
    extra = f" (+{len(rows) - limit} more)" if len(rows) > limit else ""
    return ", ".join(names) + extra


def _profiles(batch):
    """Profile dedup: bindings sharing (placement, gvk, request class)
    have identical static feasibility and capacity rows, so tier 1 scores
    one row per distinct profile.  Per-binding deltas (prev assignments,
    evictions) rejoin host-side: prev lanes append to the candidate union,
    evict lanes only ever remove feasibility.

    Returns (prof_keys int32[nprof, 3], prof_of int64[B], replicas_max
    int64[nprof])."""
    keys = np.stack([
        np.asarray(batch.placement_id, np.int32),
        np.asarray(batch.gvk_id, np.int32),
        np.asarray(batch.class_id, np.int32),
    ], axis=1)
    prof_keys, prof_of = np.unique(keys, axis=0, return_inverse=True)
    prof_of = prof_of.reshape(-1)
    rep_max = np.zeros(prof_keys.shape[0], np.int64)
    np.maximum.at(rep_max, prof_of, np.asarray(batch.replicas, np.int64))
    return prof_keys, prof_of, rep_max


_PROFILE_CLUSTER_FIELDS = (
    "cluster_valid", "deleting", "name_rank", "pods_allowed", "has_summary",
    "avail_milli", "has_alloc", "api_ok", "req_milli", "req_is_cpu",
    "req_pods", "est_override", "pl_mask", "pl_tol_bypass")


def profile_batch(batch, prof_keys, rep_max, device) -> DeviceBatch:
    """The tier-1 operands of the given profile rows on `device`: the
    cluster planes and one row per profile, padded to a power of two >= 8
    rows (padding rows invalid), with no prev/evict lanes and no
    non-workload shortcut -- the rows _shortlist_core is called with."""
    nprof = prof_keys.shape[0]
    Bp = T._next_pow2(max(nprof, 1), 8)  # noqa: SLF001

    def pad1(a, fill, dtype):
        out = np.full(Bp, fill, dtype)
        out[:nprof] = a
        return out

    b_valid = np.zeros(Bp, bool)
    b_valid[:nprof] = True
    rows = {
        "b_valid": b_valid,
        "placement_id": pad1(prof_keys[:, 0], 0, np.int32),
        "gvk_id": pad1(prof_keys[:, 1], 0, np.int32),
        "class_id": pad1(prof_keys[:, 2], -1, np.int32),
        "replicas": pad1(rep_max, 0, np.int64),
        "nw_shortcut": np.zeros(Bp, bool),
        "prev_idx": np.full((Bp, 1), -1, np.int32),
        "prev_val": np.zeros((Bp, 1), np.int32),
        "evict_idx": np.full((Bp, 1), -1, np.int32),
    }
    t = {f: _to_dev(getattr(batch, f), device)
         for f in _PROFILE_CLUSTER_FIELDS}
    t.update({f: _to_dev(a, device) for f, a in rows.items()})
    return DeviceBatch(B=Bp, C=int(batch.C), device=device, t=t)


def _t1_rows(batch, prof_keys, rep_max, k: int, agg, device):
    """Run tier 1 over the given profile rows (uncached): one K8 launch,
    which computes the rows' capacity on the raw snapshot itself.
    Returns (cand int32[nprof, k], fcount int32[nprof]) as numpy."""
    nprof = prof_keys.shape[0]
    db = profile_batch(batch, prof_keys, rep_max, device)
    cand, fcount = shortlist_topk(db, _to_dev(agg["group_pref"], device), k)
    _count("dispatches", 1)
    return cand.cpu().numpy()[:nprof], fcount.cpu().numpy()[:nprof]


def _dispatch_profiles(batch, prof_keys, rep_max, k: int, device):
    """Tier-1 candidates for the chunk's profile rows: (cand int32[nprof,
    k], fcount int32[nprof]) as numpy.

    Cached per profile across calls: tier 1 reads only the frozen
    lane/class masters (never the carried capacity ledger -- tier 2 owns
    pricing), so for an unchanged master set its output is a pure function
    of (profile key, k).  rep_max is not part of the key: profile rows
    carry no prev/evict lanes, so the eligible mask (and fcount) is
    replica-independent, and for every covered profile the widen loop
    makes cand the full eligible set whatever the order; an uncovered
    profile's truncated cand only adds superset lanes to the union, which
    never changes the sub-solve's result.  Identity-keyed on the masters
    like the aggregates memo, pinning them."""
    agg = cycle_aggregates(batch, device)
    masters = tuple(getattr(batch, f) for f in _PROFILE_CLUSTER_FIELDS) + (
        agg["group_pref"],)
    nprof = prof_keys.shape[0]
    pkeys = [(int(prof_keys[i, 0]), int(prof_keys[i, 1]),
              int(prof_keys[i, 2]), k) for i in range(nprof)]
    with _T1_LOCK:
        memo = _T1_MEMO[0]
        if (memo is None or memo["device"] != device
                or not all(a is b for a, b in zip(memo["src"], masters))):
            memo = {"src": masters, "device": device, "rows": OrderedDict()}
            _T1_MEMO[0] = memo
        have = {key: memo["rows"].get(key) for key in pkeys}
        for key in pkeys:  # LRU touch: this cycle's profiles stay warm
            if have[key] is not None:
                memo["rows"].move_to_end(key)
    miss = [i for i, key in enumerate(pkeys) if have[key] is None]
    if miss:
        cand_m, fcount_m = _t1_rows(
            batch, prof_keys[miss], rep_max[np.asarray(miss)], k, agg,
            device)
        fresh = {pkeys[i]: (cand_m[j], fcount_m[j])
                 for j, i in enumerate(miss)}
        have.update(fresh)
        with _T1_LOCK:
            memo["rows"].update(fresh)
            while len(memo["rows"]) > _T1_ROWS_CAP:
                memo["rows"].popitem(last=False)  # evict the coldest
    cand = (np.stack([have[key][0] for key in pkeys]) if nprof
            else np.zeros((0, k), np.int32))
    fcount = np.asarray([have[key][1] for key in pkeys], np.int32)
    return cand, fcount


def binding_candidates(batch, k: int, device=None):
    """Per-binding candidate lane sets (profile candidates plus the
    binding's own prev lanes) -- the recall measurement's view of tier 1.
    Host-side; small slices only."""
    device = resolve_device(device)
    prof_keys, prof_of, rep_max = _profiles(batch)
    cand, _fcount = _dispatch_profiles(batch, prof_keys, rep_max,
                                       min(k, batch.C), device)
    prev = np.asarray(T.host_rows(batch).prev_idx)
    out = []
    for b in range(batch.n_bindings):
        s = set(int(c) for c in cand[prof_of[b]] if c >= 0)
        s.update(int(c) for c in prev[b] if c >= 0)
        out.append(s)
    return out


def shrink_chunk(batch, cfg: ShortlistConfig, allow_truncate: bool = True,
                 device=None, part=None):
    """Tier selection for one encoded chunk: (sub_batch, info).

    sub_batch is a SolverBatch over the chunk's candidate-union
    sub-vocabulary whose tier-2 solve is bit-exact against the full dense
    dispatch, or None when the chunk stays dense (info["fallback"] says
    why; every fallback but `below_threshold` is counted in FALLBACKS).

    With cfg.truncate and allow_truncate, rows whose eligible set exceeds
    k_max leave the chunk as info["residual"] (chunk-local row indices)
    for the pipeline's per-binding dense solve instead of dragging all B
    rows dense.  `part` (the chunk's (spec, status) items) names the
    offending rows in the ledger's messages."""
    if cfg.min_cells > 0 and batch.B * batch.C < cfg.min_cells:
        return None, {"fallback": "below_threshold"}
    if batch.C <= cfg.k:
        return None, {"fallback": "below_threshold"}
    if batch.fused and batch.fused_src is None:
        return _fallback("fused",
                         "fused batch without a fused_src handle "
                         "(explain/legacy assemble) keeps the dense path")
    device = resolve_device(device)
    # a fused batch's binding fields live on the card: tier 1 reads the
    # host slot-store masters instead (same values)
    hv = T.host_rows(batch)
    valid = np.asarray(hv.b_valid)
    route = np.asarray(batch.route)
    if route.size and not bool(np.all(route == T.ROUTE_DEVICE)):
        n_other = int(np.sum(route != T.ROUTE_DEVICE))
        _count("fallback_rows_needed", n_other)
        _count("fallback_rows_chunk_drag", int(valid.sum()))
        return _fallback("mixed_routes",
                         f"{n_other} row(s) owned by spread/big/host tiers")
    prof_keys, prof_of, rep_max = _profiles(hv)
    # coverage is judged conservatively as profile-eligible + prev lanes
    prev_np = np.asarray(hv.prev_idx)
    prev_count = np.sum(prev_np >= 0, axis=1)
    k = min(cfg.k, batch.C)
    k_cap = min(cfg.k_max, batch.C)
    widened = 0
    drop = np.zeros(batch.B, bool)
    residual: List[int] = []
    while True:
        cand, fcount = _dispatch_profiles(batch, prof_keys, rep_max, k,
                                          device)
        need = fcount[prof_of] + prev_count
        active = valid & ~drop
        worst = int(need[active].max()) if bool(active.any()) else 0
        if worst > k_cap:
            # the eligible count does not depend on k: rows beyond k_max
            # can never be covered, however far k widens
            offenders = np.flatnonzero(active & (need > k_cap))
            if cfg.truncate and allow_truncate:
                drop[offenders] = True
                residual = [int(i) for i in offenders]
                _count("fallback_rows_needed", len(residual))
                ev.emit(_LEDGER_REF, ev.TYPE_NORMAL,
                        ev.REASON_SHORTLIST_TRUNCATE,
                        f"{len(residual)} binding(s) exceed "
                        f"k_max={cfg.k_max} (worst {worst} lane(s)): "
                        "routed to the per-binding dense residual: "
                        + _row_names(part, residual),
                        origin="shortlist")
                _note(residual=len(residual))
                active = valid & ~drop
                worst = int(need[active].max()) if bool(active.any()) else 0
            else:
                _count("fallback_rows_needed", len(offenders))
                _count("fallback_rows_chunk_drag",
                       int(active.sum()) - len(offenders))
                return _fallback(
                    "uncovered", f"eligible set of {worst} lane(s) exceeds "
                    f"k_max={cfg.k_max} for " + _row_names(part, offenders))
        if worst <= k:
            break
        k = min(max(k * 2, worst), k_cap)
        widened += 1
        _count("widenings", 1)
    # every kept row's prev lanes join the union (residual rows are priced
    # at full width and excluded)
    prev_keep = prev_np[valid & ~drop]
    lanes = np.unique(np.concatenate([
        cand[cand >= 0].astype(np.int64).reshape(-1),
        prev_keep[prev_keep >= 0].astype(np.int64).reshape(-1),
    ]))
    max_union = max(cfg.k, int(cfg.union_frac * max(batch.n_clusters, 1)))
    if lanes.size > max_union:
        _count("fallback_rows_chunk_drag", int(valid.sum()))
        return _fallback(
            "union_wide", f"candidate union of {lanes.size} lane(s) exceeds "
            f"{max_union} ({cfg.union_frac:.0%} of {batch.n_clusters})")
    sub = _sub_batch(batch, lanes, hv, drop=drop if residual else None)
    if sub is None:
        # a covered binding's prev lane missing from the union would be a
        # tier-1 bug; refuse the shortlist rather than mis-solve
        _count("fallback_rows_chunk_drag", int(valid.sum()))
        return _fallback("uncovered",
                         "prev-assignment lane absent from the union")
    _count("rows", int(batch.n_bindings) - len(residual))
    _count("cells_solve", batch.B * sub.C)
    _count("cells_dense", batch.B * batch.C)
    SHORTLIST_UNION_LANES.set(float(lanes.size))
    info = {"k": k, "widened": widened, "union": int(lanes.size),
            "sub_c": sub.C, "profiles": int(prof_keys.shape[0]),
            "residual": residual,
            "cells_solve": batch.B * sub.C,
            "cells_dense": batch.B * batch.C}
    _note(k=k, widened=widened, union=int(lanes.size), sub_c=sub.C,
          b=batch.B, c=batch.C, profiles=int(prof_keys.shape[0]),
          fallback_reason=None)
    return sub, info


def _sub_batch(batch, lanes: np.ndarray, hv, drop=None):
    """The per-chunk vocabulary remap: the full batch's planes gathered to
    the candidate union (cluster axis only -- placements, request classes
    and the binding axis keep their vocabularies), name_rank re-densified
    order-preserving, sparse prev/evict lane indices remapped.  An
    ordinary SolverBatch the dispatch/decode/carry machinery runs
    unchanged; sub_lanes / sub_full_c / sub_sig tag it for the keyed carry
    (tensors.CarryState renders accumulators across the lane remap).
    `drop` bool[B] marks rows routed out of the sub-solve (the truncation
    residual): their b_valid clears.  None when a kept row's prev lane
    lies outside the union.  `hv` is the batch's host view (host_rows): on
    a fused batch the binding rows never touch the host -- K11's sub
    flavour gathers them from the device slot store straight into the
    union vocabulary."""
    n2 = int(lanes.size)
    C2 = T._next_pow2(max(n2, 1), 8)  # noqa: SLF001
    inv = np.full(batch.C, -1, np.int32)
    inv[lanes] = np.arange(n2, dtype=np.int32)

    def g1(a, fill):
        out = np.full(C2, fill, a.dtype)
        out[:n2] = a[lanes]
        return out

    def g_rows(a, fill):  # [C, R] -> [C2, R]
        out = np.full((C2,) + a.shape[1:], fill, a.dtype)
        out[:n2] = a[lanes]
        return out

    def g_cols(a, fill):  # [.., C] -> [.., C2]
        out = np.full(a.shape[:-1] + (C2,), fill, a.dtype)
        out[..., :n2] = a[..., lanes]
        return out

    cindex2 = T.ClusterIndex.build(
        [batch.cluster_index.clusters[int(i)] for i in lanes])
    name_rank = np.zeros(C2, np.int64)
    name_rank[:n2] = cindex2.name_rank
    name_rank[n2:] = np.arange(n2, C2)

    def remap_sparse(idx):
        m = idx >= 0
        out_idx = np.where(m, inv[np.where(m, idx, 0)], -1).astype(np.int32)
        return out_idx, m & (out_idx < 0)

    kept = np.asarray(hv.b_valid)
    if drop is not None:
        kept = kept & ~drop
    prev_idx, prev_dropped = remap_sparse(np.asarray(hv.prev_idx))
    if bool(prev_dropped[kept].any()):
        return None
    if batch.fused:
        src = batch.fused_src
        rows = rg.dispatch_sub_gather(
            src["slots_b"], src["mirrors"], inv,
            drop if drop is not None else np.zeros(batch.B, bool))
        # the JAX solver's donation-safety bound over the sub width
        strat = np.asarray(batch.pl_strategy)[np.asarray(hv.placement_id)]
        wide = kept & ((strat == T.STRAT_DUPLICATED)
                       | np.asarray(hv.non_workload))
        per_row = (np.minimum(np.asarray(hv.replicas, np.int64), C2)
                   + np.asarray(hv.prev_idx).shape[1])
        nnz_bound = (int(np.sum(wide)) * C2
                     + int(np.sum(per_row[kept & ~wide])))
    else:
        prev_val = np.where(prev_idx >= 0, batch.prev_val, 0).astype(
            np.int32)
        evict_idx, _ = remap_sparse(np.asarray(batch.evict_idx))
        rows = (kept if drop is not None else batch.b_valid,
                batch.placement_id, batch.gvk_id, batch.class_id,
                batch.replicas, batch.uid_desc, batch.fresh,
                batch.non_workload, batch.nw_shortcut, prev_idx, prev_val,
                evict_idx)
        nnz_bound = None
    label_axes = {key: (g1(gid, -1), values)
                  for key, (gid, values) in (batch.label_axes or {}).items()}
    return T.SolverBatch(
        B=batch.B, C=C2, n_bindings=batch.n_bindings, n_clusters=n2,
        cluster_valid=g1(batch.cluster_valid, False),
        deleting=g1(batch.deleting, False),
        name_rank=name_rank,
        pods_allowed=g1(batch.pods_allowed, 0),
        has_summary=g1(batch.has_summary, False),
        avail_milli=g_rows(batch.avail_milli, 0),
        has_alloc=g_rows(batch.has_alloc, False),
        api_ok=g_cols(batch.api_ok, False),
        req_milli=batch.req_milli, req_is_cpu=batch.req_is_cpu,
        req_pods=batch.req_pods,
        est_override=g_cols(batch.est_override, -1),
        pl_mask=g_cols(batch.pl_mask, False),
        pl_tol_bypass=g_cols(batch.pl_tol_bypass, False),
        pl_strategy=batch.pl_strategy,
        pl_static_w=g_cols(batch.pl_static_w, 0),
        pl_has_cluster_sc=batch.pl_has_cluster_sc,
        pl_sc_min=batch.pl_sc_min, pl_sc_max=batch.pl_sc_max,
        pl_ignore_avail=batch.pl_ignore_avail,
        **dict(zip(rg.OUT_FIELDS, rows)),
        route=batch.route, cluster_index=cindex2,
        region_id=(g1(batch.region_id, -1)
                   if batch.region_id is not None else None),
        region_names=batch.region_names,
        label_axes=label_axes,
        pl_has_region_sc=batch.pl_has_region_sc,
        pl_region_min=batch.pl_region_min,
        pl_region_max=batch.pl_region_max,
        pl_extra_score=g_cols(batch.pl_extra_score, 0),
        res_names=batch.res_names, class_keys=batch.class_keys,
        pl_fail_bits=g_cols(batch.pl_fail_bits, 0),
        explain=batch.explain,
        placements=batch.placements, gvk_keys=batch.gvk_keys,
        class_reqs=batch.class_reqs,
        sub_lanes=np.concatenate([lanes, np.full(C2 - n2, -1, np.int64)]),
        sub_full_c=batch.C,
        sub_sig=hash((batch.C, C2, lanes.tobytes())),
        fused=batch.fused, nnz_bound_hint=nnz_bound,
        non_workload_host=batch.non_workload_host,
    )
