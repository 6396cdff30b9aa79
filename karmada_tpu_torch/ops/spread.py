"""Topology spread on the card: region and spread-by-label grouping.

Counterpart of the JAX package's ``ops/spread.py``.  Reference:
pkg/scheduler/core/spreadconstraint/ -- group clusters by region with
scores and available replicas (group_clusters.go:220-333), pick the best
group combination by DFS (select_groups.go:102-230), then pick clusters
within the chosen groups (select_clusters_by_region.go:27-118).

The group axis is generic: region spread uses the fleet's region ids,
spread-by-label placements a per-label-key vocabulary of label values
(``tensors.encode_batch`` builds both), with identical group math.  The
plain versions' group math is segmented (a (group, key) sort plus segment
reductions); the kernels sort nothing: one pass over a row's lanes gives
the per-group sums and least keys, and a selection the rest (K5's walk in
key order, K6's rest-th least key).  Nothing is sized by the group count
but the [B, G] results and, beyond a few groups, a per-group scratch.

Flow (solve_spread), per (axis, tier) group of one chunk's spread rows:

  phase A (card)   K1 capacity on the raw snapshot, then K5
                   spread_group_info: per row the group scalars
                   score/avail/value [Bp, G] and a feasible-any flag
  host             serial.select_groups (the port's golden DFS) over the
                   G scalars -> the chosen groups [Bs, G]
  phase B (card)   K6 spread_pick: the cluster pick inside the chosen
                   groups, bool [Bs, C], written on the card; then
                   solver.schedule_core (K1 + K2 on the std or big tier
                   per wave) with the pick as each row's placement mask,
                   and K3 compact.  Only [Bp, G] scalars, the chosen
                   groups and the compact result cross the host boundary.
  explain (card)   with `explain`, K7 explain_rows (its spread flavour)
                   over the live rows: the real placement's fail bits, the
                   raw snapshot's planes, the pick AND the assignment's
                   selection, the assignment's status.

K5 and K6 have plain PyTorch versions here (spread_group_info_plain,
spread_pick_plain), taken only for tensors that lie on the CPU.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from karmada_tpu_torch.analysis import guards as _guards
from karmada_tpu_torch.device import resolve_device
from karmada_tpu_torch.ops import kernels, serial
from karmada_tpu_torch.ops import tensors as T
from karmada_tpu_torch.ops.solver import (
    _AVAIL_BITS,
    _AVAIL_CAP,
    _LANE_BITS,
    I64,
    MAX_INT64,
    _BINDING_FIELDS,
    DeviceBatch,
    _floordiv,
    _locality_score,
    _on_cuda,
    _row_inputs,
    _to_dev,
    _use_extra,
    _zeros_used,
    capacity,
    compact,
    device_batch,
    explain_planes,
    explain_rows,
    schedule_core,
)

WEIGHT_UNIT = serial.WEIGHT_UNIT  # 1000 (group_clusters.go:139)

# the placement-row fields phase B replaces by per-binding rows
_PICK_ROW_FIELDS = ("pl_strategy", "pl_static_w", "pl_ignore_avail",
                    "pl_extra_score")


def _sort_key(score, avail, name_rank, feasible):
    """The spreadconstraint sortClusters order: score desc, avail desc,
    name asc (util.go) -- the solver's selection-key packing; infeasible
    lanes sort last."""
    avail_c = torch.clamp(avail, 0, _AVAIL_CAP)
    key = (((200 - score) << (_AVAIL_BITS + _LANE_BITS))
           | ((_AVAIL_CAP - avail_c) << _LANE_BITS) | name_rank)
    return torch.where(feasible, key, torch.full((), MAX_INT64, dtype=I64,
                                                 device=key.device))


def _planes(db: DeviceBatch, est):
    """feasible, avail_sel, score [B, C] of every row of db against est
    (JAX: _spread_planes)."""
    pid, _cid, prev_rep, prev_present, avail_cal, feasible, _ = _row_inputs(
        db, 0, db.B, est)
    score = _locality_score(prev_present, db.pl_extra_score[pid])
    return feasible, avail_cal + prev_rep * prev_present, score


def _segment(x, seg, G, reduce="sum", fill=0):
    """Per-row segment reduction of x [B, C] by seg [B, C] in [0, G]; the
    extra segment G collects infeasible / group-less lanes and is dropped."""
    B = x.shape[0]
    out = torch.full((B, G + 1), fill, dtype=I64, device=x.device)
    if reduce == "sum":
        out.scatter_add_(1, seg, x)
    else:
        out.scatter_reduce_(1, seg, x, reduce=reduce)
    return out[:, :G]


# ---------------------------------------------------------------------------
# K5 spread_group_info
# ---------------------------------------------------------------------------

def spread_group_info_plain(db: DeviceBatch, est, group_id, region_min,
                            cluster_min, duplicated, G: int):
    """Phase A for every row of db (JAX: spread_group_info with
    _group_info_one vmapped): (score_g, avail_g, value_g) int64[B, G] and
    feas_any bool[B].  est is K1's [Q+1, C] on the raw snapshot;
    group_id int32[C] (-1: no group); region_min, cluster_min int64[B];
    duplicated bool[B]."""
    feasible, avail_sel, score = _planes(db, est)
    B, C = feasible.shape
    dev = feasible.device
    gid = torch.where(feasible & (group_id >= 0)[None, :],
                      group_id.long()[None, :], G)
    key = _sort_key(score, avail_sel, db.name_rank[None, :], feasible)
    # lexicographic (group asc, key asc): within a group, clusters stay in
    # sortClusters order
    order1 = torch.sort(key, dim=1, stable=True).indices
    order = order1.gather(1, torch.sort(gid.gather(1, order1), dim=1,
                                        stable=True).indices)
    seg = gid.gather(1, order)
    f = feasible.gather(1, order) & (seg < G)
    zero = torch.zeros((), dtype=I64, device=dev)
    av = torch.where(f, avail_sel.gather(1, order), zero)
    sc = torch.where(f, score.gather(1, order), zero)
    cnt = f.long()
    pos = torch.arange(C, device=dev).expand(B, C)
    boundary = torch.ones_like(f)
    boundary[:, 1:] = seg[:, 1:] != seg[:, :-1]
    start = torch.cummax(torch.where(boundary, pos, 0), dim=1).values

    def seg_cum(x):
        t = torch.cumsum(x, 1)
        return t - t.gather(1, start) + x.gather(1, start)

    cum_avail, cum_cnt, cum_score = seg_cum(av), seg_cum(cnt), seg_cum(sc)
    value_g = _segment(cnt, seg, G)
    avail_g = _segment(av, seg, G)
    score_sum_g = _segment(sc, seg, G)

    # Divided score (group_clusters.go:220-333): walk the group's clusters
    # in sorted order until >= cluster_min members AND >= target available
    replicas = db.replicas
    mg = torch.clamp(region_min, min=1)
    target_d = torch.where(region_min > 0, -_floordiv(-replicas, mg),
                           replicas)
    cmin = torch.maximum(cluster_min, region_min)
    ok = f & (cum_cnt >= cmin[:, None]) & (cum_avail >= target_d[:, None])
    first = _segment(torch.where(ok, pos, C), seg, G, reduce="amin", fill=C)
    has = first < C
    fc = torch.clamp(first, max=C - 1)
    valid = cum_cnt.gather(1, fc)
    tcol = target_d[:, None]
    mean_all = _floordiv(score_sum_g, torch.clamp(value_g, min=1))
    # exhausted-walk semantics (group_clusters.go:300-308): only
    # insufficient availability demotes the score
    div_score = torch.where(
        has, tcol * WEIGHT_UNIT + _floordiv(cum_score.gather(1, fc),
                                            torch.clamp(valid, min=1)),
        torch.where(avail_g >= tcol, tcol * WEIGHT_UNIT + mean_all,
                    avail_g * WEIGHT_UNIT + mean_all))

    # Duplicated score (group_clusters.go:141-218)
    fits = f & (av >= replicas[:, None])
    n_fit = _segment(fits.long(), seg, G)
    fit_score = _segment(torch.where(fits, sc, zero), seg, G)
    dup_score = torch.where(
        n_fit > 0, n_fit * WEIGHT_UNIT
        + _floordiv(fit_score, torch.clamp(n_fit, min=1)), zero)

    score_g = torch.where(duplicated[:, None], dup_score, div_score)
    score_g = torch.where(value_g > 0, score_g, zero)
    return score_g, avail_g, value_g, feasible.any(1)


def _spread_checks(db: DeviceBatch, est, group_id):
    """Operand checks K5 and K6 share; returns whether a row's keys fit
    in the kernel's shared memory (else they go to a [B, C] scratch)."""
    B, C = db.B, db.C
    Q = db.req_milli.shape[0]
    P = db.pl_mask.shape[0]
    Kp = db.prev_idx.shape[1]
    Ke = db.evict_idx.shape[1]
    spec = {
        "cluster_valid": (torch.bool, (C,)), "deleting": (torch.bool, (C,)),
        "name_rank": (I64, (C,)),
        "api_ok": (torch.bool, (db.api_ok.shape[0], C)),
        "pl_mask": (torch.bool, (P, C)), "pl_tol_bypass": (torch.bool, (P, C)),
        "pl_extra_score": (I64, (P, C)),
        "placement_id": (torch.int32, (B,)), "gvk_id": (torch.int32, (B,)),
        "class_id": (torch.int32, (B,)), "replicas": (I64, (B,)),
        "nw_shortcut": (torch.bool, (B,)),
        "prev_idx": (torch.int32, (B, Kp)), "prev_val": (torch.int32, (B, Kp)),
        "evict_idx": (torch.int32, (B, Ke)),
    }
    for f, (dt, shape) in spec.items():
        kernels.check(db.t[f], dt, shape)
    kernels.check(est, I64, (Q + 1, C))
    kernels.check(group_id, torch.int32, (C,))
    if C >= 1 << _LANE_BITS:
        # the key's low bits are the lane's name_rank; the kernels mark a
        # lane outside the order with a key whose low bits are all ones
        raise ValueError(f"{C} lanes: the spread key holds fewer than "
                         f"2^{_LANE_BITS}")
    return C <= kernels.SPREAD_SMEM_LANES and Kp * 12 + Ke * 4 <= 1 << 16


def _ints(db: DeviceBatch, est, group_id, G: int):
    """The kernels' leading ints: B, C, Q, Kp, Ke, G and whether a lane
    group loads as 16-byte vectors (C a multiple of 4, the cluster-axis
    operands 16-byte aligned)."""
    vec = db.C % 4 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (
            est, group_id, db.name_rank, db.pl_extra_score, db.cluster_valid,
            db.deleting, db.pl_mask, db.pl_tol_bypass, db.api_ok))
    return (db.B, db.C, db.req_milli.shape[0], db.prev_idx.shape[1],
            db.evict_idx.shape[1], G, int(vec))


def _scratch(n: int, dev):
    """A device-memory scratch of n int64 and its pointer (0: none)."""
    if not n:
        return None, 0
    t = torch.empty((n,), dtype=I64, device=dev)
    return t, kernels.ptr(t)


def spread_group_info(db: DeviceBatch, est, group_id, region_min,
                      cluster_min, duplicated, G: int,
                      use_extra: bool = True):
    """K5 (ops/csrc/spread_group_info.cu) on a CUDA batch,
    spread_group_info_plain on a CPU one; same contract.  use_extra False
    promises that db's extra-score rows are all 0 (solver._use_extra); the
    kernel then skips them.  The kernel writes every element of its
    outputs; a scratch exists only for more than INFO_SMEM_GROUPS
    groups."""
    if not _on_cuda(est, group_id, db.b_valid):
        return spread_group_info_plain(db, est, group_id, region_min,
                                       cluster_min, duplicated, G)
    B = db.B
    kernels.check(region_min, I64, (B,))
    kernels.check(cluster_min, I64, (B,))
    kernels.check(duplicated, torch.bool, (B,))
    _spread_checks(db, est, group_id)
    grp_smem = G <= kernels.INFO_SMEM_GROUPS
    dev = est.device
    groups, gp = _scratch(
        0 if grp_smem else B * kernels.spread_info_fields() * G, dev)
    out = torch.empty((3, B, G), dtype=I64, device=dev)
    feas_any = torch.empty((B,), dtype=torch.bool, device=dev)
    kernels.launch("spread_group_info", kernels.SpreadInfoArgs(
        *(kernels.ptr(db.t[f]) for f in kernels.SPREAD_TENSOR_FIELDS),
        kernels.ptr(est), kernels.ptr(group_id), kernels.ptr(region_min),
        kernels.ptr(cluster_min), kernels.ptr(duplicated), gp,
        *(kernels.ptr(o) for o in out), kernels.ptr(feas_any),
        *_ints(db, est, group_id, G), int(use_extra), int(grp_smem)))
    return out[0], out[1], out[2], feas_any


# ---------------------------------------------------------------------------
# K6 spread_pick
# ---------------------------------------------------------------------------

def spread_pick_plain(db: DeviceBatch, est, group_id, chosen, cluster_max,
                      G: int):
    """The phase-B pick of every row of db (JAX: _pick_one vmapped,
    select_clusters_by_region.go:27-118): the first cluster of each
    chosen group in sort-key order, then the remaining chosen-group
    clusters in global key order up to cluster_max in total (0: no
    cluster constraint).  chosen bool[B, G], cluster_max int64[B] ->
    pick bool[B, C] in cluster-lane order."""
    feasible, avail_sel, score = _planes(db, est)
    B, C = feasible.shape
    dev = feasible.device
    key = _sort_key(score, avail_sel, db.name_rank[None, :], feasible)
    order = torch.sort(key, dim=1, stable=True).indices
    gid = group_id.long()[order]
    seg = torch.where(feasible.gather(1, order) & (gid >= 0), gid, G)
    chosen_ext = torch.cat(
        [chosen, torch.zeros((B, 1), dtype=torch.bool, device=dev)], 1)
    in_chosen = chosen_ext.gather(1, seg)
    pos = torch.arange(C, device=dev).expand(B, C)
    first_g = _segment(torch.where(in_chosen, pos, C), seg, G,
                       reduce="amin", fill=C)
    any_g = first_g < C
    # max: memberless groups add False without clobbering a True another
    # group scattered to the same (clamped) position
    is_first = torch.zeros((B, C), dtype=I64, device=dev).scatter_reduce_(
        1, torch.clamp(first_g, max=C - 1), any_g.long(), reduce="amax") > 0
    need = torch.minimum(in_chosen.sum(1), cluster_max)
    rest = torch.clamp(need - any_g.sum(1), min=0)
    cand = in_chosen & ~is_first
    take = cand & (torch.cumsum(cand.long(), 1) - 1 < rest[:, None])
    return torch.zeros_like(is_first).scatter_(1, order, is_first | take)


def spread_pick(db: DeviceBatch, est, group_id, chosen, cluster_max,
                G: int, use_extra: bool = True):
    """K6 (ops/csrc/spread_pick.cu) on a CUDA batch, spread_pick_plain on
    a CPU one; same contract; use_extra as in spread_group_info.  The pick
    stays on the card; the kernel writes every lane of it.  A scratch
    exists only for rows wider than SPREAD_SMEM_LANES lanes or more than
    PICK_SMEM_GROUPS groups."""
    if not _on_cuda(est, group_id, db.b_valid):
        return spread_pick_plain(db, est, group_id, chosen, cluster_max, G)
    B, C = db.B, db.C
    kernels.check(chosen, torch.bool, (B, G))
    kernels.check(cluster_max, I64, (B,))
    key_smem = _spread_checks(db, est, group_id)
    grp_smem = G <= kernels.PICK_SMEM_GROUPS
    dev = est.device
    keys, kp = _scratch(0 if key_smem else B * C, dev)
    gmin, gp = _scratch(0 if grp_smem else B * G, dev)
    pick = torch.empty((B, C), dtype=torch.bool, device=dev)
    kernels.launch("spread_pick", kernels.SpreadPickArgs(
        *(kernels.ptr(db.t[f]) for f in kernels.SPREAD_TENSOR_FIELDS),
        kernels.ptr(est), kernels.ptr(group_id), kernels.ptr(chosen),
        kernels.ptr(cluster_max), kp, gp, kernels.ptr(pick),
        *_ints(db, est, group_id, G), int(use_extra), int(key_smem),
        int(grp_smem)))
    return pick


# ---------------------------------------------------------------------------
# The spread sub-solve of one chunk
# ---------------------------------------------------------------------------

def _rows_of(db: DeviceBatch, rows: torch.Tensor) -> DeviceBatch:
    """db restricted to binding rows `rows` (a device index tensor)."""
    t = dict(db.t)
    for f in _BINDING_FIELDS:
        t[f] = db.t[f].index_select(0, rows)
    return DeviceBatch(B=int(rows.numel()), C=db.C, device=db.device, t=t)


def solve_spread(batch, items: Sequence, spread_idx: Sequence[int],
                 waves: int = 1,
                 enable_empty_workload_propagation: bool = False,
                 collect_used: bool = False, used0=None, axis: str = "",
                 tier: str = "std", device=None,
                 capture: Optional[dict] = None, explain: bool = False,
                 explain_cb=None):
    """Schedule the ROUTE_DEVICE_SPREAD(_BIG) bindings `spread_idx` of one
    chunk (JAX: solve_spread) on `device` (the card by default).

    `axis` names the group axis: "" = region (batch.region_id), else a
    label key of batch.label_axes.  `tier` is the assignment's lane tier
    ("big" for ROUTE_DEVICE_SPREAD_BIG rows); callers group the rows by
    (axis, tier) with tensors.spread_groups.

    Returns {binding_index: List[TargetCluster] | Exception}; with
    collect_used, (out, used | None) where used = (um, up, us) numpy is
    the carry-in plus the spread rows' consumption.  `used0` carries a
    previous batch's consumption into the assignment only: phase A and
    the pick price against the raw snapshot, as in the JAX program.

    Both sub-batches are padded as the JAX program pads them (phase A to
    the next power of two >= 8 of the spread rows, phase B of the live
    ones, repeating the first row as an invalid pad): the pad decides how
    many rows each capacity wave holds.

    `explain` runs the explain plane of the live rows (K7, spread flavour;
    the batch must be encoded with explain=True) and hands each live
    binding's rows to `explain_cb(binding_index, verdict_row, score_row,
    avail_row, outcome_code)` -- numpy [n_clusters] slices in lane order.
    Bindings the group DFS failed before assignment never reach the cb.

    `capture`, when given, receives the operands of K5 ("group_info"), K6
    ("pick") and, with explain, K7 ("explain") as the call passed them, so
    they can be held against the plain versions; K5 and K6 were also
    passed use_extra=solver._use_extra(batch)."""
    if not len(spread_idx):
        return ({}, None) if collect_used else {}
    if _guards.armed():
        _guards.check_batch(batch, "solve-spread")
    if explain and not batch.explain:
        raise ValueError("the explain plane needs a batch encoded with "
                         "explain=True")
    device = resolve_device(device)
    if axis == "":
        group_id_np, group_names = batch.region_id, batch.region_names
    else:
        group_id_np, group_names = batch.label_axes[axis]
    n_spread = len(spread_idx)
    Bp = T._next_pow2(n_spread, 8)  # noqa: SLF001
    idx = np.asarray(list(spread_idx) + [spread_idx[0]] * (Bp - n_spread),
                     np.int64)
    n_groups = len(group_names)
    # pow2-bucketed group axis: segments beyond n_groups are empty
    G = T._next_pow2(max(n_groups, 1), 8)  # noqa: SLF001

    # a fused batch's placement_id lives on the card: read it back
    pid = batch.placement_id
    pid = (pid.cpu().numpy() if torch.is_tensor(pid)
           else np.asarray(pid))[idx]
    duplicated = batch.pl_strategy[pid] == T.STRAT_DUPLICATED
    region_min = batch.pl_region_min[pid]
    region_max = batch.pl_region_max[pid]
    cluster_min = batch.pl_sc_min[pid]
    cluster_max = np.where(batch.pl_has_cluster_sc[pid], batch.pl_sc_max[pid], 0)

    def dev_t(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

    db = device_batch(batch, device, rows=idx)
    group_id = _to_dev(np.asarray(group_id_np, np.int32), device)
    zeros = _zeros_used(db)
    est = capacity(db.req_milli, db.req_is_cpu, db.req_pods, db.avail_milli,
                   zeros[0], db.has_alloc, db.pods_allowed, zeros[1],
                   db.has_summary, db.est_override, zeros[2])
    extra = _use_extra(batch)
    info_in = (db, est, group_id, dev_t(region_min, np.int64),
               dev_t(cluster_min, np.int64), dev_t(duplicated, bool), G)
    if capture is not None:
        capture["group_info"] = info_in
    score_g, avail_g, value_g, feas_any = (
        x.cpu().numpy()
        for x in spread_group_info(*info_in, use_extra=extra))

    # -- host DFS over G-level scalars: serial.select_groups itself --------
    out = {}
    chosen = np.zeros((len(idx), G), bool)
    for row in range(n_spread):
        b = idx[row]
        if not feas_any[row]:
            _, diagnosis = serial.find_clusters_that_fit(
                items[b][0], items[b][1], batch.cluster_index.clusters)
            out[int(b)] = serial.FitError(diagnosis)
            continue
        groups = [
            serial._DfsGroup(  # noqa: SLF001 -- the golden DFS itself
                name=group_names[g], value=int(value_g[row, g]),
                weight=int(score_g[row, g]))
            for g in range(n_groups) if value_g[row, g] > 0
        ]
        if len(groups) < int(region_min[row]):
            out[int(b)] = serial.UnschedulableError(
                "the number of feasible region is less than "
                "spreadConstraint.MinGroups")
            continue
        picked = serial.select_groups(
            groups, int(region_min[row]), int(region_max[row]),
            int(cluster_min[row]))
        if not picked:
            out[int(b)] = serial.UnschedulableError(
                "the number of clusters is less than the cluster "
                "spreadConstraint.MinGroups")
            continue
        names = {g.name for g in picked}
        for g in range(n_groups):
            chosen[row, g] = group_names[g] in names

    live = [r for r in range(n_spread) if int(idx[r]) not in out]
    if not live:
        return (out, None) if collect_used else out
    n_live = len(live)
    Bs = T._next_pow2(n_live, 8)  # noqa: SLF001
    C = batch.C
    live_np = np.asarray(live + [live[0]] * (Bs - n_live), np.int64)
    lidx = idx[live_np]
    b_valid = np.zeros(Bs, bool)
    b_valid[:n_live] = True

    rows = _rows_of(db, dev_t(live_np, np.int64))
    pick_in = (rows, est, group_id, dev_t(chosen[live_np], bool),
               dev_t(cluster_max[live_np], np.int64), G)
    if capture is not None:
        capture["pick"] = (_rows_of(rows, dev_t(np.arange(Bs), np.int64)),
                           *pick_in[1:])
    pick = spread_pick(*pick_in, use_extra=extra)
    # phase B: the placement axis becomes the binding axis -- row i's
    # placement mask is its pick, tolerations and the cluster spread are
    # folded into the pick, the strategy rows are gathered per binding
    lpid = dev_t(pid[live_np], np.int64)
    t = rows.t
    t.update({f: db.t[f].index_select(0, lpid) for f in _PICK_ROW_FIELDS})
    t.update(
        pl_mask=pick,
        pl_tol_bypass=torch.ones((Bs, C), dtype=torch.bool, device=device),
        pl_has_cluster_sc=torch.zeros((Bs,), dtype=torch.bool, device=device),
        pl_sc_min=torch.zeros((Bs,), dtype=torch.int32, device=device),
        pl_sc_max=torch.zeros((Bs,), dtype=torch.int32, device=device),
        b_valid=dev_t(b_valid, bool),
        placement_id=torch.arange(Bs, dtype=torch.int32, device=device))
    rep, sel, status, used, _ = schedule_core(
        rows, waves=waves, use_extra=extra, used0=used0,
        with_used=collect_used, tier=tier)
    if explain:
        # the live rows with their REAL placement planes (rows.t now
        # holds the pick-as-placement rows) and the sub-batch's validity
        ex_rows = _rows_of(db, dev_t(live_np, np.int64))
        ex_rows.t["b_valid"] = dev_t(b_valid, bool)
        ex_in = (ex_rows, 0, Bs, est,
                 dev_t(batch.pl_fail_bits[pid[live_np]], np.int32), sel,
                 status)
        if capture is not None:
            capture["explain"] = ex_in + (pick,)
        planes = explain_planes(Bs, C, device)
        explain_rows(*ex_in, planes, pick=pick, use_extra=extra)
        if explain_cb is not None:
            verdict, score, avail, outcome = (x.cpu().numpy() for x in planes)
            nc = batch.n_clusters
            for row in range(n_live):
                explain_cb(int(lidx[row]), verdict[row, :nc],
                           score[row, :nc], avail[row, :nc],
                           int(outcome[row]))
    cidx, cval, status, nnz = compact(rep, sel, status, rows.non_workload,
                                      enable_empty_workload_propagation)
    nnz = int(nnz)
    cidx = cidx[:nnz].cpu().numpy().astype(np.int64)
    cval = cval[:nnz].cpu().numpy()
    status = status.cpu().numpy()
    used_np = (tuple(u.cpu().numpy() for u in used) if collect_used
               else None)

    # remap the sub-batch COO rows onto the chunk's binding axis and reuse
    # the shared decoder; lidx ascends, so the row-major contract holds
    keep = cidx // C < n_live  # drop the padded rows
    remapped_idx = lidx[cidx[keep] // C] * C + cidx[keep] % C
    status_full = np.zeros((batch.n_bindings,), np.int32)
    status_full[lidx[:n_live]] = status[:n_live]
    decoded = T.decode_compact(
        batch, remapped_idx, cval[keep], status_full,
        enable_empty_workload_propagation=enable_empty_workload_propagation,
        items=items)
    for b in lidx[:n_live]:
        out[int(b)] = decoded[int(b)]
    return (out, used_np) if collect_used else out
