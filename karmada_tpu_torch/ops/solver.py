"""The device solve of one scheduling cycle, in PyTorch with Hopper kernels.

Counterpart of the JAX package's ``ops/solver.py`` (``schedule_compact``,
one jitted XLA program per chunk).  The same integer-only algorithm runs
here as a Python loop of kernel launches per chunk:

  for each of `waves` capacity-contention waves, one C call a launch slice
  (the chunk's RowsWorkspace: work buffers and argument block made once):
      K1 capacity        est[Q+1, C] from the snapshot minus what earlier
                         waves (and earlier chunks, through the carry) used,
                         enqueued by the wave's first slice (one est buffer
                         a chunk)
      K2 schedule_rows   one block per binding row: feasibility, lane
                         gather, selection, strategy, the row's Webster
                         problem (K4 webster_batch solves it, enqueued by
                         the same C call); writes the dense rep/sel/status
                         rows and charges the row's new consumption into
                         the used accumulators (atomics)
  K3 compact             row-major COO extraction of (rep > 0 | wanted sel)

With `explain` (the explain plane, obs/decisions) each wave also launches
  K7 explain_rows        one block per binding row: the verdict bitmask,
                         score and avail planes [B, C] and the outcome code
                         [B] from the wave's est and K2's dense outputs
after its K2 and before the next wave's K1.

webster_batch runs K4, the Webster allocation K2's C call enqueues, on
its own, so that it can be held against its plain version by itself.

K2 runs on one of two lane tiers (JAX: _TIERS): "std" for the main route,
"big" for the rows beyond the tier-1 compact caps (ROUTE_DEVICE_BIG, run
as their own sub-batch by solve_big, and the ROUTE_DEVICE_SPREAD_BIG
assignments of ops/spread).

Every kernel has a plain PyTorch version in this module
(``capacity_plain``, ``schedule_rows_plain``, ``compact_plain``,
``webster_plain``, ``explain_rows_plain``): batched int64 code that repeats the JAX program's
arithmetic with bounded loops in place of ``while_loop``, stable sorts and
explicit lowest-index tie breaks.  A wrapper takes the plain version only
for tensors that lie on the CPU; for CUDA tensors it launches its kernel or
raises.  All arithmetic is int64 with floor division where the JAX program
divides, so results are bit-exact.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch

from karmada_tpu_torch.analysis import guards as _guards
from karmada_tpu_torch.device import resolve_device
from karmada_tpu_torch.obs.decisions import (
    N_VERDICT_BITS,
    VERDICT_API_ENABLEMENT,
    VERDICT_BIT_CAPACITY,
    VERDICT_CAPACITY,
    VERDICT_CLUSTER_GONE,
    VERDICT_EVICTION,
    VERDICT_NOT_SELECTED,
    VERDICT_TOLERATION,
)
from karmada_tpu_torch.ops import kernels, tensors
from karmada_tpu_torch.ops.tensors import (
    COMPACT_DIVISION_CAP,
    COMPACT_DIVISION_CAP_BIG,
    COMPACT_LANES,
    COMPACT_LANES_BIG,
    COMPACT_PREV_CAP,
    COMPACT_PREV_CAP_BIG,
    ROUTE_DEVICE_BIG,
    STATUS_FIT_ERROR,
    STATUS_NO_CLUSTER,
    STATUS_OK,
    STATUS_UNSCHEDULABLE,
    STRAT_AGGREGATED,
    STRAT_DUPLICATED,
    STRAT_DYNAMIC,
    STRAT_STATIC,
)
from karmada_tpu_torch.ops.webster import PRIORITY_QBITS
from karmada_tpu_torch.utils.metrics import REGISTRY

MAX_INT32 = (1 << 31) - 1
MAX_INT64 = (1 << 63) - 1

_W_CAP = (1 << 34) - 1  # weights clamped so (w << QBITS) fits int64
_N_CAP = (1 << 25) - 1  # seat targets clamped (2^25 replicas per binding)

_AVAIL_BITS = 34  # avail values clamped below 2^34 for key packing
_AVAIL_CAP = (1 << _AVAIL_BITS) - 1
_LANE_BITS = 21
_LANE_MASK = (1 << _LANE_BITS) - 1
MAX_CLUSTER_LANES = 1 << _LANE_BITS

# gather geometry per lane tier: (g_prev, g_topk, direct_max) -- the prev
# gather, the per-key top-K gather and the direct-path ceiling
TIERS = {
    "std": (COMPACT_PREV_CAP, 2 * COMPACT_DIVISION_CAP, COMPACT_LANES),
    "big": (COMPACT_PREV_CAP_BIG, 2 * COMPACT_DIVISION_CAP_BIG,
            COMPACT_LANES_BIG),
}
for _gp, _gk, _dm in TIERS.values():
    assert _dm == _gp + 4 * _gk, "lane geometry out of sync"

I64 = torch.int64


def _floordiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def _positions(key: torch.Tensor) -> torch.Tensor:
    """Rank of every lane under a stable ascending sort of `key` (last
    axis), and the sort order itself."""
    order = torch.sort(key, dim=-1, stable=True).indices
    ar = torch.arange(key.shape[-1], device=key.device).expand_as(order)
    return torch.empty_like(order).scatter_(-1, order, ar), order


# ---------------------------------------------------------------------------
# The batch on the device
# ---------------------------------------------------------------------------

_CLUSTER_FIELDS = (
    "cluster_valid", "deleting", "name_rank", "pods_allowed", "has_summary",
    "avail_milli", "has_alloc", "api_ok",
    "req_milli", "req_is_cpu", "req_pods", "est_override",
    "pl_mask", "pl_tol_bypass", "pl_strategy", "pl_static_w",
    "pl_has_cluster_sc", "pl_sc_min", "pl_sc_max", "pl_ignore_avail",
    "pl_extra_score",
)
_BINDING_FIELDS = (
    "b_valid", "placement_id", "gvk_id", "class_id", "replicas", "uid_desc",
    "fresh", "non_workload", "nw_shortcut", "prev_idx", "prev_val",
    "evict_idx",
)


@dataclass
class DeviceBatch:
    """A SolverBatch's solver operands as contiguous tensors on one device
    (same names, same dtypes as ops/tensors.FIELD_DTYPES)."""

    B: int
    C: int
    device: torch.device
    t: dict  # field name -> tensor
    # the operand sets a kernel wrapper has checked on this batch ("snapshot":
    # K1's; "topk": K8's), each once
    checked: set = field(default_factory=set)

    def __getattr__(self, name):
        try:
            return self.__dict__["t"][name]
        except KeyError:
            raise AttributeError(name) from None


def _to_dev(a, device):
    a = np.asarray(a)
    if not (a.flags.writeable and a.flags.c_contiguous):
        a = a.copy()  # torch aliases numpy memory; keep frozen arrays frozen
    return torch.from_numpy(a).to(device)


# One device copy per frozen cluster-side tensor set (JAX: _DEVICE_SLOT):
# the encoder hands back the SAME frozen numpy objects across the chunks of
# a cycle (EncoderCache.assembled), and the resident plane the same frozen
# masters across quiet cycles, so their device copies upload once instead
# of once per chunk.  One slot per device, keyed by the identity of every
# array of the tuple, which it pins so a collected id can never alias.
_DEVICE_SLOT: dict = {}  # str(device) -> (numpy tuple, tensor tuple)

#: host-to-device traffic of device_batch since the last reset:
#: binding-axis fields uploaded from numpy (a fused batch's are already on
#: the card and add nothing -- the JAX package's H2D_BINDING_FIELDS), and
#: cluster-side tensor sets served from _DEVICE_SLOT or uploaded
TRANSFERS: Dict[str, int] = {"h2d_binding_fields": 0, "cluster_hits": 0,
                             "cluster_uploads": 0}

H2D_BINDING_FIELDS = REGISTRY.counter(
    "karmada_solver_h2d_binding_fields_total",
    "Binding-axis SolverBatch operands shipped host->device at dispatch; "
    "the fused resident-gather path (ops/resident_gather) hands live "
    "device arrays instead, so its steady-state cycles add zero here "
    "(bench --delta asserts exactly that)",
)

DONATED_DISPATCHES = REGISTRY.counter(
    "karmada_solver_donated_dispatches_total",
    "Compact dispatches whose carry used0 operands were buffer-donated",
)

D2H_ZEROCOPY = REGISTRY.counter(
    "karmada_solver_d2h_zerocopy_total",
    "Device-to-host result planes handed over without a copy (dlpack)",
)


def _frozen(arrs) -> bool:
    return all(not (isinstance(a, np.ndarray) and a.flags.writeable)
               for a in arrs)


def prime_cluster_slot(np_args, dev_args, device) -> bool:
    """Seed the device-transfer cache with cluster tensors already on
    `device` (the resident plane's mirrors): a dispatch whose batch holds
    these exact numpy objects then uploads none of them.  Both tuples
    follow _CLUSTER_FIELDS.  Refuses writable arrays: the identity check
    must never serve a stale copy."""
    np_args = tuple(np_args)
    if len(np_args) != len(_CLUSTER_FIELDS) or not _frozen(np_args):
        return False
    _DEVICE_SLOT[str(device)] = (np_args, tuple(dev_args))
    return True


def _cluster_args(batch, device) -> dict:
    np_args = tuple(getattr(batch, f) for f in _CLUSTER_FIELDS)
    slot = _DEVICE_SLOT.get(str(device))
    if slot is not None and all(a is b for a, b in zip(slot[0], np_args)):
        TRANSFERS["cluster_hits"] += 1
        return dict(zip(_CLUSTER_FIELDS, slot[1]))
    dev = tuple(_to_dev(a, device) for a in np_args)
    TRANSFERS["cluster_uploads"] += 1
    # only frozen arrays are cached: a writable one could change in place
    # between solves and the identity check would serve a stale copy
    if _frozen(np_args):
        _DEVICE_SLOT[str(device)] = (np_args, dev)
    return dict(zip(_CLUSTER_FIELDS, dev))


def _binding_rows(batch, rows, device) -> dict:
    """The binding-axis operands on `device`: numpy fields upload (and
    count), a fused batch's device tensors pass as they are.  With `rows`
    only those rows, in that order, and the prev/evict columns up to the
    last one they use (read off the operands themselves: a fused batch's
    host masters may be rewritten by a later chunk's encode)."""
    t = {}
    rows_t = None
    for f in _BINDING_FIELDS:
        a = getattr(batch, f)
        if torch.is_tensor(a):
            if a.device != device:
                raise ValueError(f"{f} lives on {a.device}, not {device}")
            if rows is not None:
                if rows_t is None:
                    rows_t = torch.from_numpy(
                        np.asarray(rows, np.int64)).to(device)
                a = a.index_select(0, rows_t)
        else:
            a = np.asarray(a)
            if rows is not None:
                a = a[rows]
        t[f] = a
    if rows is not None:
        for key, fs in (("prev_idx", ("prev_idx", "prev_val")),
                        ("evict_idx", ("evict_idx",))):
            used = (t[key] >= 0).any(0)
            cols = (torch.nonzero(used).reshape(-1).cpu().numpy()
                    if torch.is_tensor(used) else np.nonzero(used)[0])
            k = int(cols[-1]) + 1 if cols.size else min(1, t[key].shape[1])
            for f in fs:
                t[f] = t[f][:, :k]
    host = {}
    for f, a in t.items():
        if torch.is_tensor(a):
            t[f] = a.contiguous()
        else:
            host[f] = a
            TRANSFERS["h2d_binding_fields"] += 1
            H2D_BINDING_FIELDS.inc()
    if device.type == "cuda" and host:
        t.update(_staged_upload(host, device))
    else:
        t.update({f: _to_dev(a, device) for f, a in host.items()})
    return t


def _staged_upload(arrays: dict, device) -> dict:
    """numpy arrays onto a CUDA device in one non-blocking copy: staged
    in one pinned buffer (16-byte aligned offsets) and uploaded into one
    device buffer, whose slices are the fields.  PyTorch's pinned-memory
    allocator records the copy's stream event on the buffer and hands it
    out again only once that event has completed, so the host never waits
    for the stream here (a pageable copy a field would wait for it)."""
    arrays = {f: np.ascontiguousarray(a) for f, a in arrays.items()}
    offs, n = {}, 0
    for f, a in arrays.items():
        offs[f] = n
        n += -(-a.nbytes // 16) * 16
    host = torch.empty((n,), dtype=torch.uint8, pin_memory=True)
    hv = host.numpy()
    for f, a in arrays.items():
        hv[offs[f]:offs[f] + a.nbytes] = a.reshape(-1).view(np.uint8)
    slab = torch.empty((n,), dtype=torch.uint8, device=device)
    slab.copy_(host, non_blocking=True)
    return {f: slab[offs[f]:offs[f] + a.nbytes].view(
        torch.from_numpy(a[:0].reshape(-1)).dtype).view(a.shape)
        for f, a in arrays.items()}


def device_batch(batch, device, rows=None, explain: bool = False
                 ) -> DeviceBatch:
    """A SolverBatch's solver operands on `device`; with `rows` (an index
    array) only those binding rows, in that order.  The cluster-side
    tensors come from the one-slot device cache when the batch holds the
    same frozen arrays as the last upload.  With `explain` the encoder's
    static fail-bit plane pl_fail_bits [P, C] rides along (the batch must
    be encoded with explain=True)."""
    device = resolve_device(device)
    if batch.C > MAX_CLUSTER_LANES:
        raise ValueError(f"cluster axis {batch.C} exceeds the packed keys' "
                         f"{MAX_CLUSTER_LANES} lanes per solve call")
    t = _cluster_args(batch, device)
    if explain:
        if not batch.explain:
            raise ValueError("the explain plane needs a batch encoded with "
                             "explain=True")
        t["pl_fail_bits"] = _to_dev(batch.pl_fail_bits, device)
    t.update(_binding_rows(batch, rows, device))
    B = int(batch.B) if rows is None else len(rows)
    return DeviceBatch(B=B, C=int(batch.C), device=device, t=t)


def _use_extra(batch) -> bool:
    """Plugin-score mode: the encoder's extra-score rows are all-zero
    unless an out-of-tree score plugin is registered."""
    return bool(np.asarray(batch.pl_extra_score).any())


def _effective_waves(B: int, waves: int) -> int:
    """The nearest divisor of B at or below the requested wave count."""
    waves = max(1, min(waves, B))
    while B % waves:
        waves -= 1
    return waves


def _on_cuda(*ts) -> bool:
    """True when every tensor is on a CUDA device, False when all are on
    the CPU; a mix is a caller error."""
    kinds = {t.device.type for t in ts}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"}:
        return True
    raise ValueError(f"tensors on mixed devices: {sorted(kinds)}")


# ---------------------------------------------------------------------------
# K1 capacity
# ---------------------------------------------------------------------------

def capacity_plain(req_milli, req_is_cpu, req_pods, avail_milli, used_milli,
                   has_alloc, pods_allowed, used_pods, has_summary,
                   est_override, used_sets):
    """est int64[Q+1, C]: GeneralEstimator max replicas per request class
    against the snapshot minus `used` (JAX: _capacity_estimates plus the
    accurate-override decrement in wave_step).  Row Q is the
    no-requirements row."""
    avail_eff = avail_milli - used_milli
    pods_eff = torch.clamp(pods_allowed - used_pods, min=0)
    unit_avail = torch.where(req_is_cpu[None, :], avail_eff,
                             -_floordiv(-avail_eff, 1000))  # [C, R]
    req = req_milli[:, None, :]  # [Q, 1, R]
    avail = unit_avail[None, :, :]
    ok = has_alloc[None, :, :] & (avail > 0)
    cnt = torch.where(ok, _floordiv(avail, torch.clamp(req, min=1)),
                      torch.zeros((), dtype=I64, device=avail.device))
    cnt = torch.where(req > 0, cnt, torch.full((), MAX_INT64, dtype=I64,
                                               device=avail.device))
    if cnt.shape[2]:
        est = cnt.min(dim=2).values
    else:
        est = torch.full(cnt.shape[:2], MAX_INT64, dtype=I64,
                         device=avail.device)
    pods_bound = _floordiv(pods_eff[None, :],
                           torch.clamp(req_pods[:, None], min=1))
    est = torch.minimum(est, pods_bound)
    live = has_summary & (pods_eff > 0)
    est = torch.where(live[None, :], est, 0)
    est = torch.clamp(est, 0, MAX_INT32)
    ovr = torch.clamp(est_override - used_sets, min=0)
    est = torch.where(est_override >= 0, ovr, est)
    none_row = torch.where(live, torch.clamp(pods_eff, max=MAX_INT32), 0)
    return torch.cat([est, none_row[None, :]], dim=0)


def capacity(req_milli, req_is_cpu, req_pods, avail_milli, used_milli,
             has_alloc, pods_allowed, used_pods, has_summary, est_override,
             used_sets):
    """K1 (ops/csrc/capacity.cu) on CUDA tensors, capacity_plain on CPU:
    the standalone call (spread phase A, the tests).  The solve's waves
    enqueue K1 from K2's first launch instead (schedule_rows' fill_est)."""
    args = (req_milli, req_is_cpu, req_pods, avail_milli, used_milli,
            has_alloc, pods_allowed, used_pods, has_summary, est_override,
            used_sets)
    if not _on_cuda(*args):
        return capacity_plain(*args)
    Q, R = req_milli.shape
    C = avail_milli.shape[0]
    kernels.check(req_milli, I64, (Q, R))
    kernels.check(req_is_cpu, torch.bool, (R,))
    kernels.check(req_pods, I64, (Q,))
    kernels.check(avail_milli, I64, (C, R))
    kernels.check(used_milli, I64, (C, R))
    kernels.check(has_alloc, torch.bool, (C, R))
    kernels.check(pods_allowed, I64, (C,))
    kernels.check(used_pods, I64, (C,))
    kernels.check(has_summary, torch.bool, (C,))
    kernels.check(est_override, I64, (Q, C))
    kernels.check(used_sets, I64, (Q, C))
    est = torch.empty((Q + 1, C), dtype=I64, device=avail_milli.device)
    kernels.launch("capacity", kernels.CapacityArgs(
        *(kernels.ptr(a) for a in args), kernels.ptr(est), Q, R, C))
    return est


# ---------------------------------------------------------------------------
# K4 Webster (closed form)
# ---------------------------------------------------------------------------

def webster_plain(n, w, s0, active, rank):
    """Closed-form Sainte-Laguë over a batch: seats int64[B, L] (JAX:
    webster_divide_batch).  n int64[B]; w, s0, rank int64[B, L]; active
    bool[B, L].  rank must be distinct among active lanes."""
    L = w.shape[1]
    dev = w.device
    zero = torch.zeros((), dtype=I64, device=dev)
    w = torch.where(active, torch.clamp(w, 0, _W_CAP), zero)
    s0 = torch.where(active, torch.clamp(s0, 0, _N_CAP), zero)
    totw = w.sum(1)
    n_eff = torch.where(totw > 0, torch.clamp(n, 0, _N_CAP), zero)
    wq = w << PRIORITY_QBITS
    pos_mask = active & (w > 0)

    def count_above(t):
        m = (_floordiv(wq, (t + 1)[:, None]) + 1) >> 1
        c = torch.minimum(torch.clamp(m - s0, min=0), n_eff[:, None])
        return torch.where(pos_mask, c, zero)

    def cnt(t):
        return count_above(t).sum(1)

    lo = torch.zeros_like(n_eff)
    hi = torch.clamp(wq.max(1).values if L else torch.zeros_like(n_eff),
                     min=1)
    while True:
        go = hi - lo > 1
        if not bool(go.any()):
            break
        mid = (lo + hi) >> 1
        over = cnt(mid) > n_eff
        lo = torch.where(go & over, mid, lo)
        hi = torch.where(go & ~over, mid, hi)
    t_star = torch.where(cnt(torch.zeros_like(n_eff)) <= n_eff, zero, hi)
    full = count_above(t_star)
    r = n_eff - full.sum(1)
    tm1 = torch.clamp(t_star - 1, min=0)
    k = torch.where((t_star > 0)[:, None], count_above(tm1) - full, zero)
    base = s0 + full

    def cnt_key(K):
        c = _floordiv(K[:, None] - 1 - rank, L) - base + 1
        return torch.minimum(torch.clamp(c, min=0), k)

    lo = torch.zeros_like(n_eff)
    hi = torch.full_like(n_eff, (1 << 27) * L)
    while True:
        go = hi - lo > 1
        if not bool(go.any()):
            break
        mid = (lo + hi) >> 1
        ge = cnt_key(mid).sum(1) >= r
        lo = torch.where(go & ~ge, mid, lo)
        hi = torch.where(go & ge, mid, hi)
    award = torch.where((r > 0)[:, None], cnt_key(hi), zero)
    return torch.where(active, s0 + full + award, zero)


def webster_batch(n, w, s0, active, rank):
    """K4 (ops/csrc/webster_batch.cu) on CUDA tensors, webster_plain on
    CPU.  Rows wider than the kernel keeps in shared memory
    (kernels.webster_layout) keep their lanes in a device-memory scratch
    allocated here."""
    if not _on_cuda(n, w, s0, active, rank):
        return webster_plain(n, w, s0, active, rank)
    B, L = w.shape
    kernels.check(n, I64, (B,))
    for a in (w, s0, rank):
        kernels.check(a, I64, (B, L))
    kernels.check(active, torch.bool, (B, L))
    seats = torch.empty((B, L), dtype=I64, device=w.device)
    scratch = None
    smem_lanes, lane_bytes = kernels.webster_layout()
    if L > smem_lanes:
        scratch = torch.empty((B * L * lane_bytes,), dtype=torch.uint8,
                              device=w.device)
    kernels.launch("webster_batch", kernels.WebsterArgs(
        kernels.ptr(n), kernels.ptr(w), kernels.ptr(s0), kernels.ptr(active),
        kernels.ptr(rank), kernels.ptr(seats),
        None if scratch is None else kernels.ptr(scratch), B, L))
    return seats


# ---------------------------------------------------------------------------
# K2 schedule_rows: one wave's binding rows
# ---------------------------------------------------------------------------

def _select_by_cluster(feasible, score, avail, name_rank, n_need, sc_min,
                       sc_max, ignore_avail):
    """select_clusters_by_cluster as batched masked ops (JAX:
    _select_by_cluster): packed-key selection plus the capacity swap
    loop, run for at most need_cnt steps per row."""
    dev = feasible.device
    fcount = feasible.sum(1)
    avail_c = torch.clamp(avail, 0, _AVAIL_CAP)
    key = (((200 - score) << (_AVAIL_BITS + _LANE_BITS))
           | ((_AVAIL_CAP - avail_c) << _LANE_BITS) | name_rank)
    key = torch.where(feasible, key, torch.full((), MAX_INT64, dtype=I64,
                                                device=dev))
    pos, order = _positions(key)
    need_cnt = torch.minimum(sc_max, fcount)
    in_sel = feasible & (pos < need_cnt[:, None])
    rest_pos = pos.clone()
    update_id = need_cnt - 1
    rows = torch.arange(feasible.shape[0], device=dev)

    def total():
        return torch.where(in_sel, avail, 0).sum(1)

    while True:
        go = ~ignore_avail & (total() < n_need) & (update_id >= 0)
        if not bool(go.any()):
            break
        cur = order[rows, torch.clamp(update_id, min=0)]
        rest = feasible & ~in_sel
        cand = torch.where(
            rest, (avail_c << _LANE_BITS)
            | (_LANE_MASK - torch.clamp(rest_pos, 0, _LANE_MASK)),
            torch.full((), -1, dtype=I64, device=dev))
        best = cand.argmax(1)
        found = go & (cand[rows, best] >= 0) & (avail[rows, best]
                                                > avail[rows, cur])
        fr = rows[found]
        in_sel[fr, best[found]] = True
        in_sel[fr, cur[found]] = False
        rest_pos[fr, cur[found]] = rest_pos[fr, best[found]]
        update_id = torch.where(go, update_id - 1, update_id)
    unsched = (fcount < sc_min) | (~ignore_avail & (total() < n_need))
    return in_sel, unsched


def _locality_score(prev_present, extra_score):
    has_prev = prev_present.any(-1, keepdim=True)
    return torch.where(has_prev & prev_present, 100, 0) + extra_score


def _assign_lanes(feasible, avail_cal, prev_present, prev_rep, extra_score,
                  name_rank, rank_webster, n, strategy, has_sc, sc_min,
                  sc_max, ignore_avail, static_w, fresh, non_workload,
                  valid):
    """Rows against their lane axis (full C or the compact gather): JAX
    _assign_lanes, batched.  Per-row scalars are [N] tensors."""
    dev = feasible.device
    zero = torch.zeros((), dtype=I64, device=dev)
    col = lambda x: x[:, None]  # noqa: E731
    fcount = feasible.sum(1)
    score = _locality_score(prev_present, extra_score)
    sel_sc, unsched_sel = _select_by_cluster(
        feasible, score, avail_cal + prev_rep * prev_present, name_rank,
        n, sc_min, sc_max, ignore_avail)
    sel = torch.where(col(has_sc), sel_sc, feasible)
    unsched_sel = has_sc & unsched_sel
    sel_count = sel.sum(1)

    scheduled_rep = torch.where(sel & prev_present, prev_rep, zero)
    assigned = scheduled_rep.sum(1)
    is_dynamic = (strategy == STRAT_DYNAMIC) | (strategy == STRAT_AGGREGATED)
    scale_down = is_dynamic & ~fresh & (assigned > n)
    scale_up = is_dynamic & ~fresh & (assigned < n)
    steady_eq = is_dynamic & ~fresh & (assigned == n)
    is_fresh = is_dynamic & fresh
    is_static = strategy == STRAT_STATIC

    sel64 = sel.to(I64)
    static_eff = static_w * sel64
    static_eff = torch.where(col(static_eff.sum(1) > 0), static_eff, sel64)
    w = torch.zeros_like(avail_cal)
    w = torch.where(col(is_static), static_eff, w)
    w = torch.where(col(is_fresh), avail_cal * sel64 + scheduled_rep, w)
    w = torch.where(col(scale_up), avail_cal * sel64, w)
    w = torch.where(col(scale_down),
                    torch.where(prev_present, prev_rep, zero), w)
    active = torch.where(col(scale_down), prev_present, sel)
    target = torch.where(is_static, n, zero)
    target = torch.where(is_fresh | scale_down, n, target)
    target = torch.where(scale_up, n - assigned, target)
    base = torch.where(col(scale_up | steady_eq), scheduled_rep, zero)
    unsched_div = is_dynamic & (w.sum(1) < target)

    # Aggregated: trim to the capacity-descending prefix reaching target
    prior = col(scale_up) & (scheduled_rep > 0)
    wc = torch.clamp(w, 0, _AVAIL_CAP)
    agg_key = ((torch.where(prior, 0, 1).to(I64)
                << (_AVAIL_BITS + _LANE_BITS))
               | ((_AVAIL_CAP - wc) << _LANE_BITS) | name_rank)
    agg_key = torch.where(active, agg_key,
                          torch.full((), MAX_INT64, dtype=I64, device=dev))
    agg_pos, _ = _positions(agg_key)
    w_sorted = torch.zeros_like(w).scatter_(
        1, agg_pos, torch.where(active, w, zero))
    cum_excl = torch.cumsum(w_sorted, 1) - w_sorted
    inc = (cum_excl < col(target)).gather(1, agg_pos)
    use_prefix = (strategy == STRAT_AGGREGATED) & (is_fresh | scale_up
                                                   | scale_down)
    w = torch.where(col(use_prefix), torch.where(inc, w, zero), w)
    active = torch.where(col(use_prefix), active & inc, active)

    run_webster = valid & ~non_workload & (
        is_static | ((is_fresh | scale_up | scale_down) & ~unsched_div))
    seats = webster_plain(torch.where(run_webster, target, zero), w,
                          torch.zeros_like(w), active & col(run_webster),
                          rank_webster)
    rep = base + seats
    rep = torch.where(col(strategy == STRAT_DUPLICATED), col(n) * sel64, rep)
    rep = torch.where(col(non_workload), zero, rep)

    status = torch.where(
        fcount == 0, STATUS_FIT_ERROR,
        torch.where(unsched_sel | unsched_div, STATUS_UNSCHEDULABLE,
                    torch.where(sel_count == 0, STATUS_NO_CLUSTER,
                                STATUS_OK)))
    status = torch.where(valid, status, STATUS_OK).to(torch.int32)
    ok = (status == STATUS_OK) & valid
    rep = torch.where(col(ok), rep, zero)
    sel = sel & col(ok)
    return rep, sel, status


def _top_lanes(key, k):
    """lax.top_k's index set: the k largest keys, ties (the -1 keys of
    ineligible lanes) broken toward the lowest lane index."""
    return torch.sort(key, dim=1, descending=True, stable=True).indices[:, :k]


def _gather_lanes(feasible, avail_sel, w_gather, prev_present, score,
                  name_rank, rank_eff, use_extra, g_prev, g_topk):
    """The union-of-top-K lane set per row: lanes[N, K] ascending plus a
    validity mask (duplicates disabled) — JAX _gather_lanes with the
    tier's group sizes."""
    dev = feasible.device
    neg = torch.full((), -1, dtype=I64, device=dev)
    wq = torch.clamp(w_gather, 0, _AVAIL_CAP) << _LANE_BITS
    aq = torch.clamp(avail_sel, 0, _AVAIL_CAP) << _LANE_BITS
    key_prev = torch.where(prev_present, _LANE_MASK - name_rank, neg)
    key_w_rank = torch.where(feasible, wq | (_LANE_MASK - rank_eff), neg)
    key_w_name = torch.where(feasible, wq | (_LANE_MASK - name_rank), neg)
    key_a_name = torch.where(feasible, aq | (_LANE_MASK - name_rank), neg)
    groups = [_top_lanes(key_prev, g_prev), _top_lanes(key_w_rank, g_topk),
              _top_lanes(key_w_name, g_topk), _top_lanes(key_a_name, g_topk)]
    if use_extra:
        key_sel = torch.where(
            feasible, (torch.clamp(score, 0, 255) << (_AVAIL_BITS
                                                      + _LANE_BITS))
            | aq | (_LANE_MASK - name_rank), neg)
        groups.append(_top_lanes(key_sel, g_topk))
    lanes = torch.sort(torch.cat(groups, 1), dim=1).values
    dup = torch.zeros_like(lanes, dtype=torch.bool)
    dup[:, 1:] = lanes[:, 1:] == lanes[:, :-1]
    return lanes, ~dup


def _row_inputs(db: DeviceBatch, r0: int, r1: int, est):
    """Per-row operands of one wave (JAX: the wave_step prologue):
    feasibility, avail_cal and the dense prev/evict lanes."""
    C = db.C
    Q = db.req_milli.shape[0]
    rows = slice(r0, r1)
    N = r1 - r0
    dev = db.device
    zero = torch.zeros((), dtype=I64, device=dev)
    pid = db.placement_id[rows].long()
    gvk = db.gvk_id[rows].long()
    cid_raw = db.class_id[rows].long()
    cid = torch.where(cid_raw >= 0, cid_raw, Q)
    # prev/evict COO -> dense lanes (additive; padding collapses onto
    # lane 0 with zero contribution, so duplicates are safe)
    pidx = db.prev_idx[rows].long()
    pmask = pidx >= 0
    pic = torch.where(pmask, pidx, 0)
    prev_rep = torch.zeros((N, C), dtype=I64, device=dev).scatter_add_(
        1, pic, torch.where(pmask, db.prev_val[rows].long(), zero))
    prev_present = torch.zeros((N, C), dtype=I64, device=dev).scatter_add_(
        1, pic, pmask.long()) > 0
    eidx = db.evict_idx[rows].long()
    emask = eidx >= 0
    evict = torch.zeros((N, C), dtype=I64, device=dev).scatter_add_(
        1, torch.where(emask, eidx, 0), emask.long()) > 0

    replicas = db.replicas[rows]
    est_b = est[cid]
    avail_cal = torch.where(est_b == MAX_INT32, replicas[:, None], est_b)
    avail_cal = torch.where(db.nw_shortcut[rows][:, None],
                            torch.full((), MAX_INT32, dtype=I64, device=dev),
                            avail_cal)
    lanes_ok = db.cluster_valid & ~db.deleting
    feasible = (lanes_ok[None, :] & db.pl_mask[pid]
                & (db.pl_tol_bypass[pid] | prev_present)
                & (db.api_ok[gvk] | prev_present) & ~evict)
    return pid, cid, prev_rep, prev_present, avail_cal, feasible, evict


def schedule_rows_plain(db: DeviceBatch, r0: int, r1: int, est, used_milli,
                        used_pods, used_sets, rep_out, sel_out, status_out,
                        *, use_extra: bool, charge: bool,
                        tier: str = "std") -> None:
    """Rows [r0, r1) of one wave against est (JAX: one wave_step with the
    vmapped _schedule_one on lane tier `tier`), written into
    rep_out/sel_out/status_out; with `charge` the rows' new consumption
    max(rep - prev, 0) is added into the used accumulators in place."""
    g_prev, g_topk, direct_max = TIERS[tier]
    C = db.C
    dev = db.device
    zero = torch.zeros((), dtype=I64, device=dev)
    rows = slice(r0, r1)
    pid, cid, prev_rep, prev_present, avail_cal, feasible, _ = _row_inputs(
        db, r0, r1, est)
    n = db.replicas[rows]
    strategy = db.pl_strategy[pid].long()
    has_sc = db.pl_has_cluster_sc[pid]
    sc_min = db.pl_sc_min[pid].long()
    sc_max = db.pl_sc_max[pid].long()
    ignore = db.pl_ignore_avail[pid]
    static_w = db.pl_static_w[pid]
    extra = db.pl_extra_score[pid]
    uid_desc = db.uid_desc[rows]
    fresh = db.fresh[rows]
    nw = db.non_workload[rows]
    valid = db.b_valid[rows]
    name_rank = db.name_rank[None, :].expand(r1 - r0, C)
    rank_eff = torch.where(uid_desc[:, None], C - 1 - name_rank, name_rank)
    scalars = (n, strategy, has_sc, sc_min, sc_max, ignore)
    tail = (fresh, nw, valid)
    if C <= direct_max:
        rep, sel, status = _assign_lanes(
            feasible, avail_cal, prev_present, prev_rep, extra, name_rank,
            rank_eff, *scalars, static_w, *tail)
    else:
        avail_sel = avail_cal + prev_rep * prev_present
        w_gather = torch.where((strategy == STRAT_STATIC)[:, None], static_w,
                               avail_sel)
        score_full = _locality_score(prev_present, extra)
        lanes, lane_ok = _gather_lanes(feasible, avail_sel, w_gather,
                                       prev_present, score_full, name_rank,
                                       rank_eff, use_extra, g_prev, g_topk)
        g = lambda a: a.gather(1, lanes)  # noqa: E731
        rank_webster, _ = _positions(torch.where(
            lane_ok, g(rank_eff), (1 << 40) + lanes))
        rep_k, sel_k, status = _assign_lanes(
            g(feasible) & lane_ok, g(avail_cal), g(prev_present) & lane_ok,
            g(prev_rep), g(extra), g(name_rank), rank_webster, *scalars,
            g(static_w), *tail)
        rep = torch.zeros((r1 - r0, C), dtype=I64, device=dev).scatter_add_(
            1, lanes, torch.where(lane_ok, rep_k, zero))
        sel_scatter = torch.zeros((r1 - r0, C), dtype=I64,
                                  device=dev).scatter_add_(
            1, lanes, (sel_k & lane_ok).long()) > 0
        ok = ((status == STATUS_OK) & valid)[:, None]
        dup_wide = ((strategy == STRAT_DUPLICATED) & ~has_sc)[:, None]
        rep = torch.where(dup_wide & ok, n[:, None] * feasible, rep)
        rep = torch.where(nw[:, None], zero, rep)
        sel = torch.where(has_sc[:, None], sel_scatter, feasible & ok)
    rep_out[rows] = rep
    sel_out[rows] = sel
    status_out[rows] = status
    if charge:
        Q = db.req_milli.shape[0]
        delta = torch.clamp(rep - prev_rep, min=0)
        req_consume = db.req_milli * torch.where(db.req_is_cpu[None, :], 1,
                                                 1000)
        req_ext = torch.cat([req_consume, torch.zeros_like(req_consume[:1])])
        pods_ext = torch.cat([db.req_pods, torch.ones_like(db.req_pods[:1])])
        used_milli += (delta[:, :, None] * req_ext[cid][:, None, :]).sum(0)
        used_pods += (delta * pods_ext[cid][:, None]).sum(0)
        sets = torch.zeros((Q + 1, C), dtype=I64, device=dev).index_add_(
            0, cid, delta)
        used_sets += sets[:Q]


#: bytes of per-row gather key scratch K2's wrapper allocated, by lane
#: tier: neither tier keeps a key in device memory (the select recomputes
#: its keys), so both stay 0
KEY_SCRATCH_BYTES: Dict[str, int] = {"std": 0, "big": 0}
#: the big tier's per-row lane working set (`work`) of one launch slice
#: stays within this many bytes: a wave whose rows need more launches in
#: slices
SLICE_BYTES = 1 << 28

#: K2's batch operands: (dtype, shape) by field, the shape from the batch's
#: B, C, P, G, Q, R, Kp, Ke
_ROWS_SPEC = {
    "cluster_valid": (torch.bool, "C"), "deleting": (torch.bool, "C"),
    "name_rank": (I64, "C"), "api_ok": (torch.bool, "GC"),
    "req_milli": (I64, "QR"), "req_is_cpu": (torch.bool, "R"),
    "req_pods": (I64, "Q"),
    "pl_mask": (torch.bool, "PC"), "pl_tol_bypass": (torch.bool, "PC"),
    "pl_strategy": (torch.int32, "P"), "pl_static_w": (I64, "PC"),
    "pl_has_cluster_sc": (torch.bool, "P"),
    "pl_sc_min": (torch.int32, "P"), "pl_sc_max": (torch.int32, "P"),
    "pl_ignore_avail": (torch.bool, "P"),
    "pl_extra_score": (I64, "PC"),
    "b_valid": (torch.bool, "B"), "placement_id": (torch.int32, "B"),
    "gvk_id": (torch.int32, "B"), "class_id": (torch.int32, "B"),
    "replicas": (I64, "B"), "uid_desc": (torch.bool, "B"),
    "fresh": (torch.bool, "B"), "non_workload": (torch.bool, "B"),
    "nw_shortcut": (torch.bool, "B"),
    "prev_idx": (torch.int32, "BK"), "prev_val": (torch.int32, "BK"),
    "evict_idx": (torch.int32, "BE"),
}


def _check_snapshot(db: DeviceBatch) -> None:
    """K1's snapshot operands on db (the used triple is K2's operand too),
    checked once per DeviceBatch: a chunk's waves launch K1 without
    checking them again."""
    if "snapshot" in db.checked:
        return
    Q, R = db.req_milli.shape
    C = db.C
    kernels.check_fields(db.t, {
        "avail_milli": (I64, (C, R)), "has_alloc": (torch.bool, (C, R)),
        "pods_allowed": (I64, (C,)), "has_summary": (torch.bool, (C,)),
        "est_override": (I64, (Q, C))})
    db.checked.add("snapshot")


def _check_rows(db: DeviceBatch) -> None:
    """K2's batch operands on db, checked once per DeviceBatch."""
    if "rows" in db.checked:
        return
    dims = {"B": db.B, "C": db.C, "P": db.pl_mask.shape[0],
            "G": db.api_ok.shape[0], "Q": db.req_milli.shape[0],
            "R": db.req_milli.shape[1], "K": db.prev_idx.shape[1],
            "E": db.evict_idx.shape[1]}
    kernels.check_fields(db.t, {
        f: (dt, torch.Size(dims[d] for d in shape))
        for f, (dt, shape) in _ROWS_SPEC.items()})
    db.checked.add("rows")


class RowsWorkspace:
    """K2's work buffers and argument block for the waves of one chunk on
    a CUDA batch: the per-slice buffers (web_*, wk_*, seats, the s0 zero
    plane -- zeroed once -- K4's wide-row scratch, the big tier's `work`)
    sized for `rows` rows a launch slice (fewer on the big tier when
    SLICE_BYTES bounds `work`), and an ``array("q")`` block laid out like
    RowsArgs (kernels.rows_block) with every pointer filled once; a launch
    patches r0, r1 and fill_est (the C entry copies the block into the
    kernels' parameters, so a patch after a call returns is safe).  The
    chunk's waves run in order on one stream, so a wave may overwrite what
    the previous wave's finish kernel read.  Checks db's operands once
    (DeviceBatch.checked) and the outputs here."""

    def __init__(self, db: DeviceBatch, rows: int, est, used_milli,
                 used_pods, used_sets, rep_out, sel_out, status_out, *,
                 tier: str, use_extra: bool, charge: bool):
        B, C = db.B, db.C
        Q, R = db.req_milli.shape
        _check_rows(db)
        _check_snapshot(db)
        kernels.check(est, I64, (Q + 1, C))
        kernels.check(used_milli, I64, (C, R))
        kernels.check(used_pods, I64, (C,))
        kernels.check(used_sets, I64, (Q, C))
        kernels.check(rep_out, I64, (B, C))
        kernels.check(sel_out, torch.bool, (B, C))
        kernels.check(status_out, torch.int32, (B,))
        self.db, self.tier = db, tier
        self.flags = (bool(use_extra), bool(charge))
        self.operands = (est, used_milli, used_pods, used_sets, rep_out,
                         sel_out, status_out)
        self.entry = "schedule_rows_big" if tier == "big" else "schedule_rows"
        work_row = kernels.rows_work_bytes(tier) if tier == "big" else 0
        step = max(1, rows)
        if work_row:
            step = max(1, min(step, SLICE_BYTES // work_row))
        self.step = step
        L = kernels.LMAX[tier]
        dev = est.device
        smem_lanes, lane_bytes = kernels.webster_layout()
        e = torch.empty
        self.t = {
            "work": e((step * work_row,), dtype=torch.uint8, device=dev),
            "web_n": e((step,), dtype=I64, device=dev),
            "web_w": e((step, L), dtype=I64, device=dev),
            "web_s0": torch.zeros((step, L), dtype=I64, device=dev),
            "web_active": e((step, L), dtype=torch.bool, device=dev),
            "web_rank": e((step, L), dtype=I64, device=dev),
            "seats": e((step, L), dtype=I64, device=dev),
            "wk_lane": e((step, L), dtype=torch.int32, device=dev),
            "wk_base": e((step, L), dtype=I64, device=dev),
            "wk_prev": e((step, L), dtype=I64, device=dev),
            "wk_sel": e((step, L), dtype=torch.bool, device=dev),
            "wk_feas": e((step, L), dtype=torch.bool, device=dev),
            "wk_U": e((step,), dtype=torch.int32, device=dev),
            "wk_flags": e((step,), dtype=torch.int32, device=dev),
        }
        ptrs = {f: kernels.ptr(db.t[f]) for f in kernels.ROWS_TENSOR_FIELDS}
        ptrs.update(zip(("est", "used_milli", "used_pods", "used_sets",
                         "rep", "sel", "status"),
                        (kernels.ptr(x) for x in self.operands)))
        ptrs.update({f: kernels.ptr(x) for f, x in self.t.items()})
        ptrs["web_scratch"] = 0
        if L > smem_lanes:
            self.t["web_scratch"] = e((step * L * lane_bytes,),
                                      dtype=torch.uint8, device=dev)
            ptrs["web_scratch"] = kernels.ptr(self.t["web_scratch"])
        ptrs.update(r0=0, r1=0, C=C, Q=Q, R=R, Kp=db.prev_idx.shape[1],
                    Ke=db.evict_idx.shape[1], use_extra=int(use_extra),
                    charge=int(charge), fill_est=0)
        self.blk = kernels.rows_block(ptrs)
        self._dev = est.device.index

    def matches(self, db, operands, tier, use_extra, charge) -> bool:
        """True when this workspace was built for these operands."""
        return (db is self.db and tier == self.tier
                and (bool(use_extra), bool(charge)) == self.flags
                and all(a is b for a, b in zip(operands, self.operands)))

    def launch(self, r0: int, r1: int, fill: bool) -> None:
        """One launch slice, rows [r0, r1) (at most `step`): one C call
        enqueues K1 (with `fill`), the prepare kernel, K4 and the finish
        kernel.  Counts capacity (with `fill`), K2 and webster_batch once
        each."""
        blk = self.blk
        blk[_R0] = r0
        blk[_R1] = r1
        blk[_FILL] = int(fill)
        kernels.launch("schedule_rows", blk, f"{self.entry}_wave",
                       count=self.entry, device=self._dev)
        if fill:
            kernels.LAUNCHES["capacity"] += 1
        kernels.LAUNCHES["webster_batch"] += 1

    def webster_operands(self, rows: int):
        """The last slice's K4 operands (n, w, s0, active, rank), as
        copies taken on the stream after it."""
        t = self.t
        return tuple(t[f][:rows].clone() for f in (
            "web_n", "web_w", "web_s0", "web_active", "web_rank"))


_R0 = kernels.ROWS_FIELDS.index("r0")
_R1 = kernels.ROWS_FIELDS.index("r1")
_FILL = kernels.ROWS_FIELDS.index("fill_est")


def schedule_rows(db: DeviceBatch, r0: int, r1: int, est, used_milli,
                  used_pods, used_sets, rep_out, sel_out, status_out, *,
                  use_extra: bool, charge: bool, tier: str = "std",
                  fill_est: bool = False, capture: Optional[dict] = None,
                  workspace: Optional[RowsWorkspace] = None) -> None:
    """K2 (ops/csrc/schedule_rows.cu; launch counter "schedule_rows", or
    "schedule_rows_big" on the big tier) on a CUDA batch,
    schedule_rows_plain on a CPU one.  Same contract as
    schedule_rows_plain.  On CUDA each launch slice is one C call that
    enqueues the rows' prepare kernel, K4 (webster_batch) on their Webster
    problems and the finish kernel; `capture`, when given, receives the
    last launch slice's K4 operands (n, w, s0, active, rank) so they can
    be held against webster_plain.  `workspace` (a RowsWorkspace built on
    these operands; schedule_core makes one a chunk) holds the work
    buffers and the argument block; without one the call builds its own.

    With `fill_est`, est (int64[Q+1, C], any contents) first becomes the
    wave's capacity: K1 on db's snapshot minus the used triple, as
    capacity() computes it.  On CUDA the C call of the rows' first launch
    slice enqueues K1 (counted under "capacity") before the rows' first
    kernel, once however many launch slices the rows take, so every slice
    reads the est of the wave's start (an empty row range launches nothing
    and leaves est as it was); on the CPU capacity_plain fills it."""
    if not _on_cuda(est, used_milli, rep_out, db.b_valid):
        if fill_est:
            est.copy_(capacity_plain(
                db.req_milli, db.req_is_cpu, db.req_pods, db.avail_milli,
                used_milli, db.has_alloc, db.pods_allowed, used_pods,
                db.has_summary, db.est_override, used_sets))
        return schedule_rows_plain(
            db, r0, r1, est, used_milli, used_pods, used_sets, rep_out,
            sel_out, status_out, use_extra=use_extra, charge=charge,
            tier=tier)
    if not 0 <= r0 <= r1 <= db.B:
        raise ValueError(f"row range [{r0}, {r1}) outside the batch of "
                         f"{db.B}")
    operands = (est, used_milli, used_pods, used_sets, rep_out, sel_out,
                status_out)
    if workspace is None:
        workspace = RowsWorkspace(db, r1 - r0, *operands, tier=tier,
                                  use_extra=use_extra, charge=charge)
    elif not workspace.matches(db, operands, tier, use_extra, charge):
        raise ValueError("the workspace was built for other operands")
    if r1 == r0:
        return
    step = workspace.step
    for a0 in range(r0, r1, step):
        a1 = min(r1, a0 + step)
        workspace.launch(a0, a1, fill_est and a0 == r0)
    if capture is not None:
        capture["webster"] = workspace.webster_operands(a1 - a0)


# ---------------------------------------------------------------------------
# K7 explain_rows: the explain plane of one wave's rows
# ---------------------------------------------------------------------------

def explain_planes(B: int, C: int, device):
    """Fresh (verdict, score, avail [B, C], outcome [B]) int32 planes."""
    return (torch.zeros((B, C), dtype=torch.int32, device=device),
            torch.zeros((B, C), dtype=torch.int32, device=device),
            torch.zeros((B, C), dtype=torch.int32, device=device),
            torch.zeros((B,), dtype=torch.int32, device=device))


def explain_rows_plain(db: DeviceBatch, r0: int, r1: int, est, fail_bits,
                       sel, status, out, *, pick=None) -> None:
    """The explain plane of rows [r0, r1) (JAX: _explain_verdict and
    _explain_outcome as wave_step calls them), written into out =
    (verdict, score, avail [B, C], outcome [B]) int32.  est is the wave's
    K1 output, sel/status K2's dense rows.  fail_bits is the encoder's
    per-placement plane [P, C]; with `pick` (spread phase B) it is one row
    per binding [B, C] and a lane counts as selected where pick AND sel
    hold."""
    rows = slice(r0, r1)
    pid, _cid, _prev_rep, prev_present, avail_cal, feasible, evict = \
        _row_inputs(db, r0, r1, est)
    gvk = db.gvk_id[rows].long()
    i32 = torch.int32

    def bit(cond, b):
        return torch.where(cond, b, 0).to(i32)

    fb = (fail_bits[rows] if pick is not None else fail_bits[pid]).to(i32)
    workload = (~db.non_workload[rows] & ~db.nw_shortcut[rows])[:, None]
    st = status[rows]
    unsched = (st == STATUS_UNSCHEDULABLE)[:, None]
    sel_r = sel[rows] if pick is None else sel[rows] & pick[rows]
    lanes_ok = (db.cluster_valid & ~db.deleting)[None, :]
    v = fb
    v = v | bit(~(db.pl_tol_bypass[pid] | prev_present), VERDICT_TOLERATION)
    v = v | bit(~(db.api_ok[gvk] | prev_present), VERDICT_API_ENABLEMENT)
    v = v | bit(evict, VERDICT_EVICTION)
    v = v | bit(~lanes_ok, VERDICT_CLUSTER_GONE)
    v = v | bit(((avail_cal <= 0) | (unsched & feasible)) & workload,
                VERDICT_CAPACITY)
    v = v | bit(feasible & ~sel_r & ~unsched, VERDICT_NOT_SELECTED)
    v = torch.where(db.b_valid[rows][:, None], v, 0).to(i32)
    score = _locality_score(prev_present, db.pl_extra_score[pid])
    low = v & (-v)  # lowest set bit per lane (0 when clean)
    counts = torch.stack(
        [((low == (1 << k)) & db.cluster_valid[None, :]).sum(1)
         for k in range(N_VERDICT_BITS)], dim=1)
    dom = counts.argmax(1)  # the first maximum
    code = torch.where(counts.max(1).values > 0, dom + 1, 0)
    code = torch.where(st == STATUS_UNSCHEDULABLE, VERDICT_BIT_CAPACITY + 1,
                       code)
    verdict, score_out, avail_out, outcome = out
    verdict[rows] = v
    score_out[rows] = torch.clamp(score, 0, MAX_INT32).to(i32)
    avail_out[rows] = torch.clamp(avail_cal, 0, MAX_INT32).to(i32)
    outcome[rows] = (st.to(I64) | (code << 8)).to(i32)


def _check_explain(db: DeviceBatch) -> None:
    """K7's batch operands on db, checked once per DeviceBatch."""
    if "explain" in db.checked:
        return
    B, C = db.B, db.C
    P = db.pl_mask.shape[0]
    b8 = torch.bool
    kernels.check_fields(db.t, {
        "cluster_valid": (b8, (C,)), "deleting": (b8, (C,)),
        "api_ok": (b8, (db.api_ok.shape[0], C)),
        "pl_mask": (b8, (P, C)), "pl_tol_bypass": (b8, (P, C)),
        "pl_extra_score": (I64, (P, C)),
        "b_valid": (b8, (B,)), "placement_id": (torch.int32, (B,)),
        "gvk_id": (torch.int32, (B,)), "class_id": (torch.int32, (B,)),
        "replicas": (I64, (B,)), "non_workload": (b8, (B,)),
        "nw_shortcut": (b8, (B,)),
        "prev_idx": (torch.int32, (B, db.prev_idx.shape[1])),
        "prev_val": (torch.int32, (B, db.prev_idx.shape[1])),
        "evict_idx": (torch.int32, (B, db.evict_idx.shape[1]))})
    db.checked.add("explain")


#: the [C]-wide and [*, C] planes K7 reads or writes four lanes at a time
_EXPLAIN_VEC_FIELDS = ("cluster_valid", "deleting", "api_ok", "pl_mask",
                       "pl_tol_bypass", "pl_extra_score")


def check_explain_vec(C: int, planes) -> None:
    """K7 takes four lanes a thread with 4- and 16-byte vector accesses:
    raises ValueError unless C is a multiple of 4 and every plane is
    16-byte aligned.  The encoder's C is a power of two >= 8 and the
    planes are fresh allocations, so the main path always passes."""
    if C % 4:
        raise ValueError(f"K7 needs a cluster axis that is a multiple of "
                         f"4, not {C}")
    if any(t.data_ptr() % 16 for t in planes):
        raise ValueError("K7 needs every plane 16-byte aligned")


class ExplainWorkspace:
    """K7's argument block for the waves of one chunk on a CUDA batch:
    an ``array("q")`` laid out like kernels.ExplainArgs with every pointer
    filled once; a launch patches r0 and r1 (the C entry copies the block
    into the kernel's parameters, so a patch after a call returns is
    safe).  Checks db's operands once (DeviceBatch.checked) and the
    others here.  With `pick` it launches the spread flavour.
    `use_extra` False promises that db's extra-score rows are all 0
    (solver._use_extra); K7 then does not read them."""

    def __init__(self, db: DeviceBatch, est, fail_bits, sel, status, out,
                 *, pick=None, use_extra: bool = True):
        B, C = db.B, db.C
        Q = db.req_milli.shape[0]
        P = db.pl_mask.shape[0]
        _check_explain(db)
        kernels.check(est, I64, (Q + 1, C))
        kernels.check(fail_bits, torch.int32,
                      (B if pick is not None else P, C))
        kernels.check(sel, torch.bool, (B, C))
        if pick is not None:
            kernels.check(pick, torch.bool, (B, C))
        kernels.check(status, torch.int32, (B,))
        for o, shape in zip(out, ((B, C), (B, C), (B, C), (B,))):
            kernels.check(o, torch.int32, shape)
        t = db.t
        check_explain_vec(C, [t[f] for f in _EXPLAIN_VEC_FIELDS]
                          + [est, fail_bits, sel, *out[:3]]
                          + ([pick] if pick is not None else []))
        vals = {f: t[f].data_ptr() for f in kernels.EXPLAIN_TENSOR_FIELDS}
        vals.update(
            est=est.data_ptr(), fail_bits=fail_bits.data_ptr(),
            sel=sel.data_ptr(),
            pick=pick.data_ptr() if pick is not None else 0,
            status=status.data_ptr(), verdict=out[0].data_ptr(),
            score=out[1].data_ptr(), avail=out[2].data_ptr(),
            outcome=out[3].data_ptr(), r0=0, r1=0, C=C, Q=Q,
            Kp=db.prev_idx.shape[1], Ke=db.evict_idx.shape[1],
            use_extra=int(use_extra))
        self.blk = kernels.explain_block(vals)
        self.entry = ("explain_rows_spread" if pick is not None
                      else "explain_rows")
        self.operands = (db, est, fail_bits, sel, status, *out, pick,
                         bool(use_extra))
        self._dev = est.device.index

    def matches(self, db, est, fail_bits, sel, status, out, pick,
                use_extra) -> bool:
        """True when this workspace was built for these operands."""
        return all(a is b for a, b in zip(
            (db, est, fail_bits, sel, status, *out, pick),
            self.operands)) and bool(use_extra) == self.operands[-1]

    def launch(self, r0: int, r1: int) -> None:
        """K7 on rows [r0, r1): one C call, one count."""
        blk = self.blk
        blk[_XR0] = r0
        blk[_XR1] = r1
        kernels.launch("explain", blk, self.entry, count="explain_rows",
                       device=self._dev)


_XR0 = kernels.EXPLAIN_FIELDS.index("r0")
_XR1 = kernels.EXPLAIN_FIELDS.index("r1")


def explain_rows(db: DeviceBatch, r0: int, r1: int, est, fail_bits, sel,
                 status, out, *, pick=None, use_extra: bool = True,
                 workspace: Optional[ExplainWorkspace] = None) -> None:
    """K7 (ops/csrc/explain.cu; launch counter "explain_rows") on a CUDA
    batch, explain_rows_plain on a CPU one; same contract.  On CUDA a
    launch is one C call on `workspace` (an ExplainWorkspace built on
    these operands; schedule_core makes one a chunk); without one the
    call builds its own.  `use_extra` False promises that db's
    extra-score rows are all 0 (the plain version reads them either
    way)."""
    if not _on_cuda(est, sel, status, db.b_valid):
        return explain_rows_plain(db, r0, r1, est, fail_bits, sel, status,
                                  out, pick=pick)
    if not 0 <= r0 <= r1 <= db.B:
        raise ValueError(f"row range [{r0}, {r1}) outside the batch of "
                         f"{db.B}")
    if workspace is None:
        workspace = ExplainWorkspace(db, est, fail_bits, sel, status, out,
                                     pick=pick, use_extra=use_extra)
    elif not workspace.matches(db, est, fail_bits, sel, status, out, pick,
                               use_extra):
        raise ValueError("the workspace was built for other operands")
    if r1 > r0:
        workspace.launch(r0, r1)


# ---------------------------------------------------------------------------
# K3 compact
# ---------------------------------------------------------------------------

def compact_plain(rep, sel, status, non_workload, keep_sel: bool):
    """Row-major COO of (rep > 0 | wanted sel): (idx int32[nnz] flat
    b*C+c, val int32[nnz], status int32[B], nnz int64 scalar tensor) —
    JAX _compact_of with the extraction sized exactly."""
    wanted = sel if keep_sel else sel & non_workload[:, None]
    mask = (wanted | (rep > 0)).reshape(-1)
    idx = torch.nonzero(mask).reshape(-1)
    val = rep.reshape(-1)[idx]
    nnz = torch.tensor(idx.numel(), dtype=I64, device=rep.device)
    return (idx.to(torch.int32), val.to(torch.int32),
            status.to(torch.int32), nnz)


def compact(rep, sel, status, non_workload, keep_sel: bool):
    """K3 (ops/csrc/compact.cu) on CUDA tensors, compact_plain on CPU.
    One launch reads rep and sel once and writes every tile's run in
    place, its offset found by decoupled look-back: the output holds B*C
    slots, nnz of which are filled (idx[:nnz], val[:nnz]) — it never
    overflows, so the JAX path's nnz-escalation re-solve has no
    counterpart here."""
    if not _on_cuda(rep, sel, status, non_workload):
        return compact_plain(rep, sel, status, non_workload, keep_sel)
    B, C = rep.shape
    if B * C >= (1 << 31):
        raise ValueError("flat COO index b*C+c must fit int32")
    kernels.check(rep, I64, (B, C))
    kernels.check(sel, torch.bool, (B, C))
    kernels.check(status, torch.int32, (B,))
    kernels.check(non_workload, torch.bool, (B,))
    if rep.data_ptr() % 16 or sel.data_ptr() % 2:
        raise ValueError("compact: rep must be 16-byte aligned, sel 2-byte "
                         "aligned (the kernel's vector loads)")
    dev = rep.device
    idx = torch.empty((B * C,), dtype=torch.int32, device=dev)
    val = torch.empty((B * C,), dtype=torch.int32, device=dev)
    tiles = -(-B * C // kernels.COMPACT_TILE)
    state = torch.empty((2 + tiles,), dtype=I64, device=dev)
    kernels.launch("compact", kernels.CompactArgs(
        kernels.ptr(rep), kernels.ptr(sel), kernels.ptr(non_workload),
        kernels.ptr(idx), kernels.ptr(val), kernels.ptr(state),
        B, C, int(keep_sel), state.numel()))
    return idx, val, status, state[1]


# ---------------------------------------------------------------------------
# The cycle: wave loop, dense and compact entry points
# ---------------------------------------------------------------------------

def _zeros_used(db: DeviceBatch):
    return (torch.zeros_like(db.avail_milli), torch.zeros_like(db.pods_allowed),
            torch.zeros_like(db.est_override))


def _as_used(used0, db: DeviceBatch):
    """A fresh copy of the carry-in on the batch's device (numpy or
    tensors); the solve adds into it in place."""
    return tuple(torch.as_tensor(np.asarray(u) if not torch.is_tensor(u)
                                 else u).to(db.device, I64).clone()
                 for u in used0)


def schedule_core(db: DeviceBatch, *, waves: int, use_extra: bool,
                  used0=None, with_used: bool = False, tier: str = "std",
                  explain: bool = False):
    """The full chunk (JAX: _schedule_core): `waves` sequential waves of
    K1 + K2 on lane tier `tier`, K1 enqueued by each wave's first K2
    launch into one est buffer of the chunk, every wave on the chunk's one
    RowsWorkspace (on CUDA).  Returns (rep int64[B,C],
    sel bool[B,C], status int32[B], used, expl) where used is the consumed-capacity triple
    (carry-in plus this chunk's consumption) -- charged only when waves > 1
    or with_used, as in the JAX program -- and expl the explain planes
    (verdict, score, avail [B, C], outcome [B], int32) when `explain`
    (db uploaded with explain=True; K7 runs after each wave's K2), else
    None: the disarmed solve launches and allocates nothing for it."""
    B, C = db.B, db.C
    waves = _effective_waves(B, waves)
    Bw = B // waves
    dev = db.device
    used = _zeros_used(db) if used0 is None else _as_used(used0, db)
    rep = torch.empty((B, C), dtype=I64, device=dev)
    sel = torch.empty((B, C), dtype=torch.bool, device=dev)
    status = torch.empty((B,), dtype=torch.int32, device=dev)
    expl = explain_planes(B, C, dev) if explain else None
    charge = waves > 1 or with_used
    # each wave's K1 overwrites it; the wave's K2 and K7 read it after, on
    # the same stream
    est = torch.empty((db.req_milli.shape[0] + 1, C), dtype=I64, device=dev)
    # one workspace (work buffers, argument block) for the chunk's waves,
    # and one for K7's
    ws = xws = None
    if dev.type == "cuda":
        ws = RowsWorkspace(db, Bw, est, *used, rep, sel, status, tier=tier,
                           use_extra=use_extra, charge=charge)
        if explain:
            xws = ExplainWorkspace(db, est, db.pl_fail_bits, sel, status,
                                   expl, use_extra=use_extra)
    for wv in range(waves):
        r0, r1 = wv * Bw, (wv + 1) * Bw
        schedule_rows(db, r0, r1, est, *used, rep, sel, status,
                      use_extra=use_extra, charge=charge, tier=tier,
                      fill_est=True, workspace=ws)
        if explain:
            explain_rows(db, r0, r1, est, db.pl_fail_bits, sel, status, expl,
                         use_extra=use_extra, workspace=xws)
    return rep, sel, status, used, expl


def _host_planes(expl):
    return tuple(x.cpu().numpy() for x in expl)


def solve(batch, waves: int = 1, device=None, tier: str = "std",
          explain: bool = False):
    """Dense results (numpy rep[B,C], sel[B,C], status[B]) for tests and
    small callers; the cycle uses solve_compact.  With `explain` the
    (verdict, score, avail, outcome) planes follow as a fourth element."""
    if _guards.armed():
        _guards.check_batch(batch, "solve-entry")
    db = device_batch(batch, device, explain=explain)
    rep, sel, status, _, expl = schedule_core(
        db, waves=waves, use_extra=_use_extra(batch), tier=tier,
        explain=explain)
    out = (rep.cpu().numpy(), sel.cpu().numpy(), status.cpu().numpy())
    return out + (_host_planes(expl),) if explain else out


@dataclass
class CompactHandle:
    """A dispatched chunk: device tensors not yet read back."""

    idx: torch.Tensor
    val: torch.Tensor
    status: torch.Tensor
    nnz: torch.Tensor
    # with_used: the live consumed-capacity accumulators (used_milli [C,R],
    # used_pods [C], used_sets [Q,C]) the next chunk's dispatch reads
    used: Optional[tuple]
    # explain: the (verdict, score, avail, outcome) planes on the device
    explain: Optional[tuple] = None
    # B * C of the dispatched batch: the COO indices' bound (guards.check_d2h)
    dense_nnz: int = 0


def dispatch_compact(batch, waves: int = 1, keep_sel: bool = False,
                     with_used: bool = False, used0=None, device=None,
                     tier: str = "std", explain: bool = False
                     ) -> CompactHandle:
    """Enqueue the chunk's solve and COO extraction without waiting for
    the card (kernel launches are asynchronous): returns a handle for
    finalize_compact.  `used0` (numpy or tensors) carries a previous
    chunk's consumption in; it is copied, never updated in place: the JAX
    package's donated variant becomes this chunk's own accumulator buffers
    (handle.used), which the next chunk's dispatch reads.  `explain` runs
    the explain plane too (K7 per wave; the batch must be encoded with
    explain=True)."""
    if _guards.armed():
        # armed invariant mode: the host->device boundary check, before
        # anything is uploaded or launched
        _guards.check_batch(batch, "dispatch-compact")
        _guards.check_used(used0, "dispatch-compact carry")
    db = device_batch(batch, device, explain=explain)
    rep, sel, status, used, expl = schedule_core(
        db, waves=waves, use_extra=_use_extra(batch), used0=used0,
        with_used=with_used, tier=tier, explain=explain)
    idx, val, st, nnz = compact(rep, sel, status, db.non_workload, keep_sel)
    if used0 is not None:
        # the carry dispatch: the JAX package donates used0's buffers;
        # here the chunk's own accumulators take their place (see above)
        DONATED_DISPATCHES.inc()
    return CompactHandle(idx, val, st, nnz, used if with_used else None,
                         expl, dense_nnz=db.B * db.C)


def finalize_compact(handle: CompactHandle):
    """(idx, val, status, nnz) numpy -- plus the used triple (numpy) when
    dispatched with_used, then the (verdict, score, avail, outcome) numpy
    planes when dispatched with explain.  Reads nnz first, then copies
    only idx[:nnz] and val[:nnz] back."""
    nnz = int(handle.nnz)
    out = (handle.idx[:nnz].cpu().numpy(), handle.val[:nnz].cpu().numpy(),
           handle.status.cpu().numpy(), nnz)
    if handle.idx.device.type == "cpu":
        # planes on the CPU reach the host as numpy views, no copy
        D2H_ZEROCOPY.inc(3)
    if _guards.armed():
        # the device->host boundary check on the host copies just made
        _guards.check_d2h(out[0], out[1], out[2], handle.dense_nnz,
                          "finalize-compact")
    if handle.used is not None:
        out = out + (tuple(u.cpu().numpy() for u in handle.used),)
    if handle.explain is not None:
        out = out + (_host_planes(handle.explain),)
    return out


def solve_compact(batch, waves: int = 1, keep_sel: bool = False,
                  with_used: bool = False, used0=None, device=None,
                  tier: str = "std", explain: bool = False):
    """dispatch_compact + finalize_compact."""
    return finalize_compact(dispatch_compact(
        batch, waves=waves, keep_sel=keep_sel, with_used=with_used,
        used0=used0, device=device, tier=tier, explain=explain))


# ---------------------------------------------------------------------------
# Sub-batches: a chunk's rows on another route, solved as their own batch
# ---------------------------------------------------------------------------

def solve_rows(items, idx_list, cindex, estimator, cache, *, route,
               tier: str = "std", waves: int = 1,
               enable_empty_workload_propagation: bool = False,
               collect_used: bool = False, used0=None, from_batch=None,
               device=None):
    """Solve a subset of a chunk's bindings as their own sub-batch (JAX:
    solve_rows): encode items[idx_list] with the encoder's own padding,
    mark the rows carrying `route` valid, solve on lane tier `tier`.
    Returns {original_index: List[TargetCluster] | Exception}.

    `used0` carries a previous batch's consumption in: an accumulator
    triple in `from_batch`'s vocabulary (re-keyed with
    tensors.remap_used) or a tensors.CarryState.  With collect_used the
    return is (out, (sub_batch, used_out, used0_sub)), what
    CarryState.absorb takes to fold the sub-batch's own consumption back
    into a keyed store."""
    if not idx_list:
        return ({}, None) if collect_used else {}
    sub = [items[i] for i in idx_list]
    batch2 = tensors.encode_batch(sub, cindex, estimator, cache=cache)
    # rows host-invalid in the parent batch are this sub-batch's payload
    batch2.b_valid[:len(sub)] = batch2.route == route
    used0_sub = None
    if isinstance(used0, tensors.CarryState):
        used0_sub = used0.used0_for(batch2)
    elif used0 is not None and from_batch is not None:
        used0_sub = tensors.remap_used(used0, from_batch, batch2)
    res = solve_compact(
        batch2, waves=waves, tier=tier,
        keep_sel=enable_empty_workload_propagation,
        with_used=collect_used, used0=used0_sub, device=device)
    idx, val, st = res[0], res[1], res[2]
    decoded = tensors.decode_compact(
        batch2, idx, val, st,
        enable_empty_workload_propagation=enable_empty_workload_propagation,
        items=sub)
    out = {idx_list[j]: decoded[j] for j in range(len(sub))
           if batch2.route[j] == route}
    if collect_used:
        if used0_sub is None:
            used0_sub = tuple(np.zeros_like(a) for a in
                              (batch2.avail_milli, batch2.pods_allowed,
                               batch2.est_override))
        return out, (batch2, res[4], used0_sub)
    return out


def solve_big(items, idx_list, cindex, estimator, cache, waves: int = 1,
              enable_empty_workload_propagation: bool = False,
              collect_used: bool = False, used0=None, from_batch=None,
              device=None):
    """Solve one chunk's ROUTE_DEVICE_BIG bindings (beyond the tier-1
    compact caps) as their own sub-batch on the big lane tier."""
    return solve_rows(
        items, idx_list, cindex, estimator, cache, route=ROUTE_DEVICE_BIG,
        tier="big", waves=waves,
        enable_empty_workload_propagation=enable_empty_workload_propagation,
        collect_used=collect_used, used0=used0, from_batch=from_batch,
        device=device)
