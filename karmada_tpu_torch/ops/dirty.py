"""Dirty-row detection for the incremental steady-state solve (K12).

Counterpart of the JAX package's ``ops/dirty.py``.  One pass over the
resident plane's binding-row slot store (resident/state.py) classifies
every row as clean or dirty for the cycle, and the incremental solver
(scheduler/incremental.py) re-solves only the dirty rows.  No [n, C]
plane is built: the pass is O(cap * (Kp + Ke)) plus one flag per
placement for the cycle's feasibility-flip lanes.

  rv-churn   the binding was written this window (the deltas'
             bindings_touched and the solver's own write-backs): its
             encoded row is stale.
  route      rows the compact device tier does not own (spread, big, host
             routes) re-solve every cycle.
  sensitive  Dynamic/Aggregated rows that are fresh or whose previous
             assignment no longer covers the replica target under current
             feasibility (assigned != replicas), and spread-constrained
             rows: their placement depends on capacity, so they are always
             dirty.  Steady rows (assigned == replicas, not fresh)
             reproduce their previous assignment and consume nothing.
  flip       a lane's feasibility changed this window (the plane's
             last_flip_lanes: `deleting` flips and api_ok column changes):
             every row whose placement mask covers it is dirty.

Each dirty row is also graded for the solver's grouping: SENSITIVE (its
result depends on consumed capacity) and CONSUMER (its re-solve may
consume capacity beyond its previous assignment).

K12 (ops/csrc/dirty.cu; launch counter "dirty_codes") runs on CUDA
tensors, dirty_kernel_plain on CPU ones.  Dispatches and dirty rows are
counted in COUNTS (plain ints), with the last cycle's dirty fraction.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from karmada_tpu_torch.ops import kernels
from karmada_tpu_torch.ops import tensors as T
from karmada_tpu_torch.ops.solver import I64, _on_cuda, _to_dev

#: code bits of the per-slot uint8 output
DIRTY = 1        # re-solve this row this cycle
SENSITIVE = 2    # result depends on the consumed-capacity environment
CONSUMER = 4     # re-solve may consume capacity beyond the previous rep

#: K12 dispatches (one per incremental cycle), rows classified dirty, and
#: dirty rows / live roster rows of the most recent incremental cycle
COUNTS: Dict[str, float] = {"dispatches": 0, "rows": 0,
                            "dirty_fraction": 0.0}

#: slot-store fields K12 reads row by row
SLOT_FIELDS = ("placement_id", "replicas", "fresh", "non_workload", "route",
               "prev_idx", "prev_val", "evict_idx")
#: cluster/placement-side fields K12 reads
PLANE_FIELDS = ("cluster_valid", "deleting", "pl_mask", "pl_strategy",
                "pl_has_cluster_sc", "pl_has_region_sc")


def dirty_kernel_plain(placement_id, replicas, fresh, non_workload, route,
                       prev_idx, prev_val, evict_idx, cluster_valid, deleting,
                       pl_mask, pl_strategy, pl_has_cluster_sc,
                       pl_has_region_sc, flip_lanes, rv_slots):
    """uint8 [cap] dirty codes (JAX: _dirty_core).  flip_lanes int64 [F]
    and rv_slots int64 [S] are -1 padded."""
    cap = placement_id.shape[0]
    pid = placement_id.long()
    lanes_ok = cluster_valid & ~deleting
    okp = prev_idx >= 0
    pl = torch.where(okp, prev_idx, 0).long()
    in_mask = pl_mask[pid[:, None], pl]
    ev = torch.where(evict_idx >= 0, evict_idx, -2).long()
    evicted = (pl[:, :, None] == ev[:, None, :]).any(dim=2)
    feas = okp & lanes_ok[pl] & in_mask & ~evicted
    assigned = torch.where(feas, prev_val.long(), 0).sum(dim=1)
    strat = pl_strategy[pid]
    dyn = (strat == T.STRAT_DYNAMIC) | (strat == T.STRAT_AGGREGATED)
    has_sc = pl_has_cluster_sc[pid] | pl_has_region_sc[pid]
    sensitive = ~non_workload & ((dyn & (fresh | (assigned != replicas)))
                                 | has_sc)
    fl_ok = flip_lanes >= 0
    fl = torch.where(fl_ok, flip_lanes, 0)
    flip_hit = (pl_mask[pid[:, None], fl[None, :]] & fl_ok[None, :]).any(1)
    rv_ok = rv_slots >= 0
    rv_hit = torch.zeros(cap, dtype=torch.bool, device=pid.device)
    rv_hit[rv_slots[rv_ok & (rv_slots < cap)]] = True
    route_hit = route != T.ROUTE_DEVICE
    # rv-churned rows grade conservatively sensitive+consumer: the pass
    # reads the PRE-re-encode slot row, so their steadiness is unknown
    sens_out = sensitive | rv_hit | route_hit
    dirty = sens_out | flip_hit
    # Static/Duplicated rows are capacity-insensitive but their re-solve
    # can still move replicas onto new lanes (consume)
    consumer = sens_out | (dirty & ~dyn & ~non_workload)
    return (dirty.to(torch.uint8) | (sens_out.to(torch.uint8) << 1)
            | (consumer.to(torch.uint8) << 2))


def dirty_kernel(placement_id, replicas, fresh, non_workload, route,
                 prev_idx, prev_val, evict_idx, cluster_valid, deleting,
                 pl_mask, pl_strategy, pl_has_cluster_sc, pl_has_region_sc,
                 flip_lanes, rv_slots):
    """K12 on CUDA tensors, dirty_kernel_plain on CPU ones; same
    contract."""
    args = (placement_id, replicas, fresh, non_workload, route, prev_idx,
            prev_val, evict_idx, cluster_valid, deleting, pl_mask,
            pl_strategy, pl_has_cluster_sc, pl_has_region_sc)
    if not _on_cuda(*args, flip_lanes, rv_slots):
        return dirty_kernel_plain(*args, flip_lanes, rv_slots)
    cap = placement_id.shape[0]
    Kp, Ke = prev_idx.shape[1], evict_idx.shape[1]
    P, C = pl_mask.shape
    F, S = flip_lanes.shape[0], rv_slots.shape[0]
    B8, I32 = torch.bool, torch.int32
    spec = ((I32, (cap,)), (I64, (cap,)), (B8, (cap,)), (B8, (cap,)),
            (I32, (cap,)), (I32, (cap, Kp)), (I32, (cap, Kp)),
            (I32, (cap, Ke)), (B8, (C,)), (B8, (C,)), (B8, (P, C)),
            (I32, (P,)), (B8, (P,)), (B8, (P,)))
    for t, (dt, shape) in zip(args, spec):
        kernels.check(t, dt, shape)
    kernels.check(flip_lanes, I64, (F,))
    kernels.check(rv_slots, I64, (S,))
    dev = placement_id.device
    pl_flags = torch.empty((P,), dtype=torch.uint8, device=dev)
    rv_mark = torch.zeros((cap,), dtype=torch.uint8, device=dev)
    out = torch.empty((cap,), dtype=torch.uint8, device=dev)
    kernels.launch("dirty", kernels.DirtyArgs(
        *(kernels.ptr(t) for t in args), kernels.ptr(flip_lanes),
        kernels.ptr(rv_slots), kernels.ptr(pl_flags), kernels.ptr(rv_mark),
        kernels.ptr(out), cap, C, P, Kp, Ke, F, S),
        "dirty_codes", count="dirty_codes")
    return out


def _pad_lanes(arr, lo: int = 8) -> np.ndarray:
    """-1-pad to the next pow2 bucket (JAX: stable jit signatures; kept
    so both packages hand their kernels the same operands)."""
    arr = np.asarray(arr, np.int64).reshape(-1)
    n = T._next_pow2(max(arr.size, 1), lo)  # noqa: SLF001
    out = np.full(n, -1, np.int64)
    out[:arr.size] = arr
    return out


def dirty_codes(state, rv_slots: np.ndarray,
                mirrors: Optional[dict] = None) -> np.ndarray:
    """The dirty pass over a ResidentState's slot store on its device:
    the uint8 [cap] code plane as numpy (DIRTY / SENSITIVE / CONSUMER
    bits).  `rv_slots`: slots of rows the window (or the solver's own
    write-backs) touched.  `mirrors`: the fused path's device slot mirrors
    (no binding-axis upload); None uploads the host masters once.  The
    cluster-side fields always come from the host masters: begin_cycle has
    just advanced them, and the device plane syncs at the next encode."""
    p = state.plane

    def up(a) -> torch.Tensor:
        return _to_dev(a, state.device)

    slot = [mirrors[f] if mirrors else up(getattr(p, f))
            for f in SLOT_FIELDS]
    codes = dirty_kernel(
        *slot, *(up(getattr(p, f)) for f in PLANE_FIELDS),
        up(_pad_lanes(state.last_flip_lanes)), up(_pad_lanes(rv_slots)))
    COUNTS["dispatches"] += 1
    return codes.cpu().numpy()
