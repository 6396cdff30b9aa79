"""Gather of a cycle's batch rows from the device slot store (K11).

Counterpart of the JAX package's ``ops/resident_gather.py``.  The resident
plane (resident/state.py) keeps the binding-axis slot store on the card
between cycles; a fused cycle's batch rows are pulled out of it by one
gather instead of the host assembling numpy rows and uploading them at
every dispatch.  The steady-state chain is

  scatter watch deltas into the device mirrors  (ops/resident_update, K10)
  -> gather the pending batch's rows on the card (this module, K11)
  -> solve with operands already there           (ops/solver.dispatch_compact)
  -> read back only the compact COO              (solver.finalize_compact)

so the only per-chunk host-to-device traffic of a warm cycle is the [B]
slot vector (solver.TRANSFERS["h2d_binding_fields"] stays flat).

K11 (ops/csrc/resident.cu; launch counter "gather_rows") runs on CUDA
tensors, gather_batch_plain / sub_gather_batch_plain on CPU ones.
Dispatches, gathered rows, scattered slot rows and the mirror syncs'
fused scatters (ops/resident_update.scatter_fields) are counted in COUNTS
(plain ints).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from karmada_tpu_torch.ops import kernels
from karmada_tpu_torch.ops.solver import I64, _on_cuda, _to_dev
from karmada_tpu_torch.ops.tensors import FIELD_DTYPES, ROUTE_DEVICE

#: slot-store fields the gather reads, in K11's operand order
#: (resident/state.DEVICE_SLOT_FIELDS is exactly this set)
GATHER_FIELDS = (
    "placement_id", "gvk_id", "class_id", "replicas", "uid_desc",
    "fresh", "non_workload", "nw_shortcut", "route",
    "prev_idx", "prev_val", "evict_idx",
)

#: gather outputs, in ops/solver._BINDING_FIELDS order; b_valid is computed
#: on the card (route == DEVICE on real rows), route stays host-side
OUT_FIELDS = (
    "b_valid", "placement_id", "gvk_id", "class_id", "replicas",
    "uid_desc", "fresh", "non_workload", "nw_shortcut",
    "prev_idx", "prev_val", "evict_idx",
)

#: pad-row fill per output field: the host assemble's
#: (resident/state.ResidentState._assemble), so a fused batch equals the
#: host one on every row, padding included
_FILL = {
    "placement_id": 0, "gvk_id": 0, "class_id": -1, "replicas": 0,
    "uid_desc": False, "fresh": False, "non_workload": False,
    "nw_shortcut": False, "prev_idx": -1, "prev_val": 0, "evict_idx": -1,
}

#: gathers dispatched (one per fused chunk and per fused shortlist
#: sub-batch), rows gathered, slot rows scattered into the mirrors; of the
#: fused scatters (resident_update.scatter_fields): entries scattered,
#: staged buffers (one H2D copy each on the card), descriptor tables
#: applied (one K10 launch each on the card, one plain pass on the CPU)
#: and calls split for holding more than one table's entries
COUNTS: Dict[str, int] = {"dispatches": 0, "rows": 0, "row_scatters": 0,
                          "scatter_fields": 0, "scatter_staged": 0,
                          "scatter_tables": 0, "scatter_splits": 0}


def _gather_plain(slots, lane_inv, drop, m):
    ok = slots >= 0
    sl = torch.where(ok, slots, 0)

    def g(name):
        a = m[name][sl]
        okb = ok.reshape((-1,) + (1,) * (a.dim() - 1))
        return torch.where(okb, a, torch.full((), _FILL[name], dtype=a.dtype,
                                              device=a.device))

    b_valid = ok & (m["route"][sl] == ROUTE_DEVICE)
    prev_idx, prev_val, evict_idx = g("prev_idx"), g("prev_val"), \
        g("evict_idx")
    if lane_inv is not None:
        b_valid = b_valid & ~drop

        def remap(lanes):
            got = lane_inv[torch.where(lanes >= 0, lanes, 0).long()]
            return torch.where(lanes >= 0, got, -1).to(lanes.dtype)

        prev_idx = remap(prev_idx)
        prev_val = torch.where(prev_idx >= 0, prev_val, 0)
        evict_idx = remap(evict_idx)
    return (b_valid, g("placement_id"), g("gvk_id"), g("class_id"),
            g("replicas"), g("uid_desc"), g("fresh"), g("non_workload"),
            g("nw_shortcut"), prev_idx, prev_val, evict_idx)


def gather_batch_plain(slots, mirrors):
    """The solver's binding-axis operands (OUT_FIELDS order) of the slot
    store rows `slots` (int64 [B], -1 = padding row)."""
    return _gather_plain(slots, None, None, mirrors)


def sub_gather_batch_plain(slots, mirrors, lane_inv, drop):
    """gather_batch_plain with prev/evict lanes remapped into a shortlist
    sub-vocabulary: `lane_inv` int32 [C] maps full-vocabulary lanes to
    union lanes (-1 = outside; the prev value is zeroed there), `drop`
    bool [B] clears b_valid on rows routed out of the sub-solve."""
    return _gather_plain(slots, lane_inv, drop, mirrors)


def _gather(slots, mirrors, lane_inv=None, drop=None):
    m = mirrors
    if not _on_cuda(slots, *(m[f] for f in GATHER_FIELDS)):
        if lane_inv is None:
            return gather_batch_plain(slots, m)
        return sub_gather_batch_plain(slots, m, lane_inv, drop)
    B = slots.shape[0]
    cap = m["placement_id"].shape[0]
    Kp = m["prev_idx"].shape[1]
    Ke = m["evict_idx"].shape[1]
    kernels.check(slots, I64, (B,))
    for f in GATHER_FIELDS:
        shape = ((cap, Kp) if f in ("prev_idx", "prev_val")
                 else (cap, Ke) if f == "evict_idx" else (cap,))
        kernels.check(m[f], getattr(torch, FIELD_DTYPES[f]), shape)
    if lane_inv is not None:
        kernels.check(lane_inv, torch.int32, (lane_inv.shape[0],))
        kernels.check(drop, torch.bool, (B,))
    dev = slots.device
    out = []
    for f in OUT_FIELDS:
        shape = ((B, Kp) if f in ("prev_idx", "prev_val")
                 else (B, Ke) if f == "evict_idx" else (B,))
        out.append(torch.empty(shape, dtype=getattr(torch, FIELD_DTYPES[f]),
                               device=dev))
    null = 0
    kernels.launch("resident", kernels.GatherArgs(
        kernels.ptr(slots),
        kernels.ptr(lane_inv) if lane_inv is not None else null,
        kernels.ptr(drop) if drop is not None else null,
        *(kernels.ptr(m[f]) for f in GATHER_FIELDS),
        *(kernels.ptr(t) for t in out), B, Kp, Ke),
        "gather_rows", count="gather_rows")
    return tuple(out)


def gather_batch(slots, mirrors):
    """K11 (plain flavour) on CUDA tensors, gather_batch_plain on CPU
    ones; same contract."""
    return _gather(slots, mirrors)


def sub_gather_batch(slots, mirrors, lane_inv, drop):
    """K11 (sub flavour) on CUDA tensors, sub_gather_batch_plain on CPU
    ones; same contract."""
    return _gather(slots, mirrors, lane_inv, drop)


def dispatch_gather(slots: np.ndarray, mirrors: dict):
    """The fused gather of one chunk: `slots` int64 [B] numpy (-1 padded),
    the only upload; `mirrors` maps GATHER_FIELDS to the device slot
    store.  Returns the solver's binding-axis operands (OUT_FIELDS order)
    as live device tensors (nothing waits for the card)."""
    dev = mirrors["placement_id"].device
    out = gather_batch(_to_dev(np.asarray(slots, np.int64), dev), mirrors)
    COUNTS["dispatches"] += 1
    return out


def dispatch_sub_gather(slots: np.ndarray, mirrors: dict,
                        lane_inv: np.ndarray, drop: np.ndarray):
    """The fused gather straight into a shortlist sub-vocabulary: uploads
    the [B] slots, the [C] lane map and the [B] drop mask, still no
    binding field."""
    dev = mirrors["placement_id"].device
    out = sub_gather_batch(_to_dev(np.asarray(slots, np.int64), dev), mirrors,
                           _to_dev(np.asarray(lane_inv, np.int32), dev),
                           _to_dev(np.asarray(drop, bool), dev))
    COUNTS["dispatches"] += 1
    return out


def place_slot(arr: np.ndarray, device) -> torch.Tensor:
    """One slot-store master on `device`, as a copy that never aliases
    the host array (on the CPU, torch.from_numpy would share its memory
    and an in-place scatter would write into the master)."""
    a = np.array(arr, order="C")
    return torch.from_numpy(a).to(device)
