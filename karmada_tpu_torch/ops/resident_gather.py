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

K11's device work is a few microseconds; its time on the card was its
host path, so the launch path is lean:

  * the mirrors are checked in full once per mirror set: the last
    validated set is kept (weakly) with each tensor's identity, data_ptr,
    dtype and shape, and any change is checked again (a mirror sync
    scatters in place, so the set changes only when a mirror is
    re-placed);
  * the argument block is an ``array("q")`` with the mirror pointers
    filled once per set; a call writes only its inputs, outputs and B;
  * a call makes one device allocation, a slab carved into the twelve
    outputs (fresh per call: they are live operands of an in-flight
    solve), and from host slots (dispatch_gather, dispatch_sub_gather)
    the inputs are staged in one pinned buffer and uploaded into the
    front of the slab by one non-blocking copy.
"""

from __future__ import annotations

import math
import weakref
from array import array
from typing import Dict, List

import numpy as np
import torch

from karmada_tpu_torch.ops import kernels
from karmada_tpu_torch.ops.solver import I64, _to_dev
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


# -- K11's launch path on the card ---------------------------------------------

#: GatherArgs (ops/csrc/resident.cu) as an int64 argument block: the
#: inputs (slots, lane_inv, drop), the twelve mirrors (GATHER_FIELDS
#: order), the twelve outputs (OUT_FIELDS order), then B, Kp, Ke
_ARG_MIRRORS, _ARG_OUTS, _ARG_B = 3, 15, 27
_ALIGN = 16


def _aligned(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


class _Plan:
    """A validated mirror set: weak references to the twelve mirror
    tensors (a collected mirror never matches) and their (data_ptr, dtype,
    shape) signature, the store's Kp and Ke, K11's argument block with the
    mirror pointers filled, and the last call's layout."""

    __slots__ = ("refs", "sig", "Kp", "Ke", "dev", "blk", "layout")

    def __init__(self, ts, Kp, Ke):
        self.refs = [weakref.ref(t) for t in ts]
        self.sig = _signature(ts)
        self.Kp, self.Ke = Kp, Ke
        self.dev = ts[0].device.index
        self.blk = array("q", [0] * (_ARG_B + 3))
        self.blk[_ARG_MIRRORS:_ARG_OUTS] = array(
            "q", (t.data_ptr() for t in ts))
        self.blk[_ARG_B + 1], self.blk[_ARG_B + 2] = Kp, Ke
        self.layout = (None, None)


#: the last validated mirror set: a mirror sync scatters in place, so
#: consecutive gathers see the same tensors until a re-place
_PLAN: List[_Plan] = []


def _signature(ts):
    return [(t.data_ptr(), t.dtype, t.shape) for t in ts]


def _plan(mirrors) -> _Plan:
    """The mirror set's plan: checked in full (device, dtype, shape,
    contiguity) when any mirror's identity, data_ptr, dtype or shape
    differs from the last validated set's."""
    ts = [mirrors[f] for f in GATHER_FIELDS]
    if _PLAN:
        p = _PLAN[0]
        if all(r() is t for r, t in zip(p.refs, ts)) and \
                _signature(ts) == p.sig:
            return p
    cap = ts[0].shape[0]
    Kp = mirrors["prev_idx"].shape[1]
    Ke = mirrors["evict_idx"].shape[1]
    for f, t in zip(GATHER_FIELDS, ts):
        shape = ((cap, Kp) if f in ("prev_idx", "prev_val")
                 else (cap, Ke) if f == "evict_idx" else (cap,))
        kernels.check(t, getattr(torch, FIELD_DTYPES[f]), shape)
    if len({t.device for t in ts}) != 1:
        raise ValueError("the gather's mirrors lie on more than one device")
    _PLAN[:] = [_Plan(ts, Kp, Ke)]
    return _PLAN[0]


def _layout(p: _Plan, B: int, staged: int):
    """One call's device slab: `staged` bytes of uploaded inputs, then the
    outputs by dtype (int64, int32, bool), each region 16-byte aligned.
    Returns (slab bytes, [(dtype, size, stride, element offset)] and the
    byte offsets, both in OUT_FIELDS order).  The last call's layout is
    kept: consecutive chunks mostly share B."""
    key, lay = p.layout
    if key == (B, staged):
        return lay
    Kp, Ke = p.Kp, p.Ke
    shapes = {f: ((B, Kp) if f in ("prev_idx", "prev_val")
                  else (B, Ke) if f == "evict_idx" else (B,))
              for f in OUT_FIELDS}
    dts = {f: getattr(torch, FIELD_DTYPES[f]) for f in OUT_FIELDS}
    at, offs = staged, {}
    for size in (8, 4, 1):
        for f in OUT_FIELDS:
            if dts[f].itemsize == size:
                offs[f] = at
                at += math.prod(shapes[f]) * size
        at = _aligned(at)
    spec = []
    for f in OUT_FIELDS:
        shape = shapes[f]
        stride = (shape[1], 1) if len(shape) == 2 else (1,)
        spec.append((dts[f], shape, stride, offs[f] // dts[f].itemsize))
    lay = (at, spec, [offs[f] for f in OUT_FIELDS])
    p.layout = ((B, staged), lay)
    return lay


def _views(slab, spec):
    """The outputs (OUT_FIELDS order) as views of a call's slab."""
    typed = {dt: slab.view(dt) for dt in (torch.int64, torch.int32,
                                          torch.bool)}
    return tuple(typed[dt].as_strided(size, stride, off)
                 for dt, size, stride, off in spec)


def _launch(p: _Plan, slab, B: int, spec, out_offs, inputs):
    """K11 into `slab`'s output region: `inputs` are the slots, lane_inv
    and drop addresses (0 = absent).  Returns the outputs."""
    base = slab.data_ptr()
    blk = p.blk
    blk[0:_ARG_MIRRORS] = array("q", inputs)
    blk[_ARG_OUTS:_ARG_B] = array("q", [base + o for o in out_offs])
    blk[_ARG_B] = B
    kernels.launch("resident", blk, "gather_rows", count="gather_rows",
                   device=p.dev)
    return _views(slab, spec)


def _gather(slots, mirrors, lane_inv=None, drop=None):
    m = mirrors["placement_id"]
    if not (slots.is_cuda or m.is_cuda):
        if lane_inv is None:
            return gather_batch_plain(slots, mirrors)
        return sub_gather_batch_plain(slots, mirrors, lane_inv, drop)
    if not slots.is_cuda:
        raise ValueError(f"slots on {slots.device}, the mirrors on "
                         f"{m.device}")
    p = _plan(mirrors)
    B = slots.shape[0]
    kernels.check(slots, I64, (B,))
    if slots.get_device() != p.dev:
        raise ValueError(f"slots on {slots.device}, the mirrors on cuda:"
                         f"{p.dev}")
    inputs = [slots.data_ptr(), 0, 0]
    if lane_inv is not None:
        kernels.check(lane_inv, torch.int32, (lane_inv.shape[0],))
        kernels.check(drop, torch.bool, (B,))
        inputs[1:] = lane_inv.data_ptr(), drop.data_ptr()
    nbytes, spec, out_offs = _layout(p, B, 0)
    slab = torch.empty((nbytes,), dtype=torch.uint8, device=slots.device)
    return _launch(p, slab, B, spec, out_offs, inputs)


def _staged_gather(slots: np.ndarray, mirrors: dict, lane_inv=None,
                   drop=None):
    """K11 from host inputs: slots (and lane_inv, drop) staged in one
    pinned buffer and uploaded with one non-blocking copy into the front
    of the call's device slab.  PyTorch's pinned-memory allocator records
    the copy's stream event on the buffer and hands it out again only
    once that event has completed."""
    p = _plan(mirrors)
    arrays = [np.ascontiguousarray(slots, np.int64)]
    if lane_inv is not None:
        arrays += [np.ascontiguousarray(lane_inv, np.int32),
                   np.ascontiguousarray(drop, np.bool_)]
    B = arrays[0].shape[0]
    if lane_inv is not None and arrays[2].shape != (B,):
        raise ValueError(f"drop shape {arrays[2].shape}, expected ({B},)")
    in_offs, staged = [], 0
    for a in arrays:
        in_offs.append(staged)
        staged = _aligned(staged + a.nbytes)
    nbytes, spec, out_offs = _layout(p, B, staged)
    host = torch.empty((staged,), dtype=torch.uint8, pin_memory=True)
    hv = host.numpy()
    for a, o in zip(arrays, in_offs):
        hv[o:o + a.nbytes] = a.view(np.uint8)
    slab = torch.empty((nbytes,), dtype=torch.uint8,
                       device=mirrors["placement_id"].device)
    slab[:staged].copy_(host, non_blocking=True)
    base = slab.data_ptr()
    inputs = [base + o for o in in_offs] + [0] * (3 - len(in_offs))
    return _launch(p, slab, B, spec, out_offs, inputs)


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
    m = mirrors["placement_id"]
    if m.is_cuda:
        out = _staged_gather(slots, mirrors)
    else:
        out = gather_batch(_to_dev(np.asarray(slots, np.int64), m.device),
                           mirrors)
    COUNTS["dispatches"] += 1
    return out


def dispatch_sub_gather(slots: np.ndarray, mirrors: dict,
                        lane_inv: np.ndarray, drop: np.ndarray):
    """The fused gather straight into a shortlist sub-vocabulary: uploads
    the [B] slots, the [C] lane map and the [B] drop mask, still no
    binding field."""
    m = mirrors["placement_id"]
    if m.is_cuda:
        out = _staged_gather(slots, mirrors, lane_inv, drop)
    else:
        dev = m.device
        out = sub_gather_batch(_to_dev(np.asarray(slots, np.int64), dev),
                               mirrors,
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
