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

K11's device work is a few microseconds; its time on the card is its
host path, so a call is one C call on a workspace of the mirror set:

  * the mirrors are checked in full once per mirror set: the last
    validated set (_Plan) is kept (weakly) with each tensor's identity,
    data_ptr, dtype and shape, and any change is checked again (a mirror
    sync scatters in place, so the set changes only when a mirror is
    re-placed);
  * the set's call block (an ``array("q")`` laid out like resident.cu
    GatherCall) holds the mirror pointers, and the outputs' offsets of
    each call layout (built once per (B, staged)); a call writes its
    inputs, B and its slab;
  * a call's slab, carved into the twelve outputs, is fresh memory (they
    are live operands of an in-flight solve): one torch.empty a call;
  * from host inputs (dispatch_gather, dispatch_sub_gather) the C call
    itself copies the slots (and lane_inv, drop) into the next of the
    set's kernels.GATHER_RING pinned buffers -- once the event of that
    buffer's last upload has completed, so calls in flight never share
    one -- and uploads them into the front of the slab with one
    cudaMemcpyAsync before the kernel: no pinned allocation and no torch
    copy a call.  An upload, not a kernel reading the pinned buffer over
    the bus: the sub flavour's lane_inv is read at B x (Kp + Ke)
    scattered lanes, each a bus round trip from mapped memory.
"""

from __future__ import annotations

import weakref
from array import array
from typing import Dict, List

import numpy as np
import torch

from karmada_tpu_torch.ops import kernels
from karmada_tpu_torch.ops.solver import I64, _to_dev
from karmada_tpu_torch.ops.tensors import FIELD_DTYPES, ROUTE_DEVICE
from karmada_tpu_torch.utils.metrics import REGISTRY

GATHER_DISPATCHES = REGISTRY.counter(
    "karmada_resident_gather_dispatches_total",
    "Fused device-side binding-row gathers dispatched (one per chunk on "
    "the fused resident path)",
)
GATHER_ROWS = REGISTRY.counter(
    "karmada_resident_gather_rows_total",
    "Binding rows pulled out of the device slot store by the fused gather",
)
GATHER_SCATTERS = REGISTRY.counter(
    "karmada_resident_gather_row_scatters_total",
    "Churned binding rows scattered into the device slot store (miss "
    "re-encodes advancing the mirrors in place)",
)

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

#: kernels.GATHER_CALL's slots in the int64 call block
_AT = kernels.gather_call_offsets()
_ALIGN = 16


def _aligned(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


def _staged_len(B: int, n_inv: int, sub: bool) -> int:
    """Bytes of a staged call's inputs at the front of its slab: the
    slots, then (sub flavour) lane_inv and drop, each 16-byte aligned
    (resident.cu kt_gather_rows lays them out alike)."""
    n = _aligned(8 * B)
    return n + _aligned(4 * n_inv) + _aligned(B) if sub else n


def _free_ring(blk, ring, dev) -> None:
    """A workspace's ring released: its copies waited for, its events
    destroyed; `ring` (the pinned buffers) is dropped after."""
    kernels.launch("resident", blk, "gather_ring_free", device=dev)


class _Plan:
    """A validated mirror set and its workspace: weak references to the
    twelve mirror tensors (a collected mirror never matches) and their
    (data_ptr, dtype, shape) signature, the store's Kp and Ke, K11's call
    block (kernels.GATHER_CALL) with the mirror pointers, Kp and Ke
    filled, the call layouts by (B, staged) and which one's output offsets
    the block holds, the staging ring: kernels.GATHER_RING pinned
    buffers, made at the first call from host inputs and grown when a
    call needs more, with one event each (made and destroyed by the C
    entries; a dropped workspace waits for its copies first)."""

    __slots__ = ("refs", "sig", "Kp", "Ke", "dev", "device", "blk",
                 "layouts", "key", "ring", "fin", "__weakref__")

    def __init__(self, ts, Kp, Ke):
        self.refs = [weakref.ref(t) for t in ts]
        self.sig = _signature(ts)
        self.Kp, self.Ke = Kp, Ke
        self.device = ts[0].device
        self.dev = self.device.index
        self.blk = array("q", [0] * _AT["len"])
        m = _AT["mirrors"]
        self.blk[m:m + len(ts)] = array("q", (t.data_ptr() for t in ts))
        self.blk[_AT["Kp"]], self.blk[_AT["Ke"]] = Kp, Ke
        self.layouts = {}
        self.key = None
        self.ring = self.fin = None

    def stage(self, need: int) -> None:
        """The ring's buffers hold at least `need` bytes each."""
        blk = self.blk
        have = blk[_AT["ring_bytes"]]
        if have >= need:
            return
        if self.fin is not None:
            self.fin()
        size = _aligned(max(need, 2 * have))
        self.ring = torch.empty((kernels.GATHER_RING * size,),
                                dtype=torch.uint8, pin_memory=True)
        blk[_AT["ring"]] = self.ring.data_ptr()
        blk[_AT["ring_bytes"]] = size
        kernels.launch("resident", blk, "gather_ring_init", device=self.dev)
        self.fin = weakref.finalize(self, _free_ring, blk, self.ring,
                                    self.dev)
        self.fin.atexit = False


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
    outputs by dtype (int64, int32, bool; OUT_FIELDS order within each),
    each region 16-byte aligned.  Returns (slab bytes, the views' spec,
    the byte offsets in OUT_FIELDS order), built once per (B, staged):
    consecutive chunks mostly share B."""
    lay = p.layouts.get((B, staged))
    if lay is not None:
        return lay
    Kp, Ke = p.Kp, p.Ke
    sizes = {f: (B * Kp if f in ("prev_idx", "prev_val")
                 else B * Ke if f == "evict_idx" else B)
             for f in OUT_FIELDS}
    item = {f: getattr(torch, FIELD_DTYPES[f]).itemsize for f in OUT_FIELDS}
    at, offs, regions = staged, {}, []
    for size in (8, 4, 1):
        fields = [f for f in OUT_FIELDS if item[f] == size]
        regions.append((at, at + size * sum(sizes[f] for f in fields)))
        for f in fields:
            offs[f] = at
            at += sizes[f] * size
        at = _aligned(at)
    split = tuple(tuple(sizes[f] for f in OUT_FIELDS if item[f] == size)
                  for size in (4, 1))
    lay = (at, (B, Kp, Ke, regions, split), [offs[f] for f in OUT_FIELDS])
    p.layouts[(B, staged)] = lay
    return lay


def _views(slab, spec):
    """The outputs (OUT_FIELDS order) as views of a call's slab: a view
    and one split a dtype region (the per-op cost, not the per-tensor
    one, is what a call pays on the host)."""
    B, Kp, Ke, ((a8, b8), (a4, b4), (a1, b1)), (n4, n1) = spec
    rep = slab[a8:b8].view(torch.int64)
    pid, gvk, cid, pi, pv, ev = slab[a4:b4].view(torch.int32) \
        .split_with_sizes(n4)
    bv, ud, fr, nw, ns = slab[a1:b1].view(torch.bool).split_with_sizes(n1)
    return (bv, pid, gvk, cid, rep, ud, fr, nw, ns, pi.view(B, Kp),
            pv.view(B, Kp), ev.view(B, Ke))


def _launch(p: _Plan, B: int, staged: int, inputs, n_inv: int = 0):
    """K11, one C call: `inputs` are the slots, lane_inv and drop
    addresses (0 = absent) -- device addresses, or with `staged` (the
    inputs' bytes, _staged_len) host addresses that the call copies into
    the ring's next buffer and uploads into the front of its slab (fresh
    device memory).  Returns the outputs."""
    nbytes, spec, offs = _layout(p, B, staged)
    blk = p.blk
    if p.key != (B, staged):
        o = _AT["out_off"]
        blk[o:o + len(offs)] = array("q", offs)
        p.key = (B, staged)
    slab = torch.empty((nbytes,), dtype=torch.uint8, device=p.device)
    blk[0], blk[1], blk[2] = inputs
    blk[_B] = B
    blk[_SLAB] = slab.data_ptr()
    blk[_STAGED] = 1 if staged else 0
    blk[_NINV] = n_inv
    kernels.launch("resident", blk, "gather_rows", count="gather_rows",
                   device=p.dev)
    return _views(slab, spec)


_B, _SLAB, _STAGED, _NINV = (_AT[f] for f in ("B", "slab", "staged",
                                              "n_inv"))


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
    inputs = (slots.data_ptr(), 0, 0)
    if lane_inv is not None:
        kernels.check(lane_inv, torch.int32, (lane_inv.shape[0],))
        kernels.check(drop, torch.bool, (B,))
        inputs = (inputs[0], lane_inv.data_ptr(), drop.data_ptr())
    return _launch(p, B, 0, inputs)


def _staged_gather(slots: np.ndarray, mirrors: dict, lane_inv=None,
                   drop=None):
    """K11 from host inputs: one C call copies slots (and lane_inv, drop)
    into the next buffer of the mirror set's pinned ring and uploads them
    into the front of the call's slab by one copy before the kernel."""
    p = _plan(mirrors)
    s = np.ascontiguousarray(slots, np.int64)
    B = s.shape[0]
    if lane_inv is None:
        staged = _staged_len(B, 0, False)
        p.stage(staged)
        return _launch(p, B, staged, (s.ctypes.data, 0, 0))
    inv = np.ascontiguousarray(lane_inv, np.int32)
    dr = np.ascontiguousarray(drop, np.bool_)
    if inv.ndim != 1 or dr.shape != (B,):
        raise ValueError(f"lane_inv shape {inv.shape}, drop shape "
                         f"{dr.shape}, expected (C,) and ({B},)")
    staged = _staged_len(B, inv.shape[0], True)
    p.stage(staged)
    return _launch(p, B, staged,
                   (s.ctypes.data, inv.ctypes.data, dr.ctypes.data),
                   inv.shape[0])


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
    GATHER_DISPATCHES.inc()
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
    GATHER_DISPATCHES.inc()
    return out


def place_slot(arr: np.ndarray, device) -> torch.Tensor:
    """One slot-store master on `device`, as a copy that never aliases
    the host array (on the CPU, torch.from_numpy would share its memory
    and an in-place scatter would write into the master)."""
    a = np.array(arr, order="C")
    return torch.from_numpy(a).to(device)
