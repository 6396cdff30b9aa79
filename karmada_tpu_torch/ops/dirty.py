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
tensors, dirty_kernel_plain on CPU ones.  Its time on the card is its
call, so dirty_codes is one C call a cycle on the card's workspace
(_Workspace: an int64 block laid out like dirty.cu DirtyCall, pointed at
the operand set once per set, a pinned staging buffer, the device codes
and their pinned copy), reading the slot store and the cluster-side
fields from the resident plane's device mirrors: one upload of the flip
lanes, the rv list and pl_has_region_sc, one launch (no scratch, no
memset), one copy of the codes back and one synchronise.  Dispatches and
dirty rows are counted in COUNTS (plain ints), with the last cycle's
dirty fraction.
"""

from __future__ import annotations

import weakref
from array import array
from typing import Dict, Optional

import numpy as np
import torch

from karmada_tpu_torch.ops import kernels
from karmada_tpu_torch.ops import tensors as T
from karmada_tpu_torch.ops.solver import I64, _on_cuda, _to_dev
from karmada_tpu_torch.utils.metrics import REGISTRY

#: code bits of the per-slot uint8 output
DIRTY = 1        # re-solve this row this cycle
SENSITIVE = 2    # result depends on the consumed-capacity environment
CONSUMER = 4     # re-solve may consume capacity beyond the previous rep

#: K12 dispatches (one per incremental cycle), rows classified dirty, and
#: dirty rows / live roster rows of the most recent incremental cycle
COUNTS: Dict[str, float] = {"dispatches": 0, "rows": 0,
                            "dirty_fraction": 0.0}

DIRTY_DISPATCHES = REGISTRY.counter(
    "karmada_incremental_dirty_kernel_dispatches_total",
    "Dirty-set kernel dispatches (one per incremental cycle)",
)
DIRTY_ROWS = REGISTRY.counter(
    "karmada_incremental_dirty_rows_total",
    "Binding rows classified dirty by the incremental dirty-set kernel "
    "(re-solved as the cycle's compact sub-batch instead of the full "
    "roster)",
)
DIRTY_FRACTION = REGISTRY.gauge(
    "karmada_incremental_dirty_fraction",
    "Dirty rows / live roster rows in the most recent incremental cycle "
    "(the steady-state win is 1 minus this, roughly)",
)

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


def normalise_rv(rv_slots) -> np.ndarray:
    """The rv list dirty_codes hands K12: an int64 copy in ascending
    order, which lets each block find its run by a search.
    Pads (-1), duplicates and slots >= cap may stay: they sort before or
    after every block's run or write the same byte twice, as the plain
    pass drops them (a sort alone costs a third of np.unique's dedupe on
    1,000 slots)."""
    return np.sort(np.asarray(rv_slots, np.int64).reshape(-1))


# -- K12's launch path on the card ---------------------------------------------

#: kernels.DIRTY_CALL's slots in the int64 call block
_AT = kernels.block_offsets(kernels.DIRTY_CALL)
_F0, _NF = _AT["fields"], len(kernels.DIRTY_DEVICE_FIELDS)
(_REG, _FLIPS, _RV, _OUT, _HOST, _CAP, _P, _KP, _KE, _F, _S, _VEC, _STAGED,
 _DBUF, _PIN, _PIN_BYTES) = (_AT[f] for f in (
    "region_sc", "flips", "rv", "out", "host_out", "cap", "P", "Kp", "Ke",
    "F", "S", "vec", "staged", "dbuf", "pin", "pin_bytes"))
_ALIGN = 16


class _Workspace:
    """K12's call block and buffers on one card: the block (an int64
    ``array("q")`` laid out like dirty.cu DirtyCall) points at the last
    validated operand set (kernels.DIRTY_DEVICE_FIELDS: weak references
    and each tensor's data_ptr -- a live tensor keeps its dtype, and its
    shape short of an in-place resize, which the plane never makes: it
    re-places a mirror -- checked in full again on any change; the
    plane's mirror syncs scatter in place, so the set changes only when a
    mirror is re-placed) with its shapes and vector flag; dirty_codes' device codes and their pinned copy (made at its
    first call, grown with the store); the pinned buffer its staged
    inputs go through and the device buffer they land in (a staged call
    has synchronised before it returns, so the next one reuses them)."""

    __slots__ = ("device", "dev", "blk", "refs", "sig", "out", "host",
                 "host_np", "pin", "dbuf")

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.dev = device.index
        self.blk = array("q", [0] * _AT["len"])
        self.refs: Optional[list] = None
        self.sig: Optional[list] = None
        self.out = self.host = self.host_np = None
        self.pin = self.dbuf = None

    def bind(self, ts) -> None:
        """Point the block at the operand set `ts` (DIRTY_DEVICE_FIELDS
        order)."""
        if self.refs is not None and all(
                r() is t for r, t in zip(self.refs, ts)) and \
                [t.data_ptr() for t in ts] == self.sig:
            return
        cap = ts[0].shape[0]
        Kp, Ke = ts[5].shape[1], ts[7].shape[1]
        P, C = ts[10].shape
        B8, I32 = torch.bool, torch.int32
        spec = ((I32, (cap,)), (I64, (cap,)), (B8, (cap,)), (B8, (cap,)),
                (I32, (cap,)), (I32, (cap, Kp)), (I32, (cap, Kp)),
                (I32, (cap, Ke)), (B8, (C,)), (B8, (C,)), (B8, (P, C)),
                (I32, (P,)), (B8, (P,)))
        for t, (dt, shape) in zip(ts, spec):
            kernels.check(t, dt, shape)
        if any(t.device != self.device for t in ts):
            raise ValueError(f"K12's operands lie on "
                             f"{sorted({str(t.device) for t in ts})}, not "
                             f"{self.device}")
        blk = self.blk
        blk[_F0:_F0 + _NF] = array("q", (t.data_ptr() for t in ts))
        blk[_CAP], blk[_AT["C"]], blk[_P], blk[_KP], blk[_KE] = \
            cap, C, P, Kp, Ke
        # 16-byte vector loads of the prev / evict rows
        blk[_VEC] = int(Kp % 4 == 0 and Ke % 4 == 0 and Kp > 0 and Ke > 0
                        and all(t.data_ptr() % _ALIGN == 0
                                for t in ts[5:8]))
        self.refs = [weakref.ref(t) for t in ts]
        self.sig = [t.data_ptr() for t in ts]

    def codes(self, cap: int) -> None:
        """dirty_codes' device codes and pinned copy hold `cap` bytes."""
        if self.out is not None and self.out.shape[0] >= cap:
            return
        self.out = torch.empty((cap,), dtype=torch.uint8, device=self.device)
        self.host = torch.empty((cap,), dtype=torch.uint8, pin_memory=True)
        self.host_np = self.host.numpy()

    def stage(self, need: int) -> None:
        """The pinned and the device staging buffers hold `need` bytes."""
        blk = self.blk
        have = blk[_PIN_BYTES]
        if have >= need:
            return
        size = -(-max(need, 2 * have, 4096) // _ALIGN) * _ALIGN
        self.pin = torch.empty((size,), dtype=torch.uint8, pin_memory=True)
        self.dbuf = torch.empty((size,), dtype=torch.uint8,
                                device=self.device)
        blk[_PIN], blk[_PIN_BYTES] = self.pin.data_ptr(), size
        blk[_DBUF] = self.dbuf.data_ptr()


#: one K12 workspace a card, by device index
_WS: Dict[int, _Workspace] = {}


def _workspace(device: torch.device) -> _Workspace:
    ws = _WS.get(device.index)
    if ws is None:
        ws = _WS[device.index] = _Workspace(device)
    return ws


def _launch(ws: _Workspace) -> None:
    kernels.launch("dirty", ws.blk, "dirty_codes",
                   count="dirty_codes" if ws.blk[_CAP] > 0 else None,
                   device=ws.dev)


def dirty_kernel(placement_id, replicas, fresh, non_workload, route,
                 prev_idx, prev_val, evict_idx, cluster_valid, deleting,
                 pl_mask, pl_strategy, pl_has_cluster_sc, pl_has_region_sc,
                 flip_lanes, rv_slots):
    """K12 on CUDA tensors, dirty_kernel_plain on CPU ones; same
    contract.  On the card rv_slots is sorted first (the kernel searches
    an ascending list; dirty_codes sorts on the host instead)."""
    args = (placement_id, replicas, fresh, non_workload, route, prev_idx,
            prev_val, evict_idx, cluster_valid, deleting, pl_mask,
            pl_strategy, pl_has_cluster_sc)
    # the card's path checks its operands in bind and below (its cost is
    # its host time); a CPU placement_id takes the plain version, or
    # raises on operands on mixed devices
    if not placement_id.is_cuda and not _on_cuda(
            *args, pl_has_region_sc, flip_lanes, rv_slots):
        return dirty_kernel_plain(*args, pl_has_region_sc, flip_lanes,
                                  rv_slots)
    ws = _WS.get(placement_id.get_device()) or _workspace(
        placement_id.device)
    ws.bind(args)
    blk = ws.blk
    F, S = flip_lanes.shape[0], rv_slots.shape[0]
    for t, dt, shape in ((pl_has_region_sc, torch.bool, (blk[_P],)),
                         (flip_lanes, I64, (F,)), (rv_slots, I64, (S,))):
        if not (t.is_cuda and t.dtype == dt and t.shape == shape
                and t.is_contiguous()):
            kernels.check(t, dt, shape)  # raises with the reason
    rv = torch.sort(rv_slots).values if S > 1 else rv_slots
    out = torch.empty((blk[_CAP],), dtype=torch.uint8, device=ws.device)
    blk[_REG], blk[_FLIPS], blk[_RV] = (pl_has_region_sc.data_ptr(),
                                        flip_lanes.data_ptr(), rv.data_ptr())
    blk[_OUT], blk[_HOST], blk[_F], blk[_S] = out.data_ptr(), 0, F, S
    blk[_STAGED] = 0
    _launch(ws)
    return out


def _pad_lanes(arr, lo: int = 8) -> np.ndarray:
    """-1-pad to the next pow2 bucket (JAX: stable jit signatures; kept
    so both packages hand their plain passes the same operands)."""
    arr = np.asarray(arr, np.int64).reshape(-1)
    n = T._next_pow2(max(arr.size, 1), lo)  # noqa: SLF001
    out = np.full(n, -1, np.int64)
    out[:arr.size] = arr
    return out


def dirty_codes(state, rv_slots: np.ndarray,
                mirrors: Optional[dict] = None) -> np.ndarray:
    """The dirty pass over a ResidentState's slot store on its device:
    the uint8 [cap] code plane as numpy (DIRTY / SENSITIVE / CONSUMER
    bits), a copy the caller owns.  `rv_slots`: slots of rows the window
    (or the solver's own write-backs) touched.  `mirrors`: the fused
    path's device slot mirrors (no binding-axis upload); None uploads the
    host masters once.  The cluster-side fields come from the plane's
    device mirrors, brought up to the masters that begin_cycle has just
    advanced by the K10 sync the next encode would run
    (ResidentState.sync_device), so nothing of them is uploaded.

    On a card it is one C call on the card's workspace: the flip lanes,
    the normalised rv list (normalise_rv) and pl_has_region_sc staged
    through the pinned buffer in one upload, one K12 launch, the codes
    copied into pinned memory and the stream synchronised."""
    state.sync_device()
    p = state.plane
    dm = state.device_mirrors.mirrors
    slot = [mirrors[f] if mirrors else _to_dev(getattr(p, f), state.device)
            for f in SLOT_FIELDS]
    ops = slot + [dm[f] for f in PLANE_FIELDS[:-1]]
    cap = p.placement_id.shape[0]
    if state.device.type != "cuda":
        codes = dirty_kernel_plain(
            *ops, torch.from_numpy(np.array(p.pl_has_region_sc, bool)),
            torch.from_numpy(_pad_lanes(state.last_flip_lanes)),
            torch.from_numpy(_pad_lanes(rv_slots))).numpy()
        COUNTS["dispatches"] += 1
        DIRTY_DISPATCHES.inc()
        return codes
    ws = _workspace(state.device)
    ws.bind(ops)
    blk = ws.blk
    flips = np.ascontiguousarray(state.last_flip_lanes, np.int64)
    rv = normalise_rv(rv_slots)
    reg = np.ascontiguousarray(p.pl_has_region_sc, np.bool_)
    if flips.ndim != 1 or reg.shape != (blk[_P],):
        raise ValueError(f"flip lanes shape {flips.shape}, region_sc shape "
                         f"{reg.shape}, expected (F,) and ({blk[_P]},)")
    ws.stage(8 * (flips.size + rv.size) + reg.size)
    ws.codes(cap)
    blk[_REG], blk[_FLIPS], blk[_RV] = (reg.ctypes.data, flips.ctypes.data,
                                        rv.ctypes.data)
    blk[_OUT], blk[_HOST] = ws.out.data_ptr(), ws.host.data_ptr()
    blk[_F], blk[_S], blk[_STAGED] = flips.size, rv.size, 1
    _launch(ws)
    COUNTS["dispatches"] += 1
    DIRTY_DISPATCHES.inc()
    return ws.host_np[:cap].copy()
