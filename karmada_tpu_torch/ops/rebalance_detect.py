"""Rebalance detect: per-cluster overcommit and spread divergence (K13).

Counterpart of the JAX package's ``ops/rebalance_detect.py``.  Every
rebalance interval the plane (rebalance/plane.py) scores the fleet: how
overcommitted each cluster is against its capacity, and how far its share
of the committed replicas diverges from its share of the capacity.  All
math is int64 in milli units (ratios x1000), no float anywhere, so the
drain plan is the same on every device.

Outputs per cluster:
  drain_need   replicas to shed to get back inside the thresholds (the
               larger of the overcommit need and the gated spread need)
  over_milli   committed/capacity x1000 (OVER_SATURATED for committed load
               on a cluster with zero capacity)
  div_milli    committed share minus capacity share, x1000

K13 (ops/csrc/rebalance.cu; launch counter "rebalance_score") runs on
CUDA tensors, score_kernel_plain on CPU ones.  The work is tiny, so its
cost on the card is the call: score from numpy is one C call (one
upload, one launch, one download into pinned memory, one synchronise) on
the card's workspace.
"""

from __future__ import annotations

import weakref
from array import array
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from karmada_tpu_torch.device import resolve_device
from karmada_tpu_torch.ops import kernels

#: over_milli for committed load on a cluster with zero usable capacity
OVER_SATURATED = 1 << 30

_I64 = torch.int64


def _fdiv(a: torch.Tensor, b) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def score_kernel_plain(committed: torch.Tensor, capacity: torch.Tensor,
                       valid: torch.Tensor, threshold_milli: int,
                       spread_tol_milli: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(drain_need, over_milli, div_milli) int64 [C] from committed and
    capacity int64 [C] and valid bool [C] (JAX: score_kernel)."""
    zero = torch.zeros_like(committed)
    cap = torch.where(valid, capacity.clamp(min=0), zero)
    com = torch.where(valid, committed.clamp(min=0), zero)
    over_milli = torch.where(
        cap > 0, _fdiv(com * 1000, cap.clamp(min=1)),
        torch.where(com > 0, torch.full_like(com, OVER_SATURATED), zero))
    # overcommit: drain down to floor(threshold * capacity)
    over_need = (com - _fdiv(cap * threshold_milli, 1000)).clamp(min=0)
    # spread divergence: committed share vs capacity share of the fleet
    total_com = com.sum()
    total_cap = cap.sum()
    share = torch.where(total_com > 0,
                        _fdiv(com * 1000, total_com.clamp(min=1)), zero)
    fair = torch.where(total_cap > 0,
                       _fdiv(cap * 1000, total_cap.clamp(min=1)), zero)
    div_milli = share - fair
    # the spread need gates in only above the tolerance: drain down to
    # (fair share + tolerance) of the committed total
    spread_allowed = _fdiv((fair + spread_tol_milli) * total_com, 1000)
    spread_need = torch.where(div_milli > spread_tol_milli,
                              (com - spread_allowed).clamp(min=0), zero)
    drain_need = torch.where(valid, torch.maximum(over_need, spread_need),
                             zero)
    return drain_need, over_milli, div_milli


#: kernels.SCORE_CALL's slots in the int64 call block
_AT = kernels.block_offsets(kernels.SCORE_CALL)
(_COM, _CAP, _VALID, _OUT, _C, _THR, _TOL, _STAGED, _DBUF, _PIN,
 _PIN_BYTES, _TIMED, _NS) = (_AT[f] for f in (
    "committed", "capacity", "valid", "out", "C", "threshold_milli",
    "spread_tol_milli", "staged", "dbuf", "pin", "pin_bytes", "timed",
    "kernel_ns"))


def score_layout(C: int) -> Tuple[int, int]:
    """A staged call's buffer (rebalance.cu kt_rebalance_score): committed
    and capacity (8C each) and valid (C) from byte 0, the three outputs
    (24C) from the first returned offset (16-byte aligned); the second is
    the buffer's size."""
    o_out = -(-17 * C // 16) * 16
    return o_out, o_out + 24 * C


def _free(blk, dev) -> None:
    """A workspace released: its events destroyed once its work is done
    (every staged call has synchronised before it returned, so its
    buffers are free already)."""
    kernels.launch("rebalance", blk, "score_free", device=dev)


class _Workspace:
    """K13's call block (an int64 ``array("q")`` laid out like
    rebalance.cu ScoreCall) and buffers on one card: for score from
    numpy, a pinned buffer and a device buffer of score_layout (grown with
    C), and the two timing events the C entry makes at the first timed
    call (destroyed with the workspace)."""

    __slots__ = ("device", "dev", "blk", "pin", "pin_np", "dbuf", "fin",
                 "__weakref__")

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.dev = device.index
        self.blk = array("q", [0] * _AT["len"])
        self.pin = self.pin_np = self.dbuf = None
        self.fin = weakref.finalize(self, _free, self.blk, self.dev)
        self.fin.atexit = False

    def stage(self, C: int) -> int:
        """The buffers hold a staged call of C lanes; returns the outputs'
        offset."""
        o_out, need = score_layout(C)
        blk = self.blk
        if blk[_PIN_BYTES] < need:
            size = max(need, 2 * blk[_PIN_BYTES])
            self.pin = torch.empty((size,), dtype=torch.uint8,
                                   pin_memory=True)
            self.pin_np = self.pin.numpy()
            self.dbuf = torch.empty((size,), dtype=torch.uint8,
                                    device=self.device)
            blk[_PIN], blk[_DBUF], blk[_PIN_BYTES] = (
                self.pin.data_ptr(), self.dbuf.data_ptr(), size)
        return o_out


#: one K13 workspace a card, by device index
_WS: Dict[int, _Workspace] = {}


def _workspace(device: torch.device) -> _Workspace:
    ws = _WS.get(device.index)
    if ws is None:
        ws = _WS[device.index] = _Workspace(device)
    return ws


def _launch(ws: _Workspace, C: int, threshold_milli: int,
            spread_tol_milli: int) -> None:
    blk = ws.blk
    blk[_C], blk[_THR], blk[_TOL] = C, threshold_milli, spread_tol_milli
    kernels.launch("rebalance", blk, "rebalance_score",
                   count="rebalance_score" if C > 0 else None, device=ws.dev)


def score_kernel(committed: torch.Tensor, capacity: torch.Tensor,
                 valid: torch.Tensor, threshold_milli: int,
                 spread_tol_milli: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K13 on CUDA tensors, score_kernel_plain on CPU ones; same
    contract (the three outputs are the rows of one [3, C] tensor).  Zero
    lanes launch nothing."""
    cuda = (committed.is_cuda, capacity.is_cuda, valid.is_cuda)
    if not any(cuda):
        return score_kernel_plain(committed, capacity, valid,
                                  threshold_milli, spread_tol_milli)
    C = committed.shape[0]
    for t, dt in ((committed, _I64), (capacity, _I64), (valid, torch.bool)):
        if not (t.is_cuda and t.dtype == dt and t.shape == (C,)
                and t.is_contiguous()):
            kernels.check(t, dt, (C,))  # raises with the reason
    dev = committed.get_device()
    if capacity.get_device() != dev or valid.get_device() != dev:
        raise ValueError("K13's operands lie on more than one card")
    ws = _WS.get(dev) or _workspace(committed.device)
    out = torch.empty((3, C), dtype=_I64, device=ws.device)
    blk = ws.blk
    blk[_COM], blk[_CAP], blk[_VALID], blk[_OUT] = (
        committed.data_ptr(), capacity.data_ptr(), valid.data_ptr(),
        out.data_ptr())
    blk[_STAGED] = blk[_TIMED] = 0
    _launch(ws, C, int(threshold_milli), int(spread_tol_milli))
    return out.unbind(0)


def score(committed: np.ndarray, capacity: np.ndarray, valid: np.ndarray,
          threshold_milli: int, spread_tol_milli: int, device=None,
          timing: Optional[dict] = None):
    """Host wrapper: (drain_need, over_milli, div_milli) as int64 numpy
    arrays, scored on `device` (the first CUDA card by default; "cpu" runs
    the plain version).  On a card it is one C call on the card's
    workspace: the inputs copied into its pinned buffer and uploaded by
    one copy, one K13 launch, the outputs copied back by one copy into
    pinned memory and one synchronise; the arrays returned are views of
    one copy of them, which the caller owns.  With `timing` (a dict) on a
    card, the kernel's time between CUDA events lands in
    timing["kernel_ms"]."""
    dev = resolve_device(device)
    com = np.ascontiguousarray(committed, np.int64)
    cap = np.ascontiguousarray(capacity, np.int64)
    val = np.ascontiguousarray(valid, np.bool_)
    C = com.shape[0]
    if not com.shape == cap.shape == val.shape == (C,):
        raise ValueError(f"committed {com.shape}, capacity {cap.shape}, "
                         f"valid {val.shape}: expected three [C] lanes")
    if dev.type != "cuda":
        outs = score_kernel_plain(torch.from_numpy(com),
                                  torch.from_numpy(cap),
                                  torch.from_numpy(val), threshold_milli,
                                  spread_tol_milli)
        return tuple(o.numpy() for o in outs)
    ws = _workspace(dev)
    blk = ws.blk
    if C == 0:
        if timing is not None:
            timing["kernel_ms"] = 0.0
        return tuple(np.zeros(0, np.int64) for _ in range(3))
    o_out = ws.stage(C)
    blk[_COM], blk[_CAP], blk[_VALID] = (com.ctypes.data, cap.ctypes.data,
                                         val.ctypes.data)
    blk[_STAGED], blk[_TIMED] = 1, int(timing is not None)
    _launch(ws, C, int(threshold_milli), int(spread_tol_milli))
    if timing is not None:
        timing["kernel_ms"] = blk[_NS] / 1e6
    return _results(ws.pin_np, o_out, C)


def _results(buf: np.ndarray, o_out: int, C: int):
    """The three outputs of a staged call from its buffer (uint8, the
    score_layout): views of one copy, so a later call that refills the
    buffer leaves them as they are."""
    res = buf[o_out:o_out + 24 * C].view(np.int64).copy()
    return res[:C], res[C:2 * C], res[2 * C:]
