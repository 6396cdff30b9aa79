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
CUDA tensors, score_kernel_plain on CPU ones.
"""

from __future__ import annotations

from typing import Optional, Tuple

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


def score_kernel(committed: torch.Tensor, capacity: torch.Tensor,
                 valid: torch.Tensor, threshold_milli: int,
                 spread_tol_milli: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K13 on CUDA tensors, score_kernel_plain on CPU ones; same
    contract.  Zero lanes launch nothing."""
    from karmada_tpu_torch.ops.solver import _on_cuda

    if not _on_cuda(committed, capacity, valid):
        return score_kernel_plain(committed, capacity, valid,
                                  threshold_milli, spread_tol_milli)
    C = committed.shape[0]
    for t, dt in ((committed, _I64), (capacity, _I64), (valid, torch.bool)):
        kernels.check(t, dt, (C,))
    outs = tuple(torch.empty(C, dtype=_I64, device=committed.device)
                 for _ in range(3))
    if C == 0:
        return outs
    args = kernels.ScoreArgs(
        kernels.ptr(committed), kernels.ptr(capacity), kernels.ptr(valid),
        *(kernels.ptr(o) for o in outs),
        C, int(threshold_milli), int(spread_tol_milli))
    kernels.launch("rebalance", args, entry="rebalance_score",
                   count="rebalance_score")
    return outs


def score(committed: np.ndarray, capacity: np.ndarray, valid: np.ndarray,
          threshold_milli: int, spread_tol_milli: int, device=None,
          timing: Optional[dict] = None):
    """Host wrapper: (drain_need, over_milli, div_milli) as int64 numpy
    arrays, scored on `device` (the first CUDA card by default; "cpu" runs
    the plain version).  With `timing` (a dict) on a card, the kernel's
    time between CUDA events lands in timing["kernel_ms"]."""
    dev = resolve_device(device)
    com = torch.from_numpy(np.ascontiguousarray(committed, np.int64)).to(dev)
    cap = torch.from_numpy(np.ascontiguousarray(capacity, np.int64)).to(dev)
    val = torch.from_numpy(np.ascontiguousarray(valid, bool)).to(dev)
    if timing is not None and dev.type == "cuda":
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        outs = score_kernel(com, cap, val, threshold_milli, spread_tol_milli)
        t1.record()
        t1.synchronize()
        timing["kernel_ms"] = t0.elapsed_time(t1)
    else:
        outs = score_kernel(com, cap, val, threshold_milli, spread_tol_milli)
    return tuple(o.cpu().numpy() for o in outs)
