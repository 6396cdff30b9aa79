"""Scatter updates of the resident plane's device mirrors (K10).

Counterpart of the JAX package's ``ops/resident_update.py``.  The resident
plane (resident/state.py) keeps the cluster-side solver tensors and the
binding-row slot store on the card between cycles; a watch delta touches a
handful of lanes, so a mirror advances by a scatter of the churned rows or
columns instead of a re-upload:

  scatter_rows(dst, lanes, rows)   dst[lanes, ...] = rows  (lane axis
                                   first: the [C] / [C, R] capacity
                                   tensors and the [cap] / [cap, K] slot
                                   store)
  scatter_cols(dst, lanes, cols)   dst[:, lanes] = cols    (lane axis
                                   last: est_override [Q, C], api_ok
                                   [G, C])

Both write `dst` in place and return it.  K10 (ops/csrc/resident.cu;
launch counter "scatter_lanes") runs on CUDA tensors, the plain versions on
CPU ones.  The JAX package's copy-on-write flavour (scatter_rows_cow) is
kept as a copy plus the in-place scatter: the port's resident plane does
not need it, since a gather enqueued before a scatter on the one stream
finishes before the scatter runs and writes its own output buffers.

Callers pad the lanes to a power-of-two bucket (pad_lanes /
pad_lanes_cols) by repeating the last (lane, value) pair: the duplicates
rewrite equal values, so their order never matters.
"""

from __future__ import annotations

import numpy as np
import torch

from karmada_tpu_torch.ops import kernels
from karmada_tpu_torch.ops.solver import _on_cuda
from karmada_tpu_torch.ops.tensors import _next_pow2


def scatter_rows_plain(dst, lanes, rows):
    """dst[lanes, ...] = rows, in place; returns dst."""
    dst[lanes] = rows
    return dst


def scatter_cols_plain(dst, lanes, cols):
    """dst[:, lanes] = cols, in place; returns dst."""
    dst[:, lanes] = cols
    return dst


def _launch(dst, lanes, src, outer: int, D: int, inner: int) -> None:
    """K10 over dst viewed as [outer, D, inner], src [outer, L, inner]."""
    L = lanes.shape[0]
    kernels.check(lanes, torch.int64, (L,))
    if src.dtype != dst.dtype or src.numel() != outer * L * inner:
        raise ValueError(f"scatter source {tuple(src.shape)} {src.dtype} "
                         f"does not fit [{outer}, {L}, {inner}] {dst.dtype}")
    if not (dst.is_cuda and src.is_cuda and dst.is_contiguous()
            and src.is_contiguous()):
        raise ValueError("scatter operands must be contiguous CUDA tensors")
    elem = dst.element_size()
    if elem not in (1, 4, 8):
        raise TypeError(f"no K10 instantiation for {dst.dtype}")
    kernels.launch("resident", kernels.ScatterArgs(
        kernels.ptr(dst), kernels.ptr(src), kernels.ptr(lanes), outer, D,
        inner, L, elem), "scatter_lanes", count="scatter_lanes")


def scatter_rows(dst, lanes, rows):
    """K10 in row mode on CUDA tensors, scatter_rows_plain on CPU ones;
    `lanes` int64 [L] (each in [0, dst.shape[0])), `rows` [L, ...] of
    dst's dtype."""
    if not _on_cuda(dst, lanes, rows):
        return scatter_rows_plain(dst, lanes, rows)
    inner = int(np.prod(dst.shape[1:], dtype=np.int64))
    _launch(dst, lanes, rows, 1, int(dst.shape[0]), inner)
    return dst


def scatter_cols(dst, lanes, cols):
    """K10 in column mode on a CUDA [outer, D] tensor, scatter_cols_plain
    on a CPU one; `cols` [outer, L]."""
    if not _on_cuda(dst, lanes, cols):
        return scatter_cols_plain(dst, lanes, cols)
    if dst.dim() != 2:
        raise ValueError("scatter_cols takes a 2-D destination")
    _launch(dst, lanes, cols, int(dst.shape[0]), int(dst.shape[1]), 1)
    return dst


def scatter_rows_cow(dst, lanes, rows):
    """dst[lanes, ...] = rows on a copy of dst (JAX: scatter_rows_cow)."""
    return scatter_rows(dst.clone(), lanes, rows)


def _pad(lanes, data, lane_axis: int):
    """Pow2-bucket a (lanes, data) scatter (floor 8) by repeating the LAST
    lane/value pair.  Host-side: numpy in, numpy out."""
    k = len(lanes)
    cap = _next_pow2(k, 8)
    data = np.asarray(data)
    if cap == k:
        return np.asarray(lanes), data
    lanes2 = np.empty(cap, np.int64)
    lanes2[:k] = lanes
    lanes2[k:] = lanes[-1]
    shape = list(data.shape)
    shape[lane_axis] = cap
    data2 = np.empty(tuple(shape), data.dtype)
    src = [slice(None)] * data.ndim
    src[lane_axis] = slice(0, k)
    pad = [slice(None)] * data.ndim
    pad[lane_axis] = slice(k, None)
    last = [slice(None)] * data.ndim
    last[lane_axis] = slice(k - 1, k)
    data2[tuple(src)] = data
    data2[tuple(pad)] = data[tuple(last)]
    return lanes2, data2


def pad_lanes(lanes, rows):
    """Pad a row scatter (rows carry the lane axis first)."""
    return _pad(lanes, rows, 0)


def pad_lanes_cols(lanes, cols):
    """Pad a column scatter (cols carry the lane axis last)."""
    return _pad(lanes, cols, -1)
