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
  scatter_fields(items, device)    every (dst, lanes, values, mode) entry
                                   of a mirror sync in one K10 launch

The single-field calls write `dst` in place and return it; their operands
are already on the card.  scatter_fields is what a mirror sync calls: it
stages every entry's host lanes and values in one host byte buffer (each
segment 16-byte aligned; a lane list that several entries share is
staged once), uploads it with one H2D copy, and launches K10 once over a
descriptor table of the entries (DESC_COLUMNS), SCATTER_FIELDS entries
at most per launch: a longer call is split into several launches (counted
in COUNTS["scatter_splits"]).  The staged host buffer is allocated per
call and is pageable, so the non-blocking copy has taken its bytes when
it returns; the device buffer comes from the caching allocator on the
launch stream, so its reuse is ordered after the launch.

K10 (ops/csrc/resident.cu; launch counter "scatter_lanes") runs on CUDA
tensors, the plain versions on CPU ones.  scatter_fields_plain consumes
the same staged buffer and descriptor table as the kernel, so the CPU
tests cover the packing, the alignment and the dtype views.  The JAX
package's copy-on-write flavour (scatter_rows_cow) is kept as a copy plus
the in-place scatter: the port's resident plane does not need it, since a
gather enqueued before a scatter on the one stream finishes before the
scatter runs and writes its own output buffers.

K10 takes any lane count, so nothing on the port's path pads a lane
list.  pad_lanes / pad_lanes_cols stay as the JAX package's pow2 bucket
(its jit shapes need it): a padded scatter repeats the last (lane, value)
pair, and duplicate lanes that carry equal values land in any order.
"""

from __future__ import annotations

from array import array
from typing import List, NamedTuple, Sequence

import numpy as np
import torch

from karmada_tpu_torch.ops import kernels
from karmada_tpu_torch.ops.resident_gather import COUNTS
from karmada_tpu_torch.ops.solver import _on_cuda
from karmada_tpu_torch.ops.tensors import _next_pow2

#: one K10 descriptor, in the kernel's ScatterEntry order: dst address,
#: byte offsets of the lanes and the values from the staged buffer (or
#: addresses, with base 0), the [outer, D, inner] view of dst, the lane
#: count, the element size and the running element start within the
#: entry's table (one launch's SCATTER_FIELDS entries)
DESC_COLUMNS = ("dst", "lanes", "vals", "outer", "D", "inner", "L", "elem",
                "start")
#: entries of one K10 launch (resident.cu KT_SCATTER_FIELDS)
SCATTER_FIELDS = 16
_ALIGN = 16
_NP_DTYPE = {torch.bool: np.dtype(np.bool_), torch.int32: np.dtype(np.int32),
             torch.int64: np.dtype(np.int64)}


def scatter_rows_plain(dst, lanes, rows):
    """dst[lanes, ...] = rows, in place; returns dst."""
    dst[lanes] = rows
    return dst


def scatter_cols_plain(dst, lanes, cols):
    """dst[:, lanes] = cols, in place; returns dst."""
    dst[:, lanes] = cols
    return dst


# ---------------------------------------------------------------------------
# the fused scatter of a mirror sync
# ---------------------------------------------------------------------------

class Staged(NamedTuple):
    """One scatter_fields call's staging: the destinations, the host byte
    buffer of lanes and values, and one DESC_COLUMNS row per entry."""
    dsts: List[torch.Tensor]
    buf: np.ndarray
    desc: List[List[int]]


def _geometry(dst, mode: str):
    if not dst.is_contiguous():
        raise ValueError("scatter destination is not contiguous")
    if mode == "rows":
        inner = 1
        for s in dst.shape[1:]:
            inner *= int(s)
        return 1, int(dst.shape[0]), inner
    if mode == "cols":
        if dst.dim() != 2:
            raise ValueError("a column scatter takes a 2-D destination")
        return int(dst.shape[0]), int(dst.shape[1]), 1
    raise ValueError(f"scatter mode {mode!r}: expected 'rows' or 'cols'")


def stage_fields(items: Sequence) -> Staged:
    """Pack `items` -- (dst, lanes, values, mode) with host (numpy) lanes
    and values, mode "rows" (dst[lanes] = values) or "cols" (dst[:, lanes]
    = values) -- into one byte buffer and a descriptor table.  Entries
    that write nothing are left out.  Raises on a lane outside dst's lane
    axis, a values array of another dtype or shape, or a destination that
    is not contiguous."""
    dsts, desc, segs = [], [], []
    lane_seg = {}  # id(lanes) -> (offset, lo, hi): a shared list staged once
    off = start = 0
    for dst, lanes, values, mode in items:
        outer, D, inner = _geometry(dst, mode)
        seg = lane_seg.get(id(lanes))
        if seg is None:
            la = np.ascontiguousarray(lanes)
            if la.dtype != np.int64 or la.ndim != 1:
                raise TypeError(f"scatter lanes {la.dtype} {la.shape}: "
                                "expected int64 [L]")
            lo, hi = (int(la.min()), int(la.max())) if la.size else (0, -1)
            seg = (off, lo, hi)
            lane_seg[id(lanes)] = seg
            segs.append((off, la))
            off += -(-la.nbytes // _ALIGN) * _ALIGN
        lane_off, lo, hi = seg
        L = len(lanes)
        if L and (lo < 0 or hi >= D):
            raise IndexError(f"scatter lanes [{lo}, {hi}] outside [0, {D})")
        vals = np.ascontiguousarray(values)
        want = _NP_DTYPE.get(dst.dtype)
        if want is None:
            raise TypeError(f"no K10 instantiation for {dst.dtype}")
        shape = ((L,) + tuple(dst.shape[1:]) if mode == "rows"
                 else (outer, L))
        if vals.dtype != want or vals.shape != shape:
            raise TypeError(f"scatter values {vals.dtype} {vals.shape} do "
                            f"not fit {shape} {want}")
        n = outer * L * inner
        if n == 0:
            continue
        if len(desc) % SCATTER_FIELDS == 0:
            start = 0  # each launch's table starts its own element count
        dsts.append(dst)
        desc.append([dst.data_ptr(), lane_off, off, outer, D, inner, L,
                     dst.element_size(), start])
        segs.append((off, vals))
        off += -(-vals.nbytes // _ALIGN) * _ALIGN
        start += n
    buf = np.empty(off, np.uint8)
    for o, a in segs:
        buf[o:o + a.nbytes] = a.reshape(-1).view(np.uint8)
    return Staged(dsts, buf, desc)


def _tables(desc):
    for k in range(0, len(desc), SCATTER_FIELDS):
        yield k, desc[k:k + SCATTER_FIELDS]


def scatter_fields_plain(dsts, staged: torch.Tensor, desc) -> None:
    """Apply a staged descriptor table with torch indexing: the plain
    version of K10 over the same bytes the kernel reads (`staged` uint8 on
    the CPU), table by table as the kernel's launches go."""
    for k, table in _tables(desc):
        COUNTS["scatter_tables"] += 1
        for dst, (_, lo, vo, outer, D, inner, L, elem, _s) in zip(
                dsts[k:], table):
            lanes = staged[lo:lo + 8 * L].view(torch.int64)
            vals = staged[vo:vo + outer * L * inner * elem].view(
                dst.dtype).reshape(outer, L, inner)
            dst.view(outer, D, inner)[:, lanes] = vals


def scatter_staged(dsts, staged: torch.Tensor, desc) -> None:
    """K10 over a staged descriptor table whose buffer is already on the
    card: one launch per SCATTER_FIELDS entries."""
    if staged.dtype != torch.uint8 or not staged.is_cuda or (
            not staged.is_contiguous()):
        raise ValueError("the staged buffer must be a contiguous CUDA uint8 "
                         "tensor")
    for dst in dsts:
        if not dst.is_cuda:
            raise ValueError(f"scatter destination on {dst.device}, "
                             "expected cuda")
    base, dev = staged.data_ptr(), staged.get_device()
    for _k, table in _tables(desc):
        block = array("q", (base, len(table)))
        for row in table:
            block.extend(row)
        kernels.launch("resident", block, "scatter_lanes",
                       count="scatter_lanes", device=dev)
        COUNTS["scatter_tables"] += 1


def scatter_fields(items: Sequence, device) -> None:
    """Every (dst, lanes, values, mode) entry of `items` in one staged
    upload and one K10 launch per SCATTER_FIELDS entries on a CUDA
    `device`, through scatter_fields_plain on the CPU.  `lanes` and
    `values` are host arrays (int64 [L]; rows: [L, *dst.shape[1:]], cols:
    [dst.shape[0], L] of dst's dtype); the entries may differ in lanes,
    dtype and mode.  Entries must not write one element twice with
    different values.  An empty list stages and launches nothing."""
    if not items:
        return
    st = stage_fields(items)
    if not st.desc:
        return
    cuda = _on_cuda(*st.dsts)
    if cuda != (torch.device(device).type == "cuda"):
        raise ValueError(f"scatter destinations do not lie on {device}")
    COUNTS["scatter_fields"] += len(st.desc)
    COUNTS["scatter_staged"] += 1
    if len(st.desc) > SCATTER_FIELDS:
        COUNTS["scatter_splits"] += 1
    if cuda:
        scatter_staged(st.dsts, torch.from_numpy(st.buf).to(
            device, non_blocking=True), st.desc)
    else:
        scatter_fields_plain(st.dsts, torch.from_numpy(st.buf), st.desc)


# ---------------------------------------------------------------------------
# the single-field calls: one-entry tables of the same kernel
# ---------------------------------------------------------------------------

def _launch_one(dst, lanes, src, outer: int, D: int, inner: int) -> None:
    """K10 over dst viewed as [outer, D, inner], src [outer, L, inner],
    all three on the card (a CPU operand among them raises): a one-entry
    table with base 0."""
    L = lanes.shape[0]
    if lanes.dtype != torch.int64 or lanes.dim() != 1:
        raise TypeError(f"scatter lanes {lanes.dtype} {tuple(lanes.shape)}: "
                        "expected int64 [L]")
    if src.dtype != dst.dtype or src.numel() != outer * L * inner:
        raise ValueError(f"scatter source {tuple(src.shape)} {src.dtype} "
                         f"does not fit [{outer}, {L}, {inner}] {dst.dtype}")
    for t in (dst, lanes, src):
        if not (t.is_cuda and t.is_contiguous()):
            raise ValueError("scatter operands must be contiguous CUDA "
                             "tensors")
    elem = dst.element_size()
    if elem not in (1, 4, 8):
        raise TypeError(f"no K10 instantiation for {dst.dtype}")
    if outer * L * inner == 0:
        return
    kernels.launch("resident", array("q", (
        0, 1, dst.data_ptr(), lanes.data_ptr(), src.data_ptr(), outer, D,
        inner, L, elem, 0)), "scatter_lanes", count="scatter_lanes",
        device=dst.get_device())


def scatter_rows(dst, lanes, rows):
    """K10 in row mode on CUDA tensors, scatter_rows_plain on CPU ones;
    `lanes` int64 [L] (each in [0, dst.shape[0])), `rows` [L, ...] of
    dst's dtype."""
    if not (dst.is_cuda or lanes.is_cuda or rows.is_cuda):
        return scatter_rows_plain(dst, lanes, rows)
    D = dst.shape[0]
    _launch_one(dst, lanes, rows, 1, D, dst.numel() // D if D else 0)
    return dst


def scatter_cols(dst, lanes, cols):
    """K10 in column mode on a CUDA [outer, D] tensor, scatter_cols_plain
    on a CPU one; `cols` [outer, L]."""
    if not (dst.is_cuda or lanes.is_cuda or cols.is_cuda):
        return scatter_cols_plain(dst, lanes, cols)
    if dst.dim() != 2:
        raise ValueError("scatter_cols takes a 2-D destination")
    _launch_one(dst, lanes, cols, dst.shape[0], dst.shape[1], 1)
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
