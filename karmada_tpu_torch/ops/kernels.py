"""Build, binding and launch counters of the port's Hopper kernels.

The CUDA C++ sources live in ``ops/csrc/``.  Each ``*.cu`` compiles with
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface
(no PyTorch headers, so a build takes seconds), all sources at once in
parallel, at first use, into a build directory keyed by the sources'
hash.  The libraries load with ``ctypes``; each C entry takes a pointer to
an argument block and the CUDA stream, launches on that stream, and
returns ``cudaGetLastError()``.  An argument block is a ctypes struct
(mirrored below) or, where the launch is on a hot path, an
``array.array("q")`` laid out like the C struct (a pointer and an int64
are both 8 bytes), which is cheaper to build.

The launch path is lean because the small kernels' time on the card is
their host cost: once every library is loaded, ``build()`` returns
without taking its lock, each C entry is resolved once into ``_FNS``,
and the stream handle is read with the operands' device index by
PyTorch's raw accessor (``torch._C._cuda_getCurrentRawStream``, which makes
no Stream object; ``torch.cuda.current_stream`` where a build lacks it).

Nothing here runs at import time: the CPU tests import every module, and
``nvcc`` is needed only once a CUDA tensor reaches a kernel wrapper.
"""

from __future__ import annotations

import array
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Union

import torch

from karmada_tpu_torch.utils.metrics import REGISTRY

CSRC = Path(__file__).resolve().parent / "csrc"
#: kernel sources (ops/csrc/<source>.cu), one library each
SOURCES = ("capacity", "schedule_rows", "compact", "webster_batch",
           "spread_group_info", "spread_pick", "explain", "shortlist",
           "resident", "dirty", "rebalance", "probe")
#: C entry points (kt_<entry>) of each source's library
ENTRIES = {"capacity": ("capacity",),
           "schedule_rows": ("schedule_rows_wave", "schedule_rows_big_wave"),
           "compact": ("compact",),
           "webster_batch": ("webster_batch", "webster_floordiv"),
           "spread_group_info": ("spread_group_info",),
           "spread_pick": ("spread_pick",),
           "explain": ("explain_rows", "explain_rows_spread"),
           "shortlist": ("shortlist_topk", "group_sums"),
           "resident": ("scatter_lanes", "gather_rows", "gather_ring_init",
                        "gather_ring_free"),
           "dirty": ("dirty_codes",),
           "rebalance": ("rebalance_score", "score_free"),
           "probe": ("probe_mm", "marker_affine")}
#: the kernels, by launch counter: K2's big-tier instantiation counts
#: apart from the std one it shares a source with; K7's spread flavour
#: counts as explain_rows; K8 and K9 share a source, as do K10 and K11,
#: and K14 and K15
KERNELS = ("capacity", "schedule_rows", "schedule_rows_big", "compact",
           "webster_batch", "spread_group_info", "spread_pick",
           "explain_rows", "shortlist_topk", "group_sums", "scatter_lanes",
           "gather_rows", "dirty_codes", "rebalance_score", "probe_mm",
           "marker_affine")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: launches per kernel since the last reset_counts(); a wrapper adds one
#: where it launches its kernel and nowhere else
LAUNCHES: Dict[str, int] = {k: 0 for k in KERNELS}

_LIBS: Dict[str, ctypes.CDLL] = {}
#: the C entries, by entry name, resolved once when the libraries load
_FNS: Dict[str, ctypes._CFuncPtr] = {}
#: the built libraries' paths once every one is loaded (build's fast path)
_PATHS: Dict[str, Path] = {}
_LOCK = threading.Lock()
#: nvcc's output (registers, shared memory, spills) per kernel source
BUILD_LOG: Dict[str, str] = {}
#: libraries build() found already built ("hits") and compiled ("misses")
#: in this process
BUILDS: Dict[str, int] = {"hits": 0, "misses": 0}
# the JAX package's compile-cache families (its ops/aotcache.py): here a
# library found built is a hit, one nvcc compiles a miss
COMPILE_CACHE_HITS = REGISTRY.counter(
    "karmada_solver_compile_cache_hits_total",
    "Solver executables served from the persistent compilation cache",
)
COMPILE_CACHE_MISSES = REGISTRY.counter(
    "karmada_solver_compile_cache_misses_total",
    "Solver compilations the persistent compilation cache could not serve",
)


def reset_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build_dir() -> Path:
    """Where the libraries are built: $KARMADA_TORCH_BUILD_DIR, else
    ``ops/_build`` inside the checkout (listed in .gitignore)."""
    env = os.environ.get("KARMADA_TORCH_BUILD_DIR")
    return Path(env) if env else Path(__file__).resolve().parent / "_build"


def _nvcc() -> str:
    cand = [shutil.which("nvcc"),
            os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                         "bin", "nvcc")]
    for c in cand:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Dict[str, Path]:
    """Compile every kernel source (one nvcc per source, all started
    together) unless this source hash was built already; load them all.
    Raises with nvcc's output when a build fails.  Once every library is
    loaded it returns without taking the lock."""
    if _PATHS:
        return _PATHS
    with _LOCK:
        if _PATHS:
            return _PATHS
        out_dir = build_dir() / digest()
        out_dir.mkdir(parents=True, exist_ok=True)
        paths = {k: out_dir / f"lib{k}.so" for k in SOURCES}
        procs = {}
        nvcc = _nvcc()
        for k in SOURCES:
            if paths[k].exists():
                BUILDS["hits"] += 1
                COMPILE_CACHE_HITS.inc()
                continue
            BUILDS["misses"] += 1
            COMPILE_CACHE_MISSES.inc()
            tmp = out_dir / f"lib{k}.so.tmp{os.getpid()}"
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                   str(CSRC / f"{k}.cu")]
            procs[k] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True),
                        tmp)
        failed = []
        for k, (proc, tmp) in procs.items():
            log, _ = proc.communicate()
            BUILD_LOG[k] = log
            if verbose:
                print(f"[nvcc {k}.cu]\n{log.rstrip()}", flush=True)
            if proc.returncode != 0:
                failed.append(f"{k}.cu (rc {proc.returncode}):\n{log}")
            else:
                os.replace(tmp, paths[k])
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
        for k in SOURCES:
            lib = ctypes.CDLL(str(paths[k]))
            for entry in ENTRIES[k]:
                fn = getattr(lib, f"kt_{entry}")
                fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
                fn.restype = ctypes.c_int
                _FNS[entry] = fn
            _LIBS[k] = lib
        _PATHS.update(paths)
        return _PATHS


#: the handle of a CUDA device's current stream, by device index:
#: PyTorch's raw accessor where the build has it (it makes no Stream
#: object, unlike torch.cuda.current_stream)
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) or (
    lambda index: torch.cuda.current_stream(index).cuda_stream)


def ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def check(t: torch.Tensor, dtype, shape) -> None:
    """A kernel operand must be a contiguous CUDA tensor of this dtype and
    shape."""
    if t.device.type != "cuda":
        raise ValueError(f"kernel operand on {t.device}, expected cuda")
    if t.dtype != dtype:
        raise TypeError(f"kernel operand dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"kernel operand shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError("kernel operand is not contiguous")


def check_fields(t: dict, spec: dict) -> None:
    """kernels.check over a dict of operands, {name: (dtype, shape)}, in
    one loop (the launch path's cost is its host time)."""
    for f, (dtype, shape) in spec.items():
        a = t[f]
        if not (a.is_cuda and a.dtype == dtype and a.shape == shape
                and a.is_contiguous()):
            check(a, dtype, shape)  # raises with the reason


def launch(source: str, args: Union[ctypes.Structure, array.array],
           entry: Optional[str] = None, count: Optional[str] = None,
           device: Optional[int] = None) -> None:
    """Launch a C entry of a source's library (default: the source's own
    name) on the current stream of CUDA device `device` (default: the
    current device); raises when the launch is refused.  `args` is a
    ctypes struct or an ``array.array("q")`` argument block.  `count`
    names the kernel whose launch counter gets one (a wrapper whose
    kernel runs as several entries counts once; default: the source's
    own name when `entry` is omitted)."""
    if entry is None:
        entry, count = source, count or source
    fn = _FNS.get(entry)
    if fn is None:
        build()
        fn = _FNS[entry]
    block = (args.buffer_info()[0] if isinstance(args, array.array)
             else ctypes.addressof(args))
    rc = fn(block, _raw_stream(torch.cuda.current_device()
                               if device is None else device))
    if rc != 0:
        raise RuntimeError(f"kernel {entry} launch failed: CUDA error {rc}")
    if count:
        LAUNCHES[count] += 1


# -- argument structs (mirror ops/csrc/*.cu) ---------------------------------
_P = ctypes.c_void_p
_I = ctypes.c_longlong


def _struct(name, ptrs, ints):
    return type(name, (ctypes.Structure,), {
        "_fields_": [(p, _P) for p in ptrs] + [(i, _I) for i in ints]})


CapacityArgs = _struct("CapacityArgs", (
    "req_milli", "req_is_cpu", "req_pods", "avail_milli", "used_milli",
    "has_alloc", "pods_allowed", "used_pods", "has_summary", "est_override",
    "used_sets", "est"), ("Q", "R", "C"))

WebsterArgs = _struct("WebsterArgs", (
    "n", "w", "s0", "active", "rank", "seats", "scratch"), ("B", "L"))

_WEBSTER_LAYOUT: list = []


def webster_layout() -> tuple:
    """K4's row layout, read from its library once (webster_batch.cu
    kt_webster_layout): (the lanes a row keeps in shared memory, the
    device-memory scratch bytes a lane of a wider row takes)."""
    if not _WEBSTER_LAYOUT:
        build()
        out = (ctypes.c_longlong * 2)()
        _LIBS["webster_batch"].kt_webster_layout(out)
        _WEBSTER_LAYOUT[:] = out
    return tuple(_WEBSTER_LAYOUT)


#: webster_batch.cu kt_webster_floordiv: K4's division helper alone, for
#: the card tests (not a kernel of the path; it counts no launch)
FloordivArgs = _struct("FloordivArgs", ("a", "d", "q"), ("n",))

CompactArgs = _struct("CompactArgs", (
    "rep", "sel", "non_workload", "idx", "val", "state"),
    ("B", "C", "keep_sel", "state_len"))

#: flat positions per K3 tile (compact.cu TILE); the kernel's state holds
#: a tile counter, nnz and one look-back status word per tile
COMPACT_TILE = 6144

ROWS_TENSOR_FIELDS = (
    "cluster_valid", "deleting", "name_rank", "api_ok", "req_milli",
    "req_is_cpu", "req_pods", "pl_mask", "pl_tol_bypass", "pl_strategy",
    "pl_static_w", "pl_has_cluster_sc", "pl_sc_min", "pl_sc_max",
    "pl_ignore_avail", "pl_extra_score", "b_valid", "placement_id", "gvk_id",
    "class_id", "replicas", "uid_desc", "fresh", "non_workload",
    "nw_shortcut", "prev_idx", "prev_val", "evict_idx",
    "avail_milli", "has_alloc", "pods_allowed", "has_summary",
    "est_override")

#: one launch slice's work buffers (a chunk's K2 workspace): the big
#: tier's lane working set, the rows' Webster problems (web_s0: zeros),
#: K4's seats and wide-row scratch, what the finish kernel reads
ROWS_WORK_FIELDS = (
    "work", "web_n", "web_w", "web_s0", "web_active", "web_rank", "seats",
    "web_scratch", "wk_lane", "wk_base", "wk_prev", "wk_sel", "wk_feas",
    "wk_U", "wk_flags")

#: RowsArgs' integer fields (r0, r1 and fill_est change per launch slice)
ROWS_INT_FIELDS = ("r0", "r1", "C", "Q", "R", "Kp", "Ke", "use_extra",
                   "charge", "fill_est")

RowsArgs = _struct("RowsArgs", ROWS_TENSOR_FIELDS + (
    "est", "used_milli", "used_pods", "used_sets", "rep", "sel", "status")
    + ROWS_WORK_FIELDS, ROWS_INT_FIELDS)

#: RowsArgs' fields in order, each 8 bytes (a pointer or an int64)
ROWS_FIELDS = tuple(f for f, _t in RowsArgs._fields_)


def rows_block(values: dict) -> array.array:
    """K2's argument block as the hot path builds it: an ``array("q")``
    laid out like RowsArgs (one int64 a field, pointers as integers),
    from {field: int} for every field of ROWS_FIELDS."""
    return array.array("q", [values[f] for f in ROWS_FIELDS])

#: gathered lanes per row at most, per lane tier (g_prev + 5 * g_topk;
#: schedule_rows.cu TierStd / TierBig)
LMAX = {"std": 656, "big": 5248}


def rows_work_bytes(tier: str) -> int:
    """Bytes of one row's lane working set (schedule_rows.cu work_bytes):
    in shared memory on the std tier, in the `work` scratch in device
    memory on the big tier."""
    L = LMAX[tier]
    return (3 * L * 8 + 6 * L * 4 + 6 * L + 15) // 16 * 16


SPREAD_TENSOR_FIELDS = (
    "cluster_valid", "deleting", "name_rank", "api_ok", "pl_mask",
    "pl_tol_bypass", "pl_extra_score", "placement_id", "gvk_id", "class_id",
    "replicas", "nw_shortcut", "prev_idx", "prev_val", "evict_idx")

SpreadInfoArgs = _struct("SpreadInfoArgs", SPREAD_TENSOR_FIELDS + (
    "est", "group_id", "region_min", "cluster_min", "duplicated", "groups",
    "score_g", "avail_g", "value_g", "feas_any"),
    ("B", "C", "Q", "Kp", "Ke", "G", "vec", "use_extra", "grp_smem"))

SpreadPickArgs = _struct("SpreadPickArgs", SPREAD_TENSOR_FIELDS + (
    "est", "group_id", "chosen", "cluster_max", "keys", "gmin", "pick"),
    ("B", "C", "Q", "Kp", "Ke", "G", "vec", "use_extra", "key_smem",
     "grp_smem"))

#: lanes whose spread keys K6 keeps in shared memory (8 B each); wider
#: rows keep them in a [B, C] device-memory scratch
SPREAD_SMEM_LANES = 8192
#: groups whose state K5 keeps in shared memory (spread_info_fields()
#: int64 each); more groups use a [B, fields, G] device-memory scratch
INFO_SMEM_GROUPS = 64
#: groups whose least key and chosen flag K6 keeps in shared memory (9 B
#: each); more groups use a [B, G] device-memory scratch
PICK_SMEM_GROUPS = 1024

_SPREAD_INFO_LAYOUT: list = []


def spread_info_fields() -> int:
    """The int64 fields of a group's state in K5, read from its library
    once (spread_group_info.cu kt_spread_info_layout)."""
    if not _SPREAD_INFO_LAYOUT:
        build()
        out = (ctypes.c_longlong * 1)()
        _LIBS["spread_group_info"].kt_spread_info_layout(out)
        _SPREAD_INFO_LAYOUT[:] = out
    return _SPREAD_INFO_LAYOUT[0]


#: K7's DeviceBatch operands, in its argument block's order
EXPLAIN_TENSOR_FIELDS = (
    "cluster_valid", "deleting", "api_ok", "pl_mask", "pl_tol_bypass",
    "pl_extra_score", "b_valid", "placement_id", "gvk_id", "class_id",
    "replicas", "non_workload", "nw_shortcut", "prev_idx", "prev_val",
    "evict_idx")

ExplainArgs = _struct("ExplainArgs", EXPLAIN_TENSOR_FIELDS + (
    "est", "fail_bits", "sel", "pick", "status", "verdict", "score",
    "avail", "outcome"),
    ("r0", "r1", "C", "Q", "Kp", "Ke", "use_extra"))

#: ExplainArgs' fields in order, each 8 bytes (a pointer or an int64)
EXPLAIN_FIELDS = tuple(f for f, _t in ExplainArgs._fields_)


def explain_block(values: dict) -> array.array:
    """K7's argument block as its workspace builds it: an ``array("q")``
    laid out like ExplainArgs, from {field: int} for every field of
    EXPLAIN_FIELDS."""
    return array.array("q", [values[f] for f in EXPLAIN_FIELDS])

#: K8's DeviceBatch operands, in its argument block's order (shortlist.cu
#: TopkArgs: these, then group_pref, the two key scratches, cand and
#: fcount, then B, C, Q, R, Kp, Ke, k, nk, smem)
TOPK_TENSOR_FIELDS = (
    "cluster_valid", "deleting", "name_rank", "api_ok", "pl_mask",
    "pl_tol_bypass", "pods_allowed", "has_summary", "avail_milli",
    "has_alloc", "req_milli", "req_is_cpu", "req_pods", "est_override",
    "b_valid", "placement_id", "gvk_id", "class_id", "replicas", "prev_idx",
    "evict_idx")

#: lanes of a row K8 keeps in shared memory: the row's thread block
#: cluster of TOPK_CLUSTER blocks holds TOPK_SMEM_LANES / TOPK_CLUSTER
#: (key, lane) pairs a block (12 B each); wider rows use [B, C]
#: device-memory scratches of the same layout
TOPK_CLUSTER = 8
TOPK_SMEM_LANES = TOPK_CLUSTER * 8192
#: K8's leader block sorts a power of two >= k members in shared memory
TOPK_MAX_K = 4096
#: K9's bins in one shared-memory tile (227 KB of u64); more groups walk
#: the bins tile by tile (shortlist.cu GS_TILE_BINS)
GROUP_SUM_TILE_BINS = 232448 // 8

#: staging buffers of a K11 workspace (resident.cu GATHER_RING)
GATHER_RING = 4

#: K11's call block (resident.cu GatherCall), int64 slots in order, a
#: field's width in slots: the inputs, the slot-store mirrors
#: (resident_gather.GATHER_FIELDS order), the outputs' byte offsets into
#: the call's slab (OUT_FIELDS order), B, Kp, Ke, the slab, the staging
#: flag and lane_inv's entries, then the workspace's ring: its pinned
#: buffers, their size, the next one and their events
GATHER_CALL = (("slots", 1), ("lane_inv", 1), ("drop", 1), ("mirrors", 12),
               ("out_off", 12), ("B", 1), ("Kp", 1), ("Ke", 1),
               ("slab", 1), ("staged", 1), ("n_inv", 1), ("ring", 1),
               ("ring_bytes", 1), ("next", 1), ("done", GATHER_RING))


def block_offsets(layout) -> Dict[str, int]:
    """Each field's first int64 slot in a call block laid out by `layout`
    ((field, width in slots), ...), and "len" the block's."""
    out, at = {}, 0
    for f, n in layout:
        out[f] = at
        at += n
    out["len"] = at
    return out


def gather_call_offsets() -> Dict[str, int]:
    """Each GATHER_CALL field's first int64 slot, and "len" the block's."""
    return block_offsets(GATHER_CALL)


#: K12's device operands, in dirty.cu DirtyCall `fields` order: the
#: slot-store fields, then the cluster-side fields the plane mirrors
DIRTY_DEVICE_FIELDS = (
    "placement_id", "replicas", "fresh", "non_workload", "route", "prev_idx",
    "prev_val", "evict_idx", "cluster_valid", "deleting", "pl_mask",
    "pl_strategy", "pl_has_cluster_sc")

#: K12's call block (dirty.cu DirtyCall), int64 slots in order, a field's
#: width in slots: the device operands (DIRTY_DEVICE_FIELDS), region_sc,
#: the flip lanes and the ascending rv list (host addresses when staged),
#: the device codes and their pinned copy, the shapes, the vector flag,
#: the staging flag, the device buffer the staged inputs land in, and the
#: workspace's pinned staging buffer and its size
DIRTY_CALL = (("fields", len(DIRTY_DEVICE_FIELDS)), ("region_sc", 1),
              ("flips", 1), ("rv", 1), ("out", 1), ("host_out", 1),
              ("cap", 1), ("C", 1), ("P", 1), ("Kp", 1), ("Ke", 1),
              ("F", 1), ("S", 1), ("vec", 1), ("staged", 1), ("dbuf", 1),
              ("pin", 1), ("pin_bytes", 1))

#: K13's call block (rebalance.cu ScoreCall), int64 slots in order: the
#: inputs (device addresses, or host addresses when staged), the device
#: outputs [3, C], C and the two thresholds, the staging flag, the
#: workspace's device and pinned buffers and the pinned one's size, the
#: timing flag, its two events and the kernel's time in nanoseconds
SCORE_CALL = (("committed", 1), ("capacity", 1), ("valid", 1), ("out", 1),
              ("C", 1), ("threshold_milli", 1), ("spread_tol_milli", 1),
              ("staged", 1), ("dbuf", 1), ("pin", 1), ("pin_bytes", 1),
              ("timed", 1), ("ev0", 1), ("ev1", 1), ("kernel_ns", 1))
#: lanes of K13 a block keeps in registers (rebalance.cu NT * LPT), and
#: the blocks of its one thread block cluster at most (CLUSTER_MAX)
SCORE_BLOCK_LANES = 512 * 4
SCORE_CLUSTER_MAX = 8
