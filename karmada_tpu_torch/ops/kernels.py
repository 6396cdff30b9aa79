"""Build, binding and launch counters of the port's Hopper kernels.

The CUDA C++ sources live in ``ops/csrc/``.  Each ``*.cu`` compiles with
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface
(no PyTorch headers, so a build takes seconds), all sources at once in
parallel, at first use, into a build directory keyed by the sources'
hash.  The libraries load with ``ctypes``; each C entry takes a pointer to
an argument struct (mirrored below) and the CUDA stream, launches on that
stream, and returns ``cudaGetLastError()``.

Nothing here runs at import time: the CPU tests import every module, and
``nvcc`` is needed only once a CUDA tensor reaches a kernel wrapper.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
KERNELS = ("capacity", "schedule_rows", "compact", "webster_batch")
#: C entry points (kt_<entry>) of each kernel's library
ENTRIES = {"capacity": ("capacity",),
           "schedule_rows": ("schedule_rows_prepare", "schedule_rows_finish"),
           "compact": ("compact",), "webster_batch": ("webster_batch",)}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: launches per kernel since the last reset_counts(); a wrapper adds one
#: where it launches its kernel and nowhere else
LAUNCHES: Dict[str, int] = {k: 0 for k in KERNELS}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
#: nvcc's output (registers, shared memory, spills) per kernel source
BUILD_LOG: Dict[str, str] = {}


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


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Dict[str, Path]:
    """Compile every kernel source (one nvcc per source, all started
    together) unless this source hash was built already; load them all.
    Raises with nvcc's output when a build fails."""
    with _LOCK:
        if len(_LIBS) == len(KERNELS):
            return {k: Path(_LIBS[k]._name) for k in KERNELS}
        out_dir = build_dir() / _digest()
        out_dir.mkdir(parents=True, exist_ok=True)
        paths = {k: out_dir / f"lib{k}.so" for k in KERNELS}
        procs = {}
        nvcc = _nvcc()
        for k in KERNELS:
            if paths[k].exists():
                continue
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
        for k in KERNELS:
            lib = ctypes.CDLL(str(paths[k]))
            for entry in ENTRIES[k]:
                fn = getattr(lib, f"kt_{entry}")
                fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
                fn.restype = ctypes.c_int
            _LIBS[k] = lib
        return paths


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


def launch(name: str, args: ctypes.Structure, entry: Optional[str] = None,
           count: bool = True) -> None:
    """Launch a kernel's C entry (default: the kernel's own name) on the
    current stream; raises when the launch is refused.  `count` adds one
    to the kernel's launch counter (a wrapper whose kernel runs as
    several entries counts once)."""
    build()
    entry = entry or name
    rc = getattr(_LIBS[name], f"kt_{entry}")(
        ctypes.byref(args),
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if rc != 0:
        raise RuntimeError(f"kernel {entry} launch failed: CUDA error {rc}")
    if count:
        LAUNCHES[name] += 1


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
    "n", "w", "s0", "active", "rank", "seats"), ("B", "L"))

CompactArgs = _struct("CompactArgs", (
    "rep", "sel", "non_workload", "idx", "val", "offsets"),
    ("B", "C", "keep_sel"))

ROWS_TENSOR_FIELDS = (
    "cluster_valid", "deleting", "name_rank", "api_ok", "req_milli",
    "req_is_cpu", "req_pods", "pl_mask", "pl_tol_bypass", "pl_strategy",
    "pl_static_w", "pl_has_cluster_sc", "pl_sc_min", "pl_sc_max",
    "pl_ignore_avail", "pl_extra_score", "b_valid", "placement_id", "gvk_id",
    "class_id", "replicas", "uid_desc", "fresh", "non_workload",
    "nw_shortcut", "prev_idx", "prev_val", "evict_idx")

ROWS_WORK_FIELDS = (
    "web_n", "web_w", "web_active", "web_rank", "seats", "wk_lane", "wk_base",
    "wk_prev", "wk_sel", "wk_feas", "wk_U", "wk_flags")

RowsArgs = _struct("RowsArgs", ROWS_TENSOR_FIELDS + (
    "est", "used_milli", "used_pods", "used_sets", "rep", "sel", "status",
    "scratch") + ROWS_WORK_FIELDS,
    ("r0", "r1", "C", "Q", "R", "Kp", "Ke", "use_extra", "charge"))

#: gathered lanes per row at most (G_PREV + 5 * G_TOPK; schedule_rows.cu)
LMAX = 656
