"""Native host paths of the port: the C encode and decode fast paths and
the C++ serial scheduling control, with their loader and ctypes binding.

The port's counterpart of the JAX package's ``native/``; it keeps its own
copies of the three sources and builds and loads only those:

  * ``encode_fast.c`` (CPython extension ``_encode_fast``): the per-binding
    encode loop of ``ops/tensors.encode_batch`` for the common binding
    shape, calling the Python ``encode_one`` back on every other binding;
    also ``decode_fast``, the result-list builder after a Python row split;
  * ``decode_fast.c`` (``_decode_fast``): ``decode_coo``, the whole COO
    decode of ``ops/tensors.decode_compact`` -- row split, name-rank sort,
    TargetCluster construction and the explain outcome plane's reasons;
  * ``serial_solver.cc`` (a plain C library): the Go-equivalent serial
    control that backs ``Scheduler(backend="native")``,
    :func:`schedule_batch_native`.

The Python loops in ``ops/tensors`` (``native=False``) and ``ops/serial``
stay the defining implementations; the tests hold every C path to them.

Builds: gcc / g++ at first use, into a directory keyed by a digest of the
sources, the compiler commands and the interpreter's ABI tag
(``native/_build/<digest>/``, listed in .gitignore;
``$KARMADA_TORCH_NATIVE_BUILD_DIR`` overrides the parent directory).  Each
build writes a file of its own process (``<name>.tmp<pid>``) and moves it
into place, so processes that build at once all load a whole library.  A
build or load failure raises with the compiler's output: there is no quiet
fallback to the Python loops.

Marshaling contract of the serial control: everything derived from the
*snapshot* (cluster name ranks, availability matrix, per-placement filter
masks and static-weight rows) is precomputed host-side once per snapshot
-- the amortization the device path's EncoderCache performs.  All
*per-binding* work (filtering, capacity division, spread grouping / DFS,
Webster dispensing) happens inside the C++ control.  Unsupported inputs
(resource-model histograms, multi-component sets, vanished previous
clusters, weights >= 2^31) are marked per binding and reported as
``STATUS_UNSUPPORTED`` rather than silently mis-scheduled.
"""

from __future__ import annotations

import ctypes
import hashlib
import importlib.util
import os
import subprocess
import sys
import sysconfig
import threading
import time
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np

from karmada_tpu_torch.models.cluster import API_ENABLED, Cluster
from karmada_tpu_torch.models.policy import (
    SPREAD_BY_FIELD_CLUSTER,
    SPREAD_BY_FIELD_PROVIDER,
    SPREAD_BY_FIELD_REGION,
    SPREAD_BY_FIELD_ZONE,
    Placement,
)
from karmada_tpu_torch.models.work import (
    ResourceBindingSpec,
    ResourceBindingStatus,
    TargetCluster,
)
from karmada_tpu_torch.ops import serial
from karmada_tpu_torch.ops.webster import tiebreak_descending_by_uid
from karmada_tpu_torch.utils.quantity import (
    RESOURCE_CPU,
    resource_request_value,
)

SRC = Path(__file__).resolve().parent
_EXT = (sysconfig.get_config_var("EXT_SUFFIX")
        or f".{sys.implementation.cache_tag}.so")
_GCC = ("gcc", "-O2", "-shared", "-fPIC",
        f"-I{sysconfig.get_path('include')}")
_GXX = ("g++", "-O2", "-std=c++17", "-shared", "-fPIC")
#: library -> (source, compiler command head, built file name).  The two
#: extensions carry the interpreter's ABI tag: a CPython-API extension
#: must never load into another interpreter version than the one that
#: built it.
LIBRARIES = {
    "encode_fast": ("encode_fast.c", _GCC, f"_encode_fast{_EXT}"),
    "decode_fast": ("decode_fast.c", _GCC, f"_decode_fast{_EXT}"),
    "serial_solver": ("serial_solver.cc", _GXX, "_serial_solver.so"),
}

#: what the native paths did since the last reset_counts(): compiler runs
#: that produced a library; bindings the C encode filled, its encode_one
#: callbacks (misses), bindings the Python loop encoded (native=False);
#: rows decode_coo built, rows decode_fast built after the Python row
#: split, rows the Python builder built, and native decodes re-routed to
#: the Python split (the ascending contract broken, or tc_new_is_plain()
#: false)
COUNTS: Dict[str, int] = {
    "builds": 0, "encode_c": 0, "encode_miss": 0, "encode_py": 0,
    "decode_coo": 0, "decode_fast": 0, "decode_py": 0, "decode_reroute": 0,
}
#: compiler wall seconds of each library this process built
BUILD_SECONDS: Dict[str, float] = {}

#: serial_schedule_batch's C signature (serial_solver.cc): "I" an int32,
#: "P" a pointer to a contiguous array
_SERIAL_ABI = ("IPPPPPIP" "IPP" "IP" "I" + "P" * 8 + "IP" "I" + "P" * 14
               + "P" * 4 + "I")

_LOCK = threading.Lock()
_LOADED: Dict[str, object] = {}
_ERRORS: Dict[str, str] = {}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def build_dir() -> Path:
    """The digest-keyed directory the libraries are built into."""
    env = os.environ.get("KARMADA_TORCH_NATIVE_BUILD_DIR")
    root = Path(env) if env else SRC / "_build"
    h = hashlib.sha256(_EXT.encode())
    for name in sorted(LIBRARIES):
        src, cmd, out = LIBRARIES[name]
        h.update(" ".join((*cmd, out)).encode())
        h.update((SRC / src).read_bytes())
    return root / h.hexdigest()[:16]


def _command(name: str, out: Path) -> List[str]:
    src, cmd, _ = LIBRARIES[name]
    return [*cmd, "-o", str(out), str(SRC / src)]


def _build_locked(names: Sequence[str], verbose: bool) -> Dict[str, Path]:
    """Build the named libraries that are not on disk yet, one compiler
    each, all started together.  Raises with the compilers' output."""
    for name in names:
        if name in _ERRORS:
            raise RuntimeError(_ERRORS[name])
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {n: out_dir / LIBRARIES[n][2] for n in names}
    procs = {}
    for n in names:
        if paths[n].exists():
            continue
        tmp = out_dir / f"{LIBRARIES[n][2]}.tmp{os.getpid()}"
        procs[n] = (subprocess.Popen(
            _command(n, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, time.perf_counter())
    failed = []
    for n, (proc, tmp, t0) in procs.items():
        log, _ = proc.communicate()
        BUILD_SECONDS[n] = time.perf_counter() - t0
        if verbose:
            print(f"[{' '.join(_command(n, tmp))}] {BUILD_SECONDS[n]:.2f} s"
                  f"{chr(10) + log.rstrip() if log.strip() else ''}",
                  flush=True)
        if proc.returncode != 0:
            _ERRORS[n] = (f"native build of {LIBRARIES[n][0]} failed "
                          f"(rc {proc.returncode}):\n{log}")
            failed.append(_ERRORS[n])
            continue
        os.replace(tmp, paths[n])
        COUNTS["builds"] += 1
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def _load_locked(name: str, path: Path):
    if name == "serial_solver":
        lib = ctypes.CDLL(str(path))
        fn = lib.serial_schedule_batch
        fn.argtypes = [ctypes.c_int32 if k == "I" else ctypes.c_void_p
                       for k in _SERIAL_ABI]
        fn.restype = ctypes.c_int
        return lib
    # the module name's last component matches PyInit__<name>; the JAX
    # package's extension of the same init name lives under another
    # module name and file, so both load side by side in one process
    spec = importlib.util.spec_from_file_location(
        f"karmada_tpu_torch.native._{name}", str(path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _get(name: str):
    lib = _LOADED.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        if name not in _LOADED:
            path = _build_locked((name,), verbose=False)[name]
            _LOADED[name] = _load_locked(name, path)
        return _LOADED[name]


def build(verbose: bool = False) -> Dict[str, Path]:
    """Build (in parallel) and load all three libraries; their paths."""
    with _LOCK:
        paths = _build_locked(tuple(LIBRARIES), verbose)
        for name, path in paths.items():
            if name not in _LOADED:
                _LOADED[name] = _load_locked(name, path)
    return paths


def load_encode_fast():
    """The _encode_fast extension module, built at first use."""
    return _get("encode_fast")


def load_decode_fast():
    """The _decode_fast extension module, built at first use."""
    return _get("decode_fast")


def load() -> ctypes.CDLL:
    """The serial control's shared library, built at first use."""
    return _get("serial_solver")


def available() -> bool:
    """True when the serial control builds and loads, False when its
    toolchain fails: the degrade target of the serve policy
    (utils/deviceprobe.resolve_backend, the Scheduler's mid-serve guard),
    as the JAX package's native.available()."""
    try:
        load()
    except (RuntimeError, OSError):
        return False
    return True


# ---------------------------------------------------------------------------
# The serial control: snapshot and batch marshaling
# ---------------------------------------------------------------------------

STATUS_OK = 0
STATUS_FIT_ERROR = 1
STATUS_UNSCHEDULABLE = 2
STATUS_NO_CLUSTER = 3
STATUS_UNSUPPORTED = 4
STATUS_OVERFLOW = 5

_STRATEGY_CODE = {
    serial.DUPLICATED: 0,
    serial.STATIC_WEIGHT: 1,
    serial.DYNAMIC_WEIGHT: 2,
    serial.AGGREGATED: 3,
}
_FIELD_CODE = {
    SPREAD_BY_FIELD_CLUSTER: 0,
    SPREAD_BY_FIELD_REGION: 1,
    SPREAD_BY_FIELD_ZONE: 2,
    SPREAD_BY_FIELD_PROVIDER: 3,
}

_W_CAP = (1 << 31) - 1  # int32-class weights only (the reference's MaxInt32)


def _i64(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int64)


def _i32(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int32)


def _u8(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.uint8)


class NativeSnapshot:
    """Cluster-side arrays of one scheduling snapshot (reusable across
    chunks of the same cycle, like tensors.EncoderCache)."""

    def __init__(self, clusters: Sequence[Cluster], res_names: Sequence[str]):
        from karmada_tpu_torch.estimator.general import (
            _available,
            allowed_pod_number,
        )

        self.clusters = list(clusters)
        self.index: Dict[str, int] = {c.name: i for i, c in enumerate(clusters)}
        nC = len(clusters)
        order = sorted(range(nC), key=lambda i: clusters[i].name)
        # int32: the C++ control's ABI rank, not the SolverBatch field
        self.name_rank = np.zeros(nC, np.int32)
        for rank, i in enumerate(order):
            self.name_rank[i] = rank

        self.deleting = _u8([c.metadata.deleting for c in clusters])
        self.has_summary = _u8(
            [c.status.resource_summary is not None for c in clusters]
        )
        self.unsupported_modeling = any(
            c.status.resource_summary is not None
            and c.status.resource_summary.allocatable_modelings
            for c in clusters
        )

        regions: Dict[str, int] = {}
        self.region_id = np.full(nC, -1, np.int32)
        for i, c in enumerate(clusters):
            r = c.spec.region
            if not r:
                continue
            if r not in regions:
                regions[r] = len(regions)
            self.region_id[i] = regions[r]
        rnames = sorted(regions)
        self.region_rank = np.zeros(max(len(regions), 1), np.int32)
        for rank, name in enumerate(rnames):
            self.region_rank[regions[name]] = rank
        self.n_regions = len(regions)

        self.res_names = list(res_names)
        self.res_is_cpu = _u8([n == RESOURCE_CPU for n in self.res_names])
        nR = max(len(self.res_names), 1)
        self.pods_allowed = np.zeros(nC, np.int64)
        self.avail_milli = np.full((nC, nR), -1, np.int64)
        for i, c in enumerate(clusters):
            s = c.status.resource_summary
            if s is None:
                continue
            self.pods_allowed[i] = allowed_pod_number(s)
            for r, name in enumerate(self.res_names):
                self.avail_milli[i, r] = _available(s, name)

        self.gvk_rows: Dict[Tuple[str, str], int] = {}
        self.gvk_enabled: List[np.ndarray] = []
        self.placement_rows: Dict[str, int] = {}
        self.p_taint: List[np.ndarray] = []
        self.p_reason: List[np.ndarray] = []
        self.p_strategy: List[int] = []
        self.p_ignore_spread: List[int] = []
        self.p_has_weights: List[int] = []
        self.p_weights: List[np.ndarray] = []
        self.p_spread: List[np.ndarray] = []
        self.p_extra_score: List[np.ndarray] = []  # out-of-tree plugin sums
        self.p_unsupported: List[bool] = []

    def gvk_id(self, api_version: str, kind: str) -> int:
        key = (api_version, kind)
        gid = self.gvk_rows.get(key)
        if gid is not None:
            return gid
        row = _u8([
            c.api_enablement(api_version, kind) == API_ENABLED
            for c in self.clusters
        ])
        self.gvk_rows[key] = len(self.gvk_enabled)
        self.gvk_enabled.append(row)
        return self.gvk_rows[key]

    def placement_id(self, placement: Placement) -> int:
        key = serial_placement_key(placement)
        pid = self.placement_rows.get(key)
        if pid is not None:
            return pid

        from karmada_tpu_torch.scheduler.plugins import (
            REGISTRY as _PLUGINS,
            eval_filters,
            eval_scores,
        )

        nC = len(self.clusters)
        taint = np.zeros(nC, np.uint8)
        reason = np.zeros(nC, np.uint8)
        extra = np.zeros(nC, np.int64)
        plug_filters = _PLUGINS.enabled_filters()
        plug_scores = _PLUGINS.enabled_scores()
        # the placement-level filter predicates per cluster, in the serial
        # plugin order (taint, affinity, spread-field presence, out-of-tree
        # registry filters)
        dummy_spec = ResourceBindingSpec(placement=placement)
        dummy_status = ResourceBindingStatus()
        for i, c in enumerate(self.clusters):
            if serial.filter_taint_toleration(dummy_spec, dummy_status, c):
                taint[i] = 1
            if serial.filter_cluster_affinity(dummy_spec, dummy_status, c):
                reason[i] = 1
            elif serial.filter_spread_constraint(dummy_spec, dummy_status, c):
                reason[i] = 3
            elif plug_filters and eval_filters(plug_filters, placement, c):
                reason[i] = 4
            if plug_scores:
                extra[i] = eval_scores(plug_scores, placement, c)

        strategy = serial.strategy_type(
            ResourceBindingSpec(placement=placement, replicas=1)
        )
        scode = _STRATEGY_CODE.get(strategy, -1)
        unsupported = scode < 0

        weights = np.zeros(nC, np.int64)
        has_weights = 0
        rs = placement.replica_scheduling
        wp = rs.weight_preference if rs is not None else None
        if (strategy == serial.STATIC_WEIGHT and wp is not None
                and wp.static_weight_list):
            has_weights = 1
            for i, c in enumerate(self.clusters):
                w = 0
                for rule in wp.static_weight_list:
                    if rule.target_cluster.matches(c):
                        w = max(w, rule.weight)
                if w > _W_CAP:
                    unsupported = True
                weights[i] = w

        spread = np.full(6, -1, np.int32)
        scs = placement.spread_constraints
        if len(scs) > 2 or any(sc.spread_by_label for sc in scs):
            unsupported = True
        for k, sc in enumerate(scs[:2]):
            spread[k * 3] = _FIELD_CODE.get(sc.spread_by_field, -1)
            spread[k * 3 + 1] = sc.min_groups
            spread[k * 3 + 2] = sc.max_groups
            if spread[k * 3] < 0:
                unsupported = True

        self.placement_rows[key] = len(self.p_strategy)
        self.p_taint.append(taint)
        self.p_reason.append(reason)
        self.p_strategy.append(max(scode, 0))
        self.p_ignore_spread.append(
            1 if serial.should_ignore_spread_constraint(placement) else 0
        )
        self.p_has_weights.append(has_weights)
        self.p_weights.append(weights)
        self.p_spread.append(spread)
        self.p_extra_score.append(extra)
        self.p_unsupported.append(unsupported)
        return self.placement_rows[key]


def serial_placement_key(placement: Placement) -> str:
    """Identity key for memoizing placement rows (the dataclass tree's
    repr is stable for the models; collisions only merge identical
    placements)."""
    return repr(placement)


def collect_res_names(
    items: Sequence[Tuple[ResourceBindingSpec, ResourceBindingStatus]],
) -> List[str]:
    names: Dict[str, None] = {}
    for spec, _ in items:
        rr = spec.replica_requirements
        if rr is not None:
            for n in rr.resource_request:
                names.setdefault(n, None)
    return list(names)


class NativeBatch:
    """Marshaled per-binding arrays, ready for the C call (marshaling is
    separate from the call so a caller can time the control's scheduling
    work alone)."""

    def __init__(self) -> None:
        self.arrays: Dict[str, np.ndarray] = {}
        self.out_cap = 0
        self.n_bindings = 0


def marshal_batch(
    items: Sequence[Tuple[ResourceBindingSpec, ResourceBindingStatus]],
    snapshot: NativeSnapshot,
) -> NativeBatch:
    nB = len(items)
    nC = len(snapshot.clusters)

    b_placement = np.zeros(nB, np.int32)
    b_gvk = np.zeros(nB, np.int32)
    b_replicas = np.zeros(nB, np.int64)
    b_class = np.full(nB, -1, np.int32)
    b_fresh = np.zeros(nB, np.uint8)
    b_uid_desc = np.zeros(nB, np.uint8)
    b_workload = np.zeros(nB, np.uint8)
    b_zero_shortcut = np.zeros(nB, np.uint8)
    b_unsupported = np.zeros(nB, np.uint8)

    classes: Dict[Tuple, int] = {}
    class_rows: List[np.ndarray] = []
    nR = max(len(snapshot.res_names), 1)
    res_index = {n: r for r, n in enumerate(snapshot.res_names)}

    prev_off = np.zeros(nB + 1, np.int32)
    evict_off = np.zeros(nB + 1, np.int32)
    prev_idx_l: List[int] = []
    prev_val_l: List[int] = []
    evict_idx_l: List[int] = []

    for b, (spec, status) in enumerate(items):
        placement = _effective_placement(spec, status)
        pid = snapshot.placement_id(placement)
        b_placement[b] = pid
        b_gvk[b] = snapshot.gvk_id(spec.resource.api_version,
                                   spec.resource.kind)
        b_replicas[b] = min(spec.replicas, _W_CAP)
        if spec.replicas > _W_CAP:
            b_unsupported[b] = 1
        b_fresh[b] = serial.reschedule_required(spec, status)
        b_uid_desc[b] = tiebreak_descending_by_uid(spec.resource.uid)
        rr = spec.replica_requirements
        b_workload[b] = (
            (spec.replicas > 0 or rr is not None) and len(spec.components) <= 1
        )
        b_zero_shortcut[b] = spec.replicas == 0 and not spec.components
        if snapshot.p_unsupported[pid] or len(spec.components) > 1:
            b_unsupported[b] = 1
        if snapshot.unsupported_modeling:
            b_unsupported[b] = 1

        if rr is not None and rr.resource_request:
            ck = tuple(sorted((n, q.milli)
                              for n, q in rr.resource_request.items()))
            cid = classes.get(ck)
            if cid is None:
                row = np.zeros(nR, np.int64)
                for n, q in rr.resource_request.items():
                    row[res_index[n]] = resource_request_value(n, q)
                cid = classes[ck] = len(class_rows)
                class_rows.append(row)
            b_class[b] = cid

        seen: Dict[int, int] = {}
        for tc in spec.clusters:
            ci = snapshot.index.get(tc.name)
            if ci is None:
                b_unsupported[b] = 1  # vanished prev cluster: serial only
                continue
            seen[ci] = tc.replicas  # duplicate names: last wins
            if tc.replicas > _W_CAP:
                b_unsupported[b] = 1
        for ci, r in seen.items():
            prev_idx_l.append(ci)
            prev_val_l.append(r)
        prev_off[b + 1] = len(prev_idx_l)

        for task in spec.graceful_eviction_tasks:
            ci = snapshot.index.get(task.from_cluster)
            if ci is not None:
                evict_idx_l.append(ci)
        evict_off[b + 1] = len(evict_idx_l)

    nP = max(len(snapshot.p_strategy), 1)
    nG = max(len(snapshot.gvk_enabled), 1)
    nQ = max(len(class_rows), 1)

    def stack(rows: List[np.ndarray], n: int, width: int, dtype) -> np.ndarray:
        if not rows:
            return np.zeros((n, width), dtype)
        return np.ascontiguousarray(np.stack(rows), dtype)

    p_taint = stack(snapshot.p_taint, nP, nC, np.uint8)
    p_reason = stack(snapshot.p_reason, nP, nC, np.uint8)
    p_weights = stack(snapshot.p_weights, nP, nC, np.int64)
    p_spread = stack(snapshot.p_spread, nP, 6, np.int32)
    p_extra = stack(snapshot.p_extra_score, nP, nC, np.int64)
    p_strategy = _i32(snapshot.p_strategy or [0])
    p_ignore = _u8(snapshot.p_ignore_spread or [0])
    p_has_w = _u8(snapshot.p_has_weights or [0])
    gvk_enabled = stack(snapshot.gvk_enabled, nG, nC, np.uint8)
    class_req = stack(class_rows, nQ, nR, np.int64)

    prev_idx = _i32(prev_idx_l or [0])
    prev_val = _i64(prev_val_l or [0])
    evict_idx = _i32(evict_idx_l or [0])

    # tight output bound: Webster-divided results have at most
    # min(replicas + |prev|, nC) positive lanes; Duplicated at most the
    # placement's affinity-passing cluster count
    pass_count = [
        nC - int(np.count_nonzero(row)) for row in snapshot.p_reason
    ] or [nC]
    out_cap = 1
    for b in range(nB):
        if not b_workload[b] or snapshot.p_strategy[b_placement[b]] == 0:
            # non-workload zero-propagation and Duplicated both emit one
            # entry per feasible candidate
            out_cap += pass_count[b_placement[b]]
        else:
            out_cap += int(
                min(b_replicas[b] + (prev_off[b + 1] - prev_off[b]), nC)
            )

    nb = NativeBatch()
    nb.n_bindings = nB
    nb.out_cap = out_cap
    nb.arrays = {
        "nC": nC, "nR": nR, "nG": nG, "nP": nP, "nQ": nQ,
        "gvk_enabled": gvk_enabled, "p_taint": p_taint, "p_reason": p_reason,
        "p_strategy": p_strategy, "p_ignore": p_ignore, "p_has_w": p_has_w,
        "p_weights": p_weights, "p_spread": p_spread, "p_extra": p_extra,
        "class_req": class_req,
        "b_placement": b_placement, "b_gvk": b_gvk, "b_replicas": b_replicas,
        "b_class": b_class, "b_fresh": b_fresh, "b_uid_desc": b_uid_desc,
        "b_workload": b_workload, "b_zero_shortcut": b_zero_shortcut,
        "b_unsupported": b_unsupported, "prev_off": prev_off,
        "prev_idx": prev_idx, "prev_val": prev_val, "evict_off": evict_off,
        "evict_idx": evict_idx,
    }
    return nb


def run_marshaled(
    nb: NativeBatch, snapshot: NativeSnapshot
) -> List[Tuple[int, List[TargetCluster]]]:
    """Run the C++ control over a marshaled batch."""
    lib = load()
    a = nb.arrays
    nB = nb.n_bindings
    out_status = np.zeros(nB, np.int32)
    out_off = np.zeros(nB + 1, np.int32)
    out_idx = np.zeros(nb.out_cap, np.int32)
    out_val = np.zeros(nb.out_cap, np.int64)

    c = ctypes
    p = lambda arr: arr.ctypes.data_as(c.c_void_p)  # noqa: E731
    # bound to a local so the pointer outlives the call even if
    # avail_milli were a non-contiguous view
    avail_milli = np.ascontiguousarray(snapshot.avail_milli)
    rc = lib.serial_schedule_batch(
        c.c_int32(a["nC"]), p(snapshot.name_rank), p(snapshot.deleting),
        p(snapshot.has_summary), p(snapshot.region_id),
        p(snapshot.region_rank), c.c_int32(snapshot.n_regions),
        p(snapshot.pods_allowed),
        c.c_int32(a["nR"]), p(snapshot.res_is_cpu),
        p(avail_milli),
        c.c_int32(a["nG"]), p(a["gvk_enabled"]),
        c.c_int32(a["nP"]), p(a["p_taint"]), p(a["p_reason"]),
        p(a["p_strategy"]), p(a["p_ignore"]), p(a["p_has_w"]),
        p(a["p_weights"]), p(a["p_spread"]), p(a["p_extra"]),
        c.c_int32(a["nQ"]), p(a["class_req"]),
        c.c_int32(nB), p(a["b_placement"]), p(a["b_gvk"]),
        p(a["b_replicas"]), p(a["b_class"]), p(a["b_fresh"]),
        p(a["b_uid_desc"]), p(a["b_workload"]), p(a["b_zero_shortcut"]),
        p(a["b_unsupported"]),
        p(a["prev_off"]), p(a["prev_idx"]), p(a["prev_val"]),
        p(a["evict_off"]), p(a["evict_idx"]),
        p(out_status), p(out_off), p(out_idx), p(out_val),
        c.c_int32(nb.out_cap),
    )
    if rc != 0:
        raise RuntimeError("native solver output overflow")

    results: List[Tuple[int, List[TargetCluster]]] = []
    names = [cl.name for cl in snapshot.clusters]
    for b in range(nB):
        status = int(out_status[b])
        targets: List[TargetCluster] = []
        if status == STATUS_OK:
            for j in range(out_off[b], out_off[b + 1]):
                targets.append(TargetCluster(name=names[out_idx[j]],
                                             replicas=int(out_val[j])))
        results.append((status, targets))
    return results


def schedule_batch_native(
    items: Sequence[Tuple[ResourceBindingSpec, ResourceBindingStatus]],
    snapshot: NativeSnapshot,
) -> List[Tuple[int, List[TargetCluster]]]:
    """Schedule every binding through the C++ control.

    Returns ``[(status, targets), ...]`` aligned with ``items``;
    ``targets`` is meaningful only when status is ``STATUS_OK``.
    """
    return run_marshaled(marshal_batch(items, snapshot), snapshot)


def _effective_placement(
    spec: ResourceBindingSpec, status: ResourceBindingStatus
) -> Placement:
    """The placement the filters see -- one shared resolution so
    out-of-tree plugins get the identical object on every backend."""
    return serial.effective_placement(spec, status)
