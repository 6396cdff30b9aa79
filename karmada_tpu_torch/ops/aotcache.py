"""The warm hook: kernel builds and first dispatches before the first cycle.

Counterpart of the JAX package's ``ops/aotcache.py``, with
``warm_executables``' contract.  The JAX package pre-compiles its jitted
solver executables per pow2 batch shape x jit variant into a persistent
XLA cache.  The port has no XLA cache and compiles nothing per shape;
what a first cycle pays in the port is the kernels' nvcc build, the
native host paths' build, CUDA's lazy module load of each kernel and the
per-chunk / per-mirror-set workspaces.  So "warm" means here:

  * ``kernels.build()`` (on the card) and ``native.build()``;
  * each (pow2 shape x variant) the port's pipeline can dispatch is run
    once on the card: ``synth_items(n)`` encoded against the fleet,
    dispatched (ops/solver.dispatch_compact) and finalized, its
    CUDA-event device time filed with ``obs/devprof.record_cost``.

``enable`` / ``cache_key`` name the kernels' build directory, keyed by
the sources' digest (ops/kernels.py); ``counters()`` counts the
libraries a build found on disk (hits) and compiled (misses).  The
variants with no counterpart in the port are left out of
``variants_for`` and answered "skipped" by ``warm_executables``:
``donated`` (PyTorch has no buffer donation; a dispatch's carry-out is
already its own buffers) and ``fused`` (K11's plan and pinned ring are
made per mirror set, ops/resident_gather.py, so a warm gather on a
synthetic set would build a workspace the live plane never uses).

``state_payload()`` holds the warm ledger.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

import torch

from karmada_tpu_torch.device import resolve_device

VARIANT_PLAIN = "plain"
VARIANT_EXPLAIN = "explain"
VARIANT_CARRY = "carry"
VARIANT_DONATED = "donated"
VARIANT_FUSED = "fused"
VARIANT_SHORTLIST = "shortlist"
#: the JAX package's default warm set
ALL_VARIANTS = (VARIANT_PLAIN, VARIANT_EXPLAIN, VARIANT_CARRY,
                VARIANT_DONATED)
#: the variants the port runs: plain, explain (K7 after each wave), carry
#: (with_used: the accumulators out) and shortlist (tier 1, then the
#: solver over its sub-batch or the dense fallback)
PORT_VARIANTS = (VARIANT_PLAIN, VARIANT_EXPLAIN, VARIANT_CARRY,
                 VARIANT_SHORTLIST)

_LOCK = threading.Lock()
# guarded-by: _LOCK
_STATE: Dict[str, object] = {
    "armed": False,
    "cache_dir": None,
    "key": None,
    # "B{b}xC{c}:{variant}" -> {"state": compiling|done|error|skipped,
    # "seconds": s, "cost": {"device_ms": t}}
    "warmup": {},
    "warmup_thread": None,  # "running" | "done" | "error: ..." | None
}


def cache_key() -> str:
    """The build directory's key: the digest of the kernel sources and
    nvcc's flags (sm_90a)."""
    from karmada_tpu_torch.ops import kernels

    return kernels.digest()


def enable(cache_dir: Optional[str] = None) -> Dict[str, object]:
    """Arm the build cache: with `cache_dir`, the kernels build there
    ($KARMADA_TORCH_BUILD_DIR) -- before their first build in this
    process; the default is ops/_build.  Returns the state payload."""
    from karmada_tpu_torch.ops import kernels

    if cache_dir is not None:
        if kernels._PATHS and os.path.abspath(cache_dir) != os.path.abspath(  # noqa: SLF001
                str(kernels.build_dir())):
            raise RuntimeError("the kernels are loaded from "
                               f"{kernels.build_dir()} already")
        os.environ["KARMADA_TORCH_BUILD_DIR"] = cache_dir
    key = cache_key()
    with _LOCK:
        _STATE["armed"] = True
        _STATE["cache_dir"] = str(kernels.build_dir() / key)
        _STATE["key"] = key
    return state_payload()


def reset_for_tests() -> None:
    with _LOCK:
        _STATE.update(armed=False, cache_dir=None, key=None, warmup={},
                      warmup_thread=None)


def counters() -> Tuple[int, int]:
    """(hits, misses): kernel libraries found built / compiled by nvcc."""
    from karmada_tpu_torch.ops import kernels

    return int(kernels.BUILDS["hits"]), int(kernels.BUILDS["misses"])


def state_payload() -> Dict[str, object]:
    """The build directory and key, hit/miss counts and the warm ledger."""
    hits, misses = counters()
    with _LOCK:
        return {
            "armed": bool(_STATE["armed"]),
            "cache_dir": _STATE["cache_dir"],
            "key": _STATE["key"],
            "hits": hits,
            "misses": misses,
            "warmup": dict(_STATE["warmup"]),  # values are replaced whole
            "warmup_thread": _STATE["warmup_thread"],
        }


def _set_warm(label: str, state: str, seconds: Optional[float] = None,
              cost: Optional[dict] = None) -> None:
    with _LOCK:
        rec: Dict[str, object] = {"state": state}
        if seconds is not None:
            rec["seconds"] = round(seconds, 3)
        if cost:
            rec["cost"] = dict(cost)
        _STATE["warmup"][label] = rec


# -- synthetic warm workload --------------------------------------------------


def synth_items(n: int):
    """(spec, status) pairs for warm encodes: Duplicated over every
    feasible cluster, one replica, so the batch routes ROUTE_DEVICE and
    runs the kernels real traffic does."""
    from karmada_tpu_torch.models.policy import (
        REPLICA_SCHEDULING_DUPLICATED,
        Placement,
        ReplicaSchedulingStrategy,
    )
    from karmada_tpu_torch.models.work import (
        ObjectReference,
        ResourceBindingSpec,
        ResourceBindingStatus,
    )

    placement = Placement(replica_scheduling=ReplicaSchedulingStrategy(
        replica_scheduling_type=REPLICA_SCHEDULING_DUPLICATED))
    items = []
    for i in range(n):
        spec = ResourceBindingSpec(
            resource=ObjectReference(
                api_version="apps/v1", kind="Deployment",
                namespace="karmada-warmup", name=f"aot-warm-{i}",
                uid=f"aot-warm-uid-{i}"),
            replicas=1,
            placement=placement,
        )
        items.append((spec, ResourceBindingStatus()))
    return items


def warm_shapes(batch_window: int, pipeline_chunk: int) -> Tuple[int, ...]:
    """Every pow2 binding-axis bucket a serve cycle can dispatch: cycles
    cut into pipeline_chunk-sized chunks and encode_batch pads B up to the
    next pow2 (min 8), so the top bucket is the pow2 ceiling of
    min(batch_window, pipeline_chunk)."""
    cap = max(8, min(int(batch_window), int(pipeline_chunk)))
    shapes = []
    b = 8
    while b < cap:
        shapes.append(b)
        b *= 2
    shapes.append(b)
    return tuple(shapes)


def variants_for(explain_rate: float, multi_chunk: bool,
                 fused: bool = False,
                 shortlist: bool = False) -> Tuple[str, ...]:
    """The variants this Scheduler configuration dispatches, as the JAX
    package's variants_for says, less those with no counterpart in the
    port (module docstring): plain always; explain when the explain plane
    samples; carry when cycles can span chunks (the JAX package's
    donated goes with it there); shortlist when the two-tier solve is
    armed (the JAX package's fused, with the fused resident path, is left
    out)."""
    variants = [VARIANT_PLAIN]
    if explain_rate and explain_rate > 0:
        variants.append(VARIANT_EXPLAIN)
    if multi_chunk:
        variants.append(VARIANT_CARRY)
    if shortlist:
        variants.append(VARIANT_SHORTLIST)
    return tuple(variants)


def _label(batch, variant: str, resident_cap, shortlist_k) -> str:
    if variant == VARIANT_FUSED:
        return f"B{batch.B}xS{int(resident_cap or 64)}:{variant}"
    if variant == VARIANT_SHORTLIST:
        return f"B{batch.B}xC{batch.C}:k{int(shortlist_k or 64)}:{variant}"
    return f"B{batch.B}xC{batch.C}:{variant}"


def _dispatch(batch, variant: str, *, waves: int, keep_sel: bool,
              shortlist_k, dev) -> dict:
    """One warm dispatch of `variant`, finalized; its details."""
    from karmada_tpu_torch.ops import shortlist as sl
    from karmada_tpu_torch.ops import solver

    info: dict = {}
    kw = {"waves": waves, "keep_sel": keep_sel, "device": dev}
    if variant == VARIANT_SHORTLIST:
        cfg = sl.ShortlistConfig(k=min(int(shortlist_k or 64), batch.C),
                                 min_cells=0)
        sub, sl_info = sl.shrink_chunk(batch, cfg, allow_truncate=False,
                                       device=dev)
        info["tier2"] = (f"B{sub.B}xC{sub.C}" if sub is not None
                         else f"dense ({sl_info.get('fallback')})")
        handle = solver.dispatch_compact(sub if sub is not None else batch,
                                         **kw)
    else:
        handle = solver.dispatch_compact(
            batch, with_used=variant == VARIANT_CARRY,
            explain=variant == VARIANT_EXPLAIN, **kw)
    solver.finalize_compact(handle)
    return info


def warm_executables(
    clusters: Sequence,
    estimator,
    *,
    shapes: Iterable[int] = (8, 16, 32, 64),
    variants: Sequence[str] = ALL_VARIANTS,
    waves: int = 8,
    keep_sel: bool = False,
    cancelled: Optional[threading.Event] = None,
    resident_cap: Optional[int] = None,
    shortlist_k: Optional[int] = None,
    device=None,
) -> Dict[str, object]:
    """Build the kernels and the native paths, then run each (pow2 shape
    x variant) once on `device` (the first card by default; "cpu" runs
    the plain versions) over synth_items against THIS fleet.  Returns
    {label: {"seconds", "device_ms", ...} | "already-warm" | "skipped:
    ..." | "error: ..."} plus "_totals"; the ledger lands in
    state_payload() and each label's device time in devprof.record_cost."""
    from karmada_tpu_torch import native, obs
    from karmada_tpu_torch.obs import devprof
    from karmada_tpu_torch.ops import kernels, tensors

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    t_all = time.perf_counter()
    results: Dict[str, object] = {}
    shapes = tuple(shapes)
    span = (obs.TRACER.start_span(obs.SPAN_WARMUP, shapes=list(shapes),
                                  variants=list(variants))
            if obs.TRACER.enabled else None)
    warmed = 0
    build_s = 0.0
    try:
        if on_card:
            kernels.build()
        native.build()
        build_s = time.perf_counter() - t_all
        cindex = tensors.ClusterIndex.build(list(clusters))
        cache = tensors.EncoderCache()
        with torch.cuda.device(dev) if on_card else contextlib.nullcontext():
            for n in shapes:
                if cancelled is not None and cancelled.is_set():
                    break
                # one explain-encoded batch serves every variant
                cache.reset_for_cycle()
                batch = tensors.encode_batch(synth_items(n), cindex, estimator,
                                             cache=cache, explain=True)
                for variant in variants:
                    label = _label(batch, variant, resident_cap, shortlist_k)
                    with _LOCK:
                        prior = _STATE["warmup"].get(label)
                    if prior is not None and prior.get("state") == "done":
                        # sizes that pad to one bucket warm it once
                        results[label] = "already-warm"
                        continue
                    if variant not in PORT_VARIANTS:
                        why = (f"skipped: {variant!r} has no counterpart "
                               "in the port")
                        _set_warm(label, "skipped")
                        results[label] = why
                        continue
                    if cancelled is not None and cancelled.is_set():
                        _set_warm(label, "skipped")
                        continue
                    _set_warm(label, "compiling")
                    t0 = time.perf_counter()
                    try:
                        if on_card:
                            ev0 = torch.cuda.Event(enable_timing=True)
                            ev1 = torch.cuda.Event(enable_timing=True)
                            ev0.record()
                        info = _dispatch(batch, variant, waves=waves,
                                         keep_sel=keep_sel,
                                         shortlist_k=shortlist_k, dev=dev)
                        cost = None
                        if on_card:
                            ev1.record()
                            ev1.synchronize()
                            cost = {"device_ms": ev0.elapsed_time(ev1)}
                        dt = time.perf_counter() - t0
                        _set_warm(label, "done", dt, cost=cost)
                        devprof.record_cost(label, cost)
                        results[label] = {"seconds": round(dt, 3),
                                          **(cost or {}), **info}
                        warmed += 1
                    # the error is kept in the ledger
                    except Exception as e:  # noqa: BLE001
                        _set_warm(label, f"error: {e!r:.200}")
                        results[label] = f"error: {e!r:.200}"
    finally:
        if span is not None:
            span.end(warmed=warmed,
                     seconds=round(time.perf_counter() - t_all, 3))
    hits, misses = counters()
    results["_totals"] = {"warmed": warmed,
                          "seconds": round(time.perf_counter() - t_all, 3),
                          "build_s": round(build_s, 3),
                          "hits": hits, "misses": misses}
    return results


def start_background_warmup(
    clusters_fn: Callable[[], Sequence],
    estimator,
    *,
    shapes: Iterable[int],
    variants: Sequence[str],
    waves: int = 8,
    keep_sel: bool = False,
    resident_cap: Optional[int] = None,
    shortlist_k: Optional[int] = None,
    device=None,
) -> threading.Thread:
    """warm_executables on a daemon thread (the plane takes traffic at
    once; warmed shapes stop paying first-use costs as they land).
    clusters_fn runs on the thread, so the warm sees the store at warm
    time."""

    def run() -> None:
        with _LOCK:
            _STATE["warmup_thread"] = "running"
        try:
            clusters = list(clusters_fn())
            if not clusters:
                with _LOCK:
                    _STATE["warmup_thread"] = "done (no clusters)"
                return
            warm_executables(clusters, estimator, shapes=shapes,
                             variants=variants, waves=waves,
                             keep_sel=keep_sel, resident_cap=resident_cap,
                             shortlist_k=shortlist_k, device=device)
            with _LOCK:
                _STATE["warmup_thread"] = "done"
        except Exception as e:  # noqa: BLE001 — warm never kills serve
            with _LOCK:
                _STATE["warmup_thread"] = f"error: {e!r:.200}"

    t = threading.Thread(target=run, daemon=True, name="solver-aot-warmup")
    t.start()
    return t
