"""schedule_items: one scheduling cycle of the port, the entry point a
caller uses.

Counterpart of the JAX package's ``Scheduler._solve`` with
``backend="device"`` (scheduler/service.py): rows on a device route run
through the chunked device pipeline on the card -- the main route, the
spread plane (region and spread-by-label grouping) and the big lane tier;
rows on a host route (provider/zone-only topology spread, unsupported,
vanished previous cluster, huge replicas, beyond every compact tier's
caps) run the serial golden path, as the JAX scheduler does.  With a
resident plane (`resident=`, resident/state.py) the cycle encodes through
it, as the JAX Scheduler does under `serve --resident[-fused]`.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence, Tuple

from karmada_tpu_torch import obs
from karmada_tpu_torch.device import resolve_device
from karmada_tpu_torch.estimator.general import GeneralEstimator
from karmada_tpu_torch.obs import decisions as obs_decisions
from karmada_tpu_torch.ops import serial, tensors
from karmada_tpu_torch.ops.shortlist import ShortlistConfig
from karmada_tpu_torch.scheduler.pipeline import PipelineResult, run_pipeline


class ClusterView:
    """One cluster list prepared once for many cycles that read it as it
    is: its ClusterIndex and the EncoderCache of its cluster side (pod
    allowances, the cluster axis, placement and API rows).  Detached
    callers keep one where a live cycle would keep a resident plane: the
    facade while the store's Clusters keep their resourceVersions, a
    what-if query across its probes.  Nothing may change the clusters
    while a view of them is in use."""

    #: placement rows kept before the cache starts over (each distinct
    #: request shape adds one)
    MAX_PLACEMENT_ROWS = 4096

    def __init__(self, clusters: List) -> None:
        self.clusters = clusters
        self.cindex = tensors.ClusterIndex.build(clusters)
        self.cache = tensors.EncoderCache()

    def cycle_cache(self) -> tensors.EncoderCache:
        """The cache for one more cycle: everything derived from the
        clusters kept, the pins to the last cycle's placement objects
        dropped."""
        if len(self.cache.placement_rows) > self.MAX_PLACEMENT_ROWS:
            self.cache = tensors.EncoderCache()
        self.cache.placement_keys = {}
        return self.cache


def schedule_items(
    items: Sequence[Tuple],
    clusters: Sequence,
    *,
    chunk: int = 4096,
    waves: int = 8,
    device=None,
    estimator: Optional[GeneralEstimator] = None,
    estimators: Optional[Sequence] = None,
    enable_empty_workload_propagation: bool = False,
    stats: Optional[PipelineResult] = None,
    explain: Optional[obs_decisions.DecisionRecorder] = None,
    shortlist: Optional[ShortlistConfig] = None,
    keys: Optional[Sequence[str]] = None,
    resident=None,
    deltas=None,
    tokens: Optional[Sequence] = None,
    cancelled: Optional[threading.Event] = None,
    view: Optional[ClusterView] = None,
) -> List[object]:
    """Per item, List[TargetCluster] or the Exception the scheduler would
    record.  `device` defaults to the first CUDA card and raises without
    one; pass ``device="cpu"`` to run the kernels' plain versions.  Carry
    is on when the cycle spans more than one chunk, for the spread and
    big-tier sub-solves too (JAX: ``carry_spread=carry``).  `stats`, when
    given, receives the pipeline's counts and stage times.  The device
    rows price with `estimator` (a GeneralEstimator); the host rows
    min-merge over `estimators` (default: `estimator` alone), as the JAX
    Scheduler's serial section merges over its estimator list.

    `explain` (a DecisionRecorder) records one Decision per binding: the
    device rows' from the explain plane, the host rows' outcome-level
    (backend "serial"), keyed by `keys` (per item "namespace/name"; the
    workload's identity when omitted).  `shortlist` arms the two-tier
    solve (ops/shortlist).

    `resident` (a resident.ResidentState on the same device) keeps the
    solver tensors between calls (JAX: Scheduler(resident=True)): the
    cycle first advances the plane to `clusters` with the window's
    `deltas` (resident.CycleDeltas, or None: the plane's own
    resourceVersion sweep finds the changes), then encodes each chunk
    through ResidentState.encode_cycle, which re-encodes only the rows
    whose `tokens` (per item a resident.RowToken, or None: no cached row)
    changed.

    `view` (a ClusterView built over this same `clusters` list) encodes
    against the cluster side it derived in an earlier cycle.

    `cancelled` (the Scheduler's mid-serve guard, scheduler/service.py):
    once the event is set the cycle stops (run_pipeline's gates), advances
    no resident plane, runs no serial row and records no decision;
    `stats.cancelled` says so and the result is partial."""
    device = resolve_device(device)
    estimator = estimator or GeneralEstimator()
    out: List[object] = [None] * len(items)
    if not items:
        return out
    encode = None
    if cancelled is not None and cancelled.is_set():
        if stats is not None:
            stats.cancelled = True
        return out
    if resident is not None:
        if resident.device != device:
            raise ValueError(f"the resident plane lives on {resident.device}"
                             f", the cycle runs on {device}")
        resident.begin_cycle(clusters, deltas)
        cindex, cache = resident.cindex, resident.enc_cache
        toks = list(tokens) if tokens is not None else [None] * len(items)

        def encode(part, offset, armed):
            return resident.encode_cycle(
                part, toks[offset:offset + len(part)], explain=armed)
    elif view is not None:
        if view.clusters is not clusters:
            raise ValueError("the view was built over another cluster list")
        cindex, cache = view.cindex, view.cycle_cache()
    else:
        cindex = tensors.ClusterIndex.build(clusters)
        cache = tensors.EncoderCache()
        cache.reset_for_cycle()
    res = run_pipeline(
        items, cindex, estimator, chunk=chunk, waves=waves, cache=cache,
        carry=len(items) > chunk,
        enable_empty_workload_propagation=enable_empty_workload_propagation,
        explain=explain, keys=keys, shortlist=shortlist, device=device,
        encode=encode, cancelled=cancelled)
    if res.cancelled:
        if stats is not None:
            stats.__dict__.update(res.__dict__)
        return out
    for i, r in res.results.items():
        out[i] = r
    cal = serial.make_cal_available(
        list(estimators) if estimators else [estimator])
    host_idx = [i for i in range(len(items)) if i not in res.results]
    # the host rows' span, as the JAX Scheduler opens it over the rows
    # its device tier left
    with (obs.TRACER.span(obs.SPAN_SERIAL, bindings=len(host_idx))
          if host_idx else obs.NOOP_SPAN):
        for i in host_idx:
            if cancelled is not None and cancelled.is_set():
                break
            spec, status = items[i]
            try:
                out[i] = serial.schedule(
                    spec, status, list(clusters), cal,
                    enable_empty_workload_propagation=(
                        enable_empty_workload_propagation))
            # the binding's outcome object, as the scheduler records it
            except Exception as e:  # noqa: BLE001
                out[i] = e
    if cancelled is not None and cancelled.is_set():
        res.cancelled = True  # abandoned past the pipeline's last gate
    if explain is not None and not res.cancelled:
        # the serial path records decisions too: a FitError's per-cluster
        # diagnosis maps onto the same verdict bits
        for i in host_idx:
            key = (keys[i] if keys is not None
                   else obs_decisions.default_key(items[i][0]))
            explain.record(obs_decisions.decision_from_result(
                key, out[i], len(clusters), backend="serial"))
    if stats is not None:
        stats.__dict__.update(res.__dict__)
    return out
