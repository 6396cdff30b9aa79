"""Scheduler service: a store-watching batch scheduler over schedule_items.

Counterpart of the JAX package's ``scheduler/service.py``.  It keeps the
reference's decision semantics
(doScheduleBinding, pkg/scheduler/scheduler.go:376: schedule when the
spec generation moved, a reschedule was triggered, or the binding is
unscheduled; honor scheduling suspension) but drains every pending
binding per cycle into one solve.  `backend` picks it, as in the JAX
package: "device" (the default) runs one schedule_items call
(scheduler/core.py: the chunked device pipeline on the card, host routes
on the serial path); "native" runs the compiled C++ serial control
(native/serial_solver.cc) over the whole batch and ops/serial.schedule
over the rows it leaves (its unsupported classes, or every row with
empty-workload propagation on); "serial" runs ops/serial.schedule alone.
The host backends are the caller asking for the host: they build no
SolverBatch, so the shortlist and the resident plane arm only on
"device".

Pending bindings wait in a three-queue SchedulingQueue (active / backoff /
unschedulable, scheduler/queue.py); failures route back per handleErr
(scheduler.go:829-841).  The ClusterAffinities failover loop
(scheduleResourceBinding :599-662) re-batches still-failing bindings
under their next term and records the observed term in
status.schedulerObservedAffinityName.

`resident=True` keeps the solver tensors between cycles (resident/): a
DeltaTracker taps the watch bus and each cycle hands its coalesced window
to the plane.  `rebalance=INTERVAL_S` arms the rebalance plane
(rebalance/plane.py) as a periodic hook on the queue's clock.

A batch whose solve raises is contained (its bindings go to backoff, as
in the JAX package) and counted in `cycle_faults` by exception kind.  The
JAX package's leader election, device degrade guard (its mid-serve
guard, device probe and backend resolution), chaos seams, explain
sampling, batch deadline and overload mode, mesh, detached solves, flight
records, metrics, spans and event recorder are not part of the port.
"""

from __future__ import annotations

import collections
import copy
import threading
import time
import traceback
from typing import Dict, List, Optional, Tuple

from karmada_tpu_torch import native as native_mod
from karmada_tpu_torch.device import resolve_device
from karmada_tpu_torch.estimator.general import GeneralEstimator
from karmada_tpu_torch.models.cluster import Cluster
from karmada_tpu_torch.models.meta import Condition, set_condition
from karmada_tpu_torch.models.work import (
    COND_SCHEDULED,
    ResourceBinding,
    ResourceBindingSpec,
    ResourceBindingStatus,
    TargetCluster,
)
from karmada_tpu_torch.obs.decisions import classify_unschedulable
from karmada_tpu_torch.ops import serial
from karmada_tpu_torch.ops.shortlist import ShortlistConfig
from karmada_tpu_torch.scheduler.core import schedule_items
from karmada_tpu_torch.scheduler.pipeline import PipelineResult
from karmada_tpu_torch.scheduler.queue import QueuedBindingInfo, SchedulingQueue
from karmada_tpu_torch.store.store import Event, ObjectStore
from karmada_tpu_torch.store.worker import AsyncWorker, Runtime

REASON_SUCCESS = "BindingScheduled"
REASON_NO_FIT = "NoClusterFit"
REASON_UNSCHEDULABLE = "Unschedulable"

_CYCLE = "__cycle__"

#: PipelineResult stage times summed into each cycle_log entry
_STAGES = ("encode_s", "dispatch_s", "wait_s", "finalize_s", "decode_s",
           "spread_s", "big_s", "shortlist_s")
#: the host backends' stage times: the native control's snapshot and
#: marshaling, its C call, and the serial path's rows
_HOST_STAGES = ("native_marshal_s", "native_s", "serial_s")
BACKENDS = ("device", "native", "serial")


class Scheduler:
    """Watches bindings and clusters; schedules in batched cycles with
    `backend` ("device": on `device`, the first CUDA card by default, "cpu"
    running the kernels' plain versions; "native" / "serial": on the
    host)."""

    def __init__(
        self,
        store: ObjectStore,
        runtime: Runtime,
        *,
        backend: str = "device",
        device=None,
        enable_empty_workload_propagation: bool = False,
        batch_window: int = 4096,
        queue: Optional[SchedulingQueue] = None,
        waves: int = 8,
        # cycles larger than this split into pipelined chunks with
        # chunk-to-chunk consumed-capacity carry
        pipeline_chunk: int = 1024,
        # two-tier solve (ops/shortlist): chunks of at least
        # shortlist_min_cells B*C cells solve over a top-k candidate union
        shortlist_k: Optional[int] = None,
        shortlist_min_cells: int = 1 << 21,
        # resident-state plane (resident/): tensors kept between cycles,
        # every resident_audit_interval-th cycle audited bit for bit;
        # resident_fused gathers the binding rows on the device
        resident: bool = False,
        resident_audit_interval: int = 64,
        resident_fused: bool = False,
        # rebalance plane: interval in seconds on the queue's clock
        # (None/0 leaves it disarmed), its config, a shared pacing budget
        # and the clock it paces on (default: the queue's)
        rebalance: Optional[float] = None,
        rebalance_cfg=None,
        rebalance_budget=None,
        rebalance_clock=None,
    ) -> None:
        if backend not in BACKENDS:
            raise ValueError(f"backend {backend!r} is not one of {BACKENDS}")
        self.store = store
        self.backend = backend
        # the host backends solve without a card: they resolve `device`
        # only when the caller names one (a rebalance plane resolves its
        # own otherwise)
        self.device = (resolve_device(device)
                       if backend == "device" or device is not None
                       else None)
        # the port has no accurate-estimator tier yet
        self._general = GeneralEstimator()
        self.enable_empty_workload_propagation = (
            enable_empty_workload_propagation)
        self.batch_window = batch_window
        # capacity-contention waves per solver chunk (ops/solver.py)
        self.waves = max(1, waves)
        self.pipeline_chunk = max(1, pipeline_chunk)
        self.shortlist = (ShortlistConfig(k=int(shortlist_k),
                                          min_cells=int(shortlist_min_cells))
                          if shortlist_k and backend == "device" else None)
        # the queue is touched from publisher threads (_on_event) and the
        # cycle worker; one lock guards every queue operation
        self._queue_lock = threading.Lock()
        self.queue = queue if queue is not None else SchedulingQueue()
        # guarded-by: _queue_lock -- keys of the batch the current cycle
        # schedules: their result-patch echoes are gate-exempt
        self._inflight_keys: set = set()
        self._cycle_id = 0
        # cycles where batch formation cut but the pop came back empty
        # (must stay 0)
        self._empty_cuts = 0
        #: scheduling cycles whose batch solve raised, by exception kind
        self.cycle_faults: Dict[str, int] = {}
        #: promote() pushes by origin
        self.priority_pushes: Dict[str, int] = {}
        #: Cluster events handled and the host seconds of their re-queue
        #: scans (every binding is looked at on each one)
        self.cluster_events = 0
        self.cluster_event_s = 0.0
        #: the last 64 non-empty cycles: bindings, wall seconds, outcome
        #: counts and the pipeline's stage seconds
        self.cycle_log: collections.deque = collections.deque(maxlen=64)
        self._cycle_stats: Optional[PipelineResult] = None
        self._host_stats = dict.fromkeys(_HOST_STAGES, 0.0)
        self._cycle_fault: Optional[str] = None
        # (clusters list, NativeSnapshot) of the last native solve: the
        # affinity-failover rounds of one cycle share the snapshot
        self._native_snap = None
        self._resident = None
        self._delta_tracker = None
        if resident and backend == "device":
            from karmada_tpu_torch.resident import DeltaTracker, ResidentState

            self._resident = ResidentState(
                estimator=self._general,
                audit_interval=resident_audit_interval,
                fused=bool(resident_fused), device=self.device)
            # taps the same bus; its window drains at each solve
            self._delta_tracker = DeltaTracker()
            store.bus.subscribe(self._delta_tracker.on_event)
        if backend == "native":
            # build (or load) the C++ control now, so that the first cycle
            # never waits for g++; a build failure raises here
            native_mod.load()
        self.worker = runtime.register(AsyncWorker("scheduler", self._cycle))
        runtime.register_periodic(self._periodic_flush)
        self.rebalance_plane = None
        if rebalance:
            from karmada_tpu_torch.rebalance import (
                RebalanceConfig,
                RebalancePlane,
            )

            cfg = (rebalance_cfg if rebalance_cfg is not None
                   else RebalanceConfig(interval_s=float(rebalance)))
            self.rebalance_plane = RebalancePlane(
                store, self, cfg=cfg, budget=rebalance_budget,
                clock=(rebalance_clock if rebalance_clock is not None
                       else self.queue.now),
                device=self.device)
            runtime.register_periodic(self.rebalance_plane.maybe_run)
        store.bus.subscribe(self._on_event)

    # -- event wiring -------------------------------------------------------
    def _on_event(self, event: Event) -> None:
        kind = event.kind
        if kind == ResourceBinding.KIND:
            rb = event.obj
            # only creations and spec changes (generation moved) enqueue:
            # the scheduler's own status writes must not reset a failing
            # binding's backoff
            if event.old is not None and (
                    rb.metadata.generation == event.old.metadata.generation):
                return
            with self._queue_lock:
                key = (rb.namespace, rb.name)
                self.queue.push(key, _priority_of(rb),
                                gate_exempt=key in self._inflight_keys)
            self.worker.enqueue(_CYCLE)
        elif kind == Cluster.KIND:
            # capacity/feasibility changed: unschedulable entries become
            # schedulable again (still-backing-off ones keep their timer);
            # bindings resident in no queue get another look (a read-only
            # scan: the stored bindings, not copies)
            t0 = time.perf_counter()
            with self._queue_lock:
                self.queue.move_all_to_active_or_backoff()
                for rb in self.store.visit(ResourceBinding.KIND):
                    key = (rb.namespace, rb.name)
                    if self.queue.has(key):
                        continue
                    if not rb.spec.clusters or self._needs_schedule(rb):
                        self.queue.push(key, _priority_of(rb))
                enqueued = self.queue.depths()["active"] > 0
            self.cluster_event_s += time.perf_counter() - t0
            self.cluster_events += 1
            if enqueued:
                self.worker.enqueue(_CYCLE)

    def _periodic_flush(self) -> None:
        """Per-tick stand-in for the reference's 1s/30s flush goroutines."""
        with self._queue_lock:
            moved = self.queue.flush_backoff()
            moved += self.queue.flush_unschedulable_leftover()
            ready = self.queue.depths()["active"]
        if moved or ready:
            self.worker.enqueue(_CYCLE)

    # -- scheduling decision (doScheduleBinding scheduler.go:376) -----------
    def _needs_schedule(self, rb: ResourceBinding) -> bool:
        if rb.metadata.deleting:
            return False
        if rb.spec.placement is None and rb.spec.required_by:
            return False  # attached binding: follows its parents' schedule
        if rb.spec.suspension is not None and rb.spec.suspension.scheduling:
            return False
        if rb.metadata.generation != rb.status.scheduler_observed_generation:
            return True
        if serial.reschedule_required(rb.spec, rb.status):
            return True
        return not rb.spec.clusters and not _is_scheduled_empty(rb)

    def _batch_ready_locked(self) -> bool:
        """Any ready binding cuts a cycle (call under _queue_lock)."""
        return self.queue.depths()["active"] > 0

    # -- the batched cycle --------------------------------------------------
    def _cycle(self, _key) -> None:
        t0 = time.perf_counter()
        with self._queue_lock:
            self.queue.flush_backoff()
            self.queue.flush_unschedulable_leftover()
            cut = self._batch_ready_locked()
            infos = self.queue.pop_ready(self.batch_window) if cut else []
            if cut and not infos:
                self._empty_cuts += 1
        todo: List[Tuple[QueuedBindingInfo, ResourceBinding]] = []
        for info in infos:
            ns, name = info.key
            rb = self.store.try_get(ResourceBinding.KIND, ns, name)
            if rb is None or not self._needs_schedule(rb):
                # a pop for a key that needs nothing (e.g. the result
                # patch's own echo); a concurrent push survives
                continue
            info.attempts += 1
            todo.append((info, rb))
        if todo:
            self._cycle_id += 1
            clusters = self.store.list(Cluster.KIND)
            with self._queue_lock:
                self._inflight_keys = {info.key for info, _ in todo}
            self._cycle_stats = PipelineResult()
            self._host_stats = dict.fromkeys(_HOST_STAGES, 0.0)
            self._cycle_fault = None
            outcomes: List[object] = []
            try:
                outcomes = self.schedule_batch([rb for _, rb in todo],
                                               clusters)
            except Exception as e:  # noqa: BLE001 — cycle fault containment
                # the popped bindings must not be lost: every one goes to
                # backoff, and the fault is counted
                kind = type(e).__name__
                self.cycle_faults[kind] = self.cycle_faults.get(kind, 0) + 1
                self._cycle_fault = kind
                traceback.print_exc()
                with self._queue_lock:
                    for info, _ in todo:
                        self.queue.push_backoff_if_not_present(info)
                todo = []
            finally:
                with self._queue_lock:
                    self._inflight_keys = set()
            # handleErr routing: UnschedulableError waits for a cluster
            # event; other failures back off and retry; success is done
            with self._queue_lock:
                for (info, _), res in zip(todo, outcomes):
                    if isinstance(res, serial.UnschedulableError):
                        self.queue.push_unschedulable_if_not_present(
                            info, reason=classify_unschedulable(res))
                    elif isinstance(res, Exception):
                        self.queue.push_backoff_if_not_present(info)
            self._log_cycle(len(infos), outcomes, time.perf_counter() - t0)
        with self._queue_lock:
            more = self._batch_ready_locked()
        if more:
            self.worker.enqueue(_CYCLE)

    def _log_cycle(self, popped: int, outcomes, wall: float) -> None:
        st = self._cycle_stats
        n_unsched = sum(isinstance(r, serial.UnschedulableError)
                        for r in outcomes)
        n_exc = sum(isinstance(r, Exception) for r in outcomes)
        entry = {"cycle_id": self._cycle_id, "backend": self.backend,
                 "popped": popped, "bindings": len(outcomes),
                 "scheduled": len(outcomes) - n_exc,
                 "unschedulable": n_unsched, "errors": n_exc - n_unsched,
                 "fault": self._cycle_fault, "wall_s": wall,
                 "chunks": st.chunks}
        entry.update({k: getattr(st, k) for k in _STAGES})
        entry.update(self._host_stats)
        self.cycle_log.append(entry)

    def resident_state(self) -> Optional[Dict[str, object]]:
        """The resident plane's stats, or None when it is not armed."""
        return self._resident.stats() if self._resident is not None else None

    def rebalance_state(self) -> Optional[Dict[str, object]]:
        """The rebalance plane's stats, or None when it is not armed."""
        return (self.rebalance_plane.stats()
                if self.rebalance_plane is not None else None)

    def promote(self, key, priority: int = 0, origin: str = "rebalance"):
        """Priority push straight into the active queue (the rebalance
        plane's re-place step): drain -> re-solve is one cycle.  The push
        respects the admission gate like any external event; `origin`
        buckets the entry's dwell."""
        with self._queue_lock:
            decision = self.queue.push(key, priority, origin=origin)
        self.priority_pushes[origin] = self.priority_pushes.get(origin, 0) + 1
        self.worker.enqueue(_CYCLE)
        return decision

    def queue_state(self) -> Dict[str, object]:
        """One consistent snapshot of the queue: depths, oldest-resident
        ages, unschedulable reasons, admission counts."""
        with self._queue_lock:
            depths = self.queue.depths()
            oldest = self.queue.oldest_ages()
            reasons = self.queue.unschedulable_reasons()
            admission = dict(self.queue.admission)
        return {
            "depths": depths,
            "oldest_age_s": {k: round(v, 6) for k, v in oldest.items()},
            "unschedulable_reasons": reasons,
            "admission": admission,
            "empty_cuts": self._empty_cuts,
            "batch_window": self.batch_window,
            "admission_limit": self.queue.max_resident,
        }

    # -- core: schedule a list of bindings against a cluster snapshot ------
    def schedule_batch(self, bindings: List[ResourceBinding],
                       clusters: List[Cluster]) -> List[object]:
        """Solve and patch the results back; returns per binding its
        outcome (List[TargetCluster] or the Exception)."""
        results, affinity_name = self.solve_batch(bindings, clusters)
        return [self._apply_result(rb, results.get(i),
                                   affinity_name.get(i, ""))
                for i, rb in enumerate(bindings)]

    def solve_batch(self, bindings: List[ResourceBinding],
                    clusters: List[Cluster]
                    ) -> Tuple[Dict[int, object], Dict[int, str]]:
        """The affinity-failover solve loop without the store patch-back:
        ({index: List[TargetCluster] | Exception}, {index: affinity term
        name})."""
        term_idx: Dict[int, int] = {}
        active: List[Tuple[int, ResourceBinding]] = list(enumerate(bindings))
        results: Dict[int, object] = {}
        affinity_name: Dict[int, str] = {}
        keys_all = [f"{rb.namespace}/{rb.name}" for rb in bindings]
        tokens_all = None
        if self._resident is not None:
            from karmada_tpu_torch.resident import RowToken

            # (key, rv) is the encoded row's identity; affinity-failover
            # bindings encode against a per-round synthesized status, so
            # they bypass the row cache
            tokens_all = [
                None if (rb.spec.placement
                         and rb.spec.placement.cluster_affinities)
                else RowToken(key, rb.metadata.resource_version)
                for rb, key in zip(bindings, keys_all)]
        while active:
            items: List[Tuple[ResourceBindingSpec, ResourceBindingStatus]] = []
            for i, rb in active:
                spec, status = rb.spec, rb.status
                terms = (spec.placement.cluster_affinities
                         if spec.placement else [])
                if terms:
                    idx = term_idx.setdefault(i, self._initial_term(rb))
                    status = _status_with_affinity(
                        status, terms[idx].affinity_name)
                    affinity_name[i] = terms[idx].affinity_name
                items.append((spec, status))
            outcome = self._solve(
                items, clusters, keys=[keys_all[i] for i, _ in active],
                tokens=([tokens_all[i] for i, _ in active]
                        if tokens_all is not None else None))
            next_active: List[Tuple[int, ResourceBinding]] = []
            for (i, rb), res in zip(active, outcome):
                if isinstance(res, Exception):
                    terms = (rb.spec.placement.cluster_affinities
                             if rb.spec.placement else [])
                    if terms and term_idx.get(i, 0) + 1 < len(terms):
                        term_idx[i] = term_idx[i] + 1
                        next_active.append((i, rb))
                        continue
                results[i] = res
            active = next_active
        return results, affinity_name

    @staticmethod
    def _initial_term(rb: ResourceBinding) -> int:
        """Resume from the observed affinity term (scheduler.go:599-616)."""
        terms = (rb.spec.placement.cluster_affinities
                 if rb.spec.placement else [])
        observed = rb.status.scheduler_observed_affinity_name
        for idx, t in enumerate(terms):
            if t.affinity_name == observed:
                return idx
        return 0

    def _solve(self, items, clusters, keys=None, tokens=None) -> List[object]:
        """Per item List[TargetCluster] or an Exception, by the backend:
        "device" one schedule_items call (device routes on the card, host
        routes on the serial path, through the resident plane when it is
        armed); "native" the C++ control, then ops/serial.schedule over the
        rows it leaves; "serial" ops/serial.schedule over every row."""
        if self.backend != "device":
            return self._solve_host(items, clusters)
        st = PipelineResult()
        out = schedule_items(
            items, clusters, chunk=self.pipeline_chunk, waves=self.waves,
            device=self.device, estimator=self._general,
            enable_empty_workload_propagation=(
                self.enable_empty_workload_propagation),
            stats=st, shortlist=self.shortlist, keys=keys,
            resident=self._resident,
            deltas=(self._delta_tracker.drain()
                    if self._delta_tracker is not None else None),
            tokens=tokens)
        if self._cycle_stats is not None:
            self._cycle_stats.chunks += st.chunks
            for k in _STAGES:
                setattr(self._cycle_stats, k,
                        getattr(self._cycle_stats, k) + getattr(st, k))
        return out

    def _solve_host(self, items, clusters) -> List[object]:
        out: List[object] = [None] * len(items)
        handled: List[int] = []
        if self.backend == "native" and items:
            handled = self._solve_native(items, clusters, out)
        done = set(handled)
        t0 = time.perf_counter()
        cal = serial.make_cal_available([self._general])
        for i, (spec, status) in enumerate(items):
            if i in done:
                continue
            try:
                out[i] = serial.schedule(
                    spec, status, clusters, cal,
                    enable_empty_workload_propagation=(
                        self.enable_empty_workload_propagation))
            except Exception as e:  # noqa: BLE001 — the binding's outcome
                out[i] = e
        self._host_stats["serial_s"] += time.perf_counter() - t0
        return out

    def _solve_native(self, items, clusters, out: List[object]) -> List[int]:
        """backend="native": the compiled C++ control (native/) schedules
        the whole batch on the host; rows in its unsupported classes
        (multi-component sets, vanished previous clusters, resource-model
        histograms, weights of 2^31 or more) are left to the serial path,
        as is every row under empty-workload propagation (the control has
        no such mode).  Fills `out`; returns the indices it handled."""
        if self.enable_empty_workload_propagation:
            return []
        t0 = time.perf_counter()
        cached = self._native_snap
        if cached is not None and cached[0] is clusters:
            snap = cached[1]
        else:
            snap = native_mod.NativeSnapshot(
                clusters, native_mod.collect_res_names(items))
            self._native_snap = (clusters, snap)
        nb = native_mod.marshal_batch(items, snap)
        t1 = time.perf_counter()
        results = native_mod.run_marshaled(nb, snap)
        t2 = time.perf_counter()
        handled: List[int] = []
        for i, (st, targets) in enumerate(results):
            if st == native_mod.STATUS_OK:
                out[i] = targets
            elif st == native_mod.STATUS_FIT_ERROR:
                spec_i, status_i = items[i]
                _, diagnosis = serial.find_clusters_that_fit(
                    spec_i, status_i, clusters)
                out[i] = serial.FitError(diagnosis)
            elif st == native_mod.STATUS_UNSCHEDULABLE:
                out[i] = serial.UnschedulableError(
                    "insufficient capacity (native)")
            elif st == native_mod.STATUS_NO_CLUSTER:
                out[i] = serial.NoClusterAvailableError(
                    "no clusters available to schedule")
            else:  # STATUS_UNSUPPORTED: the serial path owns it
                continue
            handled.append(i)
        self._host_stats["native_marshal_s"] += t1 - t0
        self._host_stats["native_s"] += t2 - t1
        return handled

    # -- result patch-back (patchScheduleResultForResourceBinding :664) -----
    def _apply_result(self, rb: ResourceBinding, res, affinity_name: str):
        """Patch the schedule outcome back; returns it."""
        if res is None:
            return None
        if isinstance(res, Exception):
            reason = (REASON_NO_FIT if isinstance(res, serial.FitError)
                      else REASON_UNSCHEDULABLE)

            def mark_failed(obj: ResourceBinding) -> None:
                set_condition(obj.status.conditions, Condition(
                    type=COND_SCHEDULED, status="False", reason=reason,
                    message=str(res)))
                if affinity_name:
                    obj.status.scheduler_observed_affinity_name = affinity_name

            self.store.mutate(ResourceBinding.KIND, rb.namespace, rb.name,
                              mark_failed)
            return res
        # success: patch spec.clusters, then record the STORED generation
        # in status -- two steps, as the reference does
        targets: List[TargetCluster] = res

        def patch_spec(obj: ResourceBinding) -> None:
            obj.spec.clusters = list(targets)

        stored = self.store.mutate(ResourceBinding.KIND, rb.namespace,
                                   rb.name, patch_spec)

        def patch_status(obj: ResourceBinding) -> None:
            obj.status.scheduler_observed_generation = (
                stored.metadata.generation)
            if affinity_name:
                obj.status.scheduler_observed_affinity_name = affinity_name
            obj.status.last_scheduled_time = time.time()
            set_condition(obj.status.conditions, Condition(
                type=COND_SCHEDULED, status="True", reason=REASON_SUCCESS))

        self.store.mutate(ResourceBinding.KIND, rb.namespace, rb.name,
                          patch_status)
        return res

    def faults(self) -> Dict[str, int]:
        """Contained faults of the scheduler and its rebalance plane, by
        kind (empty on a clean run)."""
        out = dict(self.cycle_faults)
        if self.rebalance_plane is not None:
            for k, n in self.rebalance_plane.cycle_faults.items():
                out[f"rebalance:{k}"] = n
        return out


def _priority_of(rb: ResourceBinding) -> int:
    return rb.spec.schedule_priority or 0


def _is_scheduled_empty(rb: ResourceBinding) -> bool:
    """A successfully scheduled binding may legitimately have no targets
    (e.g. a replicas=0 workload); the Scheduled condition disambiguates."""
    return any(c.type == COND_SCHEDULED and c.status == "True"
               for c in rb.status.conditions)


def _status_with_affinity(status: ResourceBindingStatus,
                          name: str) -> ResourceBindingStatus:
    out = copy.deepcopy(status)
    out.scheduler_observed_affinity_name = name
    return out
