"""RebalancePlane: the periodic drain-and-re-place cycle on the solver.

Counterpart of the JAX package's ``rebalance/plane.py`` (the reference's
pkg/descheduler loop on the scheduler's own solver).  Every `interval_s`
on the scheduler queue's clock the plane runs

  detect    K13 (ops/rebalance_detect) scores per-cluster overcommit and
            spread divergence over [C] tensors assembled from the live
            fleet: committed replicas per cluster from the store's
            schedule results, capacity from the clusters' allocatable
            pods;
  drain     on each over-threshold cluster, victims (lowest schedule
            priority first, then the largest allotment there, then key)
            are evicted through the graceful-eviction chain
            (controllers/failover.evict_cluster, producer "rebalance"):
            the replica leaves spec.clusters but its Work survives until
            the replacement reports healthy.  Every eviction draws a token
            from the shared pacing budget (rebalance/pacing.py);
  re-place  the eviction bumps the binding's generation, so it re-enters
            the scheduler through the normal push, and the plane promotes
            it with origin "rebalance" (Scheduler.promote) so the next
            cycle re-solves it through schedule_items;
  audit     conservation: no binding with an in-flight rebalance eviction
            may serve fewer than its desired replicas (spec.clusters plus
            pending eviction tasks >= spec.replicas); violations are
            counted.

Chaos seam `rebalance.plan` (skip / raise) fires at the top of the
cycle.  A raising cycle is contained by maybe_run (the periodic loop
survives) and counted in `cycle_faults` and
karmada_rebalance_cycle_faults_total by exception kind (a chaos skip as
"chaos_skip"): a K13 build or launch failure shows there, never only as a
plane that detects nothing.  Host
time per stage of the last cycle is in `last_timing` (and the kernel's
CUDA-event time on a card).
"""

from __future__ import annotations

import threading
import time
import traceback
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from karmada_tpu_torch import chaos as chaos_mod
from karmada_tpu_torch import obs
from karmada_tpu_torch.controllers.failover import evict_cluster
from karmada_tpu_torch.device import resolve_device
from karmada_tpu_torch.models.cluster import Cluster
from karmada_tpu_torch.models.policy import REPLICA_SCHEDULING_DIVIDED
from karmada_tpu_torch.models.work import ResourceBinding
from karmada_tpu_torch.ops import rebalance_detect
from karmada_tpu_torch.ops.tensors import fleet_capacity
from karmada_tpu_torch.rebalance.pacing import EvictionBudget
from karmada_tpu_torch.store.store import NotFoundError
from karmada_tpu_torch.utils import events as ev
from karmada_tpu_torch.utils.metrics import REGISTRY

PRODUCER = "rebalance"

CYCLES = REGISTRY.counter(
    "karmada_rebalance_cycles_total",
    "Rebalance detect cycles run (drains or not)",
)

EVICTIONS = REGISTRY.counter(
    "karmada_rebalance_evictions_total",
    "Graceful evictions initiated by the rebalance plane, by cluster "
    "drained from",
    ("cluster",),
)

CYCLE_FAULTS = REGISTRY.counter(
    "karmada_rebalance_cycle_faults_total",
    "Rebalance cycles skipped or aborted by a fault (chaos rebalance.plan "
    "seam included), by kind — the cycle is contained, the plane keeps "
    "running",
    ("kind",),
)

CONSERVATION_VIOLATIONS = REGISTRY.counter(
    "karmada_rebalance_conservation_violations_total",
    "Bindings observed serving fewer than their desired replicas while a "
    "rebalance eviction was in flight (the invariant the drain chain "
    "must never break)",
)

OVERCOMMIT = REGISTRY.gauge(
    "karmada_rebalance_overcommit_milli",
    "Last detect cycle's committed/capacity ratio x1000 per cluster",
    ("cluster",),
)

DRAIN_NEED = REGISTRY.gauge(
    "karmada_rebalance_drain_need",
    "Replicas the last detect cycle wants shed per cluster to get back "
    "inside the thresholds",
    ("cluster",),
)

CONVERGED = REGISTRY.gauge(
    "karmada_rebalance_converged",
    "1 while the last detect cycle found no cluster needing a drain",
)

#: the spread gate when spread_tolerance_milli is 0 (report-only):
#: div_milli is bounded by +/-1000, so a gate this far above it never
#: selects a spread drain
SPREAD_REPORT_ONLY = 1 << 20


@dataclass(frozen=True)
class RebalanceConfig:
    """Thresholds and pacing of one rebalance plane (milli ratios are ints
    so the detect stays float-free)."""

    interval_s: float = 30.0
    # drain a cluster above committed > threshold x capacity
    overcommit_threshold_milli: int = 1000
    # drain a cluster whose committed share exceeds its capacity share by
    # more than this (x1000); 0 keeps divergence report-only
    spread_tolerance_milli: int = 0
    # pacing: hard cap per cycle across the fleet, and the shared
    # per-cluster-per-window budget
    max_evictions_per_cycle: int = 32
    budget_per_cluster: int = 8
    budget_interval_s: float = 60.0


class RebalancePlane:
    """One scheduler's rebalance loop: a runtime periodic hook (maybe_run)
    gated on the scheduler queue's clock; detect runs on `device` (the
    first CUDA card by default, "cpu" for the plain version)."""

    def __init__(self, store, scheduler, cfg: Optional[RebalanceConfig] = None,
                 budget: Optional[EvictionBudget] = None, clock=None,
                 device=None) -> None:
        self.store = store
        self.scheduler = scheduler
        self.cfg = cfg if cfg is not None else RebalanceConfig()
        self.clock = clock if clock is not None else scheduler.queue.now
        self.device = resolve_device(device)
        self.budget = budget if budget is not None else EvictionBudget(
            per_cluster=self.cfg.budget_per_cluster,
            interval_s=self.cfg.budget_interval_s, clock=self.clock)
        self._lock = threading.Lock()
        # fleet_capacity's (name -> (rv, pods)) memo: one per plane, as an
        # rv names one cluster state only within one store
        self._cap_memo: Dict[str, Tuple[int, int]] = {}
        self._last: Dict[str, object] = {}
        self._peak_over: Dict[str, int] = {}
        self._cycles = 0
        self._evictions = 0
        self._violations = 0
        self._violation_samples: List[dict] = []
        self._last_run = float("-inf")
        #: evictions by the cluster drained from (lifetime)
        self.evictions_by_cluster: Dict[str, int] = {}
        #: cycles maybe_run contained, by exception kind
        self.cycle_faults: Dict[str, int] = {}
        #: host seconds per stage of the last cycle (+ kernel_ms on a card)
        self.last_timing: Dict[str, float] = {}

    # -- periodic entry ------------------------------------------------------
    def maybe_run(self) -> None:
        """Run a cycle when the interval (on the scheduler's clock) has
        elapsed.  A raising cycle is contained and counted."""
        now = self.clock()
        if now - self._last_run < self.cfg.interval_s:
            return
        self._last_run = now
        try:
            self.run_cycle()
        except Exception as e:  # noqa: BLE001 — cycle fault containment
            kind = type(e).__name__
            self._count_fault(kind)
            traceback.print_exc()

    def _count_fault(self, kind: str) -> None:
        CYCLE_FAULTS.inc(kind=kind)
        with self._lock:
            self.cycle_faults[kind] = self.cycle_faults.get(kind, 0) + 1

    # -- one cycle -----------------------------------------------------------
    def run_cycle(self) -> dict:
        """detect -> drain -> audit; returns the cycle snapshot."""
        if chaos_mod.armed():
            f = chaos_mod.fire(chaos_mod.SITE_REBALANCE_PLAN)
            if f is not None:
                if f.mode == "skip":
                    # the planned cycle is dropped whole; the next interval
                    # re-detects from fresh state, nothing is lost
                    self._count_fault("chaos_skip")
                    return {"skipped": "chaos"}
                raise RuntimeError("chaos: rebalance.plan raise")
        timing: Dict[str, float] = {}
        with obs.TRACER.span(obs.SPAN_REBALANCE_CYCLE) as cspan:
            t0 = time.perf_counter()
            # read-only scans: the stored objects, not copies (a drain
            # replaces a binding in the store; the audit reads the scan's)
            clusters = self.store.visit(Cluster.KIND)
            bindings = self.store.visit(ResourceBinding.KIND)
            t1 = time.perf_counter()
            with obs.TRACER.span(obs.SPAN_REBALANCE_DETECT,
                                 clusters=len(clusters),
                                 bindings=len(bindings)):
                names, committed, capacity, valid, by_cluster = (
                    self._assemble(clusters, bindings))
                t2 = time.perf_counter()
                if names:
                    spread_tol = (self.cfg.spread_tolerance_milli
                                  if self.cfg.spread_tolerance_milli > 0
                                  else SPREAD_REPORT_ONLY)
                    drain_need, over_milli, div_milli = (
                        rebalance_detect.score(
                            committed, capacity, valid,
                            self.cfg.overcommit_threshold_milli, spread_tol,
                            device=self.device, timing=timing))
                else:
                    drain_need = over_milli = div_milli = np.zeros(
                        0, np.int64)
            t3 = time.perf_counter()
            with obs.TRACER.span(obs.SPAN_REBALANCE_DRAIN) as dspan:
                evicted = self._drain(names, drain_need, by_cluster)
                if dspan:
                    dspan.set_attr(evicted=evicted)
            t4 = time.perf_counter()
            violations = self._audit_conservation(bindings)
            t5 = time.perf_counter()
            timing.update(list_s=t1 - t0, assemble_s=t2 - t1,
                          detect_s=t3 - t2, drain_s=t4 - t3,
                          audit_s=t5 - t4)
            self.last_timing = timing
            snapshot = self._publish(names, committed, capacity, drain_need,
                                     over_milli, div_milli, evicted,
                                     violations)
            if cspan:
                cspan.set_attr(evicted=evicted,
                               converged=snapshot["converged"])
        return snapshot

    # -- detect assembly -----------------------------------------------------
    def _assemble(self, clusters, bindings) -> Tuple:
        """[C] committed/capacity/valid arrays and the per-cluster victim
        candidates.  Committed counts the store's current schedule
        results (spec.clusters); capacity is the allocatable pod count."""
        names = [c.metadata.name for c in clusters]
        idx = {n: i for i, n in enumerate(names)}
        committed = np.zeros(len(names), np.int64)
        valid = np.zeros(len(names), dtype=bool)
        capacity = fleet_capacity(clusters, self._cap_memo)
        for i, c in enumerate(clusters):
            summary = c.status.resource_summary
            pods = summary.allocatable.get("pods") if summary else None
            valid[i] = (not c.metadata.deleting) and pods is not None
        # cluster -> [(key, priority, replicas_here, rb)] victim candidates
        by_cluster: Dict[str, List[Tuple]] = {}
        for rb in bindings:
            eligible = self._eligible(rb)
            for t in rb.spec.clusters:
                ci = idx.get(t.name)
                if ci is None:
                    continue
                committed[ci] += t.replicas
                if eligible:
                    by_cluster.setdefault(t.name, []).append(
                        ((rb.namespace, rb.name),
                         rb.spec.schedule_priority or 0, t.replicas, rb))
        return names, committed, capacity, valid, by_cluster

    @staticmethod
    def _eligible(rb: ResourceBinding) -> bool:
        """Drain candidates: Divided bindings, not deleting, scheduling not
        suspended, with no rebalance eviction in flight.  Duplicated
        placements are never drained (a re-solve would put them back)."""
        if rb.metadata.deleting:
            return False
        if rb.spec.suspension is not None and rb.spec.suspension.scheduling:
            return False
        if any(t.producer == PRODUCER
               for t in rb.spec.graceful_eviction_tasks):
            return False
        placement = rb.spec.placement
        if placement is None or placement.replica_scheduling is None:
            return False
        return (placement.replica_scheduling.replica_scheduling_type
                == REPLICA_SCHEDULING_DIVIDED)

    # -- drain ---------------------------------------------------------------
    def _drain(self, names, drain_need, by_cluster) -> int:
        """Evict victims on over-threshold clusters under the pacing
        budget; returns evictions performed.  Clusters by need (largest
        first, then name); victims by (priority, -allotment, key)."""
        order = sorted(range(len(names)),
                       key=lambda i: (-int(drain_need[i]), names[i]))
        evicted = 0
        capped = False
        # a binding spanning two over-threshold clusters settles its first
        # drain before the next (what _eligible enforces between cycles)
        drained_keys: set = set()
        for ci in order:
            need = int(drain_need[ci])
            if need <= 0 or capped:
                break
            cname = names[ci]
            victims = sorted(by_cluster.get(cname, ()),
                             key=lambda v: (v[1], -v[2], v[0]))
            for key, prio, reps, _rb in victims:
                if evicted >= self.cfg.max_evictions_per_cycle:
                    capped = True
                    break
                if need <= 0:
                    break
                if key in drained_keys:
                    continue
                if not self.budget.try_acquire(cname, consumer=PRODUCER):
                    # a lifecycle fact on the cluster's timeline: the
                    # drain wanted to act and pacing said no
                    ev.emit(ev.ObjectRef(kind="Cluster", name=cname),
                            ev.TYPE_WARNING, ev.REASON_EVICTION_BUDGET_DENIED,
                            "rebalance drain deferred: per-cluster eviction "
                            "pacing budget exhausted for this window",
                            origin=PRODUCER)
                    break  # this cluster's window is spent; next interval
                if self._evict(key, cname, prio):
                    EVICTIONS.inc(cluster=cname)
                    self.evictions_by_cluster[cname] = (
                        self.evictions_by_cluster.get(cname, 0) + 1)
                    drained_keys.add(key)
                    evicted += 1
                    need -= reps
        with self._lock:
            self._evictions += evicted
        return evicted

    def _evict(self, key, cname: str, priority: int) -> bool:
        """One graceful eviction and the re-place promotion."""
        ns, name = key
        changed = []

        def do_evict(obj: ResourceBinding) -> None:
            changed.clear()  # mutate may retry the closure
            if evict_cluster(obj, cname, reason="Rebalance",
                             producer=PRODUCER, now=self.clock()):
                changed.append(True)

        try:
            self.store.mutate(ResourceBinding.KIND, ns, name, do_evict)
        except NotFoundError:
            return False
        if changed:
            ev.emit_key(key, ev.TYPE_NORMAL, ev.REASON_REBALANCE_EVICTED,
                        f"gracefully evicted from {cname} by the rebalance "
                        "drain (re-placed with a priority push)",
                        origin=PRODUCER)
            self.scheduler.promote(key, priority=priority, origin=PRODUCER)
        return bool(changed)

    # -- conservation audit --------------------------------------------------
    def _audit_conservation(self, bindings) -> List[dict]:
        """Bindings with an in-flight rebalance eviction serving fewer than
        their desired replicas (spec.clusters + pending task replicas)."""
        violations: List[dict] = []
        for rb in bindings:
            tasks = [t for t in rb.spec.graceful_eviction_tasks
                     if t.producer == PRODUCER]
            if not tasks:
                continue
            serving = (sum(t.replicas for t in rb.spec.clusters)
                       + sum(t.replicas for t in tasks))
            if serving < rb.spec.replicas:
                violations.append({
                    "binding": f"{rb.namespace}/{rb.name}",
                    "serving": serving, "desired": rb.spec.replicas})
        if violations:
            CONSERVATION_VIOLATIONS.inc(len(violations))
            with self._lock:
                self._violations += len(violations)
                self._violation_samples = (
                    self._violation_samples + violations)[-16:]
        return violations

    # -- state ---------------------------------------------------------------
    def _publish(self, names, committed, capacity, drain_need, over_milli,
                 div_milli, evicted: int, violations) -> dict:
        CYCLES.inc()
        per_cluster = {}
        for i, n in enumerate(names):
            per_cluster[n] = {
                "committed": int(committed[i]),
                "capacity": int(capacity[i]),
                "over_milli": int(over_milli[i]),
                "div_milli": int(div_milli[i]),
                "drain_need": int(drain_need[i]),
            }
            OVERCOMMIT.set(float(over_milli[i]), cluster=n)
            DRAIN_NEED.set(float(drain_need[i]), cluster=n)
        converged = not any(int(d) > 0 for d in drain_need)
        CONVERGED.set(1.0 if converged else 0.0)
        snapshot = {
            "t": round(self.clock(), 6),
            "clusters": per_cluster,
            "evicted": evicted,
            "converged": converged,
            "violations": len(violations),
        }
        with self._lock:
            self._cycles += 1
            self._last = snapshot
            for n, row in per_cluster.items():
                if row["over_milli"] > self._peak_over.get(n, 0):
                    self._peak_over[n] = row["over_milli"]
        return snapshot

    def converged(self) -> bool:
        """True when the last detect cycle found nothing to drain (and at
        least one cycle ran)."""
        with self._lock:
            return bool(self._last) and bool(self._last.get("converged"))

    def pending_drains(self) -> int:
        """In-flight rebalance eviction tasks across the store (0 means
        every drain settled)."""
        return sum(
            sum(1 for t in rb.spec.graceful_eviction_tasks
                if t.producer == PRODUCER)
            for rb in self.store.visit(ResourceBinding.KIND))

    def stats(self) -> dict:
        """The plane's state: config, lifetime counts, budget, the peak
        and last per-cluster scores, contained faults."""
        with self._lock:
            last = dict(self._last)
            peak = dict(self._peak_over)
            cycles = self._cycles
            evictions = self._evictions
            violations = self._violations
            samples = list(self._violation_samples)
        return {
            "enabled": True,
            "config": {
                "interval_s": self.cfg.interval_s,
                "overcommit_threshold_milli":
                    self.cfg.overcommit_threshold_milli,
                "spread_tolerance_milli": self.cfg.spread_tolerance_milli,
                "max_evictions_per_cycle": self.cfg.max_evictions_per_cycle,
            },
            "cycles": cycles,
            "evictions": evictions,
            "conservation_violations": violations,
            "violation_samples": samples,
            "budget": self.budget.state(),
            "peak_over_milli": peak,
            "last": last,
            "evictions_by_cluster": dict(self.evictions_by_cluster),
            "cycle_faults": dict(self.cycle_faults),
            "device": str(self.device),
        }
