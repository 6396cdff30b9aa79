"""LoadDriver: open-loop synthetic traffic against the serve plane.

Counterpart of the JAX package's ``loadgen/driver.py``: the same clocks,
service model, recipes, slice and driver, driving the port's Scheduler
(on the card with `ServeSlice(backend="device")`, unless the caller
passes ``device="cpu"``).  A chaotic scenario (`Scenario.chaotic`: chaos
and hotspot) arms the process-wide chaos plane (chaos/), applies its
scheduled fault windows on the virtual clock, runs the per-cycle
estimator fan-out harness in compressed mode, and ends with the safety
auditor (chaos/audit.py) over the intact plane.

The driver injects ResourceBindings and cluster events through the SAME
store/worker paths real traffic takes — store.create/mutate fires the
watch bus, the scheduler's _on_event pushes through the admission gate,
the worker drains batched cycles — so a soak exercises the production
admission / batch-formation / backoff machinery, not a simulation of it.

Two execution modes:

  * compressed (the default): an injected VirtualClock plus a
    ServiceModel.  The driver wraps `scheduler.schedule_batch`; each
    cycle advances virtual time by its modeled cost
    (per_cycle_s + n * per_binding_s), stepping the clock through every
    arrival that lands WHILE the cycle runs so their queue timestamps
    are exact.  An arrival rate of "2x capacity" is then a precise
    statement (capacity = 1/per_binding_s), wall time is whatever the
    real solves cost, and every assertion is deterministic.
  * realtime: wall clock, no wrapping — arrivals are paced by a daemon
    thread against a live serve plane (`karmadactl serve --loadgen`).

The active driver registers itself process-wide (`set_active`) so
/debug/load (utils/httpserve) can publish live state (`load_state()`).
"""

from __future__ import annotations

import random
import threading
import time as _time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from karmada_tpu_torch.loadgen.scenarios import Scenario
from karmada_tpu_torch.models.cluster import (
    APIEnablement,
    Cluster,
    ClusterSpec,
    ClusterStatus,
    ResourceSummary,
)
from karmada_tpu_torch.models.meta import ObjectMeta
from karmada_tpu_torch.models.policy import (
    ClusterAffinity,
    Placement,
    PropagationPolicy,
    PropagationSpec,
    REPLICA_DIVISION_AGGREGATED,
    REPLICA_SCHEDULING_DIVIDED,
    REPLICA_SCHEDULING_DUPLICATED,
    ReplicaSchedulingStrategy,
    ResourceSelector,
)
from karmada_tpu_torch.models.unstructured import Unstructured
from karmada_tpu_torch.models.work import (
    COND_SCHEDULED,
    ObjectReference,
    ResourceBinding,
    ResourceBindingSpec,
)
from karmada_tpu_torch.scheduler import metrics as sched_metrics
from karmada_tpu_torch.scheduler.queue import SchedulingQueue
from karmada_tpu_torch.scheduler.service import Scheduler
from karmada_tpu_torch.obs import events as obs_events
from karmada_tpu_torch.store.store import DELETED, Event, NotFoundError, ObjectStore
from karmada_tpu_torch.store.worker import Runtime
from karmada_tpu_torch.utils.locks import VetLock
from karmada_tpu_torch.utils.quantity import Quantity

LOADGEN_NS = "loadgen"
PRIORITY_HIGH = 10


class VirtualClock:
    """Injectable monotonic clock for compressed-time soaks — the same
    object serves as the SchedulingQueue's `now` and the driver's event
    timeline, so dwell/e2e are measured on one consistent axis."""

    def __init__(self, start: float = 1_000_000.0) -> None:
        self._t = start  # guarded-by: _lock
        self._lock = VetLock("loadgen.clock")

    def now(self) -> float:
        return self._t

    __call__ = now

    def advance(self, dt: float) -> float:
        with self._lock:
            self._t += max(0.0, dt)
            return self._t

    def advance_to(self, t: float) -> float:
        with self._lock:
            if t > self._t:
                self._t = t
            return self._t


class RealClock:
    """Wall clock with the same surface (realtime mode); advances are
    no-ops because reality advances itself."""

    def now(self) -> float:
        return _time.time()

    __call__ = now

    def advance(self, dt: float) -> float:
        return self.now()

    def advance_to(self, t: float) -> float:
        return self.now()


@dataclass(frozen=True)
class ServiceModel:
    """Virtual cost of one scheduling cycle in compressed mode.  The
    plane's solve capacity is 1/per_binding_s bindings/second (the
    per-cycle overhead is why trickle batching matters: many small
    cycles pay it per few bindings).  bench --soak calibrates
    per_binding_s from a real measured cycle; tier-1 tests fix it."""

    per_binding_s: float = 0.01
    per_cycle_s: float = 0.02

    def cost(self, n: int) -> float:
        return self.per_cycle_s + n * self.per_binding_s

    @property
    def capacity_rate(self) -> float:
        return 1.0 / self.per_binding_s


def build_cluster(name: str, cpu_milli: int = 64_000, memory_gi: int = 256,
                  pods: int = 1000, region: str = "") -> Cluster:
    return Cluster(
        metadata=ObjectMeta(name=name),
        spec=ClusterSpec(region=region or None),
        status=ClusterStatus(
            api_enablements=[APIEnablement("apps/v1", ["Deployment"])],
            resource_summary=ResourceSummary(
                allocatable={"cpu": Quantity.parse(str(cpu_milli) + "m"),
                             "memory": Quantity.parse(f"{memory_gi}Gi"),
                             "pods": Quantity.parse(str(pods))},
            ),
        ),
    )


def _scheduling_strategy(divided: bool) -> ReplicaSchedulingStrategy:
    if divided:
        # Divided + Aggregated: pack the replicas into the fewest
        # most-available clusters — the shape rebalance drains act on
        return ReplicaSchedulingStrategy(
            replica_scheduling_type=REPLICA_SCHEDULING_DIVIDED,
            replica_division_preference=REPLICA_DIVISION_AGGREGATED)
    return ReplicaSchedulingStrategy(
        replica_scheduling_type=REPLICA_SCHEDULING_DUPLICATED)


def build_binding(name: str, priority: int = 0,
                  namespace: str = LOADGEN_NS,
                  resource_name: Optional[str] = None,
                  replicas: int = 1,
                  divided: bool = False,
                  affinity: Optional[List[str]] = None) -> ResourceBinding:
    """A synthetic binding: Duplicated placement over every feasible
    cluster (no affinity restriction), so cluster kills force real
    rescheduling work — or, with `divided`, Divided+Aggregated packing
    of `replicas` into the fewest clusters (the rebalance plane's
    drainable shape).  `resource_name` points every binding at one
    shared template (full-ControlPlane runs, where the binding
    controller renders real Works from it).  `affinity` restricts the
    placement to the named clusters (the megafleet shape: per-tenant
    eligible sets a shortlist k covers)."""
    rb = ResourceBinding()
    rb.metadata.namespace = namespace
    rb.metadata.name = name
    rb.spec = ResourceBindingSpec(
        resource=ObjectReference(api_version="apps/v1", kind="Deployment",
                                 namespace=namespace,
                                 name=resource_name or name,
                                 uid=f"uid-{name}"),
        replicas=replicas,
        placement=Placement(
            cluster_affinity=(ClusterAffinity(cluster_names=list(affinity))
                              if affinity else None),
            replica_scheduling=_scheduling_strategy(divided)),
        schedule_priority=priority or None,
    )
    return rb


def build_workload_manifest(name: str, replicas: int,
                            namespace: str = LOADGEN_NS) -> dict:
    """A Deployment template for policy-path injection: the detector
    matches it against the loadgen PropagationPolicy and renders the
    ResourceBinding — the full template -> policy -> binding fan-out."""
    return {
        "apiVersion": "apps/v1", "kind": "Deployment",
        "metadata": {"name": name, "namespace": namespace,
                     "labels": {"loadgen.karmada.io/injected": "true"}},
        "spec": {"replicas": replicas, "template": {"spec": {
            "containers": [{"name": "app", "image": "app:1",
                            "resources": {"requests": {"cpu": "100m"}}}],
        }}},
    }


def build_loadgen_policy(divided: bool,
                         namespace: str = LOADGEN_NS) -> PropagationPolicy:
    """ONE PropagationPolicy claiming every policy-path workload in the
    loadgen namespace (detector/policy fan-out under load)."""
    return PropagationPolicy(
        metadata=ObjectMeta(name="lg-policy", namespace=namespace),
        spec=PropagationSpec(
            resource_selectors=[ResourceSelector(
                api_version="apps/v1", kind="Deployment",
                namespace=namespace)],
            placement=Placement(
                replica_scheduling=_scheduling_strategy(divided)),
        ),
    )


def warm_device_path(plane, sizes: Tuple[int, ...] = (2, 9, 17, 64),
                     aot_variants: bool = True) -> None:
    """Warm a device-backend slice before a guarded soak: direct
    schedule_batch calls pay the first-use costs (the kernels' build, the
    native paths' build, the first launches) outside the mid-serve
    guard's window, so a tight device_cycle_timeout_s measures stuck
    cycles, not first calls.  The warm bindings stay in the store as
    ordinary residents (not flight-tracked, so reports ignore them).
    With `aot_variants` the other variants this Scheduler can dispatch
    (explain, carry, shortlist) run once each too, through the port's
    warm hook (ops/aotcache.warm_executables)."""
    from karmada_tpu_torch.models.work import ResourceBinding as _RB

    sched = plane.scheduler
    prev = sched.device_cycle_timeout_s
    sched.device_cycle_timeout_s = None
    made = 0
    try:
        clusters = list(plane.store.list(Cluster.KIND))
        for size in sizes:
            names = []
            for _ in range(size):
                names.append(f"lg-warm{made:03d}")
                made += 1
                plane.store.create(build_binding(names[-1]))
            rbs = [plane.store.try_get(_RB.KIND, LOADGEN_NS, name)
                   for name in names]
            sched.schedule_batch(
                [rb for rb in rbs if rb is not None], clusters)
        if aot_variants and sched.backend == "device":
            from karmada_tpu_torch.ops import aotcache

            shortlist_k = (sched.shortlist.k if sched.shortlist is not None
                           else None)
            variants = tuple(
                v for v in aotcache.variants_for(
                    sched.explain,
                    sched.batch_window > sched.pipeline_chunk,
                    shortlist=bool(shortlist_k))
                if v != aotcache.VARIANT_PLAIN)
            if variants:
                aotcache.warm_executables(
                    clusters, sched._general,  # noqa: SLF001 — same package
                    shapes=sizes, variants=variants, waves=sched.waves,
                    keep_sel=sched.enable_empty_workload_propagation,
                    shortlist_k=shortlist_k, device=sched.device)
    finally:
        sched.device_cycle_timeout_s = prev


class ReplacementStatusEcho:
    """Stand-in for the member status-collection chain in the
    scheduler-only slice: whenever a binding's schedule result changes,
    report every target cluster applied + Healthy in aggregated_status.
    The graceful-eviction controller then drains rebalance eviction
    tasks on the PRODUCTION signal (replacement healthy), not only on
    grace expiry.  Terminates trivially: once the echo matches the spec,
    further events are no-ops (the store's drain loop is re-entrancy
    safe for subscriber writes)."""

    def __init__(self, store: ObjectStore) -> None:
        self.store = store
        store.bus.subscribe(self._on_event, kind=ResourceBinding.KIND)

    def _on_event(self, event: Event) -> None:
        if event.type == DELETED:
            return
        rb = event.obj
        want = {t.name for t in rb.spec.clusters}
        have = {i.cluster_name for i in rb.status.aggregated_status
                if i.applied and i.health == "Healthy"}
        if want == have:
            return
        from karmada_tpu_torch.models.work import AggregatedStatusItem

        def echo(obj: ResourceBinding) -> None:
            obj.status.aggregated_status = [
                AggregatedStatusItem(cluster_name=t.name, applied=True,
                                     health="Healthy")
                for t in obj.spec.clusters]

        try:
            self.store.mutate(ResourceBinding.KIND, rb.metadata.namespace,
                              rb.metadata.name, echo)
        except NotFoundError:
            pass


class ServeSlice:
    """The scheduler-owning slice of a ControlPlane: store + runtime +
    batched scheduler over the same SchedulingQueue/worker machinery
    serve mode runs.  The full ControlPlane wires ~30 controllers the
    soak does not exercise; the slice keeps tier-1 soaks inside budget.
    LoadDriver duck-types its plane — anything exposing .store /
    .runtime / .scheduler (a ControlPlane included) drives the same.

    Scenario-driven extras: `policy_path` scenarios get the real
    ResourceDetector (template -> policy -> binding fan-out), and
    `rebalance_interval_cycles` scenarios arm the rebalance plane plus
    the graceful-eviction chain it drains through (with the status echo
    standing in for member health collection).

    `device` is the Scheduler's: with backend="device", None means the
    first CUDA card (raising without one) and "cpu" the kernels' plain
    versions."""

    def __init__(self, scenario: Scenario, clock, model: ServiceModel,
                 backend: str = "serial", explain: float = 0.0,
                 resident: bool = False,
                 resident_audit_interval: int = 64,
                 device_cycle_timeout_s: Optional[float] = None,
                 device_recover_cycles: Optional[int] = None,
                 device=None) -> None:
        self.store = ObjectStore()
        self.runtime = Runtime()
        reb_interval = scenario.rebalance_interval_s(model)
        reb_cfg = reb_budget = None
        if reb_interval > 0:
            from karmada_tpu_torch.rebalance import EvictionBudget, RebalanceConfig

            # per-cluster budget sized so a hotspot drain takes a couple
            # of windows (pacing visible in the soak, convergence still
            # bounded); the window is the rebalance interval itself
            reb_budget = EvictionBudget(per_cluster=24,
                                        interval_s=reb_interval,
                                        clock=clock)
            reb_cfg = RebalanceConfig(interval_s=reb_interval)
        self.scheduler = Scheduler(
            self.store, self.runtime, backend=backend, device=device,
            batch_window=scenario.batch_window,
            batch_deadline_s=scenario.deadline_s(model),
            queue=SchedulingQueue(now=clock,
                                  max_resident=scenario.admission_limit()),
            explain=explain,
            resident=resident,
            resident_audit_interval=resident_audit_interval,
            device_cycle_timeout_s=device_cycle_timeout_s,
            device_recover_cycles=device_recover_cycles,
            rebalance=(reb_interval or None),
            rebalance_cfg=reb_cfg,
            rebalance_budget=reb_budget,
            # scenario-driven shortlist tier (ops/shortlist): compressed
            # scales must still arm, so the cell threshold drops to 0 —
            # the scenario IS the operator's explicit opt-in
            shortlist_k=(scenario.shortlist_k or None),
            shortlist_min_cells=0,
        )
        if scenario.policy_path:
            from karmada_tpu_torch.controllers.detector import ResourceDetector
            from karmada_tpu_torch.interpreter import ResourceInterpreter

            self.interpreter = ResourceInterpreter()
            self.interpreter.attach_store(self.store)
            self.detector = ResourceDetector(self.store, self.runtime,
                                             self.interpreter)
        if reb_interval > 0:
            from karmada_tpu_torch.controllers.failover import (
                GracefulEvictionController,
            )

            # grace period far beyond the soak horizon: ONLY replacement
            # health may drain a task, so a conservation breach cannot
            # hide behind a grace-expiry drain
            self.graceful_eviction = GracefulEvictionController(
                self.store, self.runtime, grace_period_s=1e9, clock=clock)
            self.status_echo = ReplacementStatusEcho(self.store)
        for i in range(scenario.n_clusters):
            # group-affine fleets (scenario.n_regions > 0): clusters
            # round-robin into regions; megafleet bindings target one
            # region each via cluster affinity
            region = (f"lg-r{i % scenario.n_regions}"
                      if scenario.n_regions > 0 else "")
            self.store.create(build_cluster(f"lg-m{i}", region=region))


@dataclass
class _Flight:
    """Per-injected-binding lifecycle record (driver-side ground truth,
    cross-checking the span-derived report quantiles)."""

    t_inject: float
    priority: int
    done: bool = False
    t_done: float = 0.0
    failed_attempts: int = 0
    reschedules: int = 0


# -- /debug/load registry -----------------------------------------------------
_ACTIVE: Optional["LoadDriver"] = None  # guarded-by: _ACTIVE_LOCK
_ACTIVE_LOCK = VetLock("loadgen.active")


def set_active(driver: Optional["LoadDriver"]) -> None:
    global _ACTIVE
    with _ACTIVE_LOCK:
        _ACTIVE = driver


def load_state() -> dict:
    """The /debug/load payload: the active driver's live snapshot, or
    {"enabled": false} so dashboards can poll unconditionally."""
    with _ACTIVE_LOCK:
        driver = _ACTIVE
    if driver is None:
        return {"enabled": False}
    return driver.snapshot()


class LoadDriver:
    def __init__(
        self,
        plane,                       # .store / .runtime / .scheduler
        scenario: Scenario,
        clock=None,
        model: Optional[ServiceModel] = None,
        seed: int = 0,
        realtime: bool = False,
        # realtime only: mean arrival rate in real arrivals/second (the
        # scenario shape scales around it via its load_factor)
        realtime_rate: float = 20.0,
        trace_capacity: int = 4096,
        # point every synthetic binding at one shared resource template
        # (full-ControlPlane runs, so Works render from a real object)
        resource_name: Optional[str] = None,
    ) -> None:
        self.plane = plane
        self.scenario = scenario
        self.realtime = realtime
        self.resource_name = resource_name
        # policy-path mode: inject Deployment templates the detector
        # renders into bindings (the plane must wire a detector —
        # ServeSlice does for policy_path scenarios; a ControlPlane
        # always has one)
        self.policy_path = scenario.policy_path
        self.clock = clock if clock is not None else (
            RealClock() if realtime else VirtualClock())
        self.model = model if model is not None else ServiceModel()
        self.seed = seed
        self.rng = random.Random(seed)
        self.trace_capacity = trace_capacity
        # realtime runs drive a LIVE (possibly persistent) plane: binding
        # names must not collide with an earlier soak's leftovers in the
        # same store, so each run gets a wall-clock tag.  Compressed runs
        # keep the bare deterministic names (fresh plane, reproducible).
        self._name_tag = (f"{_time.time_ns() % 0xffffff:06x}-"
                          if realtime else "")
        # realtime: honor the documented contract (realtime_rate is the
        # MEAN arrival rate) for every shape — mean_rate is linear in
        # capacity, so solving mean_rate(cap) == realtime_rate is one
        # division.  Dividing by load_factor alone would overshoot burst
        # scenarios (their burst window adds arrivals on top of base).
        cap = (realtime_rate / max(scenario.mean_rate(1.0), 1e-9)
               if realtime else self.model.capacity_rate)
        self.capacity_rate = cap
        self.t0 = self.clock.now()
        self.duration_s = scenario.duration_s(cap)
        rate_fn, max_rate = scenario.rate_fn(cap, self.t0, self.duration_s)
        self.mean_rate = scenario.mean_rate(cap)
        from karmada_tpu_torch.loadgen.arrival import poisson_times

        self._arrivals: List[float] = poisson_times(
            rate_fn, max_rate, self.t0, self.t0 + self.duration_s, self.rng)
        self._events: List[Tuple[float, object]] = sorted(
            ((self.t0 + ev.at_frac * self.duration_s, ev)
             for ev in scenario.events), key=lambda p: p[0])
        self._arr_idx = 0
        self._evt_idx = 0
        self._n_injected = 0
        self._lock = VetLock("loadgen.flight")
        self._flight: Dict[Tuple[str, str], _Flight] = {}  # guarded-by: _lock
        self._max_depth: Dict[str, int] = {}  # guarded-by: _lock
        self._max_oldest: Dict[str, float] = {}  # guarded-by: _lock
        self._overload_seen = False
        self._killed: List[Cluster] = []   # kill/revive LIFO (driver thread)
        self._flapped: Dict[str, dict] = {}  # name -> original allocatable
        self._flap_rr = 0  # rotating flap_down victim cursor (driver thread)
        # "whatif" event answers (facade capacity queries fired mid-soak;
        # the whatif scenario asserts they leave placements bit-identical)
        self.whatif_results: List[dict] = []
        self._installed = False
        self._orig_schedule = None
        self._prev_recorder = None
        self._base_admission: Dict[str, float] = {}
        self._wall_t0 = 0.0
        self.wall_s = 0.0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.residual: dict = {}
        # chaos plumbing (scenario.chaotic): the driver arms the process-
        # wide chaos plane, runs the per-cycle estimator fan-out harness
        # (circuit-breaker dynamics on the virtual clock), and runs the
        # safety auditor before uninstall (harness + audit: compressed
        # mode only; a realtime chaotic scenario still arms the plane and
        # applies its scheduled fault windows)
        self._chaos = scenario.chaotic
        self._audit_baseline: dict = {}
        self.estimator_client = None
        self.estimator_breaker = None
        self.chaos_state: dict = {}
        self.safety_audit: Optional[dict] = None

    def _setup_chaos(self) -> None:
        """Arm the chaos plane (empty: the scenario's fault events add
        rules at their scheduled times) and, in compressed mode, the
        estimator fan-out harness: the AccurateEstimatorClient against
        one LocalTransport per loadgen cluster, retry sleeps no-oped
        (virtual time must not wall-sleep) and the circuit breaker's
        open-window on the soak's virtual clock.  One fan-out per
        scheduling cycle gives the breaker its traffic."""
        from karmada_tpu_torch import chaos as chaos_mod

        chaos_mod.configure("", seed=self.seed)
        self._audit_baseline = chaos_mod.capture_baseline()
        if self.realtime:
            return
        from karmada_tpu_torch.estimator.client import (
            AccurateEstimatorClient,
            CircuitBreaker,
        )
        from karmada_tpu_torch.estimator.wire import LocalTransport

        breaker = CircuitBreaker(
            failure_threshold=3,
            reset_timeout_s=self.model.cost(self.scenario.batch_window),
            clock=self.clock)
        client = AccurateEstimatorClient(
            breaker=breaker, sleep=lambda _s: None)
        for c in self.plane.store.list(Cluster.KIND):
            client.register(
                c.metadata.name,
                LocalTransport(lambda _m, _r: {"maxReplicas": 50,
                                               "unschedulableReplicas": 0}))
        self.estimator_client = client
        self.estimator_breaker = breaker

    def _estimator_probe(self) -> None:
        """One per-cycle estimator fan-out across the live fleet (the
        harness's stand-in for the scheduler's accurate-tier traffic).
        Uses the unschedulable-replicas call -- the one estimator method
        with no rv-keyed memo, so every probe really crosses the wire
        and the outage window's faults reach the breaker."""
        for c in self.plane.store.list(Cluster.KIND):
            self.estimator_client.unschedulable_replicas(
                c.metadata.name, "Deployment", LOADGEN_NS, "probe")

    # -- wiring --------------------------------------------------------------
    def _install(self) -> None:
        from karmada_tpu_torch import obs

        assert not self._installed
        self._installed = True
        self._wall_t0 = _time.perf_counter()
        if self.policy_path:
            # one policy claims every injected template (detector fan-out)
            policy = build_loadgen_policy(
                self.scenario.binding_style == "divided")
            if self.plane.store.try_get(
                    PropagationPolicy.KIND, LOADGEN_NS,
                    policy.name) is None:
                self.plane.store.create(policy)
        if self._chaos:
            self._setup_chaos()
        # arm the flight recorder (the report derives its latency/dwell
        # quantiles from cycle-span samples); restore on uninstall so a
        # soak inside a test suite leaves the global tracer untouched.
        # Realtime mode never builds a report, so it must NOT flip the
        # process-wide tracer on as a side effect — a serve operator
        # arms tracing with --trace-buffer, not --loadgen
        self._prev_recorder = obs.TRACER.recorder
        if self._prev_recorder is None and not self.realtime:
            obs.TRACER.configure(capacity=self.trace_capacity, slow_keep=8)
        self.recorder = obs.TRACER.recorder
        self._base_admission = {
            d: sched_metrics.ADMISSION.value(decision=d)
            for d in ("admitted", "shed", "displaced")}
        self.plane.store.bus.subscribe(self._on_store_event)
        # lifecycle-ledger baseline: the SOAK report embeds this run's
        # event deltas (events/s, coalesce ratio, per-reason counts)
        self._events_base = obs_events.ledger().counters()
        self._prev_queue_now = None
        self._prev_events_clock = None
        if not self.realtime:
            # the ledger stamps on the SAME virtual clock the queue runs
            # on (the obs_timeseries.maybe_sample discipline): compressed
            # soak events must order against the virtual timeline, not
            # interleave wall time with it
            self._prev_events_clock = obs_events.set_clock(self.clock)
            sched = self.plane.scheduler
            # compressed time only works when the scheduler's queue stamps
            # on the SAME clock the driver advances — a duck-typed plane
            # (ControlPlane built without an injected queue) arrives on
            # wall clock, where backoff expiries would never fire inside
            # the virtual-time drain and dwell would mix time axes.
            # Re-point it; _uninstall restores.  (The queue is empty at
            # install for any fresh plane; pre-resident wall-stamped
            # entries would keep wall-clock backoff expiries.)
            if sched.queue.now is not self.clock:
                self._prev_queue_now = sched.queue.now
                sched.queue.now = self.clock
            # remember whether schedule_batch was already instance-patched
            # (a spy, a nested wrapper) so uninstall can restore EXACTLY
            # the prior state instead of pinning a new instance attribute
            self._had_instance_schedule = "schedule_batch" in vars(sched)
            self._orig_schedule = sched.schedule_batch

            def wrapped(bindings, clusters):
                # the cycle occupies [t, t + cost): step the clock through
                # every arrival landing while it runs (exact queue
                # timestamps), then stamp outcomes at completion time
                t_end = self.clock.now() + self.model.cost(len(bindings))
                self._inject_due(t_end)
                self.clock.advance_to(t_end)
                if self.estimator_client is not None:
                    # chaos harness: one estimator fan-out per cycle keeps
                    # the circuit breaker fed on the same virtual clock
                    self._estimator_probe()
                res = self._orig_schedule(bindings, clusters)
                self._sample_queue()
                return res

            sched.schedule_batch = wrapped
        set_active(self)

    def _uninstall(self) -> None:
        from karmada_tpu_torch import obs

        if not self._installed:
            return
        self._installed = False
        self.wall_s = _time.perf_counter() - self._wall_t0
        if self._orig_schedule is not None:
            if self._had_instance_schedule:
                self.plane.scheduler.schedule_batch = self._orig_schedule
            else:
                del self.plane.scheduler.schedule_batch  # class method shows
            self._orig_schedule = None
        if self._prev_queue_now is not None:
            self.plane.scheduler.queue.now = self._prev_queue_now
            self._prev_queue_now = None
        if self._prev_events_clock is not None:
            obs_events.set_clock(self._prev_events_clock)
            self._prev_events_clock = None
        self.plane.store.bus.unsubscribe(self._on_store_event)
        obs.TRACER.recorder = self._prev_recorder
        if self._chaos:
            # the chaos plane is process-wide: a finished soak must not
            # leave faults armed for whatever runs next
            from karmada_tpu_torch import chaos as chaos_mod

            chaos_mod.disarm()
        if self.estimator_client is not None:
            # the harness client's fan-out pool (the breaker stays, for the
            # report's circuit states)
            self.estimator_client.close()
        set_active(None)

    # -- traffic -------------------------------------------------------------
    def _inject_binding(self, t: float) -> None:
        self._n_injected += 1
        if self.policy_path:
            # template in, binding out: the detector matches the loadgen
            # policy and renders the ResourceBinding, so the soak load
            # crosses the full controller fan-out.  The flight is keyed
            # by the binding the detector WILL create.
            from karmada_tpu_torch.controllers.detector import binding_name

            name = f"lg-{self._name_tag}w{self._n_injected:06d}"
            key = (LOADGEN_NS, binding_name("Deployment", name))
            with self._lock:
                self._flight[key] = _Flight(t_inject=t, priority=0)
            self.plane.store.create(Unstructured.from_manifest(
                build_workload_manifest(
                    name, self.scenario.binding_replicas)))
            return
        name = f"lg-{self._name_tag}b{self._n_injected:06d}"
        prio = (PRIORITY_HIGH
                if self.rng.random() < self.scenario.priority_high_frac
                else 0)
        affinity = None
        if self.scenario.n_regions > 0:
            # tenant-clustered arrival: the targeted region advances per
            # batch_window block, not per binding — real traffic arrives
            # in per-tenant bursts, and it is exactly this locality that
            # keeps a chunk's candidate union narrow under the shortlist
            affinity = self._region_names(
                (self._n_injected // max(self.scenario.batch_window, 1))
                % self.scenario.n_regions)
        with self._lock:
            self._flight[(LOADGEN_NS, name)] = _Flight(t_inject=t,
                                                       priority=prio)
        self.plane.store.create(build_binding(
            name, priority=prio, resource_name=self.resource_name,
            replicas=self.scenario.binding_replicas,
            divided=self.scenario.binding_style == "divided",
            affinity=affinity))

    def _region_names(self, group: int) -> List[str]:
        """Cluster names of one region group (group-affine scenarios),
        derived once from the live store so any plane shape works."""
        cached = getattr(self, "_region_name_cache", None)
        if cached is None:
            cached = {}
            for c in self.plane.store.list(Cluster.KIND):
                r = c.spec.region
                if r:
                    cached.setdefault(r, []).append(c.metadata.name)
            self._region_name_cache = cached
        key = f"lg-r{group}"
        return cached.get(key) or sorted(
            n for names in cached.values() for n in names) or None

    def _apply_cluster_event(self, spec) -> None:
        if spec.kind == "whatif":
            # a facade capacity query riding the soak (facade/):
            # a hypothetical solve on a copy-on-write fork of live state —
            # the whatif scenario's control run proves it never moves a
            # placement.  `spec` names the query (default placement),
            # `count` carries the replica count.
            from karmada_tpu_torch.facade import messages as facade_messages
            from karmada_tpu_torch.facade import whatif as facade_whatif

            req = facade_messages.WhatIfRequest(
                query=spec.spec or facade_messages.QUERY_PLACEMENT,
                replicas=max(spec.count, 1),
                resource_request={"cpu": "500m", "memory": "512Mi"})
            resp = facade_whatif.run_query(self.plane.scheduler,
                                           self.plane.store, req)
            self.whatif_results.append(resp.to_json())
            return
        if spec.kind in ("chaos", "chaos_clear"):
            # scheduled fault window on the same virtual clock as the
            # traffic: arm / clear rules on the process-wide chaos plane
            from karmada_tpu_torch import chaos as chaos_mod

            plane = chaos_mod.active()
            if plane is not None:
                if spec.kind == "chaos":
                    plane.add(spec.spec)
                else:
                    plane.clear(spec.spec or None)
            return
        if spec.count <= 0:
            return  # a zero-count event is a no-op, NOT alive[-0:] == all
        store = self.plane.store
        clusters = list(store.list(Cluster.KIND))
        if spec.kind == "kill":
            import copy

            alive = [c for c in clusters
                     if c.metadata.name not in self._flapped]
            victims = alive[-spec.count:] if alive else []
            dead = set()
            for c in victims:
                # stash the REAL cluster (spec + status capacity) so a
                # later revive restores what actually died — against a
                # live plane the members carry operator-chosen capacity,
                # not the loadgen defaults; metadata is rebuilt fresh so
                # the re-create is not poisoned by deletion bookkeeping
                self._killed.append(Cluster(
                    metadata=ObjectMeta(
                        name=c.metadata.name,
                        labels=dict(c.metadata.labels),
                        annotations=dict(c.metadata.annotations)),
                    spec=copy.deepcopy(c.spec),
                    status=copy.deepcopy(c.status)))
                dead.add(c.metadata.name)
                try:
                    store.delete(Cluster.KIND, "", c.metadata.name)
                except NotFoundError:
                    pass
            # failover: evict placements referencing dead clusters — the
            # spec change bumps the generation, so every affected binding
            # re-enters the scheduler through the normal push path (the
            # same storm the graceful-eviction machinery produces)
            for rb in list(store.list(ResourceBinding.KIND)):
                if not any(tc.name in dead for tc in rb.spec.clusters):
                    continue

                def evict(obj: ResourceBinding) -> None:
                    obj.spec.clusters = [tc for tc in obj.spec.clusters
                                         if tc.name not in dead]

                store.mutate(ResourceBinding.KIND, rb.metadata.namespace,
                             rb.metadata.name, evict)
                obs_events.emit_key(
                    (rb.metadata.namespace, rb.metadata.name),
                    obs_events.TYPE_WARNING,
                    obs_events.REASON_EVICT_WORKLOAD_FROM_CLUSTER,
                    "evicted from killed cluster(s): placements referenced "
                    "a dead cluster (failover re-schedule)",
                    origin="loadgen")
                with self._lock:
                    rec = self._flight.get(
                        (rb.metadata.namespace, rb.metadata.name))
                    if rec is not None:
                        rec.reschedules += 1
        elif spec.kind == "revive":
            for _ in range(min(spec.count, len(self._killed))):
                store.create(self._killed.pop())
        elif spec.kind == "flap_down":
            if not clusters:
                return
            # rotate the victim window across flap events: the churn
            # scenario promises a ROTATING cluster, and store.list comes
            # back name-sorted, so a fixed [:count] slice would flap the
            # same first cluster forever
            n = len(clusters)
            victims = [clusters[(self._flap_rr + i) % n]
                       for i in range(min(spec.count, n))]
            self._flap_rr = (self._flap_rr + spec.count) % n
            for c in victims:
                name = c.metadata.name

                def flap_down(obj: Cluster) -> None:
                    summary = obj.status.resource_summary
                    if name not in self._flapped:
                        self._flapped[name] = dict(summary.allocatable)
                    summary.allocatable = {
                        k: Quantity.from_milli(int(v.milli * spec.scale))
                        for k, v in summary.allocatable.items()}

                store.mutate(Cluster.KIND, "", name, flap_down)
        elif spec.kind == "flap_up":
            # restore the longest-flapped clusters (insertion order),
            # wherever they sort in the store list — with rotation the
            # flapped set no longer lines up with clusters[:count]
            for name in list(self._flapped)[:spec.count]:

                def flap_up(obj: Cluster) -> None:
                    orig = self._flapped.pop(name, None)
                    if orig is not None:
                        obj.status.resource_summary.allocatable = orig

                store.mutate(Cluster.KIND, "", name, flap_up)

    def _next_pending_time(self) -> Optional[float]:
        t_arr = (self._arrivals[self._arr_idx]
                 if self._arr_idx < len(self._arrivals) else None)
        t_evt = (self._events[self._evt_idx][0]
                 if self._evt_idx < len(self._events) else None)
        if t_arr is None:
            return t_evt
        if t_evt is None:
            return t_arr
        return min(t_arr, t_evt)

    def _inject_due(self, limit_t: float) -> None:
        """Inject every arrival / cluster event with time <= limit_t,
        stepping the clock to each event's exact time first so queue
        timestamps (and therefore dwell) are exact."""
        while True:
            t = self._next_pending_time()
            if t is None or t > limit_t:
                return
            self.clock.advance_to(t)
            t_arr = (self._arrivals[self._arr_idx]
                     if self._arr_idx < len(self._arrivals) else None)
            if t_arr is not None and t_arr <= t:
                self._arr_idx += 1
                self._inject_binding(t)
            else:
                _, spec = self._events[self._evt_idx]
                self._evt_idx += 1
                self._apply_cluster_event(spec)
            # sample at inject time, not only after each cycle's pop: the
            # pre-cut peak (the depth the max_resident + one-batch ceiling
            # is actually about) is otherwise systematically missed
            self._sample_queue()

    # -- observation ---------------------------------------------------------
    def _on_store_event(self, event: Event) -> None:
        if event.kind != ResourceBinding.KIND or event.type == DELETED:
            return
        rb = event.obj
        key = (rb.metadata.namespace, rb.metadata.name)
        cond = next((c for c in rb.status.conditions
                     if c.type == COND_SCHEDULED), None)
        if cond is None:
            return
        scheduled = (cond.status == "True"
                     and rb.status.scheduler_observed_generation
                     == rb.metadata.generation)
        with self._lock:
            rec = self._flight.get(key)
            if rec is None:
                return
            if scheduled and not rec.done:
                rec.done = True
                rec.t_done = self.clock.now()
            elif cond.status == "False":
                rec.failed_attempts += 1

    def _sample_queue(self) -> None:
        state = self.plane.scheduler.queue_state()
        with self._lock:
            for q, d in state["depths"].items():
                if d > self._max_depth.get(q, 0):
                    self._max_depth[q] = d
            for q, a in state["oldest_age_s"].items():
                if a > self._max_oldest.get(q, 0.0):
                    self._max_oldest[q] = a
            if state["overload"]:
                self._overload_seen = True

    def admission_delta(self) -> Dict[str, int]:
        return {d: int(sched_metrics.ADMISSION.value(decision=d)
                       - self._base_admission.get(d, 0.0))
                for d in ("admitted", "shed", "displaced")}

    def flight_summary(self, include_latencies: bool = True) -> dict:
        """Aggregate flight state.  include_latencies=False skips the
        O(n log n) latency sort — the /debug/load snapshot path runs
        under the same lock the store-event callback takes, so a
        dashboard poll must not stall the serve plane's event path."""
        with self._lock:
            lat = (sorted(r.t_done - r.t_inject
                          for r in self._flight.values() if r.done)
                   if include_latencies else [])
            return {
                "injected": len(self._flight),
                "scheduled": sum(1 for r in self._flight.values() if r.done),
                "failed_attempts": sum(r.failed_attempts
                                       for r in self._flight.values()),
                "reschedules": sum(r.reschedules
                                   for r in self._flight.values()),
                "latencies_sorted": lat,
                "max_depth": dict(self._max_depth),
                "max_oldest_age_s": {k: round(v, 6) for k, v
                                     in self._max_oldest.items()},
                "overload_seen": self._overload_seen,
            }

    def snapshot(self) -> dict:
        """Live state for /debug/load (and the realtime progress view)."""
        fs = self.flight_summary(include_latencies=False)
        fs.pop("latencies_sorted", None)
        return {
            "enabled": True,
            "scenario": self.scenario.name,
            "realtime": self.realtime,
            "seed": self.seed,
            "t_s": round(self.clock.now() - self.t0, 3),
            "duration_s": round(self.duration_s, 3),
            "arrivals_injected": self._arr_idx,
            "arrivals_total": len(self._arrivals),
            "events_applied": self._evt_idx,
            "events_total": len(self._events),
            "admission": self.admission_delta(),
            "queue": self.plane.scheduler.queue_state(),
            **fs,
        }

    # -- compressed-mode execution -------------------------------------------
    def run(self) -> dict:
        """Run the whole scenario in compressed virtual time and return
        the SOAK report payload (loadgen/report.py)."""
        from karmada_tpu_torch.loadgen import report

        self._install()
        try:
            while self._next_pending_time() is not None:
                self._inject_due(self._next_pending_time())
                self.plane.runtime.tick()
                self._sample_queue()
            self._drain()
            # rebalance convergence (hotspot -> drain -> re-place ->
            # converge): the paced drains create NEW scheduling work
            # after the arrival stream ends, so keep stepping rebalance
            # intervals until the detector reports nothing left to drain
            # and every eviction task has settled (or the round budget
            # runs out — the residual then shows in the report)
            reb = getattr(self.plane.scheduler, "rebalance_plane", None)
            if reb is not None and not self.realtime:
                for _ in range(64):
                    if reb.converged() and reb.pending_drains() == 0:
                        break
                    self.clock.advance(reb.cfg.interval_s)
                    self.plane.runtime.tick()
                    self._drain()
            if self._chaos:
                # chaos epilogue while the plane and its rules are still
                # armed: deliver any still-held watch events (a stalled
                # event must not outlive the fault window), snapshot the
                # fire log, and run the safety auditor over the intact
                # queues
                from karmada_tpu_torch import chaos as chaos_mod

                flushed = self.plane.store.bus.flush_held()
                if flushed:
                    self.plane.runtime.tick()
                    self._drain()
                self.chaos_state = chaos_mod.state_payload()
                self.safety_audit = chaos_mod.audit_soak(
                    self, self._audit_baseline)
        finally:
            self._uninstall()
        return report.build_soak_report(self)

    def _drain(self, max_steps: int = 64) -> None:
        """Post-arrival convergence: step virtual time until the queue
        empties (or give up after max_steps — the residual is reported,
        never silently dropped).  The step starts at the batch deadline
        so end-of-run stragglers cut on their normal schedule instead of
        accruing a full synthetic second of dwell; only when a step
        makes no progress (entries waiting out backoff timers) does it
        escalate toward the backoff ceiling."""
        sched = self.plane.scheduler
        deadline = self.scenario.deadline_s(self.model)
        backoff_step = max(sched.queue.initial_backoff_s, 0.1)
        for _ in range(max_steps):
            state = sched.queue_state()
            if sum(state["depths"].values()) == 0:
                break
            if state["depths"]["active"] > 0 and deadline > 0:
                # a deferred straggler batch cuts when its OLDEST entry
                # hits the (possibly overload-widened) deadline: jump
                # exactly there (+epsilon), so only that one entry's
                # dwell touches the deadline — a blind stride would push
                # the whole batch past it and straight into the
                # reported p99
                eff = deadline * (sched.overload_deadline_factor
                                  if state["overload"] else 1.0)
                age = state["oldest_age_s"]["active"]
                step = max(eff - age, 0.0) + 1e-6
            else:
                # waiting out backoff/unschedulable timers: stride, and
                # escalate toward the backoff ceiling
                step = backoff_step
                backoff_step = min(backoff_step * 2,
                                   sched.queue.max_backoff_s)
            self.clock.advance(step)
            self.plane.runtime.tick()
            self._sample_queue()
        self.residual = sched.queue_state()["depths"]

    # -- realtime execution (serve --loadgen) --------------------------------
    def start(self) -> "LoadDriver":
        assert self.realtime, "start() is the realtime entry; use run()"
        self._install()
        self._thread = threading.Thread(target=self._run_realtime,
                                        daemon=True, name="loadgen-driver")
        self._thread.start()
        return self

    def _run_realtime(self) -> None:
        while not self._stop.is_set():
            t = self._next_pending_time()
            if t is None:
                break
            wait = t - self.clock.now()
            if wait > 0 and self._stop.wait(wait):
                break
            self._inject_due(self.clock.now())
            self._sample_queue()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        self._uninstall()
