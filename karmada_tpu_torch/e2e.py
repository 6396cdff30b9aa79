"""End-to-end control plane: the propagation loop in one process.

Counterpart of the JAX package's ``e2e.py``: fake member clusters
(capacity simulators) + detector (template + policy -> ResourceBinding) +
the port's Scheduler (the device cycle on the card by default) +
binding -> Work rendering + execution into the members + status
reflection back to the bindings and templates, behind the admission chain
(policy defaulting and validation, quota enforcement), with the failover
loop around it: the collector's heartbeat Leases and their monitor,
cluster lifecycle (finalizer, execution space, unjoin), not-ready taints,
the NoExecute taint manager behind a rate-limited eviction queue
(`eviction_rate` a second), graceful eviction and application failover,
plus dependencies, the workload rebalancer, taint policies, remedies,
agent CSR approval and FederatedResourceQuota.

Usage:
    cp = ControlPlane()              # the Scheduler on the first CUDA card
    cp.add_member("m1", cpu_milli=32000)
    cp.apply_policy(policy)
    cp.apply(deployment_manifest)
    cp.tick()          # one deterministic reconcile round
    cp.member("m1").get("Deployment", "default", "nginx")

`device` is the Scheduler's (and the rebalance plane's): None asks for the
first CUDA card and raises without one; "cpu" runs the kernels' plain
versions.  backend="native" / "serial" schedule on the host.  Every
controller reads the plane's one `clock` but the Lease heartbeats: the
collectors renew them and the lease monitor ages them on the wall clock,
as in the JAX package.

Controllers are wired in the JAX ControlPlane's order and are governed by
`controllers` (the `--controllers=` list, store/worker.parse_controllers;
None rehydrates the spec stored in the karmada-system/controller-manager
ConfigMap, "*" without one; a stored spec's names the port has not
taken are dropped with a warning, its star, enables and disables kept).  `feature_gates` overrides the gates of the
quota enforcer; application failover reads the process-wide
``utils.features.GATES``, as in the JAX package.  `add_member(...,
sync_mode="Pull")` joins a member through a KarmadaAgent (agent.py) after
its bootstrap CSR; `unjoin` unregisters one.  `add_member(...,
collect=False)` (not in the JAX package) skips the whole-fleet status
collect that each join runs, for callers that join many members and
collect once.  `apply` decodes a karmada API kind to its typed model
(models/codec.py) and stores any other manifest as an Unstructured.

The Scheduler's serve paths are the JAX ControlPlane's arguments:
device_cycle_timeout_s and device_recover_cycles (the mid-serve guard,
its degrade and re-arm), explain, batch_deadline_s and admission_limit
(scheduler/service.py).  `persist_dir` keeps the store in a snapshot +
WAL there (store/persistence.py): a plane built on a directory that
holds one is restored and resynced, and `checkpoint()` compacts the WAL
into a fresh snapshot.

The accurate estimator tier is wired as in the JAX ControlPlane: the
plane always holds one AccurateEstimatorClient (`descheduler_estimator`),
`add_member` registers an AccurateEstimatorServer per member over a
LocalTransport and `unjoin` deregisters it; `enable_descheduler=True`
runs the Descheduler over it (controllers/descheduler.py), sharing one
EvictionBudget with the rebalance plane.

`chaos` / `chaos_seed` arm the process-wide chaos plane through the
Scheduler (chaos/: the nine seams, the safety auditor), as in the JAX
ControlPlane.

Not part of the port yet, by argument: mesh_shape; by method:
enable_dns_detector, proxy, metrics_dump; and the
controllers behind them: the search cache / unified auth / cluster
proxy / metrics provider, the FederatedHPA family (FederatedHPA,
CronFederatedHPA, the scale-target marker, the replicas syncer, the HPA
fast path) and the multi-cluster services (MCS, MCI, endpointslice
collect and dispatch).  Asking for one of their names in `controllers`
raises ValueError.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

from karmada_tpu_torch.agent import KarmadaAgent
from karmada_tpu_torch.controllers.binding import BindingController
from karmada_tpu_torch.controllers.certificates import (
    AgentCsrApprover,
    bootstrap_agent_csr,
)
from karmada_tpu_torch.controllers.cluster import (
    ClusterLifecycleController,
    RateLimitedEvictionQueue,
)
from karmada_tpu_torch.controllers.dependencies import DependenciesDistributor
from karmada_tpu_torch.controllers.descheduler import Descheduler
from karmada_tpu_torch.controllers.detector import ResourceDetector
from karmada_tpu_torch.controllers.execution import ExecutionController
from karmada_tpu_torch.controllers.extras import (
    ClusterTaintPolicyController,
    FederatedResourceQuotaController,
    RemedyController,
    WorkloadRebalancerController,
)
from karmada_tpu_torch.controllers.failover import (
    ApplicationFailoverController,
    ClusterTaintController,
    GracefulEvictionController,
    NoExecuteTaintManager,
)
from karmada_tpu_torch.controllers.lease import (
    LEASE_NAMESPACE,
    ClusterLeaseMonitor,
    Lease,
)
from karmada_tpu_torch.controllers.namespace import NamespaceSyncController
from karmada_tpu_torch.controllers.status import (
    BindingStatusController,
    ClusterStatusController,
    WorkStatusController,
)
from karmada_tpu_torch.estimator.client import AccurateEstimatorClient
from karmada_tpu_torch.estimator.server import AccurateEstimatorServer
from karmada_tpu_torch.estimator.wire import LocalTransport
from karmada_tpu_torch.interpreter import ResourceInterpreter
from karmada_tpu_torch.members.member import FakeMemberCluster
from karmada_tpu_torch.models.cluster import Cluster, ClusterSpec
from karmada_tpu_torch.models.codec import from_manifest_typed
from karmada_tpu_torch.models.meta import ObjectMeta
from karmada_tpu_torch.models.unstructured import Unstructured
from karmada_tpu_torch.scheduler import Scheduler
from karmada_tpu_torch.store.store import NotFoundError, ObjectStore
from karmada_tpu_torch.store.worker import Runtime
from karmada_tpu_torch.utils.events import EventRecorder
from karmada_tpu_torch.utils.features import FeatureGates
from karmada_tpu_torch.webhook import AdmissionRegistry, install_default_webhooks

class ControlPlane:
    def __init__(
        self,
        backend: str = "device",
        device=None,
        eviction_grace_period_s: float = 600,
        feature_gates: Optional[Dict[str, bool]] = None,
        clock=None,
        # taint-driven evictions a second (the rate-limited queue; 0 halts)
        eviction_rate: float = 100.0,
        waves: int = 8,
        # pipelined chunk executor chunk size (scheduler/pipeline.py)
        pipeline_chunk: int = 1024,
        # --default-not-ready/unreachable-toleration-seconds (webhook
        # flags, 300 in the reference); None disables the defaulted
        # tolerations
        default_toleration_seconds: Optional[int] = 300,
        # --controllers= enable/disable list ("*", "-name", allowlist);
        # None rehydrates the spec stored in the karmada-system/
        # controller-manager ConfigMap
        controllers: Optional[str] = None,
        batch_window: int = 4096,
        # resident-state plane (resident/): device backend only
        resident: bool = False,
        resident_audit_interval: int = 64,
        resident_fused: bool = False,
        # rebalance plane: interval in seconds (None leaves it disarmed);
        # when armed it paces its drains through a shared EvictionBudget
        rebalance: Optional[float] = None,
        rebalance_cfg=None,  # rebalance.RebalanceConfig override
        # the descheduler (controllers/descheduler.py): stuck replicas
        # shrunk off their members over the estimator tier, paced by the
        # budget it shares with the rebalance plane
        enable_descheduler: bool = False,
        # two-tier solve (ops/shortlist): top-k candidate lanes a binding
        shortlist_k: Optional[int] = None,
        shortlist_min_cells: int = 1 << 21,
        # the mid-serve guard (scheduler/service.py): a device cycle over
        # this many seconds degrades to the fastest host backend (None: no
        # guard); after device_recover_cycles cycles the device re-arms
        # (None: one-way)
        device_cycle_timeout_s: Optional[float] = None,
        device_recover_cycles: Optional[int] = None,
        # chaos fault-injection plane (chaos/): a spec string arming
        # deterministic faults at the named seams
        chaos: Optional[str] = None,
        chaos_seed: int = 0,
        # explain plane: the sample rate of cycles recording Decisions
        explain: float = 0.0,
        # batch formation deadline (None: cut at once) and the admission
        # gate's bound on tracked bindings (None: unbounded)
        batch_deadline_s: Optional[float] = None,
        admission_limit: Optional[int] = None,
        # the store's snapshot + WAL directory (None: in memory only)
        persist_dir: Optional[str] = None,
    ) -> None:
        self.clock = clock if clock is not None else time.time
        # the process ledger's view (obs/events.py): the Scheduler's
        # outcome events and application failover's deferrals
        self.recorder = EventRecorder()
        self.gates = FeatureGates(feature_gates)
        self.admission = AdmissionRegistry()
        if persist_dir is not None:
            from karmada_tpu_torch.store.persistence import load_store

            self.store = load_store(persist_dir, admission=self.admission)
        else:
            self.store = ObjectStore(admission=self.admission)
        install_default_webhooks(
            self.admission, self.store, self.gates,
            default_toleration_seconds=default_toleration_seconds)
        rehydrated = controllers is None
        if rehydrated:
            cm = self.store.try_get(
                "ConfigMap", "karmada-system", "controller-manager")
            controllers = (
                cm.manifest.get("data", {}).get("controllers", "*")
                if cm is not None else "*")
        try:
            # a stored spec may name controllers the port has not taken:
            # those are dropped, the rest of the spec holds
            self.runtime = Runtime(controllers=controllers,
                                   drop_unported=rehydrated)
        except ValueError:
            if not rehydrated:
                raise  # an explicit bad spec must fail loudly
            # a stale stored spec must not brick the plane: run everything
            # and let the operator re-set it
            import warnings

            warnings.warn(
                f"ignoring invalid stored --controllers spec "
                f"{controllers!r}; running all controllers", stacklevel=2)
            self.runtime = Runtime()
        if self.runtime.unported_dropped:
            import warnings

            warnings.warn(
                f"the stored --controllers spec {controllers!r} names "
                f"controller(s) {sorted(self.runtime.unported_dropped)} "
                f"the port has not taken; running the rest of it",
                stacklevel=2)
        self.members: Dict[str, FakeMemberCluster] = {}
        # the push-side execution / status controllers drive PUSH members;
        # they share this dict by reference.  Pull members get an agent.
        self.push_members: Dict[str, FakeMemberCluster] = {}
        self.agents: Dict[str, KarmadaAgent] = {}
        self.interpreter = ResourceInterpreter()
        self.interpreter.attach_store(self.store)
        self.detector = ResourceDetector(self.store, self.runtime,
                                         self.interpreter)
        # shared eviction pacing (rebalance/pacing.py): the rebalance
        # plane's drains and the descheduler's shrinks draw from one
        # per-cluster token budget
        self.eviction_budget_shared = None
        if rebalance or enable_descheduler:
            from karmada_tpu_torch.rebalance import (
                EvictionBudget,
                RebalanceConfig,
            )

            bcfg = (rebalance_cfg if rebalance_cfg is not None
                    else RebalanceConfig())
            self.eviction_budget_shared = EvictionBudget(
                per_cluster=bcfg.budget_per_cluster,
                interval_s=bcfg.budget_interval_s, clock=self.clock)
        self.scheduler = Scheduler(
            self.store, self.runtime, backend=backend, device=device,
            waves=waves, pipeline_chunk=pipeline_chunk,
            batch_window=batch_window, resident=resident,
            resident_audit_interval=resident_audit_interval,
            resident_fused=resident_fused, shortlist_k=shortlist_k,
            shortlist_min_cells=shortlist_min_cells, rebalance=rebalance,
            rebalance_cfg=rebalance_cfg,
            rebalance_budget=self.eviction_budget_shared,
            rebalance_clock=self.clock,
            device_cycle_timeout_s=device_cycle_timeout_s,
            device_recover_cycles=device_recover_cycles, explain=explain,
            chaos=chaos, chaos_seed=chaos_seed,
            batch_deadline_s=batch_deadline_s,
            admission_limit=admission_limit, recorder=self.recorder)
        self.binding_controller = BindingController(
            self.store, self.runtime, self.interpreter)
        self.execution = ExecutionController(
            self.store, self.runtime, self.push_members, self.interpreter)
        self.work_status = WorkStatusController(
            self.store, self.runtime, self.push_members, self.interpreter)
        self.binding_status = BindingStatusController(
            self.store, self.runtime, self.interpreter)
        # the collectors renew their Leases on the wall clock, and the
        # lease staleness monitor reads it too (a dead collector / agent
        # degrades its cluster to Ready=Unknown), as in the JAX package
        self.cluster_status = ClusterStatusController(
            self.store, self.runtime, self.push_members)
        self.lease_monitor = ClusterLeaseMonitor(self.store, self.runtime)
        self.cluster_taints = ClusterTaintController(self.store, self.runtime,
                                                     clock=self.clock)
        # taint-driven evictions pace through the rate-limited queue
        # (cluster/eviction_worker.go); lifecycle handles join / unjoin
        self.cluster_lifecycle = ClusterLifecycleController(self.store,
                                                            self.runtime)
        self.taint_manager = NoExecuteTaintManager(self.store, self.runtime,
                                                   clock=self.clock)
        self.eviction_queue = RateLimitedEvictionQueue(
            self.runtime, self.taint_manager.evict_one,
            rate_per_s=eviction_rate, clock=self.clock,
            controller_name="taint-manager")
        self.taint_manager.eviction_queue = self.eviction_queue
        self.graceful_eviction = GracefulEvictionController(
            self.store, self.runtime, grace_period_s=eviction_grace_period_s,
            clock=self.clock)
        self.app_failover = ApplicationFailoverController(
            self.store, self.runtime, clock=self.clock,
            recorder=self.recorder)
        self.namespace_sync = NamespaceSyncController(self.store,
                                                      self.runtime)
        self.dependencies = DependenciesDistributor(
            self.store, self.runtime, self.interpreter)
        # the descheduler's unschedulable counts ride the estimator wire
        # protocol (descheduler.go:141), one in-process server a member
        self.descheduler_estimator = AccurateEstimatorClient()
        self.descheduler = (
            Descheduler(self.store, self.runtime, self.members,
                        estimator=self.descheduler_estimator,
                        budget=self.eviction_budget_shared)
            if enable_descheduler else None)
        self.rebalancer = WorkloadRebalancerController(self.store,
                                                       self.runtime)
        self.taint_policies = ClusterTaintPolicyController(self.store,
                                                           self.runtime)
        self.remedies = RemedyController(self.store, self.runtime)
        # agent CSR approval (control-plane side); credential ROTATION is
        # agent-owned: each KarmadaAgent runs its own scoped loop
        self.csr_approver = AgentCsrApprover(self.store, self.runtime,
                                             clock=self.clock)
        self.quotas = FederatedResourceQuotaController(self.store,
                                                       self.runtime)
        # a restored store resyncs every object through the freshly wired
        # controllers, as the reference's informers do after a restart
        if persist_dir is not None and len(self.store):
            self.resync()

    def resync(self) -> None:
        from karmada_tpu_torch.store.persistence import resync

        resync(self.store)

    def checkpoint(self) -> None:
        """Compact the WAL into a fresh snapshot (periodic maintenance)."""
        persistence = getattr(self.store, "persistence", None)
        if persistence is not None:
            persistence.snapshot()

    # -- fleet management ---------------------------------------------------
    def add_member(
        self,
        name: str,
        cpu_milli: int = 64_000,
        memory_gi: int = 256,
        pods: int = 110,
        region: str = "",
        zone: str = "",
        provider: str = "",
        sync_mode: str = "Push",
        collect: bool = True,
    ) -> FakeMemberCluster:
        member = FakeMemberCluster(
            name=name,
            cpu_allocatable_milli=cpu_milli,
            memory_allocatable_gi=memory_gi,
            pods_allocatable=pods,
        )
        self.members[name] = member
        if self.store.try_get(Cluster.KIND, "", name) is None:
            self.store.create(Cluster(
                metadata=ObjectMeta(name=name),
                spec=ClusterSpec(region=region, zone=zone, provider=provider,
                                 sync_mode=sync_mode),
            ))
        if sync_mode == "Pull":
            # pull mode: the control plane cannot reach the member; a
            # KarmadaAgent inside it drives execution / status instead
            # (cmd/agent/app/agent.go:140-145), bootstrapping its identity
            # with a CSR the approver honors (karmadactl register flow)
            bootstrap_agent_csr(self.store, name)
            self.agents[name] = KarmadaAgent(
                self.store, member, self.runtime, self.interpreter,
                clock=self.clock)
        else:
            # work_status shares the push_members dict by reference; only
            # the member-informer subscription needs per-member wiring
            self.push_members[name] = member
            member.store.bus.subscribe(self.work_status._member_event(name))  # noqa: SLF001
        # a per-member estimator server behind the wire transport (the
        # descheduler's unschedulable counts ride it, never the simulator)
        self.descheduler_estimator.register(
            name, LocalTransport(AccurateEstimatorServer(member).handle))
        if collect:
            self.cluster_status.collect_all()
            for agent in self.agents.values():
                agent.cluster_status.collect_all()
        return member

    def member(self, name: str) -> FakeMemberCluster:
        return self.members[name]

    # -- user-facing API ----------------------------------------------------
    def unjoin(self, name: str) -> None:
        """Unregister a member: the lifecycle controller drains its
        execution space, then the finalizer releases the Cluster object.
        Per-member wiring from add_member unwinds here too (the estimator
        transport, the status informer, the member's Lease, its agent)."""
        try:
            self.store.delete(Cluster.KIND, "", name)
        except NotFoundError:
            pass
        try:
            self.store.delete(Lease.KIND, LEASE_NAMESPACE, name)
        except NotFoundError:
            pass
        self.descheduler_estimator.deregister(name)
        self.work_status.members.pop(name, None)
        self.push_members.pop(name, None)
        agent = self.agents.pop(name, None)
        if agent is not None:
            agent.stop()
        self.members.pop(name, None)

    def apply(self, manifest: dict):
        """Create or update an object from its manifest: a karmada API
        kind decodes to its typed model (admission and the controllers see
        real objects), anything else is stored as an Unstructured."""
        typed = from_manifest_typed(manifest)
        if typed is not None:
            existing = self.store.try_get(
                typed.KIND, typed.namespace, typed.name)
            if existing is None:
                return self.store.create(typed)
            typed.metadata.resource_version = (
                existing.metadata.resource_version)
            typed.metadata.uid = existing.metadata.uid or typed.metadata.uid
            typed.metadata.generation = existing.metadata.generation
            return self.store.update(typed)
        obj = Unstructured.from_manifest(manifest)
        existing = self.store.try_get(obj.KIND, obj.namespace, obj.name)
        if existing is None:
            return self.store.create(obj)
        assert isinstance(existing, Unstructured)
        existing.manifest = obj.manifest
        existing.metadata.labels = dict(obj.metadata.labels)
        existing.metadata.annotations = dict(obj.metadata.annotations)
        return self.store.update(existing)

    def apply_policy(self, policy) -> None:
        existing = self.store.try_get(
            policy.KIND, policy.metadata.namespace, policy.name)
        if existing is None:
            self.store.create(policy)
        else:
            policy.metadata.resource_version = (
                existing.metadata.resource_version)
            self.store.update(policy)

    def delete(self, kind: str, namespace: str, name: str) -> None:
        self.store.delete(kind, namespace, name)

    def events(self, kind=None, namespace=None, name=None):
        """The plane's recorded events (the process ledger), filtered."""
        return self.recorder.list(kind=kind, namespace=namespace, name=name)

    # -- clock --------------------------------------------------------------
    def tick(self, rounds: int = 3) -> int:
        """One deterministic round: member simulators advance, statuses are
        collected, and every controller queue drains to quiescence."""
        total = 0
        for _ in range(rounds):
            for member in self.members.values():
                member.tick()
            total += self.runtime.tick()
        return total
