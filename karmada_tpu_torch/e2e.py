"""End-to-end control plane: the propagation loop in one process.

Counterpart of the JAX package's ``e2e.py``: fake member clusters
(capacity simulators) + detector (template + policy -> ResourceBinding) +
the port's Scheduler (the device cycle on the card by default) +
binding -> Work rendering + execution into the members + status
reflection back to the bindings and templates, behind the admission chain
(policy defaulting and validation).

Usage:
    cp = ControlPlane()              # the Scheduler on the first CUDA card
    cp.add_member("m1", cpu_milli=32000)
    cp.apply_policy(policy)
    cp.apply(deployment_manifest)
    cp.tick()          # one deterministic reconcile round
    cp.member("m1").get("Deployment", "default", "nginx")

`device` is the Scheduler's (and the rebalance plane's): None asks for the
first CUDA card and raises without one; "cpu" runs the kernels' plain
versions.  backend="native" / "serial" schedule on the host.

The controllers it wires are those of the JAX ControlPlane run with
``controllers="detector,binding,execution,work-status,binding-status,
cluster-status,namespace-sync,graceful-eviction"``, registered in the
same order.  `add_member(..., collect=False)` (not in the JAX package)
skips the whole-fleet status collect that each join runs, for callers
that join many members and collect once.

The Scheduler's serve paths are the JAX ControlPlane's arguments:
device_cycle_timeout_s and device_recover_cycles (the mid-serve guard,
its degrade and re-arm), explain, batch_deadline_s and admission_limit
(scheduler/service.py).  `persist_dir` keeps the store in a snapshot +
WAL there (store/persistence.py): a plane built on a directory that
holds one is restored and resynced, and `checkpoint()` compacts the WAL
into a fresh snapshot.

Not part of the port yet, by argument: enable_descheduler, feature_gates
(the process-wide ``utils.features.GATES`` is read), eviction_rate,
mesh_shape, controllers, chaos, chaos_seed; by method: unjoin,
enable_dns_detector, proxy, metrics_dump, events; and the controllers
behind them (lease,
cluster lifecycle and taints, the taint manager and its eviction queue,
application failover, dependencies, descheduler, search / proxy /
metrics, autoscaling, multi-cluster services, rebalancer, taint
policies, remedies, CSR approval, quotas).  Pull members (their agent),
and `apply` of a karmada API kind (it needs ``models/codec.py``) raise.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

from karmada_tpu_torch.controllers.binding import BindingController
from karmada_tpu_torch.controllers.detector import ResourceDetector
from karmada_tpu_torch.controllers.execution import ExecutionController
from karmada_tpu_torch.controllers.failover import GracefulEvictionController
from karmada_tpu_torch.controllers.namespace import NamespaceSyncController
from karmada_tpu_torch.controllers.status import (
    BindingStatusController,
    ClusterStatusController,
    WorkStatusController,
)
from karmada_tpu_torch.interpreter import ResourceInterpreter
from karmada_tpu_torch.members.member import FakeMemberCluster
from karmada_tpu_torch.models import cluster as _cluster_models
from karmada_tpu_torch.models import config as _config_models
from karmada_tpu_torch.models import policy as _policy_models
from karmada_tpu_torch.models import work as _work_models
from karmada_tpu_torch.models.cluster import Cluster, ClusterSpec
from karmada_tpu_torch.models.meta import ObjectMeta
from karmada_tpu_torch.models.unstructured import Unstructured
from karmada_tpu_torch.scheduler import Scheduler
from karmada_tpu_torch.store.store import ObjectStore
from karmada_tpu_torch.store.worker import Runtime
from karmada_tpu_torch.webhook import AdmissionRegistry, install_default_webhooks

#: karmada API kinds whose models the port has not taken yet
_UNPORTED_API_KINDS = frozenset({
    "CertificateSigningRequest", "ClusterCredential", "ClusterTaintPolicy",
    "CronFederatedHPA", "FederatedHPA", "FederatedResourceQuota",
    "MultiClusterIngress", "MultiClusterService", "Remedy",
    "ResourceRegistry", "ServiceExport", "ServiceImport",
    "WorkloadRebalancer",
})


def _api_kinds() -> frozenset:
    kinds = set(_UNPORTED_API_KINDS)
    for mod in (_cluster_models, _policy_models, _work_models,
                _config_models):
        for obj in vars(mod).values():
            kind = getattr(obj, "KIND", None)
            if isinstance(obj, type) and isinstance(kind, str) and kind:
                kinds.add(kind)
    return frozenset(kinds)


#: every kind the JAX package's codec decodes to a typed model
API_KINDS = _api_kinds()


class ControlPlane:
    def __init__(
        self,
        backend: str = "device",
        device=None,
        eviction_grace_period_s: float = 600,
        clock=None,
        waves: int = 8,
        # pipelined chunk executor chunk size (scheduler/pipeline.py)
        pipeline_chunk: int = 1024,
        # --default-not-ready/unreachable-toleration-seconds (webhook
        # flags, 300 in the reference); None disables the defaulted
        # tolerations
        default_toleration_seconds: Optional[int] = 300,
        batch_window: int = 4096,
        # resident-state plane (resident/): device backend only
        resident: bool = False,
        resident_audit_interval: int = 64,
        resident_fused: bool = False,
        # rebalance plane: interval in seconds (None leaves it disarmed);
        # when armed it paces its drains through a shared EvictionBudget
        rebalance: Optional[float] = None,
        rebalance_cfg=None,  # rebalance.RebalanceConfig override
        # two-tier solve (ops/shortlist): top-k candidate lanes a binding
        shortlist_k: Optional[int] = None,
        shortlist_min_cells: int = 1 << 21,
        # the mid-serve guard (scheduler/service.py): a device cycle over
        # this many seconds degrades to the fastest host backend (None: no
        # guard); after device_recover_cycles cycles the device re-arms
        # (None: one-way)
        device_cycle_timeout_s: Optional[float] = None,
        device_recover_cycles: Optional[int] = None,
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
        self.admission = AdmissionRegistry()
        if persist_dir is not None:
            from karmada_tpu_torch.store.persistence import load_store

            self.store = load_store(persist_dir, admission=self.admission)
        else:
            self.store = ObjectStore(admission=self.admission)
        install_default_webhooks(
            self.admission,
            default_toleration_seconds=default_toleration_seconds)
        self.runtime = Runtime()
        self.members: Dict[str, FakeMemberCluster] = {}
        # the execution / status controllers drive push members (the only
        # kind the port joins yet); they share this dict by reference
        self.push_members: Dict[str, FakeMemberCluster] = {}
        self.interpreter = ResourceInterpreter()
        self.interpreter.attach_store(self.store)
        self.detector = ResourceDetector(self.store, self.runtime,
                                         self.interpreter)
        self.eviction_budget_shared = None
        if rebalance:
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
            batch_deadline_s=batch_deadline_s,
            admission_limit=admission_limit)
        self.binding_controller = BindingController(
            self.store, self.runtime, self.interpreter)
        self.execution = ExecutionController(
            self.store, self.runtime, self.push_members, self.interpreter)
        self.work_status = WorkStatusController(
            self.store, self.runtime, self.push_members, self.interpreter)
        self.binding_status = BindingStatusController(
            self.store, self.runtime, self.interpreter)
        self.cluster_status = ClusterStatusController(
            self.store, self.runtime, self.push_members)
        self.graceful_eviction = GracefulEvictionController(
            self.store, self.runtime, grace_period_s=eviction_grace_period_s,
            clock=self.clock)
        self.namespace_sync = NamespaceSyncController(self.store,
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
        if sync_mode == "Pull":
            raise NotImplementedError(
                "Pull members need the karmada agent, which the port has "
                "not taken yet")
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
        self.push_members[name] = member
        member.store.bus.subscribe(self.work_status._member_event(name))  # noqa: SLF001
        if collect:
            self.cluster_status.collect_all()
        return member

    def member(self, name: str) -> FakeMemberCluster:
        return self.members[name]

    # -- user-facing API ----------------------------------------------------
    def apply(self, manifest: dict):
        """Create or update a workload template (stored as Unstructured).
        A karmada API kind raises: it needs the typed decode of
        ``models/codec.py``, which the port has not taken yet, and is never
        stored as an Unstructured."""
        if manifest.get("kind") in API_KINDS:
            raise NotImplementedError(
                f"apply of a {manifest.get('kind')} manifest needs "
                "models/codec.py, which the port has not taken yet; create "
                "the typed object (apply_policy / store.create)")
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
