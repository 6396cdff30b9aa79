"""Fake member clusters: in-process capacity simulators.

The reference's E2E environment spins up kind clusters
(hack/local-up-karmada.sh); unit tests use fake clientsets.  This module is
the framework's member-cluster substitute for the end-to-end slice
(SURVEY.md section 7 step 4): each member owns an ObjectStore of applied
manifests, reports a ResourceSummary/ APIEnablements like the reference's
cluster-status controller collects (cluster_status_controller.go:278-282),
and "runs" workloads by moving their status toward ready on each tick.

Counterpart of the JAX package's ``members/member.py``.  The pod plane
(list_pods, pod_logs, pod_exec) and the DNS detector wait with the port's
search and proxy plane.  The capacity scans read the member's store
without copying (ObjectStore.visit_all): they only look.  A tick that
wrote nothing is not run again until the member's state moves
(`state_key`: its store's revision and size, capacity fields, nodes and
health), so an idle tick over a fleet costs a key comparison a member.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from karmada_tpu_torch.models.cluster import APIEnablement, ResourceSummary
from karmada_tpu_torch.models.meta import deep_get
from karmada_tpu_torch.models.unstructured import Unstructured
from karmada_tpu_torch.store.store import NotFoundError, ObjectStore
from karmada_tpu_torch.utils.quantity import Quantity


@dataclass
class FakeNode:
    """One node's allocatable capacity (estimator-server granularity)."""

    name: str = ""
    cpu_milli: int = 0
    memory_milli: int = 0
    pods: int = 0
    labels: Dict[str, str] = field(default_factory=dict)
    # extended resources (GPUs, ephemeral-storage, ...) in milli units
    extra_milli: Dict[str, int] = field(default_factory=dict)


@dataclass
class FakeMemberCluster:
    name: str
    cpu_allocatable_milli: int = 64_000
    memory_allocatable_gi: int = 256  # GiB (memory quantities are bytes)
    pods_allocatable: int = 110
    nodes: List[FakeNode] = field(default_factory=list)
    api_enablements: List[APIEnablement] = field(default_factory=lambda: [
        APIEnablement("apps/v1", ["Deployment", "StatefulSet", "ReplicaSet"]),
        APIEnablement("batch/v1", ["Job"]),
        APIEnablement("v1", ["Pod", "ConfigMap", "Secret", "Service",
                             "ServiceAccount", "Namespace"]),
    ])
    healthy: bool = True
    # simulated in-cluster DNS plane (CoreDNS analog), probed by
    # members/dns_detector.ServiceNameResolutionDetector
    dns_healthy: bool = True
    store: ObjectStore = field(default_factory=ObjectStore)
    # per-workload live load for the metrics plane: (kind, ns, name) ->
    # per-replica usage in milli-units, e.g. {"cpu": 250, "memory": ...}.
    # Unset workloads idle at 10% of their request (something nonzero for
    # utilization math without claiming precision the simulator lacks).
    load: Dict[tuple, Dict[str, int]] = field(default_factory=dict)
    # custom metric series this member serves (custom.metrics.k8s.io):
    # (kind, namespace, name, metric) -> value — the simulator's stand-in
    # for an in-cluster custom-metrics API (prometheus-adapter etc.)
    custom_metrics: Dict[tuple, float] = field(default_factory=dict)
    # per-workload lifecycle journal: (kind, ns, name) -> lines.  This is
    # what `karmadactl logs/attach` stream through the cluster proxy — the
    # simulator's honest stand-in for container stdout (the reference
    # streams real kubelet logs, pkg/karmadactl/logs).
    journal: Dict[tuple, List[str]] = field(default_factory=dict)
    _JOURNAL_CAP = 200

    def _log(self, kind: str, namespace: str, name: str, line: str) -> None:
        lines = self.journal.setdefault((kind, namespace, name), [])
        lines.append(line)
        del lines[:-self._JOURNAL_CAP]

    def effective_nodes(self) -> List[FakeNode]:
        """Explicit node list, or one synthetic node holding all capacity."""
        if self.nodes:
            return self.nodes
        return [FakeNode(
            name=f"{self.name}-node-0",
            cpu_milli=self.cpu_allocatable_milli,
            memory_milli=Quantity.parse(f"{self.memory_allocatable_gi}Gi").milli,
            pods=self.pods_allocatable,
        )]

    # -- the member "API server" -------------------------------------------
    def apply(self, manifest: Dict[str, Any]) -> Unstructured:
        """Server-side-apply-ish create-or-update keyed by (kind, ns, name)."""
        obj = Unstructured.from_manifest(manifest)
        existing = self.store.try_get(obj.KIND, obj.namespace, obj.name)
        if existing is None:
            self._log(obj.KIND, obj.namespace, obj.name, "created")
            return self.store.create(obj)
        assert isinstance(existing, Unstructured)
        merged = copy.deepcopy(manifest)
        if existing.manifest.get("status") is not None and "status" not in merged:
            merged["status"] = existing.manifest["status"]
        if existing.spec_view() != obj.spec_view():
            self._log(obj.KIND, obj.namespace, obj.name, "spec updated")
        existing.manifest = merged
        existing.metadata.labels = dict(
            deep_get(merged, "metadata.labels", {}) or {})
        existing.metadata.annotations = dict(
            deep_get(merged, "metadata.annotations", {}) or {})
        return self.store.update(existing)

    def get(self, kind: str, namespace: str, name: str) -> Optional[Unstructured]:
        obj = self.store.try_get(kind, namespace, name)
        return obj  # type: ignore[return-value]

    def delete(self, kind: str, namespace: str, name: str) -> None:
        try:
            self.store.delete(kind, namespace, name)
            # drop the journal with the workload: no pod can read it anymore
            # and keys must not accumulate across churn in serve mode
            self.journal.pop((kind, namespace, name), None)
        except NotFoundError:
            pass

    # -- capacity telemetry (what cluster-status collects) ------------------
    def state_key(self) -> tuple:
        """What the capacity telemetry and the workload simulation read:
        the store's revision (a create or an update) and size (a delete
        hands out none), the capacity fields and nodes, and health."""
        return ((self.store.revision, len(self.store)), self.healthy,
                self.cpu_allocatable_milli, self.memory_allocatable_gi,
                self.pods_allocatable,
                tuple((n.name, n.cpu_milli, n.memory_milli, n.pods,
                       tuple(sorted(n.extra_milli.items())),
                       tuple(sorted(n.labels.items())))
                      for n in self.nodes))

    def used_milli(self) -> Dict[str, int]:
        cpu = mem = pods = 0
        for obj in self.store.visit_all():
            if not isinstance(obj, Unstructured):
                continue
            kind = obj.KIND
            if kind not in ("Deployment", "StatefulSet", "ReplicaSet", "Job", "Pod"):
                continue
            m = obj.manifest
            replicas = int(deep_get(m, "spec.replicas", 1) or 0)
            if kind == "Job":
                replicas = int(deep_get(m, "spec.parallelism", 1) or 1)
            if kind == "Pod":
                replicas = 1
            pod_spec = deep_get(m, "spec.template.spec", {}) or m.get("spec", {})
            c_cpu = c_mem = 0
            for container in pod_spec.get("containers", []) or []:
                reqs = deep_get(container, "resources.requests", {}) or {}
                c_cpu += Quantity.parse(reqs.get("cpu", 0)).milli
                c_mem += Quantity.parse(reqs.get("memory", 0)).milli
            cpu += replicas * c_cpu
            mem += replicas * c_mem
            pods += replicas
        return {"cpu": cpu, "memory": mem, "pods": pods * 1000}

    def resource_summary(self) -> ResourceSummary:
        used = self.used_milli()
        nodes = self.effective_nodes()
        return ResourceSummary(
            allocatable={
                "cpu": Quantity.from_milli(sum(n.cpu_milli for n in nodes)),
                "memory": Quantity.from_milli(sum(n.memory_milli for n in nodes)),
                "pods": Quantity.from_units(sum(n.pods for n in nodes)),
            },
            allocated={
                "cpu": Quantity.from_milli(used["cpu"]),
                "memory": Quantity.from_milli(used["memory"]),
                "pods": Quantity.from_milli(used["pods"]),
            },
        )

    # -- workload simulation ------------------------------------------------
    def _workload_request(self, m: Dict[str, Any]) -> Dict[str, int]:
        pod_spec = deep_get(m, "spec.template.spec", {}) or m.get("spec", {})
        req: Dict[str, int] = {"cpu": 0, "memory": 0}
        for container in pod_spec.get("containers", []) or []:
            reqs = deep_get(container, "resources.requests", {}) or {}
            for rname, qty in reqs.items():
                req[rname] = req.get(rname, 0) + Quantity.parse(qty).milli
        return req

    def admission_plan(self) -> Dict[tuple, int]:
        """Deterministic capacity admission: workloads in (kind, ns, name)
        order greedily admit replicas until cpu/memory/pods run out.  The
        remainder stays pending -- what the reference's unschedulable-replica
        estimator counts (pkg/estimator/server/replica/replica.go:43).

        The plan is kept on the member until its state_key moves: tick,
        the metrics plane and the estimator (once per binding and
        cluster) read one plan.  Callers must not change it."""
        key = self.state_key()
        kept = self.__dict__.get("_plan")
        if kept is not None and kept[0] == key:
            return kept[1]
        nodes = self.effective_nodes()
        cpu_left = sum(n.cpu_milli for n in nodes)
        mem_left = sum(n.memory_milli for n in nodes)
        pods_left = sum(n.pods for n in nodes)
        plan: Dict[tuple, int] = {}
        for obj in sorted(self.store.visit_all(),
                          key=lambda o: (o.KIND, o.namespace, o.name)):
            if not isinstance(obj, Unstructured):
                continue
            kind = obj.KIND
            if kind not in ("Deployment", "StatefulSet", "ReplicaSet", "Job", "Pod"):
                continue
            m = obj.manifest
            want = int(deep_get(m, "spec.replicas", 1) or 0)
            if kind == "Job":
                want = int(deep_get(m, "spec.parallelism", 1) or 1)
            if kind == "Pod":
                want = 1
            req = self._workload_request(m)
            admitted = 0
            for _ in range(want):
                if pods_left <= 0:
                    break
                if req["cpu"] > cpu_left or req["memory"] > mem_left:
                    break
                cpu_left -= req["cpu"]
                mem_left -= req["memory"]
                pods_left -= 1
                admitted += 1
            plan[(kind, obj.namespace, obj.name)] = admitted
        self.__dict__["_plan"] = (key, plan)
        return plan

    def unschedulable_replicas(self, kind: str, namespace: str, name: str) -> int:
        """Desired-but-unadmitted replicas for one workload (the estimator's
        GetUnschedulableReplicas answer)."""
        obj = self.store.peek(kind, namespace, name)
        if obj is None:
            return 0
        m = obj.manifest
        want = int(deep_get(m, "spec.replicas", 1) or 0)
        if kind == "Job":
            want = int(deep_get(m, "spec.parallelism", 1) or 1)
        admitted = self.admission_plan().get((kind, namespace, name), 0)
        return max(want - admitted, 0)

    # -- metrics plane (what the metrics adapter scrapes) -------------------
    def set_load(self, kind: str, namespace: str, name: str,
                 per_replica: Dict[str, int]) -> None:
        """Drive per-replica usage (milli-units) for one workload."""
        self.load[(kind, namespace, name)] = dict(per_replica)

    def pod_metrics(self, kind: str, namespace: str, name: str) -> List[Dict[str, Any]]:
        """metrics.k8s.io-style PodMetrics for one workload's READY replicas:
        [{"name": pod, "usage": {"cpu": milli, "memory": milli}}].  Usage is
        the driven load (set_load) or 10% of request when idle."""
        obj = self.get(kind, namespace, name)
        if obj is None or not self.healthy:
            return []
        ready = self.admission_plan().get((kind, namespace, name), 0)
        req = self._workload_request(obj.manifest)
        load = self.load.get((kind, namespace, name))
        if load is None:
            load = {k: v // 10 for k, v in req.items()}
        return [
            {"name": f"{name}-{i}", "usage": dict(load), "request": dict(req)}
            for i in range(ready)
        ]

    def tick(self) -> None:
        """Advance every applied workload's status toward ready, capped by
        the capacity admission plan."""
        if not self.healthy:
            return
        key = self.state_key()
        if self.__dict__.get("_idle") == key:
            return  # nothing moved since a tick that wrote nothing
        plan = self.admission_plan()
        for obj in self.store.visit_all():
            if not isinstance(obj, Unstructured):
                continue
            m = obj.manifest
            kind = obj.KIND
            if kind in ("Deployment", "StatefulSet", "ReplicaSet"):
                want = int(deep_get(m, "spec.replicas", 1) or 0)
                ready = plan.get((kind, obj.namespace, obj.name), want)
                status = {
                    "observedGeneration": deep_get(m, "metadata.generation",
                                                   obj.metadata.generation),
                    "replicas": want,
                    "readyReplicas": ready,
                    "updatedReplicas": ready,
                    "availableReplicas": ready,
                }
                if m.get("status") != status:
                    prev_ready = deep_get(m, "status.readyReplicas", 0) or 0
                    if prev_ready != ready:
                        self._log(kind, obj.namespace, obj.name,
                                  f"readyReplicas {prev_ready} -> {ready}")

                    def setst(o, status=status):
                        o.manifest["status"] = status
                    self.store.mutate(kind, obj.namespace, obj.name, setst)
            elif kind == "Job":
                par = int(deep_get(m, "spec.parallelism", 1) or 1)
                active = plan.get((kind, obj.namespace, obj.name), par)
                status = {"active": active, "succeeded": 0, "failed": 0}
                if m.get("status") != status:
                    def setst(o, status=status):
                        o.manifest["status"] = status
                    self.store.mutate(kind, obj.namespace, obj.name, setst)
        if self.state_key() == key:
            self.__dict__["_idle"] = key
