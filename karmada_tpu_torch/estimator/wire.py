"""Estimator wire protocol + transports (the gRPC tier of the reference).

Counterpart of the JAX package's ``estimator/wire.py``.  The reference
scheduler / descheduler talk proto2 gRPC with mTLS to one
karmada-scheduler-estimator per member cluster
(pkg/estimator/service/service.proto, pkg/estimator/pb/generated.proto:
MaxAvailableReplicasRequest/Response, UnschedulableReplicasRequest/
Response; pkg/util/grpcconnection/{client,server}.go).  The same contract
runs here over two transports with identical message schemas:

  * LocalTransport -- in-process dispatch (the fake-member loop);
  * TcpTransport / serve_tcp -- stdlib socket server with length-prefixed
    JSON frames and optional TLS via ssl.SSLContext (the mTLS analogue),
    for running estimators as sidecar processes.

Messages are dataclasses with explicit to/from_json so the wire format is
stable and transport-independent, and equal to the JAX package's frame
for frame.

The same frame transport carries the facade tier (facade/):
`SelectClusters` / `AssignReplicas` are the scheduler-as-a-service
contract -- a caller submits one small binding's requirements and gets a
placement back.
"""

from __future__ import annotations

import json
import socket
import socketserver
import struct
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from karmada_tpu_torch.models.work import ReplicaRequirements
from karmada_tpu_torch.utils.quantity import Quantity

UNAUTHENTIC_REPLICA = -1

#: hard bound on one frame's payload: a corrupt/hostile length prefix must
#: not become a multi-GiB allocation before the first payload byte arrives
MAX_FRAME_BYTES = 64 * 1024 * 1024


class FrameTooLarge(ValueError):
    """Length prefix exceeds MAX_FRAME_BYTES.  A ValueError on purpose:
    estimator.client.classify_exception maps ValueError to
    EstimatorMalformed (a protocol fault), where a ConnectionError would
    misreport it as EstimatorUnreachable and make the breaker retry a
    peer that is speaking garbage."""


# -- messages (pb/generated.proto equivalents) ------------------------------


@dataclass
class MaxAvailableReplicasRequest:
    cluster: str = ""
    resource_request: Dict[str, str] = field(default_factory=dict)
    node_selector: Dict[str, str] = field(default_factory=dict)

    def to_json(self) -> dict:
        return {"cluster": self.cluster, "resourceRequest": self.resource_request,
                "nodeSelector": self.node_selector}

    @staticmethod
    def from_json(d: dict) -> "MaxAvailableReplicasRequest":
        return MaxAvailableReplicasRequest(
            cluster=d.get("cluster", ""),
            resource_request=dict(d.get("resourceRequest", {})),
            node_selector=dict(d.get("nodeSelector", {})),
        )

    @staticmethod
    def from_requirements(
        cluster: str, requirements: Optional[ReplicaRequirements]
    ) -> "MaxAvailableReplicasRequest":
        req: Dict[str, str] = {}
        selector: Dict[str, str] = {}
        if requirements is not None:
            req = {k: str(v) for k, v in requirements.resource_request.items()}
            if requirements.node_claim is not None:
                selector = dict(requirements.node_claim.node_selector)
        return MaxAvailableReplicasRequest(
            cluster=cluster, resource_request=req, node_selector=selector
        )

    def requirements(self) -> Optional[ReplicaRequirements]:
        if not self.resource_request and not self.node_selector:
            return None
        from karmada_tpu_torch.models.work import NodeClaim

        return ReplicaRequirements(
            resource_request={k: Quantity.parse(v)
                              for k, v in self.resource_request.items()},
            node_claim=NodeClaim(node_selector=dict(self.node_selector))
            if self.node_selector else None,
        )


@dataclass
class MaxAvailableReplicasResponse:
    max_replicas: int = 0

    def to_json(self) -> dict:
        return {"maxReplicas": self.max_replicas}

    @staticmethod
    def from_json(d: dict) -> "MaxAvailableReplicasResponse":
        return MaxAvailableReplicasResponse(max_replicas=int(d.get("maxReplicas", 0)))


@dataclass
class MaxAvailableComponentSetsRequest:
    """pb.MaxAvailableComponentSetsRequest (generated.proto Component):
    how many whole SETS of a multi-template workload's components fit."""

    cluster: str = ""
    # [{"name": ..., "replicas": n, "resourceRequest": {res: quantity-str}}]
    components: List[Dict] = field(default_factory=list)

    @staticmethod
    def from_components(cluster: str, components) -> "MaxAvailableComponentSetsRequest":
        rows = []
        for c in components:
            req = {}
            if c.replica_requirements is not None:
                req = {k: str(v)
                       for k, v in c.replica_requirements.resource_request.items()}
            rows.append({"name": c.name, "replicas": c.replicas,
                         "resourceRequest": req})
        return MaxAvailableComponentSetsRequest(cluster=cluster, components=rows)

    def to_json(self) -> dict:
        return {"cluster": self.cluster, "components": self.components}

    @staticmethod
    def from_json(d: dict) -> "MaxAvailableComponentSetsRequest":
        return MaxAvailableComponentSetsRequest(
            cluster=d.get("cluster", ""),
            components=list(d.get("components", [])),
        )

    def typed_components(self):
        from karmada_tpu_torch.models.work import Component

        out = []
        for row in self.components:
            req = {k: Quantity.parse(v)
                   for k, v in (row.get("resourceRequest") or {}).items()}
            out.append(Component(
                name=row.get("name", ""), replicas=int(row.get("replicas", 0)),
                replica_requirements=ReplicaRequirements(resource_request=req)
                if req else None,
            ))
        return out


@dataclass
class MaxAvailableComponentSetsResponse:
    max_sets: int = 0

    def to_json(self) -> dict:
        return {"maxSets": self.max_sets}

    @staticmethod
    def from_json(d: dict) -> "MaxAvailableComponentSetsResponse":
        return MaxAvailableComponentSetsResponse(max_sets=int(d.get("maxSets", 0)))


@dataclass
class UnschedulableReplicasRequest:
    cluster: str = ""
    resource_kind: str = ""
    namespace: str = ""
    name: str = ""
    unschedulable_threshold_seconds: int = 60

    def to_json(self) -> dict:
        return {"cluster": self.cluster, "kind": self.resource_kind,
                "namespace": self.namespace, "name": self.name,
                "thresholdSeconds": self.unschedulable_threshold_seconds}

    @staticmethod
    def from_json(d: dict) -> "UnschedulableReplicasRequest":
        return UnschedulableReplicasRequest(
            cluster=d.get("cluster", ""), resource_kind=d.get("kind", ""),
            namespace=d.get("namespace", ""), name=d.get("name", ""),
            unschedulable_threshold_seconds=int(d.get("thresholdSeconds", 60)),
        )


@dataclass
class UnschedulableReplicasResponse:
    unschedulable_replicas: int = 0

    def to_json(self) -> dict:
        return {"unschedulableReplicas": self.unschedulable_replicas}

    @staticmethod
    def from_json(d: dict) -> "UnschedulableReplicasResponse":
        return UnschedulableReplicasResponse(
            unschedulable_replicas=int(d.get("unschedulableReplicas", 0)))


@dataclass
class CapacitySnapshotResponse:
    """Capacity-tensor shipping (the BASELINE.json pkg/estimator change):
    instead of one RPC per (binding, cluster), an estimator ships its whole
    per-node capacity table once per refresh; the scheduler's batched
    solver evaluates any request class against it locally."""

    cluster: str = ""
    # per node: free capacity, milli units for EVERY resource the node
    # exposes — {"cpu": milli, "memory": milli, "pods": n, <extended
    # resource e.g. "nvidia.com/gpu">: milli, ...}.  Estimator sidecars must
    # ship extended resources here or replicas_on_node reports 0 for them.
    node_free: List[Dict[str, int]] = field(default_factory=list)
    # per node: labels, aligned with node_free (node-selector evaluation)
    node_labels: List[Dict[str, str]] = field(default_factory=list)

    def to_json(self) -> dict:
        return {"cluster": self.cluster, "nodeFree": self.node_free,
                "nodeLabels": self.node_labels}

    @staticmethod
    def from_json(d: dict) -> "CapacitySnapshotResponse":
        return CapacitySnapshotResponse(
            cluster=d.get("cluster", ""), node_free=list(d.get("nodeFree", [])),
            node_labels=list(d.get("nodeLabels", [])))


# -- facade messages (karmada_tpu/facade's scheduler-as-a-service tier) -----


@dataclass
class SelectClustersRequest:
    """Feasibility query (the reference's SelectClusters phase: group +
    filter): which member clusters can host this request class at all."""

    namespace: str = "default"
    name: str = ""
    resource_request: Dict[str, str] = field(default_factory=dict)
    cluster_names: List[str] = field(default_factory=list)

    def to_json(self) -> dict:
        return {"namespace": self.namespace, "name": self.name,
                "resourceRequest": self.resource_request,
                "clusterNames": self.cluster_names}

    @staticmethod
    def from_json(d: dict) -> "SelectClustersRequest":
        return SelectClustersRequest(
            namespace=d.get("namespace", "default"),
            name=d.get("name", ""),
            resource_request=dict(d.get("resourceRequest", {})),
            cluster_names=list(d.get("clusterNames", [])),
        )


@dataclass
class SelectClustersResponse:
    clusters: List[str] = field(default_factory=list)
    # per filtered-out cluster: the filter diagnosis (FitError shape)
    excluded: Dict[str, str] = field(default_factory=dict)

    def to_json(self) -> dict:
        return {"clusters": self.clusters, "excluded": self.excluded}

    @staticmethod
    def from_json(d: dict) -> "SelectClustersResponse":
        return SelectClustersResponse(
            clusters=list(d.get("clusters", [])),
            excluded=dict(d.get("excluded", {})),
        )


@dataclass
class AssignReplicasRequest:
    """One small binding in, a placement out — the facade's core verb
    (the reference's core.AssignReplicas seam served over the wire).
    `divided` selects Divided+Aggregated packing; default is Duplicated
    across every feasible cluster.  `cluster_names` restricts the
    candidate set (a ClusterAffinity allowlist)."""

    namespace: str = "default"
    name: str = ""
    replicas: int = 1
    resource_request: Dict[str, str] = field(default_factory=dict)
    divided: bool = False
    cluster_names: List[str] = field(default_factory=list)
    # caller-side trace id: stitches the caller's timeline to the
    # coalesced batch it rode (the JAX package also files it in its
    # flight records)
    trace_id: str = ""

    def to_json(self) -> dict:
        d = {"namespace": self.namespace, "name": self.name,
             "replicas": self.replicas,
             "resourceRequest": self.resource_request,
             "divided": self.divided,
             "clusterNames": self.cluster_names}
        if self.trace_id:
            # emitted only when set: untraced callers keep the exact
            # frame shape older peers golden-test against
            d["traceId"] = self.trace_id
        return d

    @staticmethod
    def from_json(d: dict) -> "AssignReplicasRequest":
        return AssignReplicasRequest(
            namespace=d.get("namespace", "default"),
            name=d.get("name", ""),
            replicas=int(d.get("replicas", 1)),
            resource_request=dict(d.get("resourceRequest", {})),
            divided=bool(d.get("divided", False)),
            cluster_names=list(d.get("clusterNames", [])),
            trace_id=d.get("traceId", ""),
        )


@dataclass
class AssignReplicasResponse:
    """`assignments` is the TargetCluster list ([{cluster, replicas}]);
    `batch_id`/`batch_size` name the coalesced facade cycle this call
    shared, so a caller can see how many peers rode its device dispatch."""

    assignments: List[Dict] = field(default_factory=list)
    outcome: str = "scheduled"  # scheduled | unschedulable | error
    message: str = ""
    trace_id: str = ""
    batch_id: int = 0
    batch_size: int = 0

    def to_json(self) -> dict:
        return {"assignments": self.assignments, "outcome": self.outcome,
                "message": self.message, "traceId": self.trace_id,
                "batchId": self.batch_id, "batchSize": self.batch_size}

    @staticmethod
    def from_json(d: dict) -> "AssignReplicasResponse":
        return AssignReplicasResponse(
            assignments=list(d.get("assignments", [])),
            outcome=d.get("outcome", "scheduled"),
            message=d.get("message", ""),
            trace_id=d.get("traceId", ""),
            batch_id=int(d.get("batchId", 0)),
            batch_size=int(d.get("batchSize", 0)),
        )


def replicas_on_node(
    free: Dict[str, int],
    labels: Dict[str, str],
    requirements: Optional[ReplicaRequirements],
) -> int:
    """How many replicas of `requirements` fit on one node's free capacity.

    The single shared implementation of the per-node min-divide
    (pkg/estimator/server estimate.go:31-93 semantics): cpu in milli,
    memory Value() (ceil to units), pods; node-selector mismatch -> 0.
    """
    per_node = int(free.get("pods", 0))
    if requirements is None:
        return max(per_node, 0)
    if requirements.node_claim is not None:
        for k, v in requirements.node_claim.node_selector.items():
            if labels.get(k) != v:
                return 0
    from karmada_tpu_torch.utils.quantity import RESOURCE_CPU, resource_request_value

    for rname, qty in requirements.resource_request.items():
        requested = resource_request_value(rname, qty)
        if requested <= 0:
            continue
        if rname == RESOURCE_CPU:
            avail = int(free.get("cpu", 0))
        elif rname == "pods":
            avail = int(free.get("pods", 0))
        else:
            # generic path (memory, ephemeral-storage, extended resources
            # such as GPUs): the free table carries milli units for every
            # resource the node exposes; request values use Value(), so
            # convert milli -> value with k8s away-from-zero rounding.  A
            # resource the node does not expose is genuinely 0 here.
            avail = -((-int(free.get(rname, 0))) // 1000)
        per_node = min(per_node, avail // requested)
    return max(per_node, 0)


def _pool_sets_bound(free: List[Dict[str, int]], components) -> int:
    """Pool-level upper bound on whole component sets: summed free
    capacity divided by one set's aggregate demand (the reference's
    quota-style view)."""
    from karmada_tpu_torch.estimator.general import per_set_requirement, pods_in_set
    from karmada_tpu_torch.utils.quantity import RESOURCE_CPU, RESOURCE_PODS

    MAX_INT32 = (1 << 31) - 1
    pods_free = sum(int(f.get("pods", 0)) for f in free)
    if pods_free <= 0:
        return 0
    pods_per_set = pods_in_set(components)
    if pods_per_set <= 0:
        return min(pods_free, MAX_INT32)
    total = pods_free // pods_per_set
    for rname, req in per_set_requirement(components).items():
        if req <= 0:
            continue
        pool = sum(int(f.get(rname, 0)) for f in free)
        if rname in (RESOURCE_CPU, RESOURCE_PODS):
            avail = pool
        else:
            avail = -((-pool) // 1000)
        if avail <= 0:
            return 0
        total = min(total, avail // req)
    return min(total, MAX_INT32)


def _per_replica_needs(components) -> List[Tuple[int, Dict[str, int]]]:
    """(replicas, per-replica need in table units) per component: cpu in
    milli, every other resource milli (request Value x 1000).  The 'pods'
    axis is implicit — one pod per replica — so an explicit 'pods'
    request is skipped here (it is already counted by pods_in_set)."""
    from karmada_tpu_torch.utils.quantity import (
        RESOURCE_CPU,
        RESOURCE_PODS,
        resource_request_value,
    )

    needs: List[Tuple[int, Dict[str, int]]] = []
    for c in components:
        req: Dict[str, int] = {}
        rr = c.replica_requirements
        if rr is not None:
            for rname, qty in rr.resource_request.items():
                if rname == RESOURCE_PODS:
                    continue
                v = resource_request_value(rname, qty)
                if v <= 0:
                    continue
                req[rname] = v if rname == RESOURCE_CPU else v * 1000
        needs.append((max(int(c.replicas), 0), req))
    return needs


def max_sets_from_free_table(free: List[Dict[str, int]], components) -> int:
    """Whole component SETS that fit a free-capacity table, packed NODE
    BY NODE.

    The single implementation behind AccurateEstimatorServer and
    SnapshotEstimator component-set answers.  The reference estimator
    server leaves node-level set packing as a TODO (estimate.go:70-90
    runs only quota-style pool plugins); this resolves it: each component
    replica of each candidate set is placed first-fit onto a node that
    still fits its whole per-replica request, so a fragmented pool can no
    longer overreport (two 1-cpu nodes pack ZERO sets of a 2-cpu pod,
    where the pool bound said one).  First-fit in table order is greedy,
    not optimal bin packing (that is NP-hard) — it can only UNDER-report
    relative to a perfect packing, the safe direction for an estimator.
    Workloads with no per-replica resource requests keep the exact pool
    answer (pods spread freely, so pool == packing).  Node selectors are
    out of scope here, as in the reference's pool plugins.

    Units follow the table convention: 'pods' is a raw count, cpu is
    milli, everything else milli -> Value.
    """
    upper = _pool_sets_bound(free, components)
    if upper <= 0:
        return 0
    needs = _per_replica_needs(components)
    if not any(req for _, req in needs):
        return upper  # pods-only demand: the pool bound is exact
    nodes = [dict(f) for f in free]
    # per-component candidate lists in first-fit (table) order: node
    # capacity only decreases, so a node that cannot fit component k's
    # per-replica request NOW never can again — prune it permanently.
    # That keeps the first-fit outcome bit-identical to a full rescan
    # while making the whole pack amortized O(placements + components x
    # nodes) instead of O(placements x nodes).
    cand = [list(range(len(nodes))) for _ in needs]
    sets = 0
    while sets < upper:
        placed_all = True
        for k, (n_replicas, req) in enumerate(needs):
            lst = cand[k]
            for _ in range(n_replicas):
                node = None
                while lst:
                    nd = nodes[lst[0]]
                    if int(nd.get("pods", 0)) > 0 and all(
                            int(nd.get(r, 0)) >= v
                            for r, v in req.items()):
                        node = nd
                        break
                    lst.pop(0)  # exhausted for this component forever
                if node is None:
                    placed_all = False
                    break
                node["pods"] = int(node.get("pods", 0)) - 1
                for r, v in req.items():
                    node[r] = int(node.get(r, 0)) - v
            if not placed_all:
                break
        if not placed_all:
            break
        sets += 1
    return sets


_METHODS = {
    "MaxAvailableReplicas": MaxAvailableReplicasRequest,
    "MaxAvailableComponentSets": MaxAvailableComponentSetsRequest,
    "GetUnschedulableReplicas": UnschedulableReplicasRequest,
    "CapacitySnapshot": None,  # empty request body
}


# -- transports --------------------------------------------------------------


class Transport:
    """One estimator endpoint: call(method, request_json) -> response_json."""

    def call(self, method: str, request: dict) -> dict:  # pragma: no cover
        raise NotImplementedError

    def close(self) -> None:
        pass


class LocalTransport(Transport):
    def __init__(self, handler: Callable[[str, dict], dict]) -> None:
        self.handler = handler

    def call(self, method: str, request: dict) -> dict:
        return self.handler(method, request)


def _send_frame(sock: socket.socket, payload: dict) -> None:
    raw = json.dumps(payload).encode("utf-8")
    sock.sendall(struct.pack(">I", len(raw)) + raw)


def _recv_frame(sock: socket.socket) -> dict:
    header = _recv_exact(sock, 4)
    (length,) = struct.unpack(">I", header)
    if length > MAX_FRAME_BYTES:
        raise FrameTooLarge(
            f"frame length {length} exceeds {MAX_FRAME_BYTES} bytes")
    return json.loads(_recv_exact(sock, length).decode("utf-8"))


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return buf


class TcpTransport(Transport):
    """Length-prefixed JSON frames over TCP, optionally TLS-wrapped."""

    def __init__(self, host: str, port: int, ssl_context=None,
                 timeout: float = 5.0) -> None:
        self.addr = (host, port)
        self.ssl_context = ssl_context
        self.timeout = timeout
        self._sock: Optional[socket.socket] = None
        self._lock = threading.Lock()

    def _connect(self) -> socket.socket:
        sock = socket.create_connection(self.addr, timeout=self.timeout)
        if self.ssl_context is not None:
            sock = self.ssl_context.wrap_socket(sock, server_hostname=self.addr[0])
        # create_connection's timeout bounds only the CONNECT; re-arm it on
        # the (possibly TLS-wrapped) socket so every recv is bounded too —
        # a stalled peer surfaces as socket.timeout (a TimeoutError, i.e.
        # EstimatorTimeout through classify_exception), not a hang
        sock.settimeout(self.timeout)
        return sock

    def call(self, method: str, request: dict) -> dict:
        # _lock held across the round trip BY DESIGN: it serializes use
        # of the single persistent socket — releasing it mid-exchange
        # would let a second caller interleave frames and desync the
        # length-prefixed stream.  Every socket op below is bounded by
        # self.timeout (settimeout in _connect), so the hold time is
        # bounded too; callers queue behind the breaker, never hang.
        with self._lock:
            if self._sock is None:
                self._sock = self._connect()
            try:
                _send_frame(self._sock, {"method": method, "body": request})
                resp = _recv_frame(self._sock)
            except (FrameTooLarge, socket.timeout):
                # protocol desync / stalled peer: the stream cannot be
                # trusted (a partial frame may still be in flight), and a
                # blind resend could double-execute the call — drop the
                # connection and surface the typed fault to the breaker
                self._sock.close()
                self._sock = None
                raise
            except (ConnectionError, OSError):
                # one reconnect attempt (sidecar restarts are routine)
                self._sock.close()
                self._sock = self._connect()
                _send_frame(self._sock, {"method": method, "body": request})
                resp = _recv_frame(self._sock)
        if "error" in resp:
            raise RuntimeError(f"estimator error: {resp['error']}")
        return resp.get("body", {})

    def close(self) -> None:
        with self._lock:
            if self._sock is not None:
                self._sock.close()
                self._sock = None


class _Handler(socketserver.StreamRequestHandler):
    def handle(self) -> None:
        while True:
            try:
                frame = _recv_frame(self.request)
            except (FrameTooLarge, ConnectionError, OSError):
                # an oversize prefix means the peer is desynced or hostile:
                # there is no way to resync a length-prefixed stream, so
                # the only safe response is dropping the connection
                return
            try:
                body = self.server.dispatch(  # type: ignore[attr-defined]
                    frame.get("method", ""), frame.get("body", {}))
                _send_frame(self.request, {"body": body})
            except Exception as e:  # noqa: BLE001 -- serialize server errors
                _send_frame(self.request, {"error": str(e)})


class EstimatorTcpServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, addr, handler: Callable[[str, dict], dict],
                 ssl_context=None) -> None:
        super().__init__(addr, _Handler)
        self._dispatch = handler
        self._ssl_context = ssl_context

    def get_request(self):
        sock, addr = super().get_request()
        if self._ssl_context is not None:
            sock = self._ssl_context.wrap_socket(sock, server_side=True)
        return sock, addr

    def dispatch(self, method: str, body: dict) -> dict:
        return self._dispatch(method, body)


def serve_tcp(handler: Callable[[str, dict], dict], host: str = "127.0.0.1",
              port: int = 0, ssl_context=None) -> EstimatorTcpServer:
    """Start a daemon estimator server; returns it (server_address has the
    bound port)."""
    server = EstimatorTcpServer((host, port), handler, ssl_context)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return server
