"""Estimator clients: the scheduler side of the capacity protocol.

Counterpart of the JAX package's ``estimator/client.py``.  Mirrors
reference pkg/estimator/client: the `ReplicaEstimator` /
`UnschedulableReplicaEstimator` interfaces (interface.go:39-70), the
accurate gRPC client with per-cluster fan-out (accurate.go:55-170 --
getClusterReplicasConcurrently), the UNAUTHENTIC_REPLICA=-1 sentinel for
clusters without an estimator endpoint, and the registry the scheduler
min-merges across (serial.make_cal_available).

Beyond the reference: SnapshotEstimator pulls each estimator's whole
free-capacity table (CapacitySnapshot) on a refresh interval and answers
MaxAvailableReplicas locally -- per-binding RPCs collapse to one snapshot
fetch per cluster per cycle.

The `estimator.rpc` chaos seam sits in front of the wire
(`_transport_call`), and the JAX package's karmada_estimator_* families
count on the registry.  The same counts also live on the objects:
`AccurateEstimatorClient.errors` (failures by typed kind), `.retries` and
`.rpc_skipped` (by method), and `CircuitBreaker.transitions`.
"""

from __future__ import annotations

import json
import random
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Tuple

from karmada_tpu_torch import chaos, obs
from karmada_tpu_torch.utils.metrics import REGISTRY
from karmada_tpu_torch.estimator.wire import (
    UNAUTHENTIC_REPLICA,
    CapacitySnapshotResponse,
    MaxAvailableComponentSetsRequest,
    MaxAvailableComponentSetsResponse,
    MaxAvailableReplicasRequest,
    MaxAvailableReplicasResponse,
    Transport,
    UnschedulableReplicasRequest,
    UnschedulableReplicasResponse,
    max_sets_from_free_table,
    replicas_on_node,
)
from karmada_tpu_torch.models.cluster import Cluster
from karmada_tpu_torch.models.work import ReplicaRequirements, TargetCluster

RPC_SKIPPED = REGISTRY.counter(
    "karmada_estimator_rpc_skipped_total",
    "Per-cluster estimator RPCs short-circuited because the cluster's "
    "observed resourceVersion and the request signature were unchanged "
    "since the previous cycle (the memoized answer served instead)",
    ("method",),
)

ESTIMATOR_ERRORS = REGISTRY.counter(
    "karmada_estimator_errors_total",
    "Estimator RPC failures by typed classification (unreachable / "
    "timeout / malformed per attempt, circuit_open per short-circuited "
    "call) — a dead estimator is no longer indistinguishable from a "
    "full cluster",
    ("kind",),
)

ESTIMATOR_RETRIES = REGISTRY.counter(
    "karmada_estimator_retries_total",
    "Estimator RPC retry attempts (bounded, full-jitter exponential "
    "backoff) by method",
    ("method",),
)

CIRCUIT_STATE = REGISTRY.gauge(
    "karmada_estimator_circuit_state",
    "Per-cluster estimator circuit-breaker state "
    "(0 = closed, 1 = open, 2 = half-open)",
    ("cluster",),
)

CIRCUIT_TRANSITIONS = REGISTRY.counter(
    "karmada_estimator_circuit_transitions_total",
    "Estimator circuit-breaker state transitions by target state",
    ("to",),
)


# -- typed error classification ----------------------------------------------
class EstimatorError(Exception):
    """Base of the typed estimator failure taxonomy; `kind` is the key
    the client counts it under."""

    kind = "unreachable"


class EstimatorUnreachable(EstimatorError):
    kind = "unreachable"


class EstimatorTimeout(EstimatorError):
    kind = "timeout"


class EstimatorMalformed(EstimatorError):
    kind = "malformed"


class EstimatorCircuitOpen(EstimatorError):
    kind = "circuit_open"


def classify_exception(exc: BaseException) -> EstimatorError:
    """Map a raw transport / parse failure onto the typed taxonomy.
    TimeoutError first: socket.timeout IS a TimeoutError which IS an
    OSError, so the order of these checks is the classification."""
    if isinstance(exc, EstimatorError):
        return exc
    if isinstance(exc, TimeoutError):
        return EstimatorTimeout(str(exc))
    if isinstance(exc, (ConnectionError, OSError)):
        return EstimatorUnreachable(str(exc))
    # ValueError/TypeError/KeyError/AttributeError from response parsing,
    # json decode faults, and RuntimeError (a server-serialized error
    # frame): the endpoint answered but the reply could not be used
    return EstimatorMalformed(f"{type(exc).__name__}: {exc}")


# -- per-cluster circuit breaker ----------------------------------------------
CIRCUIT_CLOSED = "closed"
CIRCUIT_OPEN = "open"
CIRCUIT_HALF_OPEN = "half-open"
_CIRCUIT_VALUE = {CIRCUIT_CLOSED: 0.0, CIRCUIT_OPEN: 1.0,
                  CIRCUIT_HALF_OPEN: 2.0}


class CircuitBreaker:
    """Classic closed -> open -> half-open breaker, one circuit per
    member cluster: `failure_threshold` consecutive failed CALLS (each
    already retried) open the circuit; while open every call
    short-circuits to the sentinel without touching the wire; after
    `reset_timeout_s` ONE probe call is allowed through (half-open) --
    success closes the circuit, failure re-opens it for another full
    timeout.  `clock` is injectable."""

    def __init__(self, failure_threshold: int = 5,
                 reset_timeout_s: float = 30.0,
                 clock: Optional[Callable[[], float]] = None) -> None:
        self.failure_threshold = max(1, failure_threshold)
        self.reset_timeout_s = reset_timeout_s
        self.clock = clock if clock is not None else time.monotonic
        self._lock = threading.Lock()
        self._state: Dict[str, str] = {}  # guarded-by: _lock
        self._failures: Dict[str, int] = {}  # guarded-by: _lock
        self._opened_at: Dict[str, float] = {}  # guarded-by: _lock
        self._probing: set = set()  # guarded-by: _lock
        # guarded-by: _lock -- bounded transition log
        self.transitions: deque = deque(maxlen=256)

    def _set(self, cluster: str, state: str) -> None:
        """Transition (call under _lock); metrics + log on real moves."""
        prev = self._state.get(cluster, CIRCUIT_CLOSED)
        if prev == state:
            return
        self._state[cluster] = state
        self.transitions.append({"cluster": cluster, "from": prev,
                                 "to": state, "ts": self.clock()})
        CIRCUIT_STATE.set(_CIRCUIT_VALUE[state], cluster=cluster)
        CIRCUIT_TRANSITIONS.inc(to=state)

    def allow(self, cluster: str) -> bool:
        """May a call to this cluster's estimator proceed?  Handles the
        open->half-open transition; in half-open only one probe flies."""
        with self._lock:
            state = self._state.get(cluster, CIRCUIT_CLOSED)
            if state == CIRCUIT_CLOSED:
                return True
            if state == CIRCUIT_OPEN:
                if (self.clock() - self._opened_at.get(cluster, 0.0)
                        >= self.reset_timeout_s):
                    self._set(cluster, CIRCUIT_HALF_OPEN)
                    self._probing.add(cluster)
                    return True
                return False
            # half-open: exactly one in-flight probe
            if cluster in self._probing:
                return False
            self._probing.add(cluster)
            return True

    def record_success(self, cluster: str) -> None:
        with self._lock:
            self._probing.discard(cluster)
            self._failures[cluster] = 0
            self._set(cluster, CIRCUIT_CLOSED)

    def record_failure(self, cluster: str) -> None:
        with self._lock:
            self._probing.discard(cluster)
            state = self._state.get(cluster, CIRCUIT_CLOSED)
            if state in (CIRCUIT_HALF_OPEN, CIRCUIT_OPEN):
                # a failed probe re-opens for another full timeout
                self._opened_at[cluster] = self.clock()
                self._set(cluster, CIRCUIT_OPEN)
                return
            n = self._failures.get(cluster, 0) + 1
            self._failures[cluster] = n
            if n >= self.failure_threshold:
                self._opened_at[cluster] = self.clock()
                self._set(cluster, CIRCUIT_OPEN)

    def forget(self, cluster: str) -> None:
        with self._lock:
            self._state.pop(cluster, None)
            self._failures.pop(cluster, None)
            self._opened_at.pop(cluster, None)
            self._probing.discard(cluster)
        CIRCUIT_STATE.set(0.0, cluster=cluster)

    def state(self, cluster: str) -> str:
        with self._lock:
            return self._state.get(cluster, CIRCUIT_CLOSED)

    def states(self) -> Dict[str, str]:
        with self._lock:
            return dict(self._state)

    def transition_log(self) -> List[dict]:
        with self._lock:
            return list(self.transitions)


def _rpc_span(cluster: str, method: str):
    """An "estimator.rpc" span under the ambient trace, or the no-op span
    when tracing is off or no trace is active: an RPC outside any cycle or
    reconcile must not mint single-span root traces into the ring."""
    tracer = obs.TRACER
    if not tracer.enabled or tracer.current() is None:
        return obs.NOOP_SPAN
    return tracer.span(obs.SPAN_ESTIMATOR_RPC, cluster=cluster,
                       method=method)


def _traced_map(pool: ThreadPoolExecutor, fn, clusters: List[Cluster],
                method: str) -> list:
    """pool.map with flight-recorder spans: each per-cluster RPC runs
    under an "estimator.rpc" span parented, across the pool's thread
    boundary, into the calling thread's trace (the scheduler cycle, a
    descheduler reconcile).  Without an ambient trace: plain pool.map."""
    tracer = obs.TRACER
    parent = tracer.current() if tracer.enabled else None
    if parent is None:
        return list(pool.map(fn, clusters))

    def traced_one(cluster: Cluster):
        with tracer.attach(parent):
            with tracer.span(obs.SPAN_ESTIMATOR_RPC, cluster=cluster.name,
                             method=method):
                return fn(cluster)

    return list(pool.map(traced_one, clusters))


class AccurateEstimatorClient:
    """Per-cluster RPC fan-out (accurate.go): one transport per member.

    Every wire call runs through the hardened path: the per-cluster
    circuit breaker gates it (open circuits short-circuit to the
    sentinel without touching the network), transient failures retry
    with bounded full-jitter exponential backoff (`retry_attempts`
    total tries), and every failure is CLASSIFIED -- unreachable /
    timeout / malformed -- into `errors` before the UNAUTHENTIC
    sentinel keeps the solver's answer total.  `sleep` / `clock` are
    injectable so tests never wall-sleep."""

    #: per-(method, cluster) signature cap for the rv-keyed RPC memo
    _MEMO_CAP = 256

    def __init__(self, max_workers: int = 16,
                 timeout_replicas: int = UNAUTHENTIC_REPLICA,
                 breaker: Optional[CircuitBreaker] = None,
                 retry_attempts: int = 3,
                 retry_base_s: float = 0.02,
                 retry_cap_s: float = 0.25,
                 sleep: Callable[[float], None] = time.sleep,
                 clock: Optional[Callable[[], float]] = None) -> None:
        self.transports: Dict[str, Transport] = {}
        self._pool = ThreadPoolExecutor(max_workers=max_workers)
        self._timeout_replicas = timeout_replicas
        self.breaker = (breaker if breaker is not None
                        else CircuitBreaker(clock=clock))
        self.retry_attempts = max(1, retry_attempts)
        self.retry_base_s = retry_base_s
        self.retry_cap_s = retry_cap_s
        self._sleep = sleep
        # deterministic jitter stream (replayable runs)
        self._retry_rng = random.Random(0xC1A05)
        self._count_lock = threading.Lock()
        #: failures by typed kind (a call's every failed attempt, and
        #: each short-circuited call as "circuit_open")
        self.errors: Dict[str, int] = {}  # guarded-by: _count_lock
        #: retry attempts by method
        self.retries: Dict[str, int] = {}  # guarded-by: _count_lock
        #: RPCs the rv-keyed memo answered instead, by method
        self.rpc_skipped: Dict[str, int] = {}  # guarded-by: _count_lock
        self._memo_lock = threading.Lock()
        # guarded-by: _memo_lock -- per (method, cluster): the cluster
        # resourceVersion the memoized answers were observed at, and the
        # successful answers keyed by request signature.  A cluster whose
        # rv is unchanged since the last call re-serves the memo instead
        # of refetching; any rv move drops the whole entry.  Only
        # SUCCESSFUL responses memoize -- an unreachable estimator must be
        # retried next call, not pinned UNAUTHENTIC.  Each entry holds at
        # most _MEMO_CAP signatures; overflow drops the oldest insertions.
        self._memo: Dict[Tuple[str, str], Tuple[int, Dict[str, int]]] = {}

    def _count(self, table: Dict[str, int], key: str) -> None:
        with self._count_lock:
            table[key] = table.get(key, 0) + 1

    def counts(self) -> Dict[str, Dict[str, int]]:
        """The client's counters: errors by kind, retries and memo skips
        by method."""
        with self._count_lock:
            return {"errors": dict(self.errors),
                    "retries": dict(self.retries),
                    "rpc_skipped": dict(self.rpc_skipped)}

    def register(self, cluster: str, transport: Transport) -> None:
        self.transports[cluster] = transport

    def deregister(self, cluster: str) -> None:
        t = self.transports.pop(cluster, None)
        if t is not None:
            t.close()
        self.breaker.forget(cluster)
        with self._memo_lock:
            for key in [k for k in self._memo if k[1] == cluster]:
                del self._memo[key]

    def close(self) -> None:
        """Release the fan-out pool's threads (the JAX client leaves its
        pool to the interpreter's exit)."""
        self._pool.shutdown(wait=True)

    # -- the hardened wire path ----------------------------------------------
    def _transport_call(self, cluster: str, transport: Transport,
                        method: str, payload: dict) -> dict:
        """One raw attempt, with the chaos seam in front of the wire
        (error/timeout raise the transport's own failure shapes; slow
        delays; garbage substitutes an unparseable reply)."""
        if chaos.armed():
            f = chaos.fire(chaos.SITE_ESTIMATOR_RPC, cluster=cluster,
                           method=method)
            if f is not None:
                if f.mode == "error":
                    raise ConnectionError(
                        "chaos: estimator connection refused")
                if f.mode == "timeout":
                    raise TimeoutError("chaos: estimator call timed out")
                if f.mode == "slow":
                    self._sleep(f.delay)
                elif f.mode == "garbage":
                    # structurally unusable on every method's parse path
                    return {"maxReplicas": "garbage", "maxSets": "garbage",
                            "unschedulableReplicas": "garbage",
                            "nodeFree": 0, "nodeLabels": 0}
        return transport.call(method, payload)

    def _request(self, cluster: str, transport: Transport, method: str,
                 payload: dict, parse: Callable[[dict], object]) -> object:
        """One logical estimator call: breaker gate, bounded full-jitter
        retry, typed classification.  Returns parse(reply) or raises an
        EstimatorError whose kind is already counted."""
        if not self.breaker.allow(cluster):
            self._count(self.errors, EstimatorCircuitOpen.kind)
            ESTIMATOR_ERRORS.inc(kind=EstimatorCircuitOpen.kind)
            raise EstimatorCircuitOpen(
                f"estimator circuit open for cluster {cluster!r}")
        err: EstimatorError = EstimatorUnreachable("no attempt made")
        for attempt in range(self.retry_attempts):
            if attempt:
                self._count(self.retries, method)
                ESTIMATOR_RETRIES.inc(method=method)
                # full jitter: uniform over [0, min(cap, base * 2^k)] --
                # a deterministic stream, never a synchronized stampede
                self._sleep(self._retry_rng.uniform(
                    0.0, min(self.retry_cap_s,
                             self.retry_base_s * (2 ** (attempt - 1)))))
            try:
                value = parse(self._transport_call(
                    cluster, transport, method, payload))
            except Exception as exc:  # noqa: BLE001 — classified + counted
                err = classify_exception(exc)
                self._count(self.errors, err.kind)
                ESTIMATOR_ERRORS.inc(kind=err.kind)
                continue
            self.breaker.record_success(cluster)
            return value
        self.breaker.record_failure(cluster)
        raise err

    # -- rv-keyed RPC memo ---------------------------------------------------
    @staticmethod
    def _req_sig(payload: dict) -> str:
        return json.dumps(payload, sort_keys=True, default=str)

    def _memo_get(self, method: str, cluster: Cluster,
                  sig: str) -> Optional[int]:
        rv = cluster.metadata.resource_version
        with self._memo_lock:
            entry = self._memo.get((method, cluster.name))
            if entry is None or entry[0] != rv:
                return None
            answer = entry[1].get(sig)
        if answer is not None:
            self._count(self.rpc_skipped, method)
            RPC_SKIPPED.inc(method=method)
        return answer

    def _memo_put(self, method: str, cluster: Cluster, sig: str,
                  answer: int) -> None:
        rv = cluster.metadata.resource_version
        with self._memo_lock:
            entry = self._memo.get((method, cluster.name))
            if entry is None or entry[0] != rv:
                entry = (rv, {})
                self._memo[(method, cluster.name)] = entry
            answers = entry[1]
            while len(answers) >= self._MEMO_CAP:
                answers.pop(next(iter(answers)))  # oldest insertion
            answers[sig] = answer

    def _fan_out(self, clusters: List[Cluster], method: str, sig: str,
                 payload_of: Callable[[str], dict],
                 parse: Callable[[dict], int]) -> List[TargetCluster]:
        """One memoized, hardened call per cluster over the pool."""

        def one(cluster: Cluster) -> TargetCluster:
            transport = self.transports.get(cluster.name)
            if transport is None:
                return TargetCluster(cluster.name, UNAUTHENTIC_REPLICA)
            payload = payload_of(cluster.name)
            cached = self._memo_get(method, cluster, sig)
            if cached is not None:
                return TargetCluster(cluster.name, cached)
            try:
                value = self._request(cluster.name, transport, method,
                                      payload, parse)
            except EstimatorError:
                # typed + counted in _request; the sentinel keeps the
                # solver's min-merge total
                return TargetCluster(cluster.name, self._timeout_replicas)
            self._memo_put(method, cluster, sig, value)
            return TargetCluster(cluster.name, value)

        return _traced_map(self._pool, one, clusters, method)

    # -- ReplicaEstimator ----------------------------------------------------
    def max_available_replicas(
        self,
        clusters: List[Cluster],
        requirements: Optional[ReplicaRequirements],
    ) -> List[TargetCluster]:
        # the memo key carries the cluster name, so the request signature
        # is computed ONCE per call from a name-free template
        sig = self._req_sig(MaxAvailableReplicasRequest.from_requirements(
            "", requirements).to_json())
        return self._fan_out(
            clusters, "MaxAvailableReplicas", sig,
            lambda name: MaxAvailableReplicasRequest.from_requirements(
                name, requirements).to_json(),
            lambda raw: MaxAvailableReplicasResponse.from_json(
                raw).max_replicas)

    def max_available_component_sets(
        self, clusters: List[Cluster], components
    ) -> List[TargetCluster]:
        """MaxAvailableComponentSets fan-out (estimation.go:66-103 client
        side): unreachable / unregistered estimators answer UNAUTHENTIC."""
        sig = self._req_sig(MaxAvailableComponentSetsRequest.from_components(
            "", components).to_json())
        return self._fan_out(
            clusters, "MaxAvailableComponentSets", sig,
            lambda name: MaxAvailableComponentSetsRequest.from_components(
                name, components).to_json(),
            lambda raw: MaxAvailableComponentSetsResponse.from_json(
                raw).max_sets)

    # -- UnschedulableReplicaEstimator --------------------------------------
    def unschedulable_replicas(
        self, cluster: str, kind: str, namespace: str, name: str
    ) -> int:
        transport = self.transports.get(cluster)
        if transport is None:
            return UNAUTHENTIC_REPLICA
        req = UnschedulableReplicasRequest(
            cluster=cluster, resource_kind=kind, namespace=namespace, name=name
        )
        try:
            with _rpc_span(cluster, "GetUnschedulableReplicas"):
                return self._request(
                    cluster, transport, "GetUnschedulableReplicas",
                    req.to_json(),
                    lambda raw: UnschedulableReplicasResponse.from_json(
                        raw).unschedulable_replicas)
        except EstimatorError:
            # typed + counted in _request; UNAUTHENTIC keeps callers total
            return UNAUTHENTIC_REPLICA


class SnapshotEstimator:
    """Capacity-tensor shipping: refresh per-cluster node-free tables and
    answer MaxAvailableReplicas locally (no per-call RPC)."""

    def __init__(self, client: AccurateEstimatorClient,
                 refresh_interval_s: float = 5.0,
                 max_age_s: Optional[float] = None) -> None:
        self.client = client
        self.refresh_interval_s = refresh_interval_s
        # a snapshot older than this is stale: fall back to UNAUTHENTIC so a
        # dead/deregistered estimator cannot keep advertising capacity
        self.max_age_s = (max_age_s if max_age_s is not None
                          else 6 * refresh_interval_s)
        self._snapshots: Dict[str, CapacitySnapshotResponse] = {}
        self._fetched_at: Dict[str, float] = {}
        self._lock = threading.Lock()

    def refresh(self, cluster: str, force: bool = False) -> None:
        transport = self.client.transports.get(cluster)
        if transport is None:
            return
        with self._lock:
            last = self._fetched_at.get(cluster, 0.0)
            if not force and time.time() - last < self.refresh_interval_s:
                return
        try:
            with _rpc_span(cluster, "CapacitySnapshot"):
                snap = self.client._request(  # noqa: SLF001 — same tier
                    cluster, transport, "CapacitySnapshot", {},
                    CapacitySnapshotResponse.from_json)
        except EstimatorError:
            # typed + counted in _request; the stale-age gate answers
            # UNAUTHENTIC for this cluster until a refresh succeeds
            return
        with self._lock:
            self._snapshots[cluster] = snap
            self._fetched_at[cluster] = time.time()

    def _fresh_snapshot(self, cluster_name: str
                        ) -> Optional[CapacitySnapshotResponse]:
        """The current snapshot, or None when it is absent/stale or the
        estimator endpoint is gone (callers answer UNAUTHENTIC)."""
        self.refresh(cluster_name)
        with self._lock:
            snap = self._snapshots.get(cluster_name)
            age = time.time() - self._fetched_at.get(cluster_name, 0.0)
        if cluster_name not in self.client.transports:
            return None
        if snap is None or age > self.max_age_s:
            return None
        return snap

    def max_available_replicas(
        self,
        clusters: List[Cluster],
        requirements: Optional[ReplicaRequirements],
    ) -> List[TargetCluster]:
        out: List[TargetCluster] = []
        for cluster in clusters:
            snap = self._fresh_snapshot(cluster.name)
            if snap is None:
                out.append(TargetCluster(cluster.name, UNAUTHENTIC_REPLICA))
                continue
            total = 0
            for i, f in enumerate(snap.node_free):
                labels = (snap.node_labels[i] if i < len(snap.node_labels)
                          else {})
                total += replicas_on_node(f, labels, requirements)
            out.append(TargetCluster(cluster.name, total))
        return out

    def max_available_component_sets(
        self, clusters: List[Cluster], components
    ) -> List[TargetCluster]:
        """Component-set capacity from the shipped free table (the same
        bound as AccurateEstimatorServer, via the shared
        wire.max_sets_from_free_table)."""
        out: List[TargetCluster] = []
        for cluster in clusters:
            snap = self._fresh_snapshot(cluster.name)
            if snap is None:
                out.append(TargetCluster(cluster.name, UNAUTHENTIC_REPLICA))
                continue
            out.append(TargetCluster(
                cluster.name,
                max_sets_from_free_table(snap.node_free, components)))
        return out
