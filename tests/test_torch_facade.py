"""Facade-plane parity: the port's facade/ (FacadeService, FacadeClient,
the what-if plane, the registry) and the facade messages of
estimator/wire.py against the JAX package's, tolerance 0.

The cases of tests/test_facade.py that need no unported plane, on both
packages: wire drift (every message round-trips and its frame equals the
JAX package's), the method registry, the oversize frame, the stalled
peer and the unknown method (typed through FacadeClient, over a real
localhost socket), coalescing with its state_payload counts, never
writing the store, select with diagnosis, the three what-if queries, a
what-if soak leaving placements bit-identical to a run without the
queries, and the breaker -- driven by a transport that raises, in place
of the chaos seam.  The JAX tests build their plane with
loadgen.ServeSlice over the steady scenario; both sides here do the same,
each with its own package's ServeSlice (`Slice`: a store, a runtime, a
Scheduler and the six 64-CPU clusters of loadgen.driver.build_cluster;
`build_binding` is that recipe in each package's models).  The planes
run backends
"serial", "native" and "device" (the port's with device="cpu", the JAX
package's on its CPU backend).  Also here: what-if on the resident plane
(ResidentState.fork_clusters) answers as the store path does.

Left for later, with the planes they need: the chaos cases (the chaos
plane) and the /debug/facade and /whatif endpoints (the debug server).
The CLI's `estimate` is held against a port FacadeService in
tests/test_torch_cli.py.

Every FacadeService and client pool made here is closed; no JAX
process-wide plane (the decision recorder, the events ledger, the
facade registry) is left armed.
"""

import dataclasses
import importlib
import socket
import struct
import threading

import pytest

import torch_scenarios as S
from torch_fixtures import collect_jax_planes  # noqa: F401 — autouse

BACKENDS = ["serial", "native", "device"]


def facade_pkg(name):
    M = S.models_of(name)
    for mod in ("estimator.wire", "estimator.client", "facade",
                "facade.whatif", "facade.messages", "store.store",
                "store.worker", "scheduler", "loadgen"):
        setattr(M, mod.replace(".", "_"), importlib.import_module(
            f"{name}.{mod}"))
    M.name = name
    return M


FJ, FP = facade_pkg("karmada_tpu"), facade_pkg("karmada_tpu_torch")


@pytest.fixture(autouse=True)
def _disarm():
    memo = importlib.import_module("karmada_tpu.ops.tensors")
    memo._FLEET_CAP_MEMO.clear()
    yield
    memo._FLEET_CAP_MEMO.clear()
    FJ.facade.set_active(None)
    FP.facade.set_active(None)


# -- one recipe for both packages (loadgen.driver's builders) -----------------

def build_cluster(M, name, cpu_milli=64_000, memory_gi=256, pods=1000,
                  region=""):
    Q = M.Quantity
    return M.Cluster(
        metadata=M.ObjectMeta(name=name),
        spec=M.ClusterSpec(region=region or None),
        status=M.ClusterStatus(
            api_enablements=[M.APIEnablement("apps/v1", ["Deployment"])],
            resource_summary=M.ResourceSummary(allocatable={
                "cpu": Q.parse(f"{cpu_milli}m"),
                "memory": Q.parse(f"{memory_gi}Gi"),
                "pods": Q.parse(str(pods))})))


def build_binding(M, name, replicas=1, divided=False, cpu=None,
                  namespace="loadgen"):
    rs = (M.ReplicaSchedulingStrategy(
        replica_scheduling_type=M.REPLICA_SCHEDULING_DIVIDED,
        replica_division_preference=M.REPLICA_DIVISION_AGGREGATED)
        if divided else M.ReplicaSchedulingStrategy(
            replica_scheduling_type=M.REPLICA_SCHEDULING_DUPLICATED))
    rb = M.ResourceBinding()
    rb.metadata.namespace = namespace
    rb.metadata.name = name
    rb.spec = M.ResourceBindingSpec(
        resource=M.ObjectReference(api_version="apps/v1", kind="Deployment",
                                   namespace=namespace, name=name,
                                   uid=f"uid-{name}"),
        replicas=replicas,
        replica_requirements=(M.ReplicaRequirements(resource_request={
            "cpu": M.Quantity.parse(cpu)}) if cpu else None),
        placement=M.Placement(replica_scheduling=rs))
    return rb


def Slice(M, backend, n=6, **kw):
    """Each package's loadgen.ServeSlice over the steady scenario (as the
    JAX tests build it), with `n` clusters lg-m0.. of 64 CPU each; the
    port's device backend runs with device="cpu"."""
    L = M.loadgen
    scenario = L.get_scenario("steady")
    if n != scenario.n_clusters:
        scenario = dataclasses.replace(scenario, n_clusters=n)
    if M is FP and backend == "device":
        kw["device"] = "cpu"
    clock = L.VirtualClock()
    plane = L.ServeSlice(scenario, clock, L.ServiceModel(),
                         backend=backend, **kw)
    plane.clock = clock  # the queue's clock: a test steps it
    return plane


def service(M, plane, **kw):
    kw.setdefault("batch_window", 8)
    kw.setdefault("batch_deadline_s", 0.05)
    return M.facade.FacadeService(plane.scheduler, plane.store, **kw)


def assign_req(M, name="caller", replicas=2, cpu="500m"):
    return M.estimator_wire.AssignReplicasRequest(
        namespace="facade-test", name=name, replicas=replicas,
        resource_request={"cpu": cpu}, divided=True)


def both(fn, *args):
    """fn on the JAX package, then on the port: (jax, port)."""
    return fn(FJ, *args), fn(FP, *args)


# -- wire drift ----------------------------------------------------------------

SEEDED = {
    "SelectClustersRequest": dict(
        namespace="ns7", name="web", resource_request={"cpu": "750m"},
        cluster_names=["m1", "m2"]),
    "SelectClustersResponse": dict(
        clusters=["m1"], excluded={"m2": "insufficient cpu"}),
    "AssignReplicasRequest": dict(
        namespace="ns7", name="api", replicas=13,
        resource_request={"cpu": "250m", "memory": "1Gi"},
        divided=True, cluster_names=["m3"]),
    "AssignReplicasResponse": dict(
        assignments=[{"cluster": "m3", "replicas": 13}],
        outcome="scheduled", message="ok", trace_id="abc123",
        batch_id=7, batch_size=3),
    "WhatIfRequest": dict(
        query="headroom", replicas=64, resource_request={"cpu": "2000m"},
        divided=False, cluster="m1", limit=17),
    "WhatIfResponse": dict(
        query="cluster-loss", source="resident",
        result={"worst": "m1", "ranking": []}),
}


def classes(M):
    msgs = M.facade_messages
    return {c.__name__: c for c in (*msgs.FACADE_METHODS.values(),
                                    *msgs.FACADE_RESPONSES.values())}


@pytest.mark.parametrize("name", sorted(SEEDED))
def test_wire_drift_round_trip(name):
    """Each message round-trips through JSON, its defaults survive an
    empty frame, and its frame equals the JAX package's key for key."""
    import json

    frames = []
    for M in (FJ, FP):
        cls = classes(M)[name]
        msg = cls(**SEEDED[name])
        payload = msg.to_json()
        assert cls.from_json(json.loads(json.dumps(payload))) == msg
        assert cls.from_json({}) == cls()
        frames.append((payload, cls().to_json()))
    assert frames[0] == frames[1]


def test_method_registry_covers_dispatch():
    regs = [(sorted(M.facade_messages.FACADE_METHODS),
             sorted(M.facade_messages.FACADE_RESPONSES)) for M in (FJ, FP)]
    assert regs[0] == regs[1] == (["AssignReplicas", "SelectClusters",
                                   "WhatIf"],) * 2


# -- wire hardening ------------------------------------------------------------

def raw_server(behave):
    """A one-connection TCP server running `behave(conn)` on a thread."""
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)

    def run():
        conn, _ = srv.accept()
        try:
            behave(conn)
        finally:
            conn.close()
            srv.close()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return srv.getsockname(), t


def test_oversize_frame_is_typed_malformed():
    """A length prefix above MAX_FRAME_BYTES surfaces as
    EstimatorMalformed and drops the connection."""
    wire = FP.estimator_wire

    def behave(conn):
        conn.recv(1 << 16)
        conn.sendall(struct.pack(">I", wire.MAX_FRAME_BYTES + 1))

    (host, port), t = raw_server(behave)
    transport = wire.TcpTransport(host, port, timeout=5.0)
    client = FP.facade.FacadeClient(transport, retry_attempts=1,
                                    sleep=lambda s: None)
    with pytest.raises(FP.estimator_client.EstimatorMalformed):
        client.assign_replicas(assign_req(FP))
    assert transport._sock is None  # noqa: SLF001 — connection dropped
    assert client.errors == {"malformed": 1}
    assert wire.MAX_FRAME_BYTES == FJ.estimator_wire.MAX_FRAME_BYTES
    t.join(5)


def test_stalled_peer_is_typed_timeout():
    stall = threading.Event()

    def behave(conn):
        conn.recv(1 << 16)
        stall.wait(5.0)

    (host, port), t = raw_server(behave)
    client = FP.facade.FacadeClient(
        FP.estimator_wire.TcpTransport(host, port, timeout=0.2),
        retry_attempts=1, sleep=lambda s: None)
    try:
        with pytest.raises(FP.estimator_client.EstimatorTimeout):
            client.assign_replicas(assign_req(FP))
    finally:
        stall.set()
        client.close()
        t.join(5)
    assert client.errors == {"timeout": 1}


def test_unknown_method_is_an_error_frame():
    """An unknown verb comes back as an error frame on a connection that
    still serves; the SelectClusters body after it equals the JAX
    package's."""
    bodies = []
    for M in (FJ, FP):
        svc = service(M, Slice(M, "serial"))
        try:
            host, port = svc.serve()
            transport = M.estimator_wire.TcpTransport(host, port,
                                                      timeout=5.0)
            with pytest.raises(RuntimeError, match="unknown facade method"):
                transport.call("Bogus", {})
            bodies.append(transport.call(
                "SelectClusters",
                M.estimator_wire.SelectClustersRequest().to_json()))
            transport.close()
        finally:
            svc.close()
    assert bodies[0] == bodies[1] and bodies[1]["clusters"]


# -- coalescing ----------------------------------------------------------------

def coalesce(M, backend):
    svc = service(M, Slice(M, backend), batch_window=8,
                  batch_deadline_s=0.25)
    try:
        results = [None] * 6
        barrier = threading.Barrier(6)

        def call(i):
            barrier.wait(timeout=5)
            results[i] = svc.assign(assign_req(M, name=f"caller-{i}"))

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        state = svc.state_payload()
    finally:
        svc.close()
    assert all(r is not None and r.outcome == "scheduled" for r in results)
    assert all(sum(a["replicas"] for a in r.assignments) == 2
               for r in results)
    assert len({r.batch_id for r in results}) == 1
    assert all(r.batch_size == 6 for r in results)
    # the callers' order in the batch is the threads' arrival order
    return (sorted(str(sorted((a["cluster"], a["replicas"])
                              for a in r.assignments)) for r in results),
            state)


@pytest.mark.parametrize("backend", BACKENDS)
def test_concurrent_callers_coalesce_into_one_dispatch(backend):
    (aj, sj), (ap, sp) = both(coalesce, backend)
    assert ap == aj
    assert sp == sj
    assert (sp["calls"], sp["batches"], sp["coalesce_ratio"]) == (6, 1, 6.0)


def never_writes(M, backend):
    plane = Slice(M, backend)
    svc = service(M, plane)
    try:
        before = plane.store.counts_by_kind()
        rev = (plane.store.revision if M is FP else None)
        out = [svc.assign(assign_req(M)).to_json(),
               svc.select_clusters(M.estimator_wire.SelectClustersRequest(
                   resource_request={"cpu": "100m"})).to_json(),
               svc.whatif(M.facade.WhatIfRequest(
                   query="placement", replicas=4,
                   resource_request={"cpu": "500m"})).to_json()]
        assert plane.store.counts_by_kind() == before
        if M is FP:
            assert plane.store.revision == rev
    finally:
        svc.close()
    return out


@pytest.mark.parametrize("backend", BACKENDS)
def test_facade_never_writes_the_store(backend):
    j, p = both(never_writes, backend)
    assert p == j


def select(M):
    svc = service(M, Slice(M, "serial"))
    try:
        resp = svc.select_clusters(M.estimator_wire.SelectClustersRequest(
            resource_request={"cpu": "500m"},
            cluster_names=["lg-m0", "lg-m1"]))
        fit = svc.select_clusters(M.estimator_wire.SelectClustersRequest(
            resource_request={"cpu": "500m"}))
    finally:
        svc.close()
    assert resp.clusters == ["lg-m0", "lg-m1"]
    assert set(resp.excluded) == {f"lg-m{i}" for i in range(2, 6)}
    assert all("affinity" in why for why in resp.excluded.values())
    assert len(fit.clusters) == 6 and fit.excluded == {}
    return resp.to_json(), fit.to_json()


def pinned_req(M, replicas=4):
    return M.estimator_wire.AssignReplicasRequest(
        namespace="facade-test", name="pinned", replicas=replicas,
        resource_request={"cpu": "500m"}, divided=True,
        cluster_names=["lg-m0", "lg-m1"])


def cut_cpu(c):
    c.status.resource_summary.allocatable["cpu"] = \
        c.status.resource_summary.allocatable["cpu"].parse("1")


def rereads(M, backend):
    """One service's answers as the fleet moves between its calls: lg-m0
    held by a finalizer and marked for deletion in place, then lg-m1's
    CPU cut to one core."""
    plane = Slice(M, backend)
    svc = service(M, plane)
    views = []
    try:
        def ask():
            out.append(svc.assign(pinned_req(M)).to_json())
            if M is FP:
                views.append(svc._view)
        out = []
        ask()
        ask()
        plane.store.mutate("Cluster", "", "lg-m0",
                           lambda c: c.metadata.finalizers.append("hold"))
        plane.store.delete("Cluster", "", "lg-m0")
        ask()
        plane.store.mutate("Cluster", "", "lg-m1", cut_cpu)
        ask()
        out.append(svc.select_clusters(M.estimator_wire.SelectClustersRequest(
            resource_request={"cpu": "500m"})).to_json())
    finally:
        svc.close()
    return out, views


@pytest.mark.parametrize("backend", BACKENDS)
def test_facade_rereads_the_clusters_when_one_moves(backend):
    """The port's coalesced solves read a copy of the Clusters kept while
    no Cluster's resourceVersion moves: the same answers as the JAX
    service, which copies them every batch, through an in-place deletion
    mark and an update; a copy in use never changes."""
    (j, _), (p, views) = both(rereads, backend)
    assert p == j
    assert {a["cluster"] for a in p[0]["assignments"]} <= {"lg-m0", "lg-m1"}
    assert "lg-m0" not in {a["cluster"] for a in p[2]["assignments"]}
    assert p[3]["outcome"] != p[2]["outcome"] or \
        p[3]["assignments"] != p[2]["assignments"]
    assert views[0] is views[1] and len({id(v) for v in views}) == 3
    first = views[0].clusters[0]
    assert first.name == "lg-m0" and first.metadata.deletion_timestamp is None


def view_batches(M):
    """Three batches of loadgen bindings, each solved detached: through one
    core.ClusterView of the fleet in the port, fresh in both packages."""
    plane = Slice(M, "device", n=6)
    clusters = plane.store.list("Cluster")
    batches = [[build_binding(M, f"b{k}-{i}", replicas=1 + (i * 7) % 40,
                              divided=bool((i + k) % 3), cpu=f"{250 * (1 + i % 5)}m")
                for i in range(12)] for k in range(3)]

    def outcome(results):
        return [[(t.name, t.replicas) for t in r] if isinstance(r, list)
                else type(r).__name__
                for r in (results.get(i) for i in range(12))]
    fresh = [outcome(plane.scheduler.solve_batch(b, clusters,
                                                 detached=True)[0])
             for b in batches]
    if M is FJ:
        return fresh, fresh
    view = M.scheduler.core.ClusterView(clusters)
    kept = [outcome(plane.scheduler.solve_batch(b, clusters, detached=True,
                                                view=view)[0])
            for b in batches]
    with pytest.raises(ValueError, match="another cluster list"):
        plane.scheduler.solve_batch(batches[0], list(clusters),
                                    detached=True, view=view)
    with pytest.raises(ValueError, match="detached solves only"):
        plane.scheduler.solve_batch(batches[0], clusters, view=view)
    return fresh, kept


def test_cluster_view_answers_as_fresh_solves():
    """Detached solves through one ClusterView equal fresh detached solves
    of the same batches, and the JAX package's."""
    (j, _), (p, kept) = both(view_batches)
    assert p == j and kept == p
    assert any(isinstance(r, list) for b in p for r in b)


def test_select_clusters_excludes_with_diagnosis():
    j, p = both(select)
    assert p == j


# -- the what-if plane ---------------------------------------------------------

def placement(M, backend):
    plane = Slice(M, backend)
    resp = M.facade_whatif.run_query(
        plane.scheduler, plane.store,
        M.facade.WhatIfRequest(query="placement", replicas=10,
                               resource_request={"cpu": "1000m"}))
    assert resp.source == "store"
    assert resp.result["outcome"] == "scheduled"
    assert sum(a["replicas"] for a in resp.result["assignments"]) == 10
    with pytest.raises(ValueError, match="unknown what-if query"):
        M.facade_whatif.run_query(plane.scheduler, plane.store,
                                  M.facade.WhatIfRequest(query="bogus"))
    return resp.to_json()


@pytest.mark.parametrize("backend", BACKENDS)
def test_whatif_placement_and_unknown_query(backend):
    j, p = both(placement, backend)
    assert p == j


def headroom(M, backend):
    plane = Slice(M, backend)
    resp = M.facade_whatif.run_query(
        plane.scheduler, plane.store,
        M.facade.WhatIfRequest(query="headroom", replicas=1,
                               resource_request={"cpu": "1000m"}))
    res = resp.result
    assert res["max_replicas"] == 384
    assert res["probes"] <= 2 * M.facade_whatif.HEADROOM_MAX_PROBES
    assert sum(a["replicas"] for a in res["assignments"]) == 384
    return resp.to_json()


@pytest.mark.parametrize("backend", BACKENDS)
def test_whatif_headroom_finds_exact_capacity(backend):
    j, p = both(headroom, backend)
    assert p == j


def cluster_loss(M, backend):
    plane = Slice(M, backend)
    store = plane.store
    store.create(build_cluster(M, "big", cpu_milli=512_000))
    hostage = build_binding(M, "hostage", replicas=500, divided=True,
                            cpu="1000m")
    hostage.spec.clusters = [M.TargetCluster(name="big", replicas=500)]
    store.create(hostage)
    movable = build_binding(M, "movable", replicas=4, divided=True,
                            cpu="1000m")
    movable.spec.clusters = [M.TargetCluster(name="lg-m0", replicas=4)]
    store.create(movable)
    resp = M.facade_whatif.run_query(
        plane.scheduler, plane.store,
        M.facade.WhatIfRequest(query="cluster-loss"))
    res = resp.result
    assert resp.source == "store" and res["worst"] == "big"
    by_name = {r["cluster"]: r for r in res["ranking"]}
    assert by_name["big"]["stranded_bindings"] == 1
    assert by_name["big"]["stranded_replicas"] == 500
    assert by_name["lg-m0"]["stranded_bindings"] == 0
    one = M.facade_whatif.run_query(
        plane.scheduler, plane.store,
        M.facade.WhatIfRequest(query="cluster-loss", cluster="lg-m0"))
    return resp.to_json(), one.to_json()


@pytest.mark.parametrize("backend", BACKENDS)
def test_whatif_cluster_loss_ranks_the_stranding_loss(backend):
    j, p = both(cluster_loss, backend)
    assert p == j


def soak(M, backend, queries: bool):
    """Bindings arrive in waves and the Scheduler's cycles place them;
    with `queries`, what-if queries and assigns run between the waves.
    Returns the placements and the answers."""
    plane = Slice(M, backend)
    svc = service(M, plane)
    answers = []
    try:
        for wave in range(4):
            for i in range(6):
                plane.store.create(build_binding(
                    M, f"w{wave}-{i}", replicas=1 + (wave * 6 + i) % 5,
                    divided=i % 2 == 0, cpu=f"{250 * (1 + i % 3)}m"))
            # the wave waits out the slice's batch deadline (queue clock)
            plane.clock.advance(plane.scheduler.batch_deadline_s + 1e-3)
            plane.runtime.pump()
            if queries:
                for q in ("placement", "headroom", "cluster-loss"):
                    answers.append(svc.whatif(M.facade.WhatIfRequest(
                        query=q, replicas=3, limit=8,
                        resource_request={"cpu": "2000m"})).to_json())
                answers.append(svc.assign(assign_req(
                    M, name=f"q{wave}")).to_json())
    finally:
        svc.close()
    placed = {(rb.metadata.namespace, rb.metadata.name): tuple(sorted(
        (t.name, t.replicas) for t in rb.spec.clusters))
        for rb in plane.store.list("ResourceBinding")}
    assert len(placed) == 24 and all(placed.values())
    return placed, answers


@pytest.mark.parametrize("backend", BACKENDS)
def test_whatif_soak_leaves_placements_bit_identical(backend):
    """The isolation proof: placements with the queries riding the run
    equal a control run's, and both packages give the same placements
    and answers."""
    (pj, aj), (pp, ap) = both(soak, backend, True)
    assert pp == pj and ap == aj
    assert soak(FP, backend, False)[0] == pp
    assert [a.get("query") for a in ap[:3]] == ["placement", "headroom",
                                                "cluster-loss"]


def test_whatif_on_the_resident_plane_answers_as_the_store():
    """A resident plane's fork_clusters (a deep copy of its cluster view)
    feeds the what-if solves: the same answers as the store path, with
    source "resident", and the live plane's clusters untouched."""
    out = []
    for resident in (True, False):
        plane = Slice(FP, "device", resident=resident)
        plane.store.create(build_binding(FP, "seed", replicas=3,
                                         divided=True, cpu="500m"))
        plane.clock.advance(plane.scheduler.batch_deadline_s + 1e-3)
        plane.runtime.pump()
        state = plane.scheduler._resident  # noqa: SLF001
        if resident:
            assert len(state.fork_clusters()) == 6
            assert state.fork_clusters()[0] is not state.clusters[0]
        res = [FP.facade_whatif.run_query(
            plane.scheduler, plane.store, FP.facade.WhatIfRequest(
                query=q, replicas=5, resource_request={"cpu": "1000m"}))
            for q in ("placement", "headroom", "cluster-loss")]
        out.append(([r.source for r in res], [r.result for r in res]))
    assert out[0][0] == ["resident"] * 3 and out[1][0] == ["store"] * 3
    assert out[0][1] == out[1][1]


# -- the breaker, driven by a transport that raises ---------------------------

class Raising:
    """Raise `faults` (one a call) before passing calls to `inner`:
    "error" a refused connection, "timeout", "garbage" an unusable
    reply (the JAX chaos seam's modes at the transport)."""

    def __init__(self, inner, faults):
        self.inner, self.faults = inner, list(faults)

    def call(self, method, body):
        if self.faults:
            f = self.faults.pop(0)
            if f == "error":
                raise ConnectionError("connection refused")
            if f == "timeout":
                raise TimeoutError("call timed out")
            return {"assignments": 0, "clusters": 0, "excluded": 0,
                    "result": 0}
        return self.inner.call(method, body)

    def close(self):
        pass


def breaker_walk(M):
    svc = service(M, Slice(M, "serial"))
    ec = M.estimator_client
    log = []
    try:
        for fault, err in (("error", ec.EstimatorUnreachable),
                           ("timeout", ec.EstimatorTimeout),
                           ("garbage", ec.EstimatorMalformed)):
            client = M.facade.FacadeClient(
                Raising(M.estimator_wire.LocalTransport(svc.dispatch),
                        [fault]), retry_attempts=1, sleep=lambda s: None)
            with pytest.raises(err):
                client.assign_replicas(assign_req(M))
            log.append(client.assign_replicas(assign_req(M)).outcome)
        now = [0.0]
        breaker = ec.CircuitBreaker(failure_threshold=2,
                                    reset_timeout_s=10.0,
                                    clock=lambda: now[0])
        slept = []
        client = M.facade.FacadeClient(
            Raising(M.estimator_wire.LocalTransport(svc.dispatch),
                    ["error"] * 4), breaker=breaker, retry_attempts=2,
            sleep=slept.append)
        for _ in range(2):
            with pytest.raises(ec.EstimatorUnreachable):
                client.assign_replicas(assign_req(M))
        with pytest.raises(ec.EstimatorCircuitOpen):
            client.assign_replicas(assign_req(M))
        now[0] = 11.0  # the half-open probe flies, the faults are spent
        log.append(client.assign_replicas(assign_req(M)).outcome)
        log.append(client.assign_replicas(assign_req(M)).outcome)
        log.append([(t["from"], t["to"]) for t in breaker.transition_log()])
        log.append(slept)
        if M is FP:
            assert client.errors == {"unreachable": 4, "circuit_open": 1}
    finally:
        svc.close()
    return log


def test_breaker_opens_and_half_open_recovers_at_the_facade():
    j, p = both(breaker_walk)
    assert p == j
    assert p[:5] == ["scheduled"] * 5
    assert p[5] == [("closed", "open"), ("open", "half-open"),
                    ("half-open", "closed")]


def test_registry_arms_and_disarms():
    """The process-wide registry: disarmed until set_active, then the
    armed service's counters and its what-if answers."""
    fac = FP.facade
    assert fac.state_payload() == {"enabled": False}
    assert fac.whatif_payload({"query": "placement"})["enabled"] is False
    plane = Slice(FP, "serial")
    svc = service(FP, plane)
    try:
        fac.set_active(svc)
        svc.assign(assign_req(FP))
        state = fac.state_payload()
        assert state["enabled"] and state["calls"] == 1
        got = fac.whatif_payload({"query": "placement", "replicas": "3",
                                  "cpu": "500m"})
        assert got["query"] == "placement"
        assert got["result"]["outcome"] == "scheduled"
        assert "unknown what-if query" in fac.whatif_payload(
            {"query": "bogus"})["error"]
    finally:
        fac.set_active(None)
        svc.close()
