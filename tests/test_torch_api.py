"""API-surface parity: the port's auxiliary controllers, admission
plugins, Pull members and typed codec (karmada_tpu_torch/controllers/
{extras,certificates}.py, agent.py, webhook/builtin.py,
models/{codec,conversion}.py) against the JAX package's, tolerance 0.

Scenarios of tests/test_extras.py (all four), the quota and FederatedHPA
cases of tests/test_admission.py, tests/test_agent_pull.py (all) and the
codec and conversion cases of tests/test_api_versions.py (the HTTP cases
need the query plane, which the port has not taken) run on both
packages: the planes (the JAX one on exactly the ported controllers)
must log the same observations and end with equal normalized snapshots
(torch_loop), and each holds the JAX test's own assertions.  The loop
scenarios run on the port's "serial", "native" and "device" (device="cpu")
backends; the codec cases compare the two packages' outputs.

Also here: the repair of the port Scheduler's schedule-result patch
under an admission denial (an unschedulable outcome, as the JAX
Scheduler treats it, never a contained fault).
"""

import dataclasses

import pytest

from torch_fixtures import collect_jax_planes  # noqa: F401 — autouse
from torch_loop import (  # noqa: F401 — deterministic_uids is autouse
    CLEARED,
    MJ,
    MP,
    Clock,
    deterministic_uids,
    norm,
    plane,
    run_both,
)

BACKENDS = ["serial", "native", "device"]


def policy(M, name="pp"):
    return M.PropagationPolicy(
        metadata=M.ObjectMeta(name=name, namespace="default"),
        spec=M.PropagationSpec(
            resource_selectors=[M.ResourceSelector(api_version="apps/v1",
                                                   kind="Deployment")],
            placement=M.Placement(
                replica_scheduling=M.ReplicaSchedulingStrategy(
                    replica_scheduling_type=M.REPLICA_SCHEDULING_DIVIDED,
                    replica_division_preference=M.REPLICA_DIVISION_WEIGHTED,
                    weight_preference=M.ClusterPreferences(
                        dynamic_weight=M.DYNAMIC_WEIGHT_AVAILABLE_REPLICAS)))))


def deployment(name="app", replicas=4, cpu="100m", memory="128Mi"):
    return {"apiVersion": "apps/v1", "kind": "Deployment",
            "metadata": {"name": name, "namespace": "default"},
            "spec": {"replicas": replicas, "template": {"spec": {
                "containers": [{"name": "c", "image": "i", "resources": {
                    "requests": {"cpu": cpu, "memory": memory}}}]}}}}


def members(M, backend, names=("m1", "m2"), clock=None, **kw):
    cp = plane(M, backend, clock if clock is not None else Clock(), **kw)
    for n in names:
        cp.add_member(n, cpu_milli=64_000)
    cp.tick()
    return cp


def rb_of(cp, name="app-deployment"):
    return cp.store.get("ResourceBinding", "default", name)


# -- tests/test_extras.py -----------------------------------------------------

def sc_workload_rebalancer_triggers_fresh_reschedule(M, backend, log):
    cp = members(M, backend)
    cp.apply_policy(policy(M))
    cp.apply(deployment())
    cp.tick()
    assert rb_of(cp).spec.reschedule_triggered_at is None
    cp.store.create(M.WorkloadRebalancer(
        metadata=M.ObjectMeta(name="rebalance-now"),
        spec=M.WorkloadRebalancerSpec(workloads=[M.ObjectReferenceSpec(
            api_version="apps/v1", kind="Deployment", namespace="default",
            name="app")])))
    cp.tick()
    wr = cp.store.get("WorkloadRebalancer", "", "rebalance-now")
    assert wr.status.finish_time is not None
    assert wr.status.observed_workloads[0].result == "Successful"
    rb = rb_of(cp)
    assert rb.spec.reschedule_triggered_at is not None
    assert sum(t.replicas for t in rb.spec.clusters) == 4
    return cp


def sc_cluster_taint_policy_adds_and_removes(M, backend, log):
    cp = members(M, backend, ("m1",))
    cp.store.create(M.ClusterTaintPolicy(
        metadata=M.ObjectMeta(name="notready-taint"),
        spec=M.ClusterTaintPolicySpec(
            add_on_conditions=[M.MatchCondition(
                condition_type="Ready", operator="In",
                status_values=["False"])],
            remove_on_conditions=[M.MatchCondition(
                condition_type="Ready", operator="In",
                status_values=["True"])],
            taints=[M.TaintSpec(key="example.io/unhealthy",
                                effect="NoSchedule")])))
    for healthy in (True, False, True):
        cp.member("m1").healthy = healthy
        cp.tick()
        has = any(t.key == "example.io/unhealthy" for t in
                  cp.store.get("Cluster", "", "m1").spec.taints)
        assert has is (not healthy)
        log.append(has)
    return cp


def sc_remedy_sets_cluster_actions(M, backend, log):
    cp = members(M, backend, ("m1",))
    cp.store.create(M.Remedy(
        metadata=M.ObjectMeta(name="traffic-off"),
        spec=M.RemedySpec(
            decision_matches=[M.DecisionMatch(
                cluster_condition_type="Ready",
                cluster_condition_status="False")],
            actions=["TrafficControl"])))
    for healthy, want in ((True, []), (False, ["TrafficControl"]),
                          (True, [])):
        cp.member("m1").healthy = healthy
        cp.tick()
        got = cp.store.get("Cluster", "", "m1").status.remedy_actions
        assert got == want
        log.append(got)
    return cp


def sc_federated_resource_quota_renders_per_cluster(M, backend, log):
    cp = members(M, backend)
    Q = M.Quantity
    cp.store.create(M.FederatedResourceQuota(
        metadata=M.ObjectMeta(name="team-quota", namespace="default"),
        spec=M.FederatedResourceQuotaSpec(
            overall={"cpu": Q.parse("20")},
            static_assignments=[
                M.StaticClusterAssignment("m1", {"cpu": Q.parse("12")}),
                M.StaticClusterAssignment("m2", {"cpu": Q.parse("8")})])))
    cp.tick()
    for m, want in (("m1", "12"), ("m2", "8")):
        rq = cp.member(m).get("ResourceQuota", "default", "team-quota")
        assert rq.manifest["spec"]["hard"]["cpu"] == want
    frq = cp.store.get("FederatedResourceQuota", "default", "team-quota")
    assert {c.cluster_name for c in frq.status.aggregated_status} == {
        "m1", "m2"}
    return cp


EXTRAS = [sc_workload_rebalancer_triggers_fresh_reschedule,
          sc_cluster_taint_policy_adds_and_removes,
          sc_remedy_sets_cluster_actions,
          sc_federated_resource_quota_renders_per_cluster]

#: a taint policy stamps its taints on the wall clock in both packages
EXTRAS_CLEARED = CLEARED | {"time_added"}


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("scenario", EXTRAS, ids=lambda f: f.__name__[3:])
def test_extras_parity(scenario, backend):
    run_both(scenario, backend, cleared=EXTRAS_CLEARED)


# -- tests/test_admission.py (quota and FederatedHPA) -------------------------

def nginx(replicas=6):
    return dict(deployment("nginx", replicas, cpu="500m", memory="1Gi"))


def frq(M, cpu_milli):
    return M.FederatedResourceQuota(
        metadata=M.ObjectMeta(name="quota", namespace="default"),
        spec=M.FederatedResourceQuotaSpec(
            overall={"cpu": M.Quantity.from_milli(cpu_milli)}))


def quota_plane(M, backend, enforce):
    return members(M, backend, feature_gates=(
        {"FederatedQuotaEnforcement": True} if enforce else None))


def sc_frq_validation_rejects_negative(M, backend, log):
    cp = quota_plane(M, backend, False)
    with pytest.raises(M.AdmissionDenied, match="non-negative") as e:
        cp.store.create(frq(M, -100))
    log.append(str(e.value))
    return cp


def sc_quota_gate_disabled_by_default(M, backend, log):
    cp = quota_plane(M, backend, False)
    cp.store.create(frq(M, 1000))
    cp.store.create(policy(M))
    cp.apply(nginx())
    cp.tick()
    assert sum(t.replicas for t in rb_of(cp, "nginx-deployment")
               .spec.clusters) == 6
    return cp


def sc_quota_gate_blocks_scheduling(M, backend, log):
    """The schedule-result patch is denied by the quota gate: the binding
    lands unschedulable (the port Scheduler's repaired path)."""
    cp = quota_plane(M, backend, True)
    cp.store.create(frq(M, 1000))
    cp.store.create(policy(M))
    cp.apply(nginx())
    cp.tick()
    rb = rb_of(cp, "nginx-deployment")
    assert rb.spec.clusters == []
    conds = {c.type: (c.status, c.message) for c in rb.status.conditions}
    assert conds["Scheduled"][0] == "False"
    assert "FederatedResourceQuota" in conds["Scheduled"][1]
    log.append(conds["Scheduled"])
    return cp


def sc_quota_gate_allows_within_budget_and_bumps_used(M, backend, log):
    cp = quota_plane(M, backend, True)
    cp.store.create(frq(M, 5000))
    cp.store.create(policy(M))
    cp.apply(nginx())
    cp.tick()
    assert sum(t.replicas for t in rb_of(cp, "nginx-deployment")
               .spec.clusters) == 6
    used = cp.store.get("FederatedResourceQuota", "default", "quota") \
        .status.overall_used["cpu"].milli
    assert used == 3000
    return cp


def sc_quota_gate_scale_down_releases_budget(M, backend, log):
    cp = quota_plane(M, backend, True)
    cp.store.create(frq(M, 3000))
    cp.store.create(policy(M))
    for replicas, want in ((6, 3000), (2, 1000)):
        cp.apply(nginx(replicas))
        cp.tick()
        used = cp.store.get("FederatedResourceQuota", "default", "quota") \
            .status.overall_used["cpu"].milli
        assert used == want
        log.append(used)
    return cp


def sc_federated_hpa_validation(M, backend, log):
    A = M

    def hpa(**kw):
        spec = A.FederatedHPASpec(
            scale_target_ref=A.CrossVersionObjectReference(
                "apps/v1", "Deployment", "web"),
            min_replicas=1, max_replicas=10,
            metrics=[A.MetricSpec(resource=A.ResourceMetricSource(
                name="cpu", target=A.MetricTarget(
                    type="Utilization", average_utilization=60)))])
        for k, v in kw.items():
            setattr(spec, k, v)
        return A.FederatedHPA(metadata=M.ObjectMeta(name="h", namespace="ns"),
                              spec=spec)

    v = M.builtin.validate_federated_hpa
    cases = [
        (hpa(), None),
        (hpa(max_replicas=0), "maxReplicas"),
        (hpa(min_replicas=12), "minReplicas"),
        (hpa(metrics=[A.MetricSpec(type="Pods", pods=A.PodsMetricSource(
            metric="rps", target=A.MetricTarget(average_value=100)))]),
         "not supported"),
        (hpa(metrics=[A.MetricSpec(type="External",
                                   external=A.ExternalMetricSource(
             metric="q", target=A.MetricTarget(type="AverageValue")))]),
         "matching value field"),
        (hpa(metrics=[A.MetricSpec(resource=None)]), "one of"),
    ]
    for obj, want in cases:
        got = v("CREATE", obj, None)
        assert (got is None) if want is None else (want in got)
        log.append(got)
    cp = plane(M, backend, Clock())
    with pytest.raises(M.AdmissionDenied) as e:
        cp.store.create(hpa(max_replicas=0))
    log.append(str(e.value))
    return cp


ADMISSION = [sc_frq_validation_rejects_negative,
             sc_quota_gate_disabled_by_default,
             sc_quota_gate_blocks_scheduling,
             sc_quota_gate_allows_within_budget_and_bumps_used,
             sc_quota_gate_scale_down_releases_budget,
             sc_federated_hpa_validation]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("scenario", ADMISSION, ids=lambda f: f.__name__[3:])
def test_admission_parity(scenario, backend):
    run_both(scenario, backend)


def sc_denied_schedule_patch(M, backend, log):
    """Any admission gate refusing the scheduler's spec.clusters patch
    (here a validator that admits no placement at all)."""
    cp = members(M, backend)

    def no_placement(op, rb, old):
        if rb.spec.clusters:
            return "placements are frozen"
        return None
    cp.admission.register_validating("ResourceBinding", no_placement)
    cp.store.create(policy(M))
    cp.apply(nginx())
    cp.tick()
    rb = rb_of(cp, "nginx-deployment")
    cond = [c for c in rb.status.conditions if c.type == "Scheduled"]
    log.append((rb.spec.clusters, [(c.status, c.reason, c.message)
                                   for c in cond]))
    return cp


@pytest.mark.parametrize("backend", BACKENDS)
def test_admission_denied_schedule_patch_is_unschedulable(backend):
    """The port Scheduler treats an AdmissionDenied on its schedule-result
    patch as an unschedulable outcome (the JAX Scheduler's
    service.py:1494-1501): Scheduled=False with the denial, no contained
    fault, the same outcome as the JAX package's."""
    cps, logs = run_both(sc_denied_schedule_patch, backend)
    clusters, cond = logs[1][0]
    assert clusters == [] and cond[0][0] == "False"
    assert "placements are frozen" in cond[0][2]
    assert cps[1].scheduler.faults() == {}
    assert not cps[1].runtime.reconcile_errors()["scheduler"]


# -- tests/test_agent_pull.py -------------------------------------------------

def mixed_plane(M, backend, clock, **kw):
    cp = plane(M, backend, clock, **kw)
    cp.add_member("push-1", cpu_milli=64_000)
    cp.add_member("pull-1", cpu_milli=64_000, sync_mode="Pull")
    cp.tick()
    return cp


def pull_policy(M):
    p = policy(M)
    return p


def sc_pull_member_gets_workload_via_agent(M, backend, log):
    cp = mixed_plane(M, backend, Clock())
    cp.store.create(pull_policy(M))
    cp.apply(deployment("nginx", 4, memory="1Gi"))
    cp.tick()
    rb = rb_of(cp, "nginx-deployment")
    assert {t.name for t in rb.spec.clusters} == {"push-1", "pull-1"}
    assert cp.members["pull-1"].get("Deployment", "default",
                                    "nginx") is not None
    assert "pull-1" not in cp.execution.members and "pull-1" in cp.agents
    return cp


def sc_pull_member_status_reflected_by_agent(M, backend, log):
    cp = mixed_plane(M, backend, Clock())
    cp.store.create(pull_policy(M))
    cp.apply(deployment("nginx", 4, memory="1Gi"))
    cp.tick()
    cp.members["pull-1"].tick()
    cp.tick()
    rb = rb_of(cp, "nginx-deployment")
    agg = {a.cluster_name: a.status for a in rb.status.aggregated_status}
    assert agg["pull-1"].get("readyReplicas", 0) > 0
    cluster = cp.store.get("Cluster", "", "pull-1")
    assert cluster.status.resource_summary is not None and cluster.ready
    log.append(agg["pull-1"])
    return cp


def sc_agent_bootstrap_csr_approved_and_credential_issued(M, backend, log):
    cp = mixed_plane(M, backend, Clock())
    csr = cp.store.get("CertificateSigningRequest", "", "bootstrap-pull-1")
    assert csr.status.approved and csr.status.expires_at is not None
    cred = cp.store.get("ClusterCredential", "", "pull-1")
    assert cred.status.expires_at == csr.status.expires_at
    return cp


def sc_csr_with_wrong_identity_denied(M, backend, log):
    cp = mixed_plane(M, backend, Clock())
    bad = M.CertificateSigningRequest(metadata=M.ObjectMeta(name="evil"))
    bad.spec.cluster = "pull-1"
    bad.spec.username = "system:karmada:agent:other"
    cp.store.create(bad)
    cp.tick()
    got = cp.store.get("CertificateSigningRequest", "", "evil")
    assert not got.status.approved and got.status.denied_reason
    return cp


def sc_certificate_rotation_renews_before_expiry(M, backend, log):
    clock = Clock(1_000_000.0)
    cp = mixed_plane(M, backend, clock)
    cred = cp.store.get("ClusterCredential", "", "pull-1")
    ttl = cred.status.expires_at - cred.status.issued_at
    assert cred.status.rotations == 0
    clock.advance(ttl * 0.5)
    cp.tick()
    assert cp.store.get("ClusterCredential", "", "pull-1") \
        .status.rotations == 0
    clock.advance(ttl * 0.35)
    cp.tick()
    rotated = cp.store.get("ClusterCredential", "", "pull-1")
    assert rotated.status.rotations >= 1
    assert rotated.status.expires_at > cred.status.expires_at
    log.append(rotated.status.rotations)
    return cp


def sc_agent_owns_its_rotation_scope(M, backend, log):
    clock = Clock(1_000_000.0)
    cp = mixed_plane(M, backend, clock)
    cp.add_member("pull-2", sync_mode="Pull")
    cp.tick()
    cred1 = cp.store.get("ClusterCredential", "", "pull-1")
    ttl = cred1.status.expires_at - cred1.status.issued_at
    assert cp.agents["pull-1"].cert_rotation.cluster == "pull-1"
    assert cp.agents["pull-2"].cert_rotation.cluster == "pull-2"
    cp.agents["pull-2"].stop()
    clock.advance(ttl * 0.9)
    cp.tick()
    assert cp.store.get("ClusterCredential", "", "pull-1") \
        .status.rotations >= 1
    assert cp.store.get("ClusterCredential", "", "pull-2") \
        .status.rotations == 0
    return cp


def sc_stopped_agent_under_a_clock_jump(M, backend, log):
    """A stopped agent, then the plane's clock 60 s past its last Lease
    renewal: the heartbeats and their monitor read the wall clock in both
    packages, so the jump alone degrades no cluster (the port once renewed
    on the plane's clock and turned pull-1 Ready=Unknown here)."""
    clock = Clock(1_000_000.0)
    cp = mixed_plane(M, backend, clock)
    cp.agents["pull-1"].stop()
    clock.advance(60.0)
    cp.tick()
    log.append({c.name: [(x.type, x.status, x.reason)
                         for x in c.status.conditions]
                for c in cp.store.list("Cluster")})
    assert log[-1]["pull-1"][0][1] == "True"
    return cp


PULL = [sc_pull_member_gets_workload_via_agent,
        sc_pull_member_status_reflected_by_agent,
        sc_agent_bootstrap_csr_approved_and_credential_issued,
        sc_csr_with_wrong_identity_denied,
        sc_certificate_rotation_renews_before_expiry,
        sc_agent_owns_its_rotation_scope,
        sc_stopped_agent_under_a_clock_jump]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("scenario", PULL, ids=lambda f: f.__name__[3:])
def test_pull_parity(scenario, backend):
    run_both(scenario, backend)


def test_unjoin_of_a_pull_member_stops_its_agent():
    def scenario(M, backend, log):
        cp = mixed_plane(M, backend, Clock())
        cp.store.create(pull_policy(M))
        cp.apply(deployment("nginx", 4, memory="1Gi"))
        cp.tick()
        cp.unjoin("pull-1")
        cp.tick()
        log.append((sorted(cp.agents), sorted(
            t.name for t in rb_of(cp, "nginx-deployment").spec.clusters)))
        return cp
    _, logs = run_both(scenario, "serial")
    assert logs[1] == [([], ["push-1"])]


# -- tests/test_api_versions.py (codec and conversion) ------------------------

WORK_V2 = {
    "apiVersion": "work.karmada.io/v1alpha2", "kind": "Work",
    "metadata": {"name": "w1", "namespace": "karmada-es-m1"},
    "spec": {"suspend": True,
             "workload": [{"apiVersion": "v1", "kind": "ConfigMap",
                           "metadata": {"name": "cm"}}]},
}
LEGACY_RB = {
    "apiVersion": "work.karmada.io/v1alpha1", "kind": "ResourceBinding",
    "metadata": {"name": "rb", "namespace": "default"},
    "spec": {"resource": {"apiVersion": "apps/v1", "kind": "Deployment",
                          "name": "app", "replicas": 4,
                          "replicaResourceRequirements": {"cpu": "500m"}},
             "clusters": [{"name": "m1", "replicas": 4}]},
}


def codec_served_versions(M):
    R = M.REGISTRY
    V1 = M.Work.API_VERSION
    out = [R.storage_version("Work"), sorted(R.served_versions("Work")),
           R.served("Work", V1), R.served("Work", M.WORK_V1ALPHA2),
           R.served("Work", "work.karmada.io/v9"),
           R.served("ClusterResourceBinding", M.BINDING_V1ALPHA1)]
    assert out[2:5] == [True, True, False]
    return out


def codec_convert_via_hub(M):
    R = M.REGISTRY
    V1 = M.Work.API_VERSION
    v1 = R.convert(WORK_V2, V1)
    assert v1["spec"]["suspendDispatching"] is True
    assert "suspend" not in v1["spec"] and v1["spec"]["workload"]
    back = R.convert(v1, M.WORK_V1ALPHA2)
    assert back["spec"]["suspend"] is True
    assert R.convert(v1, V1) is v1
    for bad in ((WORK_V2, "work.karmada.io/v9"),
                ({"apiVersion": "work.karmada.io/v9", "kind": "Work"}, V1)):
        with pytest.raises(KeyError):
            R.convert(*bad)
    crb = R.convert({"apiVersion": "work.karmada.io/v1alpha2",
                     "kind": "ClusterResourceBinding",
                     "metadata": {"name": "crb"},
                     "spec": {"replicas": 2, "resource": {
                         "kind": "ClusterRole", "name": "r"}}},
                    M.BINDING_V1ALPHA1)
    assert crb["spec"]["resource"]["replicas"] == 2
    return [v1, back, crb]


def codec_decode_encode(M):
    w = M.from_manifest_typed(WORK_V2)
    assert isinstance(w, M.Work) and w.spec.suspend_dispatching is True
    v1 = M.to_manifest_typed(w)
    v2 = M.to_manifest_typed(w, version=M.WORK_V1ALPHA2)
    assert v2["spec"]["suspend"] is True
    assert "suspendDispatching" not in v2["spec"]
    assert M.from_manifest_typed(v2) == w
    return [norm(w), v1, v2]


def codec_binding_structural_moves(M):
    rb = M.from_manifest_typed(LEGACY_RB)
    assert isinstance(rb, M.ResourceBinding) and rb.spec.replicas == 4
    assert str(rb.spec.replica_requirements.resource_request["cpu"]) \
        == "500m"
    rb2 = dataclasses.replace(
        rb, spec=dataclasses.replace(rb.spec, placement=M.Placement()))
    down = M.to_manifest_typed(rb2, version=M.BINDING_V1ALPHA1)
    assert down["spec"]["resource"]["replicas"] == 4
    assert "placement" not in down["spec"]
    assert M.from_manifest_typed(down).spec.replicas == 4
    return [norm(rb), down]


def codec_every_kind_round_trips(M):
    """Each registered kind: its default object encodes and decodes back
    to itself (the registry is the JAX package's)."""
    out = []
    for kind, cls in sorted(M.model_registry().items()):
        obj = cls()
        obj.metadata.name = "x"
        manifest = M.to_manifest_typed(obj)
        assert M.from_manifest_typed(manifest) == obj, kind
        out.append((kind, manifest))
    return out


def codec_apply_rejects_unserved_version(M):
    cp = plane(M, "serial")
    with pytest.raises(ValueError, match="not served") as e:
        cp.apply(dict(WORK_V2, apiVersion="work.karmada.io/v9"))
    return [str(e.value)]


CODEC = [codec_served_versions, codec_convert_via_hub, codec_decode_encode,
         codec_binding_structural_moves, codec_every_kind_round_trips,
         codec_apply_rejects_unserved_version]


@pytest.mark.parametrize("case", CODEC, ids=lambda f: f.__name__[6:])
def test_codec_parity(case):
    assert case(MJ) == case(MP)


def test_randomized_work_manifests_round_trip_both_versions():
    """Decode -> encode at either served version -> decode is the
    identity for arbitrary Work content, and both packages encode alike
    (hypothesis-driven, as tests/test_api_versions.py)."""
    pytest.importorskip("hypothesis")
    from hypothesis import HealthCheck, given, settings
    from hypothesis import strategies as st

    json_scalars = st.one_of(st.booleans(), st.integers(-2**31, 2**31),
                             st.text(max_size=12))
    manifests = st.lists(
        st.fixed_dictionaries({
            "apiVersion": st.sampled_from(["v1", "apps/v1"]),
            "kind": st.sampled_from(["ConfigMap", "Deployment"]),
            "metadata": st.fixed_dictionaries(
                {"name": st.text(min_size=1, max_size=8)}),
        }, optional={"data": st.dictionaries(
            st.text(min_size=1, max_size=6), json_scalars, max_size=3)}),
        max_size=3)

    @settings(max_examples=30, deadline=None,
              suppress_health_check=[HealthCheck.too_slow])
    @given(suspend=st.booleans(), workload=manifests,
           version=st.sampled_from(["work.karmada.io/v1alpha1",
                                    MP.WORK_V1ALPHA2]),
           name=st.text(min_size=1, max_size=10))
    def prop(suspend, workload, version, name):
        src = {"apiVersion": MP.WORK_V1ALPHA2, "kind": "Work",
               "metadata": {"name": name, "namespace": "ns"},
               "spec": {"suspend": suspend, "workload": workload}}
        encoded = []
        for M in (MJ, MP):
            w = M.from_manifest_typed(src)
            assert w.spec.suspend_dispatching is suspend
            assert w.spec.workload == workload
            enc = M.to_manifest_typed(w, version=version)
            assert enc["apiVersion"] == version
            assert M.from_manifest_typed(enc) == w
            encoded.append(enc)
        assert encoded[0] == encoded[1]

    prop()
