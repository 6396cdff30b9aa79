"""Propagation-loop parity: the port's ControlPlane (karmada_tpu_torch/
e2e.py) against the JAX package's, tolerance 0.

The JAX ControlPlane runs exactly the ported controller set
(``controllers=JAX_CONTROLLERS``, store/worker.PORTED_CONTROLLERS); both
run the same scenario -- every scenario of tests/test_e2e_slice.py (but the opt-in 600-member one), the
detector cases of tests/test_detector_semantics.py and the policy
defaulting and validation cases of tests/test_admission.py -- and their
normalized snapshots must be equal: templates, policies, bindings, Works,
Clusters, Namespaces, Leases and interpreter configs of the control
plane, and every member's objects, with uids, resourceVersions,
timestamps, condition times and lease renewal times cleared (generations
kept).  Both stores hand out uids from a counter (a template's uid breaks
scheduling ties), so both collectors write their heartbeat Leases in the
same order (tests/torch_loop.py holds the shared helpers).  A scenario
also logs what it observes (admission denials, claims, ready replicas);
the logs must be equal too.

Backends "serial" and "native" run every scenario (the JAX side runs the
same backend); "device" with device="cpu" runs two, against the JAX
package's "serial" (its device path is the JAX package's own concern and
costs XLA compiles here).
"""

import pytest

from torch_fixtures import collect_jax_planes  # noqa: F401 — autouse
from torch_loop import (  # noqa: F401 — deterministic_uids is autouse
    JAX_CONTROLLERS,
    MJ,
    MP,
    assert_same,
    deterministic_uids,
    norm,
)

#: control-plane kinds of the snapshot besides the templates
SNAP_KINDS = frozenset({
    "Cluster", "Namespace", "PropagationPolicy", "ClusterPropagationPolicy",
    "OverridePolicy", "ClusterOverridePolicy", "ResourceBinding",
    "ClusterResourceBinding", "Work", "ResourceInterpreterCustomization",
    "ResourceInterpreterWebhook", "Lease",
})


def snapshot(cp) -> dict:
    out = {}
    for obj in cp.store.items():
        kind = obj.KIND
        if type(obj).__name__ != "Unstructured" and kind not in SNAP_KINDS:
            continue  # kinds the loop's scenarios do not compare
        out[(kind, obj.metadata.namespace, obj.metadata.name)] = norm(obj)
    for name, member in cp.members.items():
        for obj in member.store.items():
            out[("member", name, obj.KIND, obj.metadata.namespace,
                 obj.metadata.name)] = norm(obj)
    return out


def plane(M, backend, members=(), tick=True):
    if M is MJ:
        cp = M.ControlPlane(
            backend="serial" if backend == "device" else backend,
            controllers=JAX_CONTROLLERS)
    else:
        cp = M.ControlPlane(backend=backend,
                            device="cpu" if backend == "device" else None)
    for name, kw in members:
        cp.add_member(name, **kw)
    if tick:
        cp.tick()
    return cp


# -- tests/test_e2e_slice.py --------------------------------------------------

FLEET3 = (("m1", {"cpu_milli": 64_000}), ("m2", {"cpu_milli": 32_000}),
          ("m3", {"cpu_milli": 16_000}))
FLEET2 = (("m1", {"cpu_milli": 64_000}), ("m2", {"cpu_milli": 32_000}))


def nginx(replicas=6, cpu="500m"):
    return {
        "apiVersion": "apps/v1",
        "kind": "Deployment",
        "metadata": {"name": "nginx", "namespace": "default"},
        "spec": {
            "replicas": replicas,
            "template": {"spec": {"containers": [
                {"name": "nginx", "image": "nginx:1.19",
                 "resources": {"requests": {"cpu": cpu, "memory": "1Gi"}}},
            ]}},
        },
    }


def policy(M, name="nginx-pp", divided=True, clusters=None):
    if divided:
        rs = M.ReplicaSchedulingStrategy(
            replica_scheduling_type=M.REPLICA_SCHEDULING_DIVIDED,
            replica_division_preference=M.REPLICA_DIVISION_WEIGHTED,
            weight_preference=M.ClusterPreferences(
                dynamic_weight=M.DYNAMIC_WEIGHT_AVAILABLE_REPLICAS))
    else:
        rs = M.ReplicaSchedulingStrategy(
            replica_scheduling_type=M.REPLICA_SCHEDULING_DUPLICATED)
    placement = M.Placement(replica_scheduling=rs)
    if clusters:
        placement.cluster_affinity = M.ClusterAffinity(cluster_names=clusters)
    return M.PropagationPolicy(
        metadata=M.ObjectMeta(name=name, namespace="default"),
        spec=M.PropagationSpec(
            resource_selectors=[M.ResourceSelector(api_version="apps/v1",
                                                   kind="Deployment")],
            placement=placement))


def sc_full_propagation_loop(M, backend, log):
    cp = plane(M, backend, FLEET3)
    cp.apply_policy(policy(M))
    cp.apply(nginx(replicas=6))
    cp.tick()
    cp.tick()
    log.append(cp.store.get("Deployment", "default", "nginx")
               .manifest["status"]["readyReplicas"])
    return cp


def sc_scale_up_keeps_existing_assignment(M, backend, log):
    cp = plane(M, backend, FLEET3)
    cp.apply_policy(policy(M))
    cp.apply(nginx(replicas=6))
    cp.tick()
    cp.apply(nginx(replicas=12))
    cp.tick()
    return cp


def sc_duplicated_propagates_full_replicas(M, backend, log):
    cp = plane(M, backend, FLEET3)
    cp.apply_policy(policy(M, divided=False, clusters=["m1", "m2"]))
    cp.apply(nginx(replicas=4))
    cp.tick()
    return cp


def sc_override_policy_rewrites_image(M, backend, log):
    cp = plane(M, backend, FLEET3)
    cp.apply_policy(policy(M, divided=False, clusters=["m1"]))
    cp.apply_policy(M.OverridePolicy(
        metadata=M.ObjectMeta(name="img", namespace="default"),
        spec=M.OverrideSpec(
            resource_selectors=[M.ResourceSelector(kind="Deployment")],
            override_rules=[M.RuleWithCluster(
                target_cluster=M.ClusterAffinity(cluster_names=["m1"]),
                overriders=M.Overriders(image_overrider=[
                    M.ImageOverrider(component="Registry",
                                     operator="replace",
                                     value="registry.local")]),
            )])))
    cp.apply(nginx())
    cp.tick()
    return cp


def sc_template_delete_cleans_up(M, backend, log):
    cp = plane(M, backend, FLEET3)
    cp.apply_policy(policy(M))
    cp.apply(nginx())
    cp.tick()
    cp.delete("Deployment", "default", "nginx")
    cp.tick()
    log.append(len(cp.store.list("Work")))
    return cp


def sc_policy_delete_cleans_bindings(M, backend, log):
    cp = plane(M, backend, FLEET3)
    cp.apply_policy(policy(M))
    cp.apply(nginx())
    cp.tick()
    cp.delete(M.PropagationPolicy.KIND, "default", "nginx-pp")
    cp.tick()
    return cp


def sc_member_object_recreated_when_deleted(M, backend, log):
    cp = plane(M, backend, FLEET3)
    cp.apply_policy(policy(M, divided=False, clusters=["m1"]))
    cp.apply(nginx(replicas=2))
    cp.tick()
    cp.member("m1").delete("Deployment", "default", "nginx")
    cp.tick()
    return cp


def sc_device_backend_end_to_end(M, backend, log):
    cp = plane(M, backend, FLEET2)
    cp.apply_policy(policy(M))
    cp.apply(nginx(replicas=8))
    cp.tick()
    return cp


def sc_native_backend_schedules_like_serial(M, backend, log):
    cp = plane(M, backend, FLEET2, tick=False)
    cp.apply(nginx(replicas=6))
    cp.apply_policy(policy(M))
    cp.tick()
    return cp


def sc_affinity_failover_loop(M, backend, log):
    cp = plane(M, backend, (("m1", {}), ("m2", {})), tick=False)
    cp.apply(nginx(replicas=4))
    pol = policy(M)
    pol.spec.placement.cluster_affinity = None
    pol.spec.placement.cluster_affinities = [
        M.ClusterAffinityTerm(affinity_name="primary",
                              affinity=M.ClusterAffinity(
                                  cluster_names=["absent-a", "absent-b"])),
        M.ClusterAffinityTerm(affinity_name="backup",
                              affinity=M.ClusterAffinity(
                                  cluster_names=["m1", "m2"])),
    ]
    cp.apply_policy(pol)
    cp.tick()
    log.append(cp.store.get("ResourceBinding", "default", "nginx-deployment")
               .status.scheduler_observed_affinity_name)
    return cp


def sc_namespace_sync_and_divided_job(M, backend, log):
    """Namespaces reach every member (and a joining one); a Divided Job
    splits its completions with its replicas."""
    cp = plane(M, backend, FLEET2)
    cp.apply({"apiVersion": "v1", "kind": "Namespace",
              "metadata": {"name": "team-a"}})
    cp.apply({"apiVersion": "v1", "kind": "Namespace",
              "metadata": {"name": "kube-system"}})
    cp.apply_policy(M.PropagationPolicy(
        metadata=M.ObjectMeta(name="jobs", namespace="team-a"),
        spec=M.PropagationSpec(
            resource_selectors=[M.ResourceSelector(api_version="batch/v1",
                                                   kind="Job")],
            placement=policy(M).spec.placement)))
    cp.apply({"apiVersion": "batch/v1", "kind": "Job",
              "metadata": {"name": "crunch", "namespace": "team-a"},
              "spec": {"parallelism": 5, "completions": 9,
                       "template": {"spec": {"containers": [
                           {"name": "c", "resources": {
                               "requests": {"cpu": "1"}}}]}}}})
    cp.tick()
    cp.add_member("m3", cpu_milli=16_000)
    cp.tick()
    return cp


def sc_conflict_abort_fails_the_sync(M, backend, log):
    """A member already runs an object of the same name that no Work
    made: ConflictResolution Abort (the default) refuses to take it over,
    the Work stays Applied=False; after the policy turns Overwrite, the
    next change of the Work takes the object over."""
    cp = plane(M, backend, FLEET2)
    cp.member("m1").apply(nginx(replicas=1))
    cp.apply_policy(policy(M, divided=False, clusters=["m1", "m2"]))
    cp.apply(nginx(replicas=2))
    cp.tick()
    log.append(cp.member("m1").get("Deployment", "default", "nginx")
               .manifest["spec"]["replicas"])

    def overwrite(p):
        p.spec.conflict_resolution = "Overwrite"

    cp.store.mutate(M.PropagationPolicy.KIND, "default", "nginx-pp",
                    overwrite)
    cp.tick()
    log.append(cp.member("m1").get("Deployment", "default", "nginx")
               .manifest["spec"]["replicas"])
    cp.apply(nginx(replicas=3))
    cp.tick()
    log.append(cp.member("m1").get("Deployment", "default", "nginx")
               .manifest["spec"]["replicas"])
    return cp


E2E = [sc_full_propagation_loop, sc_scale_up_keeps_existing_assignment,
       sc_duplicated_propagates_full_replicas,
       sc_override_policy_rewrites_image, sc_template_delete_cleans_up,
       sc_policy_delete_cleans_bindings,
       sc_member_object_recreated_when_deleted, sc_device_backend_end_to_end,
       sc_native_backend_schedules_like_serial, sc_affinity_failover_loop,
       sc_namespace_sync_and_divided_job, sc_conflict_abort_fails_the_sync]


# -- tests/test_detector_semantics.py -----------------------------------------

def plain_nginx():
    return {"apiVersion": "apps/v1", "kind": "Deployment",
            "metadata": {"name": "nginx", "namespace": "default"},
            "spec": {"replicas": 3}}


def pp(M, name, priority=0, preemption="Never", lazy=False, ns="default"):
    return M.PropagationPolicy(
        metadata=M.ObjectMeta(name=name, namespace=ns),
        spec=M.PropagationSpec(
            resource_selectors=[M.ResourceSelector(api_version="apps/v1",
                                                   kind="Deployment")],
            placement=M.Placement(replica_scheduling=(
                M.ReplicaSchedulingStrategy(
                    replica_scheduling_type=(
                        M.REPLICA_SCHEDULING_DUPLICATED)))),
            priority=priority, preemption=preemption,
            activation_preference=M.LAZY_ACTIVATION if lazy else ""))


def cpp(M, name, priority=0, preemption="Never"):
    p = pp(M, name, priority, preemption, ns="")
    return M.ClusterPropagationPolicy(metadata=p.metadata, spec=p.spec)


def claimed_by(M, cp):
    labels = cp.store.get("Deployment", "default", "nginx").metadata.labels
    return (labels.get(M.detector.POLICY_LABEL),
            labels.get(M.detector.CLUSTER_POLICY_LABEL))


def _claim_case(first, second):
    def scenario(M, backend, log):
        cp = plane(M, backend, (("m1", {"cpu_milli": 64_000}),))
        cp.store.create(first(M))
        cp.apply(plain_nginx())
        cp.tick()
        log.append(claimed_by(M, cp))
        cp.store.create(second(M))
        cp.tick()
        log.append(claimed_by(M, cp))
        return cp
    return scenario


sc_preemption_never_keeps_claim = _claim_case(
    lambda M: pp(M, "low", priority=1),
    lambda M: pp(M, "high", priority=10, preemption="Never"))
sc_preemption_always_takes_claim = _claim_case(
    lambda M: pp(M, "low", priority=1),
    lambda M: pp(M, "high", priority=10, preemption="Always"))
sc_preemption_always_requires_higher_priority = _claim_case(
    lambda M: pp(M, "first", priority=5),
    lambda M: pp(M, "equal", priority=5, preemption="Always"))
sc_pp_preempts_cpp_with_always = _claim_case(
    lambda M: cpp(M, "cluster-wide", priority=100),
    lambda M: pp(M, "local", priority=0, preemption="Always"))
sc_pp_does_not_preempt_cpp_with_never = _claim_case(
    lambda M: cpp(M, "cluster-wide"),
    lambda M: pp(M, "local", priority=50, preemption="Never"))


def sc_lazy_policy_update_deferred(M, backend, log):
    cp = plane(M, backend, (("m1", {"cpu_milli": 64_000}),))
    cp.store.create(pp(M, "lazy", lazy=True))
    cp.apply(plain_nginx())
    cp.tick()

    def bump(p):
        p.spec.conflict_resolution = "Overwrite"

    cp.store.mutate(M.PropagationPolicy.KIND, "default", "lazy", bump)
    cp.tick()
    log.append(cp.store.get("ResourceBinding", "default", "nginx-deployment")
               .spec.conflict_resolution)
    manifest = plain_nginx()
    manifest["spec"]["replicas"] = 4
    cp.apply(manifest)
    cp.tick()
    log.append(cp.store.get("ResourceBinding", "default", "nginx-deployment")
               .spec.conflict_resolution)
    return cp


def sc_lazy_policy_does_not_claim_existing(M, backend, log):
    cp = plane(M, backend, (("m1", {"cpu_milli": 64_000}),))
    cp.apply(plain_nginx())
    cp.tick()
    cp.store.create(pp(M, "late-lazy", lazy=True))
    cp.tick()
    log.append(cp.store.try_get("ResourceBinding", "default",
                                "nginx-deployment") is None)
    manifest = plain_nginx()
    manifest["spec"]["replicas"] = 5
    cp.apply(manifest)
    cp.tick()
    return cp


DETECTOR = [sc_preemption_never_keeps_claim, sc_preemption_always_takes_claim,
            sc_preemption_always_requires_higher_priority,
            sc_pp_preempts_cpp_with_always,
            sc_pp_does_not_preempt_cpp_with_never,
            sc_lazy_policy_update_deferred,
            sc_lazy_policy_does_not_claim_existing]


# -- tests/test_admission.py (the policy and interpreter-webhook cases) ------

def denied(M, log, fn):
    try:
        fn()
    except M.AdmissionDenied as e:
        log.append(("denied", str(e)))
    else:
        log.append("admitted")


def admission_policy(M):
    return M.PropagationPolicy(
        metadata=M.ObjectMeta(name="pp", namespace="default"),
        spec=M.PropagationSpec(
            resource_selectors=[M.ResourceSelector(api_version="apps/v1",
                                                   kind="Deployment")],
            placement=policy(M).spec.placement))


def sc_policy_validation(M, backend, log):
    cp = plane(M, backend, FLEET2)
    bad = admission_policy(M)
    bad.spec.placement.spread_constraints = [M.SpreadConstraint(
        spread_by_field="cluster", min_groups=3, max_groups=1)]
    denied(M, log, lambda: cp.store.create(bad))
    for field, value in (("resource_selectors", []),
                         ("preemption", "Sometimes"),
                         ("activation_preference", "Eager")):
        p = admission_policy(M)
        setattr(p.spec, field, value)
        denied(M, log, lambda p=p: cp.store.create(p))
    p = admission_policy(M)
    p.spec.placement.cluster_tolerations = [M.Toleration(
        key="k", operator="Exists", effect="NoExecute",
        toleration_seconds=-1)]
    denied(M, log, lambda: cp.store.create(p))
    # an update is admitted (and validated) too
    p = admission_policy(M)
    cp.store.create(p)
    bad = cp.store.get(M.PropagationPolicy.KIND, "default", "pp")
    bad.spec.placement.spread_constraints = [M.SpreadConstraint(
        spread_by_field="region", spread_by_label="zone")]
    denied(M, log, lambda: cp.store.update(bad))
    return cp


def sc_policy_defaulting(M, backend, log):
    cp = plane(M, backend, FLEET2)
    p = admission_policy(M)
    p.spec.preemption = ""
    p.spec.conflict_resolution = "Whatever"
    cp.store.create(p)
    c = cpp(M, "cluster-wide")
    c.spec.placement.cluster_tolerations = [M.Toleration(
        key="cluster.karmada.io/not-ready", operator="Exists",
        effect="NoExecute", toleration_seconds=30)]
    cp.store.create(c)
    log.append(cp.store.get(M.PropagationPolicy.KIND, "default", "pp")
               .spec.preemption)
    return cp


def sc_override_policy_validation(M, backend, log):
    cp = plane(M, backend, FLEET2)
    for op in ("replace", "merge"):
        denied(M, log, lambda op=op: cp.store.create(M.OverridePolicy(
            metadata=M.ObjectMeta(name=f"o-{op}", namespace="default"),
            spec=M.OverrideSpec(override_rules=[M.RuleWithCluster(
                overriders=M.Overriders(image_overrider=[M.ImageOverrider(
                    component="Tag", operator=op, value="v2")]))]))))
    return cp


def sc_interpreter_webhook_admission(M, backend, log):
    cp = plane(M, backend, FLEET2)
    C = M.config

    def mk(endpoint, rules, timeout_s=5.0, name="w"):
        return C.ResourceInterpreterWebhook(
            metadata=M.ObjectMeta(name=name),
            spec=C.ResourceInterpreterWebhookSpec(
                endpoint=endpoint, rules=rules, timeout_s=timeout_s))

    ok_rule = C.InterpreterRule(api_versions=["apps/v1"], kinds=["*"],
                                operations=["*"])
    for args in ((mk("local:ok-hook", [ok_rule]),),
                 (mk("ftp://nope", [ok_rule], name="bad-scheme"),),
                 (mk("local:x", [], name="no-rules"),),
                 (mk("local:x", [C.InterpreterRule()], name="empty-rule"),),
                 (mk("local:x", [ok_rule], timeout_s=0,
                     name="bad-timeout"),),
                 (mk("local:x", [C.InterpreterRule(
                     api_versions=["apps/v1"], kinds=["*"],
                     operations=[])], name="no-ops"),)):
        denied(M, log, lambda args=args: cp.store.create(*args))
    return cp


ADMISSION = [sc_policy_validation, sc_policy_defaulting,
             sc_override_policy_validation, sc_interpreter_webhook_admission]


def run_both(scenario, backend):
    logs = ([], [])
    cps = [scenario(M, backend, log) for M, log in zip((MJ, MP), logs)]
    assert logs[0] == logs[1]
    assert_same(snapshot(cps[0]), snapshot(cps[1]))
    for name in ("scheduler", "binding", "execution"):
        assert not cps[1].runtime.reconcile_errors()[name]
    if scenario is not sc_conflict_abort_fails_the_sync:
        assert cps[1].execution.sync_failures == 0
    assert cps[1].scheduler.faults() == {}
    return cps, logs


@pytest.mark.parametrize("backend", ["serial", "native"])
@pytest.mark.parametrize("scenario", E2E + DETECTOR,
                         ids=lambda f: f.__name__[3:])
def test_loop_parity(scenario, backend):
    run_both(scenario, backend)


@pytest.mark.parametrize("scenario", [sc_full_propagation_loop,
                                      sc_device_backend_end_to_end],
                         ids=lambda f: f.__name__[3:])
def test_loop_parity_device_cpu(scenario):
    cps, _ = run_both(scenario, "device")
    assert cps[1].scheduler.device.type == "cpu"
    assert any(c["backend"] == "device" for c in cps[1].scheduler.cycle_log)


@pytest.mark.parametrize("scenario", ADMISSION,
                         ids=lambda f: f.__name__[3:])
def test_admission_parity(scenario):
    _, logs = run_both(scenario, "serial")
    assert logs[1]


def test_scenarios_hold_what_the_jax_tests_assert():
    """The JAX tests' own assertions, on the port's planes."""
    log = []
    cp = sc_full_propagation_loop(MP, "serial", log)
    rb = cp.store.get("ResourceBinding", "default", "nginx-deployment")
    assert rb.spec.replicas == 6 and log == [6]
    assert sum(t.replicas for t in rb.spec.clusters) == 6
    for t in rb.spec.clusters:
        w = cp.store.get("Work", f"karmada-es-{t.name}",
                         MP.binding.work_name(rb))
        assert w.spec.workload[0]["spec"]["replicas"] == t.replicas
        applied = cp.member(t.name).get("Deployment", "default", "nginx")
        assert applied.manifest["spec"]["replicas"] == t.replicas
    assert {t.key for t in rb.spec.placement.cluster_tolerations} == {
        "cluster.karmada.io/not-ready", "cluster.karmada.io/unreachable"}
    log = []
    cp = sc_template_delete_cleans_up(MP, "serial", log)
    assert log == [0]
    assert all(cp.member(m).get("Deployment", "default", "nginx") is None
               for m in ("m1", "m2", "m3"))
    log = []
    sc_affinity_failover_loop(MP, "native", log)
    assert log == ["backup"]
    log = []
    sc_pp_preempts_cpp_with_always(MP, "serial", log)
    assert log == [(None, "cluster-wide"), ("default/local", None)]
    log = []
    sc_lazy_policy_update_deferred(MP, "serial", log)
    assert log == ["Abort", "Overwrite"]
    log = []
    cp = sc_policy_defaulting(MP, "serial", log)
    assert log == ["Never"]
    tol = cp.store.get("ClusterPropagationPolicy", "", "cluster-wide") \
        .spec.placement.cluster_tolerations
    assert [(t.key, t.toleration_seconds) for t in tol] == [
        ("cluster.karmada.io/not-ready", 30),
        ("cluster.karmada.io/unreachable", 300)]
    log = []
    sc_namespace_sync_and_divided_job(MP, "serial", log)
    log = []
    cp = sc_conflict_abort_fails_the_sync(MP, "serial", log)
    assert log == [1, 1, 3] and cp.execution.sync_failures > 0


def test_apply_of_a_karmada_kind_raises_and_stores_nothing():
    """A karmada kind goes through the typed codec and admission: one
    admission denies, or one at a version nobody serves, raises in both
    packages and leaves both stores as they were."""
    for M in (MJ, MP):
        kw = ({"controllers": JAX_CONTROLLERS} if M is MJ else {})
        cp = M.ControlPlane(backend="serial", **kw)
        n = len(cp.store)
        with pytest.raises(M.AdmissionDenied):
            cp.apply({"apiVersion": "policy.karmada.io/v1alpha1",
                      "kind": "PropagationPolicy",
                      "metadata": {"name": "p", "namespace": "default"}})
        with pytest.raises(M.AdmissionDenied):
            cp.apply({"apiVersion": "policy.karmada.io/v1alpha1",
                      "kind": "FederatedResourceQuota",
                      "metadata": {"name": "q", "namespace": "default"},
                      "spec": {"overall": {"cpu": "-1"}}})
        with pytest.raises(ValueError):
            cp.apply({"apiVersion": "policy.karmada.io/v9",
                      "kind": "PropagationPolicy",
                      "metadata": {"name": "p", "namespace": "default"}})
        assert len(cp.store) == n and not cp.members


def sc_apply_karmada_kinds_and_pull_join(M, backend, log):
    """`apply` of karmada kinds (a policy, an override, a quota) decodes
    them to their typed models; a Pull member joins through its agent
    after its bootstrap CSR and receives its share."""
    cp = plane(M, backend, FLEET2)
    cp.add_member("pulled", cpu_milli=32_000, sync_mode="Pull")
    cp.apply({"apiVersion": "policy.karmada.io/v1alpha1",
              "kind": "PropagationPolicy",
              "metadata": {"name": "nginx-pp", "namespace": "default"},
              "spec": {"resourceSelectors": [{"apiVersion": "apps/v1",
                                              "kind": "Deployment"}],
                       "placement": {"replicaScheduling": {
                           "replicaSchedulingType": "Divided",
                           "replicaDivisionPreference": "Weighted",
                           "weightPreference": {
                               "dynamicWeight": "AvailableReplicas"}}}}})
    cp.apply({"apiVersion": "policy.karmada.io/v1alpha1",
              "kind": "FederatedResourceQuota",
              "metadata": {"name": "q", "namespace": "default"},
              "spec": {"overall": {"cpu": "100"}}})
    cp.apply(nginx(replicas=6))
    cp.tick()
    cp.tick()
    log.append(type(cp.store.get("PropagationPolicy", "default",
                                 "nginx-pp")).__name__)
    log.append(sorted(t.name for t in cp.store.get(
        "ResourceBinding", "default", "nginx-deployment").spec.clusters))
    log.append(cp.member("pulled").get("Deployment", "default", "nginx")
               is not None)
    log.append(cp.store.get("ClusterCredential", "", "pulled")
               .status.rotations)
    return cp


@pytest.mark.parametrize("backend", ["serial", "native"])
def test_apply_karmada_kinds_and_pull_join_parity(backend):
    _, logs = run_both(sc_apply_karmada_kinds_and_pull_join, backend)
    assert logs[1][0] == "PropagationPolicy" and logs[1][2] is True
    assert "pulled" in logs[1][1]


def test_default_tolerations_off():
    cps = []
    for M in (MJ, MP):
        kw = ({"backend": "serial", "controllers": JAX_CONTROLLERS}
              if M is MJ else {"backend": "serial"})
        cp = M.ControlPlane(default_toleration_seconds=None, **kw)
        cp.store.create(admission_policy(M))
        cps.append(cp)
    assert_same(snapshot(cps[0]), snapshot(cps[1]))
    assert not cps[1].store.get("PropagationPolicy", "default", "pp") \
        .spec.placement.cluster_tolerations


def sc_resource_modeling_collect(M, backend, log):
    """A Cluster with resource models: the collector fills its
    AllocatableModelings from the member's node inventory, free capacity
    after the admitted workloads (the producer, estimator/general)."""
    gi = 1024 ** 3
    Q = M.Quantity

    def grade(g, cpu, mem):
        return M.ResourceModel(grade=g, ranges=[
            M.ResourceModelRange("cpu", Q.from_milli(cpu[0]),
                                 Q.from_milli(cpu[1])),
            M.ResourceModelRange("memory", Q.from_units(mem[0] * gi),
                                 Q.from_units(mem[1] * gi))])

    cp = plane(M, backend, (), tick=False)
    cp.store.create(M.Cluster(
        metadata=M.ObjectMeta(name="m1"),
        spec=M.ClusterSpec(resource_models=[
            grade(0, (0, 2000), (0, 8)), grade(1, (2000, 16000), (8, 64)),
            grade(2, (16000, 1 << 40), (64, 1 << 30))])))
    member = cp.add_member("m1")
    member.nodes = [
        type(member.effective_nodes()[0])(
            name=n, cpu_milli=cpu, pods=110,
            memory_milli=Q.parse(f"{mem}Gi").milli)
        for n, cpu, mem in (("small", 1000, 4), ("medium", 8000, 32),
                            ("skewed", 32000, 4), ("large", 32000, 128))]
    cp.apply_policy(policy(M, divided=False, clusters=["m1"]))
    cp.apply(nginx(replicas=3, cpu="6"))
    cp.tick()
    log.append([(m.grade, m.count) for m in cp.store.get(
        "Cluster", "", "m1").status.resource_summary.allocatable_modelings])
    return cp


def test_resource_modeling_parity():
    _, logs = run_both(sc_resource_modeling_collect, "serial")
    assert sum(n for _, n in logs[1][0]) > 0
