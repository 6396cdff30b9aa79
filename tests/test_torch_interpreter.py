"""Interpreter parity: the port's resource interpreter
(karmada_tpu_torch/interpreter) against the JAX package's, tolerance 0.

Every operation of the facade (InterpretReplica, InterpretComponent,
ReviseReplica, Job completions, Retain, AggregateStatus,
InterpretDependency, InterpretStatus, InterpretHealth, and the prune
before a Work) runs on the same manifests through both packages: the
native defaults' kinds, every kind of the third-party bundle (a generic
manifest each, plus the realistic ones of
tests/test_declarative_interpreter.py), a declarative customization from
the store and a `local:` webhook endpoint.  Results -- or the raised
error's type and message -- must be equal.  The declarative script dialect
must reject what the JAX package's rejects, and evaluate what it
evaluates to the same values.
"""

import dataclasses
import importlib

import pytest

import torch_scenarios as S


def _pkg(name):
    M = S.models_of(name)
    M.interp = importlib.import_module(f"{name}.interpreter.interpreter")
    M.decl = importlib.import_module(f"{name}.interpreter.declarative")
    M.third = importlib.import_module(f"{name}.interpreter.thirdparty")
    M.hook = importlib.import_module(f"{name}.interpreter.webhook")
    M.config = importlib.import_module(f"{name}.models.config")
    M.store = importlib.import_module(f"{name}.store.store")
    return M


MJ = _pkg("karmada_tpu")
MP = _pkg("karmada_tpu_torch")


def norm(v):
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return {"@": type(v).__name__,
                **{f.name: norm(getattr(v, f.name))
                   for f in dataclasses.fields(v)}}
    if isinstance(v, dict):
        return {k: norm(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [norm(x) for x in v]
    return v


def outcome(fn, *args):
    try:
        return ("ok", norm(fn(*args)))
    except Exception as e:  # noqa: BLE001 — compared across packages
        return ("error", type(e).__name__, str(e))


def every_op(M, interp, manifest) -> dict:
    observed = {**manifest,
                "spec": {**(manifest.get("spec") or {}), "replicas": 9,
                         "clusterIP": "10.0.0.7", "volumeName": "pv-1"},
                "secrets": [{"name": "tok"}],
                "status": {"readyReplicas": 2, "replicas": 3}}
    items = [M.AggregatedStatusItem(cluster_name="m1",
                                    status={"replicas": 2, "readyReplicas": 1,
                                            "ready": 2, "active": 1},
                                    applied=True, health="Healthy"),
             M.AggregatedStatusItem(cluster_name="m2",
                                    status={"replicas": 3, "readyReplicas": 3,
                                            "succeeded": 1},
                                    applied=True, health="Unhealthy"),
             M.AggregatedStatusItem(cluster_name="m3", status=None)]
    return {
        "replicas": outcome(interp.get_replicas, manifest),
        "components": outcome(interp.get_components, manifest),
        "revise": outcome(interp.revise_replica, manifest, 3),
        "completions": outcome(interp.revise_job_completions, manifest, 5),
        "retain": outcome(interp.retain, manifest, observed),
        "aggregate": outcome(interp.aggregate_status, manifest, items),
        "dependencies": outcome(interp.get_dependencies, manifest),
        "reflect": outcome(interp.reflect_status, observed),
        "health": outcome(interp.interpret_health, observed),
        "health_bare": outcome(interp.interpret_health, manifest),
        "prune": outcome(M.interp.prune_for_propagation, manifest),
    }


POD_SPEC = {
    "containers": [
        {"name": "a", "image": "nginx:1.19",
         "resources": {"requests": {"cpu": "250m", "memory": "1Gi",
                                    "nvidia.com/gpu": "1"}},
         "envFrom": [{"configMapRef": {"name": "cm-env"}},
                     {"secretRef": {"name": "sec-env"}}],
         "env": [{"name": "X", "valueFrom": {
             "configMapKeyRef": {"name": "cm-key", "key": "k"}}},
                 {"name": "Y", "valueFrom": {
                     "secretKeyRef": {"name": "sec-key", "key": "k"}}}]},
        {"name": "b", "resources": {"requests": {"cpu": "1"}}},
    ],
    "volumes": [{"configMap": {"name": "cm-vol"}},
                {"secret": {"secretName": "sec-vol"}},
                {"persistentVolumeClaim": {"claimName": "data"}},
                {"configMap": {"name": "cm-vol"}}],
    "serviceAccountName": "runner",
    "nodeSelector": {"disk": "ssd"},
    "priorityClassName": "high",
}


def native_manifests():
    meta = {"name": "w", "namespace": "ns", "generation": 3,
            "resourceVersion": "17", "uid": "u-1", "labels": {"app": "w"},
            "managedFields": [{}], "ownerReferences": [{}],
            "creationTimestamp": "t"}
    out = []
    for kind in ("Deployment", "StatefulSet", "ReplicaSet", "DaemonSet"):
        out.append({"apiVersion": "apps/v1", "kind": kind,
                    "metadata": dict(meta),
                    "spec": {"replicas": 4,
                             "template": {"spec": POD_SPEC}},
                    "status": {"observedGeneration": 3,
                               "availableReplicas": 4}})
    retained = dict(out[0], metadata={
        **meta, "labels": {"resourcetemplate.karmada.io/retain-replicas":
                           "true"}})
    out.append(retained)
    out.append({"apiVersion": "batch/v1", "kind": "Job",
                "metadata": dict(meta),
                "spec": {"parallelism": 3, "completions": 7,
                         "template": {"spec": POD_SPEC}},
                "status": {"conditions": [{"type": "Failed",
                                           "status": "True"}]}})
    out.append({"apiVersion": "batch/v1", "kind": "Job",
                "metadata": dict(meta), "spec": {}})
    out.append({"apiVersion": "v1", "kind": "Pod", "metadata": dict(meta),
                "spec": POD_SPEC, "status": {"phase": "Running"}})
    out.append({"apiVersion": "v1", "kind": "Pod", "metadata": dict(meta),
                "spec": {"containers": []}, "status": {"phase": "Failed"}})
    for kind in ("Service", "ServiceAccount", "PersistentVolumeClaim",
                 "ConfigMap", "Namespace"):
        out.append({"apiVersion": "v1", "kind": kind,
                    "metadata": dict(meta), "spec": {"x": 1}})
    return out


def realistic_thirdparty():
    return [
        {"apiVersion": "argoproj.io/v1alpha1", "kind": "Rollout",
         "metadata": {"name": "r", "namespace": "default", "generation": 2},
         "spec": {"replicas": 5, "template": {"spec": {"containers": [
             {"name": "c", "resources": {"requests": {"cpu": "250m"}}}]}}},
         "status": {"observedGeneration": 2, "availableReplicas": 5,
                    "replicas": 5, "readyReplicas": 5,
                    "updatedReplicas": 5, "phase": "Healthy"}},
        {"apiVersion": "apps.kruise.io/v1alpha1", "kind": "CloneSet",
         "metadata": {"name": "cs", "namespace": "default"},
         "spec": {"replicas": 7, "template": {"spec": {"containers": [
             {"name": "c", "resources": {"requests": {"memory": "2Gi"}}}]}}}},
        {"apiVersion": "flink.apache.org/v1beta1", "kind": "FlinkDeployment",
         "metadata": {"namespace": "d", "name": "f"},
         "spec": {"taskManager": {"replicas": 4,
                                  "resource": {"cpu": 2, "memory": "2Gi"}}},
         "status": {"lifecycleState": "STABLE",
                    "jobStatus": {"state": "RUNNING"}}},
        {"apiVersion": "batch.volcano.sh/v1alpha1", "kind": "Job",
         "metadata": {"namespace": "d", "name": "v"},
         "spec": {"tasks": [{"replicas": 2}, {"replicas": 3}]},
         "status": {"state": {"phase": "Running"}, "running": 5}},
        {"apiVersion": "kubeflow.org/v1", "kind": "TFJob",
         "metadata": {"namespace": "d", "name": "t"},
         "spec": {"tfReplicaSpecs": {"PS": {"replicas": 1},
                                     "Worker": {"replicas": 3}}},
         "status": {"conditions": [{"type": "Running", "status": "True"}]}},
        {"apiVersion": "helm.toolkit.fluxcd.io/v2beta1",
         "kind": "HelmRelease", "metadata": {"namespace": "d", "name": "h"},
         "status": {"conditions": [{"type": "Ready", "status": "False"}]}},
        {"apiVersion": "sparkoperator.k8s.io/v1beta2",
         "kind": "SparkApplication",
         "metadata": {"namespace": "d", "name": "s"},
         "spec": {"executor": {"instances": 3}},
         "status": {"applicationState": {"state": "RUNNING"}}},
    ]


def generic_thirdparty():
    """One generic manifest per bundle kind: common fields set, so most
    scripts evaluate and the rest fail the same way on both sides."""
    out = []
    for api_version, kind in sorted(MJ.third.THIRDPARTY_BUNDLE):
        out.append({
            "apiVersion": api_version, "kind": kind,
            "metadata": {"name": "g", "namespace": "ns", "generation": 2},
            "spec": {"replicas": 3, "parallelism": 2,
                     "template": {"spec": POD_SPEC}},
            "status": {"observedGeneration": 2, "replicas": 3,
                       "readyReplicas": 3, "availableReplicas": 3,
                       "updatedReplicas": 3, "updatedReadyReplicas": 3,
                       "conditions": [{"type": "Ready", "status": "True",
                                       "reason": "Succeeded"}]},
        })
    return out


def test_bundles_hold_the_same_kinds_and_scripts():
    assert MP.third.THIRDPARTY_BUNDLE == MJ.third.THIRDPARTY_BUNDLE


@pytest.mark.parametrize("family,manifests", [
    ("native", native_manifests()),
    ("thirdparty-realistic", realistic_thirdparty()),
    ("thirdparty-generic", generic_thirdparty()),
])
def test_every_operation(family, manifests):
    got = {}
    for M in (MJ, MP):
        interp = M.interp.ResourceInterpreter()
        got[M is MP] = [every_op(M, interp, m) for m in manifests]
    for m, a, b in zip(manifests, got[False], got[True]):
        assert a == b, (m["apiVersion"], m["kind"])
    oks = sum(v[0] == "ok" for r in got[True] for v in r.values())
    assert oks > len(manifests) * 6  # most operations evaluate


def widget(replicas=7):
    return {"apiVersion": "example.io/v1", "kind": "Widget",
            "metadata": {"namespace": "default", "name": "w"},
            "spec": {"size": replicas}, "status": {"size": replicas - 1}}


def customization(M, name, scripts):
    C = M.config
    return C.ResourceInterpreterCustomization(
        metadata=M.ObjectMeta(name=name),
        spec=C.ResourceInterpreterCustomizationSpec(
            target=C.CustomizationTarget(api_version="example.io/v1",
                                         kind="Widget"),
            customizations=scripts))


WIDGET_SCRIPTS = {
    "InterpretReplica": ("{'replicas': get(obj, 'spec.size', 0),"
                         " 'requirements': {'cpu': '250m'}}"),
    "InterpretComponent": ("[{'name': 'leader', 'replicas': 1,"
                           " 'requirements': {'memory': '1Gi'}},"
                           " {'name': 'worker', 'replicas':"
                           " get(obj, 'spec.size', 0)}]"),
    "ReviseReplica": "set(obj, 'spec.size', replicas)",
    "Retain": "set(desired, 'status', get(observed, 'status'))",
    "AggregateStatus": ("set(obj, 'status', {'size': sum([get(i,"
                        " 'status.replicas', 0) or 0 for i in items]),"
                        " 'clusters': sorted([i['cluster'] for i in"
                        " items])})"),
    "InterpretStatus": "{'size': get(obj, 'status.size', 0)}",
    "InterpretHealth": ("get(obj, 'status.size', 0) >="
                        " get(obj, 'spec.size', 0)"),
    "InterpretDependency": ("[{'apiVersion': 'v1', 'kind': 'ConfigMap',"
                            " 'name': 'cfg-' + str(get(obj, 'spec.size'))}]"),
}


def test_declarative_customization_every_operation():
    """A store-fed customization, an invalid one (never shadows a working
    tier) and an alphabetically later one (loses per operation)."""
    got = {}
    for M in (MJ, MP):
        store = M.store.ObjectStore()
        interp = M.interp.ResourceInterpreter()
        interp.attach_store(store)
        before = every_op(M, interp, widget())
        store.create(customization(M, "b-widget", WIDGET_SCRIPTS))
        store.create(customization(M, "a-bad",
                                   {"InterpretReplica": "import os"}))
        store.create(customization(M, "c-late",
                                   {"InterpretReplica": "111",
                                    "InterpretHealth": "False"}))
        with_cust = every_op(M, interp, widget())
        store.delete(M.config.ResourceInterpreterCustomization.KIND, "",
                     "b-widget")
        after = every_op(M, interp, widget())
        got[M is MP] = (before, with_cust, after)
    assert got[False] == got[True]
    assert got[True][1]["replicas"][1][0] == 7
    assert got[True][2]["replicas"][1][0] == 111


def _serve(M, name):
    srv = M.hook.InterpreterWebhookServer()
    I = M.interp
    srv.handle("example.io/v1", "Widget", I.OP_INTERPRET_REPLICA,
               lambda req: {"replicas": req["object"]["spec"]["size"],
                            "requirements": {"cpu": "250m"}})
    srv.handle("example.io/v1", "Widget", I.OP_INTERPRET_COMPONENT,
               lambda req: {"components": [{"name": "x", "replicas": 2}]})
    srv.handle("example.io/v1", "Widget", I.OP_REVISE_REPLICA,
               lambda req: {"revised": {
                   **req["object"], "spec": {**req["object"]["spec"],
                                             "size": req["desiredReplicas"]}}})
    srv.handle("example.io/v1", "Widget", I.OP_RETAIN,
               lambda req: {"retained": {**req["object"], "kept": True}})
    srv.handle("example.io/v1", "Widget", I.OP_AGGREGATE_STATUS,
               lambda req: {"status": {"readyTotal": sum(
                   (i["status"] or {}).get("ready", 0)
                   for i in req["aggregatedStatusItems"])}})
    srv.handle("example.io/v1", "Widget", I.OP_INTERPRET_STATUS,
               lambda req: {"status": {"seen": True}})
    srv.handle("example.io/v1", "Widget", I.OP_INTERPRET_HEALTH,
               lambda req: {"healthy": req["object"]["spec"]["size"] < 100})
    # InterpretDependency is left unhandled: an unsuccessful response
    return srv.as_local_endpoint(name)


def test_local_webhook_every_operation():
    got = {}
    for M in (MJ, MP):
        name = "widget-parity"  # each package keeps its own registry
        endpoint = _serve(M, name)
        try:
            store = M.store.ObjectStore()
            interp = M.interp.ResourceInterpreter()
            interp.attach_store(store)
            store.create(customization(M, "declarative",
                                       {"InterpretReplica": "999"}))
            C = M.config
            store.create(C.ResourceInterpreterWebhook(
                metadata=M.ObjectMeta(name="hook"),
                spec=C.ResourceInterpreterWebhookSpec(
                    endpoint=endpoint,
                    rules=[C.InterpreterRule(api_versions=["example.io/v1"],
                                             kinds=["Widget"],
                                             operations=["*"])])))
            ops = every_op(M, interp, widget())
            big = every_op(M, interp, widget(500))
            absent = M.store.ObjectStore()
            interp2 = M.interp.ResourceInterpreter()
            interp2.attach_store(absent)
            absent.create(C.ResourceInterpreterWebhook(
                metadata=M.ObjectMeta(name="gone"),
                spec=C.ResourceInterpreterWebhookSpec(
                    endpoint="local:definitely-absent",
                    rules=[C.InterpreterRule(api_versions=["*"],
                                             kinds=["Widget"],
                                             operations=["*"])])))
            missing = outcome(interp2.get_replicas, widget())
        finally:
            M.hook.unregister_local_endpoint(name)
        got[M is MP] = (ops, big, missing)
    assert got[False] == got[True]
    ops, big, missing = got[True]
    assert ops["replicas"][1][0] == 7  # the webhook outranks declarative
    assert ops["dependencies"][0] == "error"
    assert missing[:2] == ("error", "WebhookCallError")


DIALECT_REJECTS = [
    "__import__('os')", "obj.__class__", "(lambda: 1)()", "x := 5",
    "import os", "obj.keys()", "[].append(1)", "__builtins__", "f'{obj}'",
    "(yield 1)", "await x", "del x", "1 if",
]
DIALECT_EVALUATES = [
    ("get(obj, 'spec.replicas', 0) * 2", {"obj": {"spec": {"replicas": 3}}}),
    ("{'n': max([i for i in [1, 5, 3]])}", {}),
    ("quantity('500m') + quantity('1')", {}),
    ("set(obj, 'spec.replicas', replicas)",
     {"obj": {"spec": {"replicas": 1}}, "replicas": 9}),
    ("merge({'a': {'b': 1}}, {'a': {'c': 2}, 'd': 3})", {}),
    ("sorted(keys(obj))", {"obj": {"z": 1, "a": 2}}),
    ("[k for k, v in items(obj) if v > 1]", {"obj": {"z": 1, "a": 2}}),
    ("sum(values(obj)) // 2", {"obj": {"z": 1, "a": 4}}),
    ("obj['missing']", {"obj": {}}),
    ("1 / 0", {}),
    ("undefined_name + 1", {}),
    ("len(range(3)) if all([True]) and not any([]) else -1", {}),
]


def test_dialect_rejects_what_the_jax_package_rejects():
    for script in DIALECT_REJECTS:
        got = [outcome(M.decl.compile_script, script)[:2] for M in (MJ, MP)]
        assert got[0] == got[1] == ("error", "ScriptError"), script


#: names outside the helper table compile but find no builtins
DIALECT_FAILS_AT_RUN = ["open('f')", "eval('1')", "getattr(obj, 'x')",
                        "print(1)"]


def test_dialect_evaluates_alike():
    for script, env in DIALECT_EVALUATES:
        got = [outcome(lambda M=M: M.decl.compile_script(script)(env))
               for M in (MJ, MP)]
        assert got[0] == got[1], script
    for script in DIALECT_FAILS_AT_RUN:
        got = [outcome(lambda M=M: M.decl.compile_script(script)(
            {"obj": {}})) for M in (MJ, MP)]
        assert got[0] == got[1] and got[1][:2] == ("error", "ScriptError")
    src = {"spec": {"replicas": 1}}
    out = MP.decl.compile_script("set(obj, 'spec.replicas', 9)")({"obj": src})
    assert out["spec"]["replicas"] == 9 and src["spec"]["replicas"] == 1
