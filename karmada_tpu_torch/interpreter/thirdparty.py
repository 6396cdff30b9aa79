"""Third-party customization bundle — pure data, like the reference's
embedded Lua tree (pkg/resourceinterpreter/default/thirdparty/
resourcecustomizations/<group>/<Kind>/customizations.yaml: Kruise, Argo,
Flink, ...); counterpart of the JAX package's ``interpreter/thirdparty.py``.
Each entry is the same script dialect users write in
ResourceInterpreterCustomization objects; the facade ranks this tier below
user customizations and above the native defaults.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

from karmada_tpu_torch.interpreter.declarative import make_hooks

# (apiVersion, kind) -> op -> script
THIRDPARTY_BUNDLE: Dict[Tuple[str, str], Dict[str, str]] = {
    # Argo Rollouts (argoproj.io/v1alpha1 Rollout/customizations.yaml)
    ("argoproj.io/v1alpha1", "Rollout"): {
        "InterpretReplica": (
            "{'replicas': get(obj, 'spec.replicas', 0) or 0,"
            " 'requirements': {"
            "   name: req for c in get(obj, 'spec.template.spec.containers', [])"
            "   for name, req in items(get(c, 'resources.requests', {}))"
            " }}"
        ),
        "ReviseReplica": "set(obj, 'spec.replicas', replicas)",
        "InterpretHealth": (
            "get(obj, 'status.observedGeneration', 0) =="
            " get(obj, 'metadata.generation', 0)"
            " and (get(obj, 'status.availableReplicas', 0) or 0) >="
            " (get(obj, 'spec.replicas', 0) or 0)"
            " and get(obj, 'status.phase', '') != 'Degraded'"
        ),
        "InterpretStatus": (
            "{'replicas': get(obj, 'status.replicas', 0),"
            " 'readyReplicas': get(obj, 'status.readyReplicas', 0),"
            " 'availableReplicas': get(obj, 'status.availableReplicas', 0),"
            " 'updatedReplicas': get(obj, 'status.updatedReplicas', 0),"
            " 'phase': get(obj, 'status.phase', '')}"
        ),
        "AggregateStatus": (
            "set(obj, 'status', {"
            " 'replicas': sum([get(i, 'status.replicas', 0) or 0 for i in items]),"
            " 'readyReplicas': sum([get(i, 'status.readyReplicas', 0) or 0 for i in items]),"
            " 'availableReplicas': sum([get(i, 'status.availableReplicas', 0) or 0 for i in items]),"
            " 'updatedReplicas': sum([get(i, 'status.updatedReplicas', 0) or 0 for i in items])})"
        ),
    },
    # OpenKruise CloneSet (apps.kruise.io/v1alpha1 CloneSet/customizations.yaml)
    ("apps.kruise.io/v1alpha1", "CloneSet"): {
        "InterpretReplica": (
            "{'replicas': get(obj, 'spec.replicas', 0) or 0,"
            " 'requirements': {"
            "   name: req for c in get(obj, 'spec.template.spec.containers', [])"
            "   for name, req in items(get(c, 'resources.requests', {}))"
            " }}"
        ),
        "ReviseReplica": "set(obj, 'spec.replicas', replicas)",
        "InterpretHealth": (
            "get(obj, 'status.observedGeneration', 0) =="
            " get(obj, 'metadata.generation', 0)"
            " and (get(obj, 'status.updatedReadyReplicas', 0) or 0) >="
            " (get(obj, 'spec.replicas', 0) or 0)"
        ),
        "InterpretStatus": (
            "{'replicas': get(obj, 'status.replicas', 0),"
            " 'readyReplicas': get(obj, 'status.readyReplicas', 0),"
            " 'updatedReplicas': get(obj, 'status.updatedReplicas', 0),"
            " 'updatedReadyReplicas': get(obj, 'status.updatedReadyReplicas', 0),"
            " 'expectedUpdatedReplicas': get(obj, 'status.expectedUpdatedReplicas', 0)}"
        ),
        "AggregateStatus": (
            "set(obj, 'status', {"
            " 'replicas': sum([get(i, 'status.replicas', 0) or 0 for i in items]),"
            " 'readyReplicas': sum([get(i, 'status.readyReplicas', 0) or 0 for i in items]),"
            " 'updatedReplicas': sum([get(i, 'status.updatedReplicas', 0) or 0 for i in items]),"
            " 'updatedReadyReplicas': sum([get(i, 'status.updatedReadyReplicas', 0) or 0 for i in items])})"
        ),
    },
    # OpenKruise Advanced StatefulSet (apps.kruise.io/v1beta1
    # StatefulSet/customizations.yaml)
    ("apps.kruise.io/v1beta1", "StatefulSet"): {
        "InterpretReplica": (
            "{'replicas': get(obj, 'spec.replicas', 0) or 0,"
            " 'requirements': {"
            "   name: req for c in get(obj, 'spec.template.spec.containers', [])"
            "   for name, req in items(get(c, 'resources.requests', {}))"
            " }}"
        ),
        "ReviseReplica": "set(obj, 'spec.replicas', replicas)",
        "InterpretHealth": (
            "get(obj, 'status.observedGeneration', 0) =="
            " get(obj, 'metadata.generation', 0)"
            " and (get(obj, 'status.readyReplicas', 0) or 0) >="
            " (get(obj, 'spec.replicas', 0) or 0)"
        ),
        "InterpretStatus": (
            "{'replicas': get(obj, 'status.replicas', 0),"
            " 'readyReplicas': get(obj, 'status.readyReplicas', 0),"
            " 'updatedReplicas': get(obj, 'status.updatedReplicas', 0),"
            " 'availableReplicas': get(obj, 'status.availableReplicas', 0)}"
        ),
        "AggregateStatus": (
            "set(obj, 'status', {"
            " 'replicas': sum([get(i, 'status.replicas', 0) or 0 for i in items]),"
            " 'readyReplicas': sum([get(i, 'status.readyReplicas', 0) or 0 for i in items]),"
            " 'updatedReplicas': sum([get(i, 'status.updatedReplicas', 0) or 0 for i in items]),"
            " 'availableReplicas': sum([get(i, 'status.availableReplicas', 0) or 0 for i in items])})"
        ),
    },
    # Flink operator (flink.apache.org/v1beta1
    # FlinkDeployment/customizations.yaml): replica weight is the
    # taskmanager count; health tracks the operator's lifecycle state
    ("flink.apache.org/v1beta1", "FlinkDeployment"): {
        "InterpretReplica": (
            # `or 0` (not `or 1`): an EXPLICIT replicas: 0 (suspended
            # deployment) must round-trip with ReviseReplica(0)
            "{'replicas': int(get(obj, 'spec.taskManager.replicas', 1) or 0),"
            " 'requirements': {"
            "   'cpu': get(obj, 'spec.taskManager.resource.cpu', 1),"
            "   'memory': get(obj, 'spec.taskManager.resource.memory', '1Gi')}}"
        ),
        "ReviseReplica": "set(obj, 'spec.taskManager.replicas', replicas)",
        "InterpretHealth": (
            "get(obj, 'status.lifecycleState', '') == 'STABLE'"
        ),
        "InterpretStatus": (
            "{'lifecycleState': get(obj, 'status.lifecycleState', ''),"
            " 'jobState': get(obj, 'status.jobStatus.state', '')}"
        ),
    },
    # Volcano batch Job (batch.volcano.sh/v1alpha1 Job/customizations.yaml):
    # replicas is the sum over task groups; health follows the job phase
    ("batch.volcano.sh/v1alpha1", "Job"): {
        "InterpretReplica": (
            "{'replicas': sum([get(t, 'replicas', 1) or 1"
            "                  for t in get(obj, 'spec.tasks', [])])}"
        ),
        # divide by sequential fill over the task list: task i keeps
        # min(own, total - sum(earlier)); minAvailable clamps to the revised
        # total so the gang-scheduling bar stays satisfiable
        "ReviseReplica": (
            "set(set(obj, 'spec.tasks', ["
            "  set(t, 'replicas', max(0, min(get(t, 'replicas', 1) or 1,"
            "    replicas - sum([get(u, 'replicas', 1) or 1"
            "      for u in get(obj, 'spec.tasks', [])[:i]]))))"
            "  for i, t in enumerate(get(obj, 'spec.tasks', []))"
            "]), 'spec.minAvailable',"
            " min(get(obj, 'spec.minAvailable', replicas) or replicas, replicas))"
        ),
        "InterpretHealth": (
            "get(obj, 'status.state.phase', '') in"
            " ('Running', 'Completed', 'Completing')"
        ),
        "InterpretStatus": (
            "{'state': get(obj, 'status.state', {}),"
            " 'succeeded': get(obj, 'status.succeeded', 0),"
            " 'failed': get(obj, 'status.failed', 0),"
            " 'running': get(obj, 'status.running', 0)}"
        ),
        "AggregateStatus": (
            "set(obj, 'status', {"
            " 'running': sum([get(i, 'status.running', 0) or 0 for i in items]),"
            " 'succeeded': sum([get(i, 'status.succeeded', 0) or 0 for i in items]),"
            " 'failed': sum([get(i, 'status.failed', 0) or 0 for i in items]),"
            " 'state': {'phase':"
            "   'Running' if sum([get(i, 'status.running', 0) or 0 for i in items]) > 0"
            "   else ('Failed' if sum([get(i, 'status.failed', 0) or 0 for i in items]) > 0"
            "   else ('Completed' if sum([get(i, 'status.succeeded', 0) or 0 for i in items]) > 0"
            "   else ''))}})"
        ),
    },
    # Kubeflow TFJob (kubeflow.org/v1 TFJob/customizations.yaml): replicas
    # is the sum over the role replica specs; health from the Succeeded/
    # Running conditions
    ("kubeflow.org/v1", "TFJob"): {
        "InterpretReplica": (
            "{'replicas': sum(["
            "   get(s, 'replicas', 1) or 1"
            "   for role, s in items(get(obj, 'spec.tfReplicaSpecs', {}))])}"
        ),
        # division scales the Worker role; fixed roles (PS/Chief/...) keep
        # their counts and the Worker absorbs the difference
        "ReviseReplica": (
            "set(obj, 'spec.tfReplicaSpecs.Worker.replicas',"
            " max(0, replicas - sum(["
            "   get(s, 'replicas', 1) or 1"
            "   for role, s in items(get(obj, 'spec.tfReplicaSpecs', {}))"
            "   if role != 'Worker'])))"
        ),
        "InterpretHealth": (
            "any([get(c, 'type', '') in ('Running', 'Succeeded')"
            "     and get(c, 'status', '') == 'True'"
            "     for c in get(obj, 'status.conditions', [])])"
        ),
        "InterpretStatus": (
            "{'conditions': get(obj, 'status.conditions', []),"
            " 'replicaStatuses': get(obj, 'status.replicaStatuses', {})}"
        ),
    },
    # Flux HelmRelease (helm.toolkit.fluxcd.io/v2beta1
    # HelmRelease/customizations.yaml): non-workload; health is the Ready
    # condition
    ("helm.toolkit.fluxcd.io/v2beta1", "HelmRelease"): {
        "InterpretReplica": "{'replicas': 0}",
        "InterpretHealth": (
            "any([get(c, 'type', '') == 'Ready'"
            "     and get(c, 'status', '') == 'True'"
            "     for c in get(obj, 'status.conditions', [])])"
        ),
        "InterpretStatus": (
            "{'conditions': get(obj, 'status.conditions', []),"
            " 'lastAppliedRevision': get(obj, 'status.lastAppliedRevision', '')}"
        ),
    },
    # OpenKruise DaemonSet (apps.kruise.io/v1alpha1
    # DaemonSet/customizations.yaml): no divisible replicas; health is
    # generation-observed + updated>=desired + available>=updated
    ("apps.kruise.io/v1alpha1", "DaemonSet"): {
        "InterpretReplica": "{'replicas': 0}",
        "InterpretHealth": (
            "get(obj, 'status.observedGeneration', 0) =="
            " get(obj, 'metadata.generation', 0)"
            " and (get(obj, 'status.updatedNumberScheduled', 0) or 0) >="
            " (get(obj, 'status.desiredNumberScheduled', 0) or 0)"
            " and (get(obj, 'status.numberAvailable', 0) or 0) >="
            " (get(obj, 'status.updatedNumberScheduled', 0) or 0)"
        ),
        "InterpretStatus": (
            "{'currentNumberScheduled': get(obj, 'status.currentNumberScheduled', 0),"
            " 'desiredNumberScheduled': get(obj, 'status.desiredNumberScheduled', 0),"
            " 'numberReady': get(obj, 'status.numberReady', 0),"
            " 'numberAvailable': get(obj, 'status.numberAvailable', 0),"
            " 'updatedNumberScheduled': get(obj, 'status.updatedNumberScheduled', 0)}"
        ),
        "AggregateStatus": (
            "set(obj, 'status', {"
            " 'currentNumberScheduled': sum([get(i, 'status.currentNumberScheduled', 0) or 0 for i in items]),"
            " 'desiredNumberScheduled': sum([get(i, 'status.desiredNumberScheduled', 0) or 0 for i in items]),"
            " 'numberReady': sum([get(i, 'status.numberReady', 0) or 0 for i in items]),"
            " 'numberAvailable': sum([get(i, 'status.numberAvailable', 0) or 0 for i in items]),"
            " 'updatedNumberScheduled': sum([get(i, 'status.updatedNumberScheduled', 0) or 0 for i in items])})"
        ),
    },
    # OpenKruise SidecarSet (apps.kruise.io/v1alpha1
    # SidecarSet/customizations.yaml): injects into pods, manages none
    # itself; healthy when nothing is matched or every matched pod updated
    ("apps.kruise.io/v1alpha1", "SidecarSet"): {
        "InterpretReplica": "{'replicas': 0}",
        "InterpretHealth": (
            "(get(obj, 'status.matchedPods', 0) or 0) == 0"
            " or (get(obj, 'status.updatedPods', 0) or 0) >="
            " (get(obj, 'status.matchedPods', 0) or 0)"
        ),
        "InterpretStatus": (
            "{'matchedPods': get(obj, 'status.matchedPods', 0),"
            " 'updatedPods': get(obj, 'status.updatedPods', 0),"
            " 'readyPods': get(obj, 'status.readyPods', 0)}"
        ),
        "AggregateStatus": (
            "set(obj, 'status', {"
            " 'matchedPods': sum([get(i, 'status.matchedPods', 0) or 0 for i in items]),"
            " 'updatedPods': sum([get(i, 'status.updatedPods', 0) or 0 for i in items]),"
            " 'readyPods': sum([get(i, 'status.readyPods', 0) or 0 for i in items])})"
        ),
    },
    # OpenKruise UnitedDeployment (apps.kruise.io/v1alpha1
    # UnitedDeployment/customizations.yaml)
    ("apps.kruise.io/v1alpha1", "UnitedDeployment"): {
        # the pod template nests under the per-flavor sub-template
        # (spec.template.{statefulSetTemplate|deploymentTemplate|
        # cloneSetTemplate|advancedStatefulSetTemplate}.spec.template)
        "InterpretReplica": (
            "{'replicas': get(obj, 'spec.replicas', 0) or 0,"
            " 'requirements': {"
            "   name: req for c in ("
            "     get(obj, 'spec.template.statefulSetTemplate.spec.template.spec.containers', [])"
            "     or get(obj, 'spec.template.advancedStatefulSetTemplate.spec.template.spec.containers', [])"
            "     or get(obj, 'spec.template.deploymentTemplate.spec.template.spec.containers', [])"
            "     or get(obj, 'spec.template.cloneSetTemplate.spec.template.spec.containers', [])"
            "     or [])"
            "   for name, req in items(get(c, 'resources.requests', {}))"
            " }}"
        ),
        "ReviseReplica": "set(obj, 'spec.replicas', replicas)",
        "InterpretHealth": (
            "get(obj, 'status.observedGeneration', 0) =="
            " get(obj, 'metadata.generation', 0)"
            " and (get(obj, 'status.updatedReplicas', 0) or 0) >="
            " (get(obj, 'spec.replicas', 0) or 0)"
        ),
        "InterpretStatus": (
            "{'replicas': get(obj, 'status.replicas', 0),"
            " 'readyReplicas': get(obj, 'status.readyReplicas', 0),"
            " 'updatedReplicas': get(obj, 'status.updatedReplicas', 0)}"
        ),
        "AggregateStatus": (
            "set(obj, 'status', {"
            " 'replicas': sum([get(i, 'status.replicas', 0) or 0 for i in items]),"
            " 'readyReplicas': sum([get(i, 'status.readyReplicas', 0) or 0 for i in items]),"
            " 'updatedReplicas': sum([get(i, 'status.updatedReplicas', 0) or 0 for i in items])})"
        ),
    },
    # OpenKruise BroadcastJob (apps.kruise.io/v1alpha1
    # BroadcastJob/customizations.yaml): parallelism-shaped like a Job
    ("apps.kruise.io/v1alpha1", "BroadcastJob"): {
        "InterpretReplica": (
            "{'replicas': int(get(obj, 'spec.parallelism', 1) or 1)}"
        ),
        "ReviseReplica": "set(obj, 'spec.parallelism', replicas)",
        "InterpretHealth": (
            "(get(obj, 'status.desired', 0) or 0) > 0"
            " and (get(obj, 'status.failed', 0) or 0) == 0"
            " and ((get(obj, 'status.succeeded', 0) or 0) > 0"
            "      or (get(obj, 'status.active', 0) or 0) > 0)"
        ),
        "InterpretStatus": (
            "{'active': get(obj, 'status.active', 0),"
            " 'succeeded': get(obj, 'status.succeeded', 0),"
            " 'failed': get(obj, 'status.failed', 0),"
            " 'desired': get(obj, 'status.desired', 0)}"
        ),
        "AggregateStatus": (
            "set(obj, 'status', {"
            " 'active': sum([get(i, 'status.active', 0) or 0 for i in items]),"
            " 'succeeded': sum([get(i, 'status.succeeded', 0) or 0 for i in items]),"
            " 'failed': sum([get(i, 'status.failed', 0) or 0 for i in items]),"
            " 'desired': sum([get(i, 'status.desired', 0) or 0 for i in items])})"
        ),
    },
    # OpenKruise AdvancedCronJob (apps.kruise.io/v1alpha1
    # AdvancedCronJob/customizations.yaml): cron trigger, nothing divisible
    ("apps.kruise.io/v1alpha1", "AdvancedCronJob"): {
        "InterpretReplica": "{'replicas': 0}",
        "InterpretStatus": (
            "{'active': get(obj, 'status.active', []),"
            " 'lastScheduleTime': get(obj, 'status.lastScheduleTime', ''),"
            " 'type': get(obj, 'status.type', '')}"
        ),
        "AggregateStatus": (
            "set(obj, 'status', {"
            " 'active': [a for i in items"
            "            for a in (get(i, 'status.active', []) or [])],"
            " 'lastScheduleTime': max("
            "   [get(i, 'status.lastScheduleTime', '') or '' for i in items]"
            "   + ['']),"
            " 'type': get(items[0] if items else {}, 'status.type', '')})"
        ),
    },
    # Argo Workflow (argoproj.io/v1alpha1 Workflow/customizations.yaml):
    # parallelism is the replica axis; Failed/Error phases are unhealthy
    ("argoproj.io/v1alpha1", "Workflow"): {
        "InterpretReplica": (
            "{'replicas': int(get(obj, 'spec.parallelism', 1) or 1)}"
        ),
        "ReviseReplica": "set(obj, 'spec.parallelism', replicas)",
        "InterpretHealth": (
            "get(obj, 'status.phase', '') not in ('', 'Failed', 'Error')"
        ),
        "InterpretStatus": (
            "{'phase': get(obj, 'status.phase', ''),"
            " 'startedAt': get(obj, 'status.startedAt', ''),"
            " 'finishedAt': get(obj, 'status.finishedAt', ''),"
            " 'progress': get(obj, 'status.progress', '')}"
        ),
    },
    # Kubeflow Notebook (kubeflow.org/v1 Notebook/customizations.yaml):
    # single-pod workload; healthy when running or still creating
    ("kubeflow.org/v1", "Notebook"): {
        "InterpretReplica": (
            "{'replicas': 1,"
            " 'requirements': {"
            "   name: req for c in get(obj, 'spec.template.spec.containers', [])"
            "   for name, req in items(get(c, 'resources.requests', {}))"
            " }}"
        ),
        "InterpretHealth": (
            "get(obj, 'status.containerState.running', None) is not None"
            " or get(obj, 'status.containerState.waiting.reason', '')"
            " == 'ContainerCreating'"
        ),
        "InterpretStatus": (
            "{'containerState': get(obj, 'status.containerState', {}),"
            " 'readyReplicas': get(obj, 'status.readyReplicas', 0),"
            " 'conditions': get(obj, 'status.conditions', [])}"
        ),
    },
    # Kubeflow MPIJob (kubeflow.org/v2beta1 MPIJob/customizations.yaml):
    # role replica specs are the component sets; Failed=True condition
    # is terminal-unhealthy
    ("kubeflow.org/v2beta1", "MPIJob"): {
        "InterpretReplica": (
            "{'replicas': sum(["
            "   get(s, 'replicas', 1) or 1"
            "   for role, s in items(get(obj, 'spec.mpiReplicaSpecs', {}))])}"
        ),
        "InterpretComponent": (
            "[{'name': role, 'replicas': get(s, 'replicas', 1) or 1}"
            " for role, s in items(get(obj, 'spec.mpiReplicaSpecs', {}))]"
        ),
        "ReviseReplica": (
            "set(obj, 'spec.mpiReplicaSpecs.Worker.replicas',"
            " max(0, replicas - sum(["
            "   get(s, 'replicas', 1) or 1"
            "   for role, s in items(get(obj, 'spec.mpiReplicaSpecs', {}))"
            "   if role != 'Worker'])))"
        ),
        "InterpretHealth": (
            "len(get(obj, 'status.conditions', []) or []) > 0"
            " and not any([get(c, 'type', '') == 'Failed'"
            "              and get(c, 'status', '') == 'True'"
            "              for c in get(obj, 'status.conditions', [])])"
        ),
        "InterpretStatus": (
            "{'conditions': get(obj, 'status.conditions', []),"
            " 'replicaStatuses': get(obj, 'status.replicaStatuses', {})}"
        ),
    },
    # Flux Kustomization (kustomize.toolkit.fluxcd.io/v1
    # Kustomization/customizations.yaml): Ready/ReconciliationSucceeded
    ("kustomize.toolkit.fluxcd.io/v1", "Kustomization"): {
        "InterpretReplica": "{'replicas': 0}",
        "InterpretHealth": (
            "any([get(c, 'type', '') == 'Ready'"
            "     and get(c, 'status', '') == 'True'"
            "     and get(c, 'reason', '') == 'ReconciliationSucceeded'"
            "     for c in get(obj, 'status.conditions', [])])"
        ),
        "InterpretStatus": (
            "{'conditions': get(obj, 'status.conditions', []),"
            " 'lastAppliedRevision': get(obj, 'status.lastAppliedRevision', '')}"
        ),
    },
    # Kyverno policies (kyverno.io/v1 {Cluster,}Policy/customizations.yaml):
    # status.ready wins; otherwise the Ready/Succeeded condition
    ("kyverno.io/v1", "ClusterPolicy"): {
        "InterpretReplica": "{'replicas': 0}",
        "InterpretHealth": (
            "get(obj, 'status.ready', None)"
            " if get(obj, 'status.ready', None) is not None"
            " else any([get(c, 'type', '') == 'Ready'"
            "           and get(c, 'status', '') == 'True'"
            "           and get(c, 'reason', '') == 'Succeeded'"
            "           for c in get(obj, 'status.conditions', [])])"
        ),
        "InterpretStatus": (
            "{'ready': get(obj, 'status.ready', False),"
            " 'conditions': get(obj, 'status.conditions', [])}"
        ),
    },
    # Spark operator (sparkoperator.k8s.io/v1beta2
    # SparkApplication/customizations.yaml)
    ("sparkoperator.k8s.io/v1beta2", "SparkApplication"): {
        "InterpretReplica": (
            # `or 0` keeps the Spark pods' total (one plus the executors)
            # invertible with ReviseReplica: an explicit instances: 0
            # reads back as 1 total
            "{'replicas': 1 + int(get(obj, 'spec.executor.instances', 1) or 0)}"
        ),
        "ReviseReplica": (
            "set(obj, 'spec.executor.instances',"
            "    replicas - 1 if replicas > 0 else 0)"
        ),
        "InterpretHealth": (
            "get(obj, 'status.applicationState.state', '') in"
            " ('RUNNING', 'COMPLETED', 'SUBMITTED')"
        ),
        "InterpretStatus": (
            "{'applicationState': get(obj, 'status.applicationState', {}),"
            " 'executorState': get(obj, 'status.executorState', {}),"
            " 'lastSubmissionAttemptTime':"
            "   get(obj, 'status.lastSubmissionAttemptTime', '')}"
        ),
    },
}

# Namespaced Kyverno Policy shares ClusterPolicy's semantics verbatim
THIRDPARTY_BUNDLE[("kyverno.io/v1", "Policy")] = \
    THIRDPARTY_BUNDLE[("kyverno.io/v1", "ClusterPolicy")]


def _flux_source(ready_reasons: Tuple[str, ...]) -> Dict[str, str]:
    """Flux source-controller kinds (source.toolkit.fluxcd.io
    {GitRepository,Bucket,HelmChart,HelmRepository,OCIRepository}/
    customizations.yaml): non-workload, healthy on a True Ready condition
    with a fetch-succeeded reason; status reflects conditions + artifact."""
    reasons = ", ".join(f"'{r}'" for r in ready_reasons)
    return {
        "InterpretReplica": "{'replicas': 0}",
        "InterpretHealth": (
            "any([get(c, 'type', '') == 'Ready'"
            "     and get(c, 'status', '') == 'True'"
            f"     and get(c, 'reason', '') in ({reasons},)"
            "     for c in get(obj, 'status.conditions', [])])"
        ),
        "InterpretStatus": (
            "{'conditions': get(obj, 'status.conditions', []),"
            " 'artifact': get(obj, 'status.artifact', {}),"
            " 'observedGeneration': get(obj, 'status.observedGeneration', 0)}"
        ),
    }


THIRDPARTY_BUNDLE[("source.toolkit.fluxcd.io/v1", "GitRepository")] = \
    _flux_source(("Succeeded",))
THIRDPARTY_BUNDLE[("source.toolkit.fluxcd.io/v1beta2", "Bucket")] = \
    _flux_source(("Succeeded",))
THIRDPARTY_BUNDLE[("source.toolkit.fluxcd.io/v1beta2", "HelmChart")] = \
    _flux_source(("Succeeded", "ChartPullSucceeded"))
THIRDPARTY_BUNDLE[("source.toolkit.fluxcd.io/v1beta2", "HelmRepository")] = \
    _flux_source(("Succeeded", "IndexationSucceeded"))
THIRDPARTY_BUNDLE[("source.toolkit.fluxcd.io/v1beta2", "OCIRepository")] = \
    _flux_source(("Succeeded",))

_compiled: Dict[Tuple[str, str], Dict[str, Callable]] = {}


def thirdparty_hook(api_version: str, kind: str, op: str) -> Optional[Callable]:
    key = (api_version, kind)
    if key not in THIRDPARTY_BUNDLE:
        return None
    if key not in _compiled:
        _compiled[key] = make_hooks(THIRDPARTY_BUNDLE[key])
    return _compiled[key].get(op)
