"""Isolation of the port: karmada_tpu_torch, chip_smoke.py and tools/
import neither jax nor anything of the JAX package karmada_tpu (whose name is a
prefix of the port's: `karmada_tpu` followed by a boundary other than
`_torch`), a cycle -- and a resident adopt plus an incremental cycle --
runs with neither in sys.modules, as does a control-plane
Scheduler with the rebalance plane armed and one with backend="native",
and the propagation loop (ControlPlane) on every backend -- with its
failover loop (leases, taints, the taint manager and its eviction queue,
graceful eviction), typed applies, quotas, a Pull member and an unjoin --
and the entry
points -- ControlPlane among them -- never drift to the CPU unless asked.
The sustained-traffic slice -- the flight recorder, the metrics and the
ledger (obs/, utils/metrics, utils/events, scheduler/metrics), loadgen/,
printers and the port CLI -- runs a compressed soak, the CLI's catalog
and a plane flow with neither in sys.modules either, and so does the
faults and telemetry slice (chaos/, analysis/guards, obs/incidents,
obs/slo, obs/timeseries) over the hotspot soak.  The cycle's
encode and decode run through the port's C paths (native/), whose loaded
libraries are the port's own builds: no port module names the JAX
package's native directory, and no library of it is mapped into the
process."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "karmada_tpu_torch"


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "karmada_tpu")


def _port_sources():
    files = (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
             + sorted((ROOT / "tools").glob("*.py")))
    assert len(files) >= 15
    return files


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_static_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and _forbidden(node.args[0].value)):
            bad.append(node.args[0].value)
    assert not bad, f"{path.name} imports {bad}"


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_names_no_jax_native_library(path):
    """The port loads only its own native builds: no module of it names
    the JAX package's native directory."""
    assert "karmada_tpu/native" not in path.read_text()


def test_forbidden_matches_prefix_boundary():
    assert _forbidden("karmada_tpu.ops.solver")
    assert _forbidden("karmada_tpu")
    assert not _forbidden("karmada_tpu_torch.ops.solver")
    assert _forbidden("jax.numpy")


_CYCLE = r"""
import random, sys
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
import torch_scenarios as S
from karmada_tpu_torch.scheduler.core import schedule_items
M = S.models_of("karmada_tpu_torch")
clusters, items = S.random_scenario(M, 1, n_clusters=11, n_bindings=20)
from karmada_tpu_torch import native
native.reset_counts()
out = schedule_items(items, clusters, chunk=8, waves=2, device="cpu")
assert len(out) == 20 and all(r is not None for r in out)
# the C encode and decode ran, and nothing went through the Python loops
assert native.COUNTS["encode_c"] > 0 and native.COUNTS["decode_coo"] > 0, \
    native.COUNTS
assert native.COUNTS["encode_py"] == 0, native.COUNTS
# the resident plane and the incremental solve: adopt, write back, and
# one watch-driven cycle on the fused plane
from karmada_tpu_torch.estimator.general import GeneralEstimator
from karmada_tpu_torch.resident import CycleDeltas, ResidentState
from karmada_tpu_torch.scheduler.incremental import IncrementalSolver
state = ResidentState(audit_interval=0, fused=True, device="cpu")
solver = IncrementalSolver(state, GeneralEstimator(), chunk=8,
                           audit_every=0)
bindings = S.as_bindings(M, items)
assert solver.adopt(clusters, bindings).mode == "full"
solver.write_back()
rep = solver.cycle(clusters, bindings, CycleDeltas(), force_audit=True)
assert rep.mode == "incremental" and rep.audit_outcome == "ok", rep
assert state.fused_cycles > 0
# the control plane: a Scheduler with the rebalance plane armed and the
# graceful-eviction controller, two ticks on one clock
from karmada_tpu_torch.controllers.failover import GracefulEvictionController
from karmada_tpu_torch.scheduler import Scheduler, SchedulingQueue
from karmada_tpu_torch.store import ObjectStore, Runtime
rng = random.Random(2)
clock = S.FakeClock()
store, rt = ObjectStore(), Runtime()
fleet = S.control_fleet(M, rng, 6)
for c in fleet:
    store.create(c)
sched = Scheduler(store, rt, device="cpu", queue=SchedulingQueue(now=clock),
                  rebalance=30.0, rebalance_clock=clock)
GracefulEvictionController(store, rt, clock=clock)
for rb in S.control_bindings(M, rng, 30, S.control_placements(
        M, rng, [c.name for c in fleet])):
    store.create(rb)
for _ in range(2):
    clock.advance(30.0)
    rt.tick()
assert sched.rebalance_plane.stats()["cycles"] == 2
assert sched.faults() == {{}} and not any(rt.reconcile_errors().values())
# the C++ serial control behind a Scheduler's native backend
store2, rt2 = ObjectStore(), Runtime()
for c in S.control_fleet(M, rng, 6):
    store2.create(c)
nsched = Scheduler(store2, rt2, backend="native")
for rb in S.control_bindings(M, rng, 12, S.control_placements(
        M, rng, [c.name for c in store2.list("Cluster")])):
    store2.create(rb)
rt2.tick()
assert nsched.faults() == {{}} and nsched.cycle_log[-1]["native_s"] > 0
libs = [native.load_encode_fast().__file__, native.load_decode_fast().__file__,
        native.load()._name]
assert all("karmada_tpu_torch/native/_build/" in f for f in libs), libs
with open("/proc/self/maps") as fh:
    maps = fh.read()
assert "karmada_tpu/native/" not in maps
assert all(f in maps for f in libs), libs
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "karmada_tpu"))
print("LOADED", bad)
assert not bad, bad
"""


_TRAFFIC = r"""
import contextlib, io, os, sys, tempfile
sys.path.insert(0, {root!r})
from karmada_tpu_torch import cli, obs, printers
from karmada_tpu_torch.obs import events, export, recorder, trace
from karmada_tpu_torch.utils import events as uevents, metrics
from karmada_tpu_torch.scheduler import metrics as smetrics
from karmada_tpu_torch.loadgen import (
    LoadDriver, ServeSlice, ServiceModel, VirtualClock, get_scenario)
from karmada_tpu_torch.loadgen import arrival, report, scenarios
scenario = get_scenario("steady")
clock, model = VirtualClock(), ServiceModel()
plane = ServeSlice(scenario, clock, model)
p = LoadDriver(plane, scenario, clock=clock, model=model, seed=1).run()
assert p["scheduled"] == p["injected"] > 0, p
assert p["stage_utilization"]["scheduler.cycle"]["count"] > 0
assert p["events"]["recorded"] > 0
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    assert cli.main(["loadgen"]) == 0
    d = tempfile.mkdtemp()
    assert cli.main(["--dir", d, "init"]) == 0
    assert cli.main(["--dir", d, "join", "m1"]) == 0
    assert cli.main(["--dir", d, "tick"]) == 0
    assert cli.main(["--dir", d, "get", "Cluster"]) == 0
assert "steady" in buf.getvalue() and "m1" in buf.getvalue()
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "karmada_tpu"))
print("LOADED", bad)
assert not bad, bad
"""


def test_traffic_slice_loads_no_jax_subprocess():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c",
                           _TRAFFIC.format(root=str(ROOT))],
                          capture_output=True, text=True, timeout=300,
                          env=env, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout


_FAULTS = r"""
import contextlib, io, sys, tempfile
sys.path.insert(0, {root!r})
from karmada_tpu_torch import chaos, cli
from karmada_tpu_torch.analysis import guards
from karmada_tpu_torch.chaos import audit, plane
from karmada_tpu_torch.facade import metrics as fmetrics
from karmada_tpu_torch.obs import incidents, slo, timeseries
from karmada_tpu_torch.loadgen import (
    LoadDriver, ServeSlice, ServiceModel, VirtualClock, get_scenario)
timeseries.configure(capacity=64)
slo.configure()
incidents.configure(tempfile.mkdtemp())
guards.arm()
scenario = get_scenario("hotspot")
clock, model = VirtualClock(), ServiceModel()
plane = ServeSlice(scenario, clock, model, device="cpu")
p = LoadDriver(plane, scenario, clock=clock, model=model, seed=1).run()
assert p["safety_audit"]["violations"] == [], p["safety_audit"]
assert p["chaos"]["fired_by_site"] == {{"rebalance.plan": 1}}
assert p["slo"]["enabled"] and p["incidents"]["enabled"]
assert not chaos.armed()
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "karmada_tpu"))
print("LOADED", bad)
assert not bad, bad
"""


def test_fault_planes_load_no_jax_subprocess():
    """The faults and telemetry slice -- chaos/ with its auditor,
    analysis/guards armed, obs/incidents, obs/slo, obs/timeseries and the
    facade's metrics -- runs the hotspot soak with neither jax nor the JAX
    package in sys.modules."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c",
                           _FAULTS.format(root=str(ROOT))],
                          capture_output=True, text=True, timeout=300,
                          env=env, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout


def test_fault_entry_points_refuse_cpu_drift(capsys):
    """The chaotic scenarios' entry points ask for the card unless told
    the CPU: `loadgen hotspot` without --device exits 1 naming the
    missing card, and a guarded device slice raises, with no card."""
    from karmada_tpu_torch import cli
    from karmada_tpu_torch.loadgen import (
        ServeSlice, ServiceModel, VirtualClock, get_scenario)

    if torch.cuda.is_available():
        return
    assert cli.main(["loadgen", "hotspot"]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeSlice(get_scenario("chaos"), VirtualClock(), ServiceModel(),
                   backend="device", resident=True,
                   device_cycle_timeout_s=2.0, device_recover_cycles=2)


def test_cycle_loads_no_jax_subprocess():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    code = _CYCLE.format(root=str(ROOT), tests=str(ROOT / "tests"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, env=env, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout


def test_entry_points_refuse_cpu_drift():
    """Without device= the entry points ask for the card; with no card they
    raise instead of running on the CPU."""
    from karmada_tpu_torch.device import resolve_device
    from karmada_tpu_torch.scheduler.core import schedule_items

    import torch_scenarios as S

    M = S.models_of("karmada_tpu_torch")
    clusters, items = S.random_scenario(M, 1, n_clusters=4, n_bindings=2)
    assert resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        schedule_items(items, clusters)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")


def test_scheduler_refuses_cpu_drift():
    """Scheduler(store, runtime) without device= runs on the card, and its
    rebalance plane with it; with no card it raises."""
    from karmada_tpu_torch.scheduler import Scheduler
    from karmada_tpu_torch.store import ObjectStore, Runtime

    if torch.cuda.is_available():
        sched = Scheduler(ObjectStore(), Runtime(), rebalance=30.0)
        assert sched.device.type == "cuda"
        assert sched.rebalance_plane.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Scheduler(ObjectStore(), Runtime())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Scheduler(ObjectStore(), Runtime(), rebalance=30.0)


_LOOP = r"""
import sys
sys.path.insert(0, {root!r})
from karmada_tpu_torch.e2e import ControlPlane
from karmada_tpu_torch.models.meta import ObjectMeta
from karmada_tpu_torch.models.policy import (
    DYNAMIC_WEIGHT_AVAILABLE_REPLICAS, REPLICA_DIVISION_WEIGHTED,
    REPLICA_SCHEDULING_DIVIDED, ClusterPreferences, ClusterPropagationPolicy,
    Placement, PropagationSpec, ReplicaSchedulingStrategy, ResourceSelector)
for backend in ("device", "native", "serial"):
    cp = ControlPlane(backend=backend,
                      device="cpu" if backend == "device" else None)
    for i in range(3):
        cp.add_member(f"m{{i}}", cpu_milli=16_000 * (i + 1))
    cp.apply_policy(ClusterPropagationPolicy(
        metadata=ObjectMeta(name="all"),
        spec=PropagationSpec(
            resource_selectors=[ResourceSelector(api_version="apps/v1",
                                                 kind="Deployment")],
            placement=Placement(replica_scheduling=ReplicaSchedulingStrategy(
                replica_scheduling_type=REPLICA_SCHEDULING_DIVIDED,
                replica_division_preference=REPLICA_DIVISION_WEIGHTED,
                weight_preference=ClusterPreferences(
                    dynamic_weight=DYNAMIC_WEIGHT_AVAILABLE_REPLICAS))))))
    cp.apply({{"apiVersion": "v1", "kind": "Namespace",
               "metadata": {{"name": "team"}}}})
    for j in range(4):
        cp.apply({{"apiVersion": "apps/v1", "kind": "Deployment",
                   "metadata": {{"name": f"app-{{j}}", "namespace": "team"}},
                   "spec": {{"replicas": 3 + j, "template": {{"spec": {{
                       "containers": [{{"name": "c", "image": "nginx",
                           "resources": {{"requests": {{"cpu": "500m"}}}}}}]}}}}}}}})
    cp.tick()
    cp.tick()
    for j in range(4):
        t = cp.store.get("Deployment", "team", f"app-{{j}}")
        assert t.manifest["status"]["readyReplicas"] == 3 + j, t.manifest
        placed = sum(
            (m.get("Deployment", "team", f"app-{{j}}").manifest["spec"]
             ["replicas"])
            for m in cp.members.values()
            if m.get("Deployment", "team", f"app-{{j}}") is not None)
        assert placed == 3 + j
    assert all(m.get("Namespace", "", "team") for m in cp.members.values())
    assert cp.scheduler.faults() == {{}}
    assert not any(cp.runtime.reconcile_errors().values())
    assert cp.execution.sync_failures == 0
    assert cp.scheduler.cycle_log[-1]["backend"] == backend
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "karmada_tpu"))
print("LOADED", bad)
assert not bad, bad
"""


def test_control_plane_loop_loads_no_jax_subprocess():
    """The port's ControlPlane (detector -> scheduler -> Work -> members ->
    status) runs on every backend with neither jax nor the JAX package
    loaded."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, "-c", _LOOP.format(root=str(ROOT))],
        capture_output=True, text=True, timeout=300, env=env, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout


def test_control_plane_refuses_cpu_drift():
    """ControlPlane(backend="device") without device= schedules on the
    card; with no card it raises (the host backends need none)."""
    from karmada_tpu_torch.e2e import ControlPlane

    assert ControlPlane(device="cpu").scheduler.device.type == "cpu"
    assert ControlPlane(backend="serial").scheduler.device is None
    if torch.cuda.is_available():
        assert ControlPlane().scheduler.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ControlPlane()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ControlPlane(backend="device", rebalance=30.0)


_FAILOVER = r"""
import sys
sys.path.insert(0, {root!r})
from karmada_tpu_torch.e2e import ControlPlane
clock = {{"t": 1000.0}}
for backend in ("device", "native", "serial"):
    cp = ControlPlane(backend=backend, clock=lambda: clock["t"],
                      device="cpu" if backend == "device" else None,
                      feature_gates={{"FederatedQuotaEnforcement": True}})
    for i in range(3):
        cp.add_member(f"m{{i}}", cpu_milli=16_000)
    cp.add_member("pulled", cpu_milli=16_000, sync_mode="Pull")
    cp.apply({{"apiVersion": "policy.karmada.io/v1alpha1",
               "kind": "ClusterPropagationPolicy", "metadata": {{"name": "all"}},
               "spec": {{"resourceSelectors": [{{"apiVersion": "apps/v1",
                                                 "kind": "Deployment"}}],
                        "placement": {{"replicaScheduling": {{
                            "replicaSchedulingType": "Divided",
                            "replicaDivisionPreference": "Weighted",
                            "weightPreference": {{
                                "dynamicWeight": "AvailableReplicas"}}}}}}}}}})
    cp.apply({{"apiVersion": "policy.karmada.io/v1alpha1",
               "kind": "FederatedResourceQuota",
               "metadata": {{"name": "q", "namespace": "team"}},
               "spec": {{"overall": {{"cpu": "100"}}}}}})
    for j in range(4):
        cp.apply({{"apiVersion": "apps/v1", "kind": "Deployment",
                   "metadata": {{"name": f"app-{{j}}", "namespace": "team"}},
                   "spec": {{"replicas": 4, "template": {{"spec": {{
                       "containers": [{{"name": "c", "image": "nginx",
                           "resources": {{"requests": {{"cpu": "500m"}}}}}}]}}}}}}}})
    cp.tick()
    cp.member("m0").healthy = False
    cp.tick()
    assert cp.store.get("Cluster", "", "m0").spec.taints
    clock["t"] += 301.0
    for _ in range(3):
        cp.tick()
    for rb in cp.store.list("ResourceBinding", "team"):
        assert "m0" not in {{t.name for t in rb.spec.clusters}}, rb.spec
        assert sum(t.replicas for t in rb.spec.clusters) == 4
    cp.member("m0").healthy = True
    cp.unjoin("pulled")
    cp.tick()
    assert not cp.store.get("Cluster", "", "m0").spec.taints
    assert cp.store.try_get("Cluster", "", "pulled") is None
    assert cp.taint_manager.evicted > 0
    assert cp.scheduler.faults() == {{}}
    assert not any(cp.runtime.reconcile_errors().values())
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "karmada_tpu"))
print("LOADED", bad)
assert not bad, bad
"""


def test_failover_loop_loads_no_jax_subprocess():
    """The port's failover loop -- a member failing, its taint, the taint
    manager's paced evictions, recovery -- with typed applies, an enforced
    quota, a Pull member and an unjoin, on every backend, with neither jax
    nor the JAX package loaded."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, "-c", _FAILOVER.format(root=str(ROOT))],
        capture_output=True, text=True, timeout=300, env=env, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout
