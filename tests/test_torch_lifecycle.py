"""The device lifecycle of the port against the JAX package, on the CPU.

K14 probe_mm's and K15 marker_affine's plain versions against the JAX
programs they replace (the probe snippet's ``a @ a`` on seeded bf16
matrices of {-1, 0, 1}, where every partial sum is exact, and the
profiler's marker on ``arange(128)`` in the JAX config's integer dtype),
bit for bit; resolve_backend's serve policy case for case with injected
probes; the probe subprocess without a card; devprof's capture, memory
and cost surfaces; the warm hook's shapes, variants, labels and ledger;
the Scheduler's mid-serve guard on both ControlPlanes (a stuck device
cycle degrades to native with the batch scheduled in that cycle, equal
snapshots), its re-arm with the doubling cooldown, batch formation and
overload mode under an injected clock, the admission gate and detached
solves against the JAX Scheduler; persistence and leader election.

JAX is imported inside the tests that compare with it, so that the card
cases (marked `gpu`, skipped here inside the test) collect on a machine
without it:

    python -m pytest tests/test_torch_lifecycle.py -q -m gpu
"""

import importlib
import itertools
import random
import threading

import numpy as np
import pytest
import torch

import torch_scenarios as S
from torch_fixtures import collect_jax_planes  # noqa: F401 — autouse
from karmada_tpu_torch import native as PN
from karmada_tpu_torch.obs import devprof
from karmada_tpu_torch.ops import aotcache, kernels, probe
from karmada_tpu_torch.utils import deviceprobe

MP = S.models_of("karmada_tpu_torch")



@pytest.fixture
def uids(monkeypatch):
    """Both stores hand out uids from a counter (tests/test_torch_e2e.py's
    rule; both collectors write their heartbeat Leases in the same
    order)."""
    for name in ("karmada_tpu", "karmada_tpu_torch"):
        seq = itertools.count(1)
        monkeypatch.setattr(importlib.import_module(f"{name}.store.store"),
                            "new_uid", lambda seq=seq: f"uid-{next(seq):06d}")


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels run only on the card)")


def _ternary_bf16(n, seed):
    """A seeded n x n matrix of {-1, 0, 1}: every fp32 partial sum of its
    square is an exact integer, whatever the summation order."""
    return np.random.default_rng(seed).integers(-1, 2, (n, n)).astype(
        np.float32)


def _bf16_bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int16).numpy()


# -- K14 / K15 plain versions against the JAX programs ------------------------

@pytest.mark.parametrize("n", [8, 128])
def test_probe_mm_plain_matches_jax(n):
    import jax
    import jax.numpy as jnp

    a = _ternary_bf16(n, seed=n)
    want = jax.jit(lambda x: x @ x)(jnp.asarray(a, jnp.bfloat16))
    assert want.dtype == jnp.bfloat16
    want_bits = np.asarray(want).view(np.int16)
    got = probe.probe_mm(torch.from_numpy(a).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (n, n)
    np.testing.assert_array_equal(_bf16_bits(got), want_bits)
    ones = probe.probe_mm(torch.ones((128, 128), dtype=torch.bfloat16))
    assert bool((ones.float() == 128).all())


def test_marker_affine_plain_matches_jax():
    import jax
    import jax.numpy as jnp

    from karmada_tpu.obs import devprof as jax_devprof  # noqa: F401
    from karmada_tpu.ops import solver as _jax_solver  # noqa: F401 — x64

    want = jax.jit(lambda a: a * 2 + 1)(jnp.arange(128))
    dtype = torch.int64 if jax.config.x64_enabled else torch.int32
    assert str(want.dtype) == str(dtype).replace("torch.", "")
    got = probe.marker_affine(torch.arange(128, dtype=dtype))
    assert got.dtype == dtype
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # capture_profile's marker input is torch.arange(128): the same dtype
    assert torch.arange(128).dtype == dtype
    wrap = torch.tensor([2**62, -(2**63), 2**63 - 1], dtype=torch.int64)
    assert probe.marker_affine(wrap).tolist() == [
        -(2**63) + 1, 1, -1]


def test_kernels_registered():
    assert "probe" in kernels.SOURCES
    assert kernels.ENTRIES["probe"] == ("probe_mm", "marker_affine")
    assert {"probe_mm", "marker_affine"} <= set(kernels.KERNELS)
    assert set(kernels.LAUNCHES) == set(kernels.KERNELS)
    src = (kernels.CSRC / "probe.cu").read_text()
    assert "kt_probe_mm" in src and "kt_marker_affine" in src
    assert "cublas" not in src.lower()


# -- resolve_backend: the serve policy, case for case -------------------------

def _probe_of(ok, platform):
    calls = []

    def p(timeout_s):
        calls.append(timeout_s)
        return {"ok": ok, "platform": platform,
                "attempts": [{"ok": ok, "s": 0.1}]}
    p.calls = calls
    return p


POLICY_CASES = [
    # (requested, probe ok, platform, native toolchain)
    ("native", True, "tpu", True),
    ("serial", True, "tpu", True),
    ("device", True, "tpu", True),
    ("device", True, "TPU v4", True),
    ("device", True, "gpu", True),
    ("device", True, "cuda", True),
    ("device", False, None, True),
    ("device", True, "cpu", True),
    ("device", False, None, False),
    ("device", True, "cpu", False),
]


@pytest.mark.parametrize("requested,ok,platform,toolchain", POLICY_CASES)
def test_resolve_backend_policy_matches_jax(monkeypatch, requested, ok,
                                           platform, toolchain):
    from karmada_tpu import native as JN
    from karmada_tpu.utils import deviceprobe as jax_deviceprobe

    if not toolchain:
        monkeypatch.setattr(JN, "available", lambda: False)
        monkeypatch.setattr(PN, "available", lambda: False)
    out = []
    for mod in (jax_deviceprobe, deviceprobe):
        p = _probe_of(ok, platform)
        backend, diag = mod.resolve_backend(requested, probe=p)
        out.append((backend, "degraded" in diag, len(p.calls),
                    diag.get("degraded", "").split("rerouting to ")[-1]))
    assert out[0] == out[1]
    if requested != "device":
        assert out[1] == (requested, False, 0, "")
    if not ok:
        assert out[1][0] == ("native" if toolchain else "serial")
    assert deviceprobe.last_probe()["probed"] or requested != "device"


def test_probe_without_a_card_fails_and_never_answers_cpu():
    before = deviceprobe.last_probe()["consecutive_failures"]
    diag = deviceprobe.probe_backend(timeout_s=120)
    assert diag["ok"] is False and diag["platform"] is None
    assert "no CUDA device" in diag["attempts"][-1]["err"]
    last = deviceprobe.last_probe()
    assert last["probed"] and last["ok"] is False
    assert last["consecutive_failures"] == before + 1
    diag = deviceprobe.probe_backend(timeout_s=0.01)
    assert diag["ok"] is False and "timed out" in diag["attempts"][-1]["err"]


def test_probe_snippet_launches_k14_not_a_library_matmul():
    snippet = deviceprobe._PROBE_SNIPPET  # noqa: SLF001
    assert "probe.probe_mm(" in snippet and "kernels.build()" in snippet
    assert "@" not in snippet.replace("'cuda:", "")
    assert "jax" not in snippet.replace("karmada", "")
    for key in ("PLATFORM=gpu", "NDEV=", "MEMSTATS=", "bytes_in_use",
                "peak_bytes_in_use", "bytes_limit"):
        assert key in snippet


# -- devprof ------------------------------------------------------------------

def test_capture_profile_cpu_window(tmp_path):
    devprof.reset_for_tests()
    rec = devprof.capture_profile(0.0, str(tmp_path), device="cpu")
    assert rec["ok"], rec
    assert [f["path"] for f in rec["files"]] == [devprof.TRACE_FILE]
    assert rec["total_bytes"] > 0
    trace = (tmp_path / rec["dir"].split("/")[-1] / devprof.TRACE_FILE)
    assert "marker_affine" in trace.read_text()
    assert devprof.state_payload()["last_capture"] == rec
    # a CPU window holds the plain version's ops and no device kernel
    assert rec["markers"] == 1 and rec["seconds"] == 0.0
    assert rec["device_kernels"] == rec["marker_kernels"] == 0


def test_trace_kernels_reads_device_events(tmp_path):
    import json

    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": [
        {"cat": "user_annotation", "name": "marker_affine"},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel"},
        {"cat": "kernel", "name": "marker_affine_i64"},
        {"cat": "kernel", "name": "schedule_rows_prepare"}]}))
    assert devprof._trace_kernels(str(p)) == [  # noqa: SLF001
        "marker_affine_i64", "schedule_rows_prepare"]


def test_capture_profile_gate_and_cap(tmp_path, monkeypatch):
    assert devprof._CAPTURE_GATE.acquire(blocking=False)  # noqa: SLF001
    try:
        busy = devprof.capture_profile(0.0, str(tmp_path), device="cpu")
    finally:
        devprof._CAPTURE_GATE.release()  # noqa: SLF001
    assert busy["busy"] and not busy["ok"]
    slept = []
    monkeypatch.setattr(devprof.time, "sleep", slept.append)
    rec = devprof.capture_profile(1e9, str(tmp_path), device="cpu")
    assert rec["ok"] and rec["seconds"] == devprof.MAX_CAPTURE_S
    assert slept and max(slept) <= devprof.MAX_CAPTURE_S
    assert rec["markers"] == devprof.MAX_CAPTURE_S / devprof.MARKER_EVERY_S
    # no card: answered as the outcome, never raised
    if not torch.cuda.is_available():
        bad = devprof.capture_profile(0.0, str(tmp_path))
        assert bad["ok"] is False and "CUDA" in bad["error"]


def test_memory_and_cost_surfaces():
    devprof.reset_for_tests()
    assert devprof.memory_stats_payload([]) == []
    assert devprof.refresh_memory_gauges([]) == 0
    mem = devprof.state_payload()["last_memory"]
    assert mem["devices"] == [] and mem["rss_bytes"] > 0
    devprof.record_cost("B8xC4:plain", {"device_ms": 0.25})
    devprof.record_cost("B8xC4:carry", None)
    assert devprof.cost_ledger() == {"B8xC4:plain": {"device_ms": 0.25}}
    devprof.reset_for_tests()
    assert devprof.state_payload() == {"costs": {}, "last_memory": None,
                                       "last_capture": None}


# -- the warm hook --------------------------------------------------------------

def test_warm_shapes_and_variants_match_jax():
    from karmada_tpu.ops import aotcache as JA

    for window in (1, 7, 8, 9, 100, 1000, 1024, 4096, 5000):
        for chunk in (1, 8, 64, 1000, 1024, 4096):
            assert aotcache.warm_shapes(window, chunk) == \
                JA.warm_shapes(window, chunk)
    for rate, multi, fused, sl in itertools.product(
            (0.0, 0.1, 1.0), (False, True), (False, True), (False, True)):
        want = tuple(v for v in JA.variants_for(rate, multi, fused, sl)
                     if v in aotcache.PORT_VARIANTS)
        assert aotcache.variants_for(rate, multi, fused, sl) == want
    spec, _ = aotcache.synth_items(3)[2]
    jspec, _ = JA.synth_items(3)[2]
    assert (spec.resource.name, spec.replicas,
            spec.placement.replica_scheduling.replica_scheduling_type) == (
        jspec.resource.name, jspec.replicas,
        jspec.placement.replica_scheduling.replica_scheduling_type)


def test_warm_executables_ledger_on_cpu():
    from karmada_tpu_torch.estimator.general import GeneralEstimator

    aotcache.reset_for_tests()
    fleet = S.control_fleet(MP, random.Random(5), 12)
    variants = aotcache.ALL_VARIANTS + (aotcache.VARIANT_SHORTLIST,
                                        aotcache.VARIANT_FUSED)
    kw = dict(shapes=(8, 9, 16), variants=variants, waves=4, shortlist_k=4,
              device="cpu")
    first = aotcache.warm_executables(fleet, GeneralEstimator(), **kw)
    labels = sorted(k for k in first if k != "_totals")
    assert labels == sorted(
        [f"B{b}xC16:{v}" for b in (8, 16) for v in (
            "plain", "explain", "carry", "donated")]
        + [f"B{b}xC16:k4:shortlist" for b in (8, 16)]
        + [f"B{b}xS64:fused" for b in (8, 16)])
    ledger = aotcache.state_payload()["warmup"]
    for label in labels:
        port = label.split(":")[-1] in aotcache.PORT_VARIANTS
        assert ledger[label]["state"] == ("done" if port else "skipped")
    assert first["B8xC16:plain"] == "already-warm" or \
        isinstance(first["B8xC16:plain"], dict)
    assert first["_totals"]["warmed"] == 8
    second = aotcache.warm_executables(fleet, GeneralEstimator(), **kw)
    for label in labels:
        if label.split(":")[-1] in aotcache.PORT_VARIANTS:
            assert second[label] == "already-warm"
    cancelled = threading.Event()
    cancelled.set()
    aotcache.reset_for_tests()
    assert aotcache.warm_executables(fleet, GeneralEstimator(),
                                     cancelled=cancelled,
                                     **kw)["_totals"]["warmed"] == 0
    t = aotcache.start_background_warmup(
        lambda: fleet, GeneralEstimator(), shapes=(8,),
        variants=("plain",), waves=4, device="cpu")
    t.join(60)
    assert aotcache.state_payload()["warmup_thread"] == "done"
    st = aotcache.enable()
    assert st["armed"] and st["key"] == kernels.digest()
    aotcache.reset_for_tests()


# -- the mid-serve guard on both ControlPlanes ----------------------------------

class _Stuck:
    """A `_solve_device` that hangs on the calls `plan` marks (a dead
    card's launch never returns), then -- once released -- runs the real
    one, which sees the guard's event set."""

    def __init__(self, orig, plan):
        self.orig, self.plan, self.calls = orig, list(plan), 0
        self.release = threading.Event()

    def install(self, monkeypatch, cls):
        stuck = self

        def solve(sched, items, clusters, *a, **kw):
            stuck.calls += 1
            if stuck.plan and stuck.plan.pop(0):
                stuck.release.wait(30)
            return stuck.orig(sched, items, clusters, *a, **kw)
        monkeypatch.setattr(cls, "_solve_device", solve)


def _planes(**kw):
    """tests/test_torch_e2e.py's helpers, and a JAX and a port
    ControlPlane on the device backend (the port's on the CPU)."""
    import test_torch_e2e as E

    return E, (E.MJ.ControlPlane(backend="device",
                                 controllers=E.JAX_CONTROLLERS, **kw),
               E.MP.ControlPlane(backend="device", device="cpu", **kw))


def test_hung_device_cycle_degrades_both_planes(uids, monkeypatch, capsys):
    from karmada_tpu.scheduler import service as jsvc
    from karmada_tpu_torch.scheduler import service as psvc

    E, cps = _planes(device_cycle_timeout_s=0.3)
    stucks = []
    for cp, mod in zip(cps, (jsvc, psvc)):
        cp.add_member("m1", cpu_milli=64_000)
        cp.tick()
        st = _Stuck(mod.Scheduler._solve_device, [True])
        st.install(monkeypatch, mod.Scheduler)
        stucks.append(st)
    for cp, M in zip(cps, (E.MJ, E.MP)):
        cp.apply_policy(E.policy(M))
        cp.apply(E.nginx(replicas=2))
        cp.tick()
    for st in stucks:
        st.release.set()
    err = capsys.readouterr().err
    assert err.count("degrading the scheduler to backend=native") == 2
    for cp in cps:
        assert cp.scheduler.backend == "native"
        rb = cp.store.get("ResourceBinding", "default", "nginx-deployment")
        assert rb.spec.clusters, "the degraded cycle still schedules"
    E.assert_same(E.snapshot(cps[0]), E.snapshot(cps[1]))
    port = cps[1].scheduler
    assert port.backend_transitions() == {"degraded_to_native": 1,
                                          "degraded_to_serial": 0,
                                          "rearmed": 0}
    assert port.join_abandoned(10)
    (ab,) = port.abandoned_cycles()
    assert ab["running"] is False and ab["error"] is None
    assert ab["cancelled"] is True and ab["chunks"] == 0
    assert {c["backend"] for c in port.cycle_log} == {"native"}
    assert {c["chunks"] for c in port.cycle_log} == {0}


def test_rearm_with_doubling_cooldown_matches_jax(uids, monkeypatch, capsys):
    """recover_cycles=1 and the device hanging on its first three tries:
    degrade, re-arm after 1 cycle, hang, re-arm after 2, hang, re-arm
    after 4, succeed -- the same backend after each tick, the same
    transitions and equal snapshots on both planes."""
    from karmada_tpu.scheduler import metrics as jmetrics
    from karmada_tpu.scheduler import service as jsvc
    from karmada_tpu_torch.scheduler import service as psvc

    E, cps = _planes(device_cycle_timeout_s=None, device_recover_cycles=1)
    d0 = jmetrics.BACKEND_DEGRADED.total()
    r0 = jmetrics.BACKEND_REARMED.value(backend="device")
    seqs, stucks = [], []
    for cp, mod, M in zip(cps, (jsvc, psvc), (E.MJ, E.MP)):
        cp.add_member("m1", cpu_milli=64_000)
        cp.add_member("m2", cpu_milli=32_000)
        cp.tick()
        cp.apply_policy(E.policy(M))
        cp.apply(dict(E.nginx(replicas=2),
                      metadata={"name": "warm", "namespace": "default"}))
        cp.tick()  # unguarded: the JAX side pays its compile here
        cp.scheduler.device_cycle_timeout_s = 0.2
        st = _Stuck(mod.Scheduler._solve_device, [True, True, True, False])
        st.install(monkeypatch, mod.Scheduler)
        stucks.append(st)
        seq = []
        for i in range(8):
            cp.apply(dict(E.nginx(replicas=1 + i % 3),
                          metadata={"name": f"app{i}",
                                    "namespace": "default"}))
            cp.tick()
            seq.append(cp.scheduler.backend)
        seqs.append(seq)
    for st in stucks:
        st.release.set()
    # a tick runs a few cycles (a binding is scheduled, then picked up
    # again after its status moves), so the cooldowns end mid-sequence
    assert seqs[0] == seqs[1] and seqs[1][0] == seqs[1][1] == "native"
    assert seqs[1][-1] == "device"
    assert stucks[0].calls == stucks[1].calls
    assert jmetrics.BACKEND_DEGRADED.total() == d0 + 3
    assert jmetrics.BACKEND_REARMED.value(backend="device") == r0 + 3
    assert cps[1].scheduler.backend_transitions() == {
        "degraded_to_native": 3, "degraded_to_serial": 0, "rearmed": 3}
    err = capsys.readouterr().err
    for n in (1, 2, 4):
        assert err.count(f"for ~{n} cycle(s)") == 2
    E.assert_same(E.snapshot(cps[0]), E.snapshot(cps[1]))
    assert cps[1].scheduler.join_abandoned(10)
    assert all(a["cancelled"] and a["chunks"] == 0
               for a in cps[1].scheduler.abandoned_cycles())


class _Hold:
    """Holds the guarded cycle's thread, once, at one point of its device
    cycle (`where`): right after solver.dispatch_compact returned (its
    chunk's rows are on the card), inside finalize past its last gate
    (tensors.decode_compact), or after run_pipeline returned (before the
    serial rows).  The hold ends on `release`."""

    def __init__(self, where):
        self.where = where
        self.reached, self.release = threading.Event(), threading.Event()
        self._armed = True

    def _hold(self):
        if self._armed and threading.current_thread().name == \
                "scheduler-device-cycle":
            self._armed = False
            self.reached.set()
            self.release.wait(60)

    def install(self, monkeypatch):
        from karmada_tpu_torch.ops import solver, tensors
        from karmada_tpu_torch.scheduler import core

        target = {"dispatch": (solver, "dispatch_compact"),
                  "finalize": (tensors, "decode_compact"),
                  "serial": (core, "run_pipeline")}[self.where]
        orig = getattr(*target)
        hold = self

        def held(*a, **kw):
            if hold.where == "finalize":
                hold._hold()
            out = orig(*a, **kw)
            if hold.where != "finalize":
                hold._hold()
            return out
        monkeypatch.setattr(*target, held)


def _zombie_plane(dev, backends=None):
    """A port ControlPlane on `dev` with two members and the explain
    plane on, its device path warmed by one unguarded cycle.  `backends`
    (the reference run) names each cycle's backend in turn, set after
    each cycle is logged, with no guard."""
    import test_torch_e2e as E

    cp = E.MP.ControlPlane(backend="device", device=dev, explain=1.0,
                           device_recover_cycles=1)
    cp.add_member("m1", cpu_milli=64_000)
    cp.add_member("m2", cpu_milli=32_000)
    cp.tick()
    cp.apply_policy(E.policy(E.MP))
    sched = cp.scheduler
    if backends is not None:
        seq = iter(backends[1:])
        log_cycle = sched._log_cycle

        def log_then_next(*a):
            log_cycle(*a)
            sched.backend = next(seq, sched.backend)
        sched._log_cycle = log_then_next
    cp.apply(dict(E.nginx(replicas=2),
                  metadata={"name": "warm", "namespace": "default"}))
    cp.tick()
    return E, cp


def _zombie_run(E, cp, on_wave=None):
    for wave in range(3):
        if on_wave is not None:
            on_wave(wave)
        for i in range(3):
            cp.apply(dict(E.nginx(replicas=1 + (wave + i) % 4),
                          metadata={"name": f"w{wave}-{i}",
                                    "namespace": "default"}))
        cp.tick()


@pytest.mark.parametrize("dev", ["cpu", pytest.param(
    "cuda", marks=pytest.mark.gpu)])
@pytest.mark.parametrize("where", ["dispatch", "finalize", "serial"])
def test_held_zombie_beside_the_rearmed_cycle(uids, monkeypatch, capsys,
                                              where, dev):
    """The abandoned cycle's thread is held mid-cycle (_Hold) while the
    Scheduler degrades to native, re-arms and runs device cycles beside
    it; released, it ends cancelled.  The snapshot and the recorded
    decisions equal an unguarded run's that takes the same backend cycle
    by cycle: the zombie wrote nothing the live cycles read."""
    if dev == "cuda":
        _card()
    E, cp = _zombie_plane(dev)
    sched = cp.scheduler
    hold = _Hold(where)
    degrade = sched._degrade_device

    def degrade_then_raise():
        degrade()
        sched.device_cycle_timeout_s = 60.0  # the re-armed cycles finish
    sched._degrade_device = degrade_then_raise
    beside = []

    def on_wave(wave):
        if wave == 0:
            sched.device_cycle_timeout_s = 0.5
            hold.install(monkeypatch)
        else:
            beside.append(sched.abandoned_cycles()[0]["running"])
    _zombie_run(E, cp, on_wave)
    assert hold.reached.is_set()
    cycles = list(sched.cycle_log)
    backends = [c["backend"] for c in cycles]
    held_device = [c for c in cycles[backends.index("native") + 1:]
                   if c["backend"] == "device" and c["chunks"] >= 1]
    assert sched.abandoned_cycles()[0]["running"], "the zombie still held"
    hold.release.set()
    assert sched.join_abandoned(30)
    (ab,) = sched.abandoned_cycles()
    assert ab["cancelled"] is True and ab["error"] is None
    assert beside == [True, True] and held_device
    assert sched.backend_transitions() == {
        "degraded_to_native": 1, "degraded_to_serial": 0, "rearmed": 1}
    first = backends.index("native")  # the abandoned cycle's batch
    assert set(backends[:first]) == {"device"} and first >= 1
    assert "degrading the scheduler to backend=native" in \
        capsys.readouterr().err
    monkeypatch.undo()
    E2, ref = _zombie_plane(dev, backends)
    _zombie_run(E2, ref)
    assert [c["backend"] for c in ref.scheduler.cycle_log] == backends
    E.assert_same(E.snapshot(cp), E.snapshot(ref))

    def decisions(s):
        return [(d["key"], d["outcome"], d.get("backend"))
                for d in s.decisions.recent()]
    assert decisions(sched) == decisions(ref.scheduler)
    # one decision a binding of each device cycle (the native control
    # records none for the rows it places), none of the zombie's
    assert len(decisions(sched)) == sum(
        c["bindings"] for c in cycles if c["backend"] == "device")


# -- batch formation, overload, admission, detached ----------------------------

def _slices(clock, **kw):
    """A JAX and a port Scheduler (backend serial) over twin stores."""
    out = []
    for pkg in ("karmada_tpu", "karmada_tpu_torch"):
        st = importlib.import_module(f"{pkg}.store.store")
        wk = importlib.import_module(f"{pkg}.store.worker")
        qu = importlib.import_module(f"{pkg}.scheduler.queue")
        svc = importlib.import_module(f"{pkg}.scheduler.service")
        store, rt = st.ObjectStore(), wk.Runtime()
        queue = (qu.SchedulingQueue(now=clock,
                                    max_resident=kw.pop("max_resident"))
                 if "max_resident" in kw else
                 qu.SchedulingQueue(now=clock))
        sched = svc.Scheduler(store, rt, backend="serial", queue=queue,
                              **kw)
        M = S.models_of(pkg)
        for c in S.control_fleet(M, random.Random(1), 6):
            store.create(c)
        out.append((M, store, rt, sched))
    return out


def test_batch_cut_sequence_matches_jax(uids):
    clock = S.FakeClock()
    sides = _slices(clock, batch_window=4, batch_deadline_s=2.0)
    seqs = [[], []]
    rbs = [S.control_bindings(M, random.Random(2), 12,
                              S.control_placements(M, random.Random(3), [
                                  c.name for c in store.list("Cluster")]))
           for M, store, _rt, _s in sides]

    def step(create, advance=0.0):
        clock.advance(advance)
        for k, (M, store, rt, sched) in enumerate(sides):
            for rb in create[k]:
                store.create(rb)
            n0 = _scheduled(store)
            rt.tick()
            with sched._queue_lock:  # noqa: SLF001
                ready = sched._batch_ready_locked()  # noqa: SLF001
            seqs[k].append((_scheduled(store) - n0, ready))

    step([r[:1] for r in rbs])              # one binding: deferred
    step([r[1:2] for r in rbs], 1.0)        # two, the oldest 1 s old
    step([[], []], 1.0)                     # the oldest reaches 2 s: cut
    step([r[2:6] for r in rbs])             # a full window: cut at once
    step([r[6:9] for r in rbs], 0.5)        # three: deferred
    step([[], []], 2.0)                     # deadline: cut
    step([r[9:12] for r in rbs], 2.5)       # past the deadline at once
    assert seqs[0] == seqs[1]
    # deferred, deferred, the deadline cut, a full window at once; then
    # the window fills with the earlier cycles' backoff retries
    assert [s for s, _ in seqs[1]] == [0, 0, 2, 4, 2, 1, 3]
    for _M, _store, _rt, sched in sides:
        assert sched.queue_state()["empty_cuts"] == 0
        with sched._queue_lock:  # noqa: SLF001
            if sched._cut_timer is not None:  # noqa: SLF001
                sched._cut_timer.cancel()  # noqa: SLF001


def _scheduled(store):
    return sum(1 for rb in store.list("ResourceBinding")
               if any(c.type == "Scheduled" for c in rb.status.conditions))


def test_overload_enter_exit_matches_jax():
    from karmada_tpu_torch.obs.decisions import DecisionRecorder

    clock = S.FakeClock()
    sides = _slices(clock, batch_window=4, batch_deadline_s=1.0)
    states = [[], []]
    for k, (_M, _store, _rt, sched) in enumerate(sides):
        if k == 0:
            # the JAX explain plane armed by hand: its Scheduler(explain=)
            # arms a process-wide recorder
            sched.explain, sched._decisions = 1.0, object()  # noqa: SLF001
        else:
            sched.explain, sched.decisions = 1.0, DecisionRecorder()
        out = states[k]
        out.append(sched._explain_sample() is not None)  # noqa: SLF001
        for dwells, popped, after in (
                ([0.5, 0.6, 3.0, 3.5], 4, 9),   # enter
                ([], 0, 3),                      # a deferred no-cut
                ([4.0, 4.1], 2, 9),              # a sub-window cut: exit
                ([3.0, 3.5, 4.0, 4.5], 4, 9),    # enter
                ([4.0, 4.1, 4.2, 4.3], 4, 0),    # the backlog drained: exit
                ([3.0, 3.5, 4.0, 4.5], 4, 9),    # enter
                ([0.1, 0.2], 4, 9)):             # p95 under the deadline
            sched._update_overload(dwells, popped=popped,  # noqa: SLF001
                                   active_after=after)
            out.append((sched._overload,  # noqa: SLF001
                        sched._explain_sample() is not None))  # noqa: SLF001
        sched._update_overload([3.0, 3.5, 4.0, 4.5], popped=4,  # noqa: SLF001
                               active_after=9)
        with sched._queue_lock:  # noqa: SLF001
            sched.queue.push(("ns", "a"))
            clock.advance(2.0)  # past 1x the deadline, short of 4x
            out.append(sched._batch_ready_locked())  # noqa: SLF001
            clock.advance(2.5)
            out.append(sched._batch_ready_locked())  # noqa: SLF001
            sched.queue.pop_ready(4)
    assert states[0] == states[1]
    assert states[1][:4] == [True, (True, False), (True, False),
                             (False, True)]
    assert states[1][-2:] == [False, True]


def test_admission_limit_sheds_like_jax():
    clock = S.FakeClock()
    out = []
    for pkg in ("karmada_tpu", "karmada_tpu_torch"):
        st = importlib.import_module(f"{pkg}.store.store")
        wk = importlib.import_module(f"{pkg}.store.worker")
        svc = importlib.import_module(f"{pkg}.scheduler.service")
        sched = svc.Scheduler(st.ObjectStore(), wk.Runtime(),
                              backend="serial", admission_limit=3)
        q = sched.queue
        assert q.max_resident == 3
        got = [q.push(("ns", f"b{i}"), p)
               for i, p in enumerate((0, 5, 0, 9, 1, 0, 7))]
        got.append(q.push(("ns", "b0"), 0, gate_exempt=True))
        got.append(sorted(k for k in (("ns", f"b{i}") for i in range(7))
                          if q.has(k)))
        got.append(q.depths())
        out.append(got)
    assert out[0] == out[1]
    assert len(out[1][-2]) <= 4


def test_detached_solve_touches_nothing_live(uids):
    """solve_batch(detached=True): no guard (a guard this short would
    degrade any guarded cycle), no resident advance, the delta window left
    for the live cycle -- and the outcomes the JAX Scheduler's detached
    solve gives."""
    from karmada_tpu.scheduler import service as jsvc
    from karmada_tpu.store import store as jst
    from karmada_tpu.store import worker as jwk
    from karmada_tpu_torch.scheduler import Scheduler
    from karmada_tpu_torch.store import ObjectStore, Runtime

    MJ = S.models_of("karmada_tpu")
    res = []
    for M, store, rt in ((MJ, jst.ObjectStore(), jwk.Runtime()),
                         (MP, ObjectStore(), Runtime())):
        fleet = S.control_fleet(M, random.Random(7), 8)
        for c in fleet:
            store.create(c)
        rbs = S.control_bindings(M, random.Random(8), 24,
                                 S.control_placements(
                                     M, random.Random(9),
                                     [c.name for c in fleet]))
        if M is MP:
            sched = Scheduler(store, rt, device="cpu", resident=True,
                              device_cycle_timeout_s=1e-6)
            # a window for the next live cycle
            store.mutate("Cluster", "", fleet[0].name,
                         lambda c: c.metadata.labels.update(x="y"))
            tracker = sched._delta_tracker  # noqa: SLF001
            res_before = sched.resident_state()
            pending = (tracker._structural,  # noqa: SLF001
                       dict(tracker._clusters))  # noqa: SLF001
            assert pending != (None, {})
        else:
            sched = jsvc.Scheduler(store, rt, backend="device")
        out, names = sched.solve_batch(rbs, store.list("Cluster"),
                                       detached=True)
        res.append(({i: _outcome(r) for i, r in out.items()}, names))
        if M is MP:
            assert sched.backend == "device"
            assert sched.backend_transitions()["degraded_to_native"] == 0
            assert sched.resident_state() == res_before
            assert sched._delta_tracker is tracker  # noqa: SLF001
            assert (tracker._structural,  # noqa: SLF001
                    tracker._clusters) == pending  # noqa: SLF001
            assert not sched.cycle_log and not sched.abandoned_cycles()
    assert res[0] == res[1]


def _outcome(r):
    if isinstance(r, Exception):
        return type(r).__name__
    return sorted((t.name, t.replicas) for t in r)


# -- persistence and leader election --------------------------------------------

def _dup_policy():
    return MP.PropagationPolicy(
        metadata=MP.ObjectMeta(name="pp", namespace="default"),
        spec=MP.PropagationSpec(
            resource_selectors=[MP.ResourceSelector(api_version="apps/v1",
                                                    kind="Deployment")],
            placement=MP.Placement(replica_scheduling=(
                MP.ReplicaSchedulingStrategy(
                    replica_scheduling_type=MP.REPLICA_SCHEDULING_DUPLICATED)
            ))))


def _nginx():
    return {"apiVersion": "apps/v1", "kind": "Deployment",
            "metadata": {"name": "nginx", "namespace": "default"},
            "spec": {"replicas": 2}}


def test_persist_dir_round_trip(tmp_path):
    from karmada_tpu_torch.e2e import ControlPlane
    from karmada_tpu_torch.store.persistence import load_store

    d = str(tmp_path / "cp")
    cp = ControlPlane(backend="serial", persist_dir=d)
    cp.add_member("m1")
    cp.add_member("m2")
    cp.tick()
    cp.store.create(_dup_policy())
    cp.apply(_nginx())
    cp.tick()
    rb1 = cp.store.get("ResourceBinding", "default", "nginx-deployment")
    assert len(rb1.spec.clusters) == 2
    objs = {(o.KIND, o.namespace, o.name): o for o in cp.store.items()}
    rv = cp.store.revision
    cp.checkpoint()
    cp.store.delete("Deployment", "default", "nginx")  # lands in the WAL
    cp.store.persistence.close()
    del cp

    back = load_store(d)
    assert back.try_get("Deployment", "default", "nginx") is None
    assert back.revision >= rv
    back.persistence.close()
    # a torn tail write is discarded
    with open(f"{d}/store.wal", "ab") as f:
        f.write(b"\x40\x00\x00\x00partial")
    cp2 = ControlPlane(backend="serial", persist_dir=d)
    for name in ("m1", "m2"):
        cp2.add_member(name)
    cp2.tick()
    rb2 = cp2.store.get("ResourceBinding", "default", "nginx-deployment")
    assert {t.name for t in rb2.spec.clusters} == {
        t.name for t in rb1.spec.clusters}
    assert objs[("PropagationPolicy", "default", "pp")].spec == \
        cp2.store.get("PropagationPolicy", "default", "pp").spec
    cp2.apply(_nginx())
    cp2.tick()
    assert cp2.members["m1"].get("Deployment", "default", "nginx") \
        is not None
    cp2.store.persistence.close()


def test_leader_election_and_standby_takeover():
    from karmada_tpu_torch.e2e import ControlPlane
    from karmada_tpu_torch.scheduler import Scheduler
    from karmada_tpu_torch.store import ObjectStore, Runtime
    from karmada_tpu_torch.utils.leaderelection import LeaderElector

    clock = S.FakeClock()
    store = ObjectStore()
    a = LeaderElector(store, "s", "a", lease_duration_s=10, clock=clock)
    b = LeaderElector(store, "s", "b", lease_duration_s=10, clock=clock)
    assert a.tick() and not b.tick()
    clock.advance(5)
    assert a.tick()
    clock.advance(8)
    assert not b.tick()
    clock.advance(11)
    assert b.tick() and not a.tick()
    b.release()
    assert a.tick()

    cp = ControlPlane(backend="serial", clock=clock)
    cp.scheduler.elector = LeaderElector(
        cp.store, "scheduler", "replica-1", lease_duration_s=10, clock=clock)
    standby_rt = Runtime()
    standby = Scheduler(cp.store, standby_rt, backend="serial",
                        elector=LeaderElector(cp.store, "scheduler",
                                              "replica-2",
                                              lease_duration_s=10,
                                              clock=clock))
    cp.add_member("m1", cpu_milli=64_000)
    cp.tick()
    standby_rt.tick()
    cp.store.create(_dup_policy())
    cp.apply({"apiVersion": "apps/v1", "kind": "Deployment",
              "metadata": {"name": "web", "namespace": "default"},
              "spec": {"replicas": 2}})
    cp.tick()
    standby_rt.tick()
    assert cp.store.get("ResourceBinding", "default",
                        "web-deployment").spec.clusters
    cp.apply({"apiVersion": "apps/v1", "kind": "Deployment",
              "metadata": {"name": "web2", "namespace": "default"},
              "spec": {"replicas": 2}})
    cp.scheduler.elector._leading = False  # noqa: SLF001 — a crash
    cp.scheduler.elector.tick = lambda: False
    clock.advance(11)
    cp.tick()
    standby_rt.tick()
    assert cp.store.get("ResourceBinding", "default",
                        "web2-deployment").spec.clusters
    assert standby.elector.is_leader()


# -- on the card ------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("n", [8, 128, 1000, 1024])
def test_probe_mm_on_card(n):
    _card()
    a = torch.from_numpy(_ternary_bf16(n, seed=n)).to(torch.bfloat16)
    dev = a.cuda()
    kernels.reset_counts()
    got = probe.probe_mm(dev)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["probe_mm"] == 1
    np.testing.assert_array_equal(_bf16_bits(got.cpu()),
                                  _bf16_bits(probe.probe_mm_plain(a)))
    with pytest.raises(TypeError):
        probe.probe_mm(dev.float())


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 127, 128, 1 << 20, (1 << 20) + 3])
@pytest.mark.parametrize("offset", [0, 1])
def test_marker_affine_on_card(n, offset):
    """K15 bit for bit on any length (the scalar tail), the int64 edges
    first, from a view `offset` elements into its card buffer (offset 1:
    8 bytes off a 16-byte boundary, the scalar head)."""
    _card()
    info = torch.iinfo(torch.int64)
    a = torch.from_numpy(np.random.default_rng(n).integers(
        info.min, info.max, n, dtype=np.int64))
    a[:3] = torch.tensor([info.min, info.max, -1])[:n]
    buf = torch.empty(n + offset, dtype=torch.int64, device="cuda")
    buf[offset:].copy_(a)
    dev = buf[offset:]
    assert (dev.data_ptr() % 16 == 8) == (offset == 1)
    got = probe.marker_affine(dev)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), probe.marker_affine_plain(a))
    with pytest.raises(TypeError):
        probe.marker_affine(dev.int())


@pytest.mark.gpu
def test_probe_backend_and_capture_on_card(tmp_path):
    _card()
    diag = deviceprobe.probe_backend(timeout_s=600)
    n = torch.cuda.device_count()
    assert diag["ok"] and diag["platform"] == "gpu", diag
    assert diag["device_count"] == n
    assert diag["launches"] == {"probe_mm": n}
    assert all(m["memory_stats"]["bytes_limit"] > 0
               for m in diag["memory_stats"])
    assert deviceprobe.resolve_backend("device")[0] == "device"
    rec = devprof.capture_profile(0.2, str(tmp_path))
    assert rec["ok"], rec
    assert rec["seconds"] == devprof.MIN_DEVICE_WINDOW_S
    assert 1 <= rec["marker_kernels"] <= rec["markers"]
    trace = tmp_path / rec["dir"].split("/")[-1] / devprof.TRACE_FILE
    assert "marker_affine_i64" in trace.read_text()
