"""Load-generator parity: the port's loadgen/ (arrival, scenarios, driver,
report) and the admission / batch-formation machinery it drives, against
the JAX package's, tolerance 0.

- Arrival times: equal, bit for bit, for each process shape, each
  scenario's rate function and each seed.
- The scenario catalog: equal, entry for entry.
- Each compressed test of tests/test_loadgen_soak.py, mirrored on the
  port: the admission gate's sheds and displacements, the depth counters,
  the zero-count event, the revive, the weighted percentiles, the dwell
  by origin, batch formation, overload, the unschedulable flush, the
  steady / diurnal / storm / churn soaks, determinism, the report's
  shape, the driver's uninstall, the live state and the ControlPlane as
  a loadgen plane.  (The lock watchdog and /debug/load of the JAX tests
  are planes the port lacks; the live state is read in process.)
- SOAK payloads of both packages: equal but for `wall_s` and the seconds
  of `stage_utilization` (tests/torch_soak.comparable) for steady,
  diurnal, storm, churn and whatif on the serial backend, and megafleet
  on the device backend (the port on device="cpu"); the ledger's
  `events` section is part of the payload.  The runs hold the
  Schedulers' host clock still (tests/torch_soak: the e2e samples are
  floored at a cycle's wall seconds, which would tie them to the host's
  load).
- The whatif soak's placements equal a control run without its queries.
- The chaotic scenarios (chaos, hotspot) refused by name.
- The ADMISSION, SCHEDULE_ATTEMPTS and BATCH_SIZE families: the same
  deltas over the same run.
"""

import dataclasses
import json
import random

import pytest

import torch_soak as TS
from torch_fixtures import collect_jax_planes  # noqa: F401 — autouse
from torch_soak import PKGS, mod

from karmada_tpu_torch import obs
from karmada_tpu_torch.loadgen import (
    SCENARIOS,
    LoadDriver,
    ServeSlice,
    ServiceModel,
    VirtualClock,
    get_scenario,
    load_state,
)
from karmada_tpu_torch.loadgen import driver as lg_driver
from karmada_tpu_torch.loadgen import report as lg_report
from karmada_tpu_torch.loadgen.arrival import (
    burst_rate,
    constant_rate,
    diurnal_rate,
    poisson_times,
)
from karmada_tpu_torch.scheduler import metrics as sched_metrics
from karmada_tpu_torch.scheduler.queue import (
    ADMIT_ADMITTED,
    ADMIT_DISPLACED,
    ADMIT_SHED,
    QueuedBindingInfo,
    SchedulingQueue,
)
from karmada_tpu_torch.scheduler.service import Scheduler
from karmada_tpu_torch.store.store import ObjectStore
from karmada_tpu_torch.store.worker import Runtime


class Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def run_scenario(name: str, seed: int = 1):
    clock = VirtualClock()
    model = ServiceModel()
    scenario = get_scenario(name)
    plane = ServeSlice(scenario, clock, model)
    driver = LoadDriver(plane, scenario, clock=clock, model=model, seed=seed)
    return scenario, driver, driver.run()


# -- arrivals and the catalog: equal to the JAX package's ---------------------

SHAPES = {
    "constant": lambda A: (A.constant_rate(50.0), 50.0),
    "diurnal": lambda A: (A.diurnal_rate(50.0, 0.8, 10.0, t0=0.5), 90.0),
    "burst": lambda A: (A.burst_rate(10.0, 200.0, 4.0, 6.0), 200.0),
}


@pytest.mark.parametrize("seed", [0, 7, 12345])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_arrival_times_equal(shape, seed):
    def times(pkg):
        A = mod(pkg, "loadgen.arrival")
        fn, mx = SHAPES[shape](A)
        return A.poisson_times(fn, mx, 0.0, 10.0, random.Random(seed))

    j, p = (times(pkg) for pkg in PKGS)
    assert p == j and len(p) > 100


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_arrivals_equal(name, seed):
    """Each scenario's rate function and duration at the default
    capacity: the same arrival times on both packages."""
    def times(pkg):
        L = mod(pkg, "loadgen")
        sc = L.get_scenario(name)
        cap = L.ServiceModel().capacity_rate
        dur = sc.duration_s(cap)
        fn, mx = sc.rate_fn(cap, 1e6, dur)
        return mod(pkg, "loadgen.arrival").poisson_times(
            fn, mx, 1e6, 1e6 + dur, random.Random(seed))

    j, p = (times(pkg) for pkg in PKGS)
    assert p == j and p


def test_catalog_equal():
    j, p = (mod(pkg, "loadgen.scenarios").SCENARIOS for pkg in PKGS)
    assert list(p) == list(j)
    for name in j:
        assert dataclasses.asdict(p[name]) == dataclasses.asdict(j[name])
        assert p[name].chaotic == j[name].chaotic
        assert p[name].admission_limit() == j[name].admission_limit()
    assert {n for n, s in p.items() if s.chaotic} == {"chaos", "hotspot"}


@pytest.mark.parametrize("name", ["chaos", "hotspot"])
def test_chaotic_scenarios_refused_by_name(name):
    scenario = get_scenario(name)
    clock = VirtualClock()
    # device="cpu": hotspot arms the rebalance plane, whose detect runs
    # on a device whatever the Scheduler's backend
    plane = ServeSlice(scenario, clock, ServiceModel(), device="cpu")
    with pytest.raises(ValueError, match="chaos plane.*item 7"):
        LoadDriver(plane, scenario, clock=clock)
    assert load_state() == {"enabled": False}


# -- the compressed tests of test_loadgen_soak.py, on the port ----------------

def test_arrival_processes_deterministic_and_shaped():
    fn = constant_rate(50.0)
    a = poisson_times(fn, 50.0, 0.0, 10.0, random.Random(7))
    b = poisson_times(fn, 50.0, 0.0, 10.0, random.Random(7))
    assert a == b and a == sorted(a)
    assert 350 < len(a) < 650
    d = diurnal_rate(50.0, 0.8, 10.0)
    times = poisson_times(d, 90.0, 0.0, 10.0, random.Random(7))
    assert 350 < len(times) < 650
    peak = sum(1 for t in times if 1.5 <= t < 3.5)
    trough = sum(1 for t in times if 6.5 <= t < 8.5)
    assert peak > 2 * trough
    br = burst_rate(10.0, 200.0, 4.0, 6.0)
    times = poisson_times(br, 200.0, 0.0, 10.0, random.Random(7))
    in_burst = sum(1 for t in times if 4.0 <= t < 6.0)
    assert in_burst > 0.7 * len(times)


def admission_counts():
    return {d: sched_metrics.ADMISSION.value(decision=d)
            for d in (ADMIT_ADMITTED, ADMIT_SHED, ADMIT_DISPLACED)}


def test_admission_gate_sheds_and_displaces_exactly():
    clk = Clock()
    q = SchedulingQueue(now=clk, max_resident=3)
    base = admission_counts()
    decisions = [q.push(f"k{i}") for i in range(3)]
    assert decisions == [ADMIT_ADMITTED] * 3
    assert q.push("k-overflow") == ADMIT_SHED
    assert not q.has("k-overflow")
    assert q.push("k1") == ADMIT_ADMITTED
    assert q.depths()["active"] == 3
    assert q.push("vip", priority=5) == ADMIT_ADMITTED
    assert q.has("vip")
    assert q.depths()["active"] == 3
    delta = {k: admission_counts()[k] - base[k] for k in base}
    assert delta[ADMIT_ADMITTED] + delta[ADMIT_SHED] == 6
    assert delta[ADMIT_SHED] == 1
    assert delta[ADMIT_DISPLACED] == 1


def test_admission_equal_priority_never_thrashes():
    q = SchedulingQueue(max_resident=2)
    q.push("a", priority=1)
    q.push("b", priority=1)
    for i in range(5):
        assert q.push(f"c{i}", priority=1) == ADMIT_SHED
    assert q.has("a") and q.has("b")


def test_admission_unbounded_by_default():
    q = SchedulingQueue()
    for i in range(100):
        assert q.push(i) == ADMIT_ADMITTED
    assert q.depths()["active"] == 100


def test_admission_bound_holds_across_internal_moves():
    clk = Clock()
    q = SchedulingQueue(now=clk, max_resident=2)
    q.push("a")
    q.push_backoff_if_not_present(QueuedBindingInfo(key="b", attempts=1))
    assert q.push("c") == ADMIT_SHED
    clk.t += 1.1
    assert q.flush_backoff() == 1
    assert q.depths() == {"active": 2, "backoff": 0, "unschedulable": 0}


def test_depth_counters_exact_under_mixed_transitions():
    clk = Clock()
    q = SchedulingQueue(now=clk, max_resident=12)
    rng = random.Random(3)
    for step in range(2000):
        k = f"k{rng.randrange(30)}"
        op = rng.randrange(6)
        if op == 0:
            q.push(k, priority=rng.randrange(3))
        elif op == 1:
            q.push_backoff_if_not_present(
                QueuedBindingInfo(key=k, attempts=rng.randrange(4)))
        elif op == 2:
            q.push_unschedulable_if_not_present(QueuedBindingInfo(key=k))
        elif op == 3:
            q.pop_ready(rng.randrange(1, 5))
        elif op == 4:
            q.forget(k)
        else:
            clk.t += rng.random() * 3
            q.flush_backoff()
            q.flush_unschedulable_leftover()
            if rng.random() < 0.2:
                q.move_all_to_active_or_backoff()
        truth = {"active": 0, "backoff": 0, "unschedulable": 0}
        for w in q._where.values():  # noqa: SLF001 — the ground truth
            truth[w] += 1
        assert q.depths() == truth, step


def test_zero_count_cluster_event_is_noop():
    from karmada_tpu_torch.loadgen.scenarios import ClusterEventSpec
    from karmada_tpu_torch.models.cluster import Cluster

    clock = VirtualClock()
    model = ServiceModel()
    scenario = get_scenario("steady")
    plane = ServeSlice(scenario, clock, model)
    driver = LoadDriver(plane, scenario, clock=clock, model=model)
    before = len(list(plane.store.list(Cluster.KIND)))
    driver._apply_cluster_event(  # noqa: SLF001
        ClusterEventSpec(0.0, "kill", count=0))
    assert len(list(plane.store.list(Cluster.KIND))) == before


def test_weighted_percentiles_honor_strides():
    from karmada_tpu_torch.loadgen.report import weighted_percentiles

    pairs = sorted([(0.01, 1)] * 100 + [(1.0, 8)] * 512)
    p = weighted_percentiles(pairs)
    assert p["count"] == 100 + 512 * 8
    assert p["p50"] == 1.0
    unweighted = weighted_percentiles([(v, 1) for v, _ in pairs])
    assert unweighted["count"] == 612
    assert weighted_percentiles([]) == {"count": 0}


def test_storm_revive_restores_real_capacity():
    from karmada_tpu_torch.loadgen.scenarios import ClusterEventSpec
    from karmada_tpu_torch.models.cluster import Cluster
    from karmada_tpu_torch.utils.quantity import Quantity

    clock = VirtualClock()
    model = ServiceModel()
    scenario = get_scenario("steady")
    plane = ServeSlice(scenario, clock, model)
    victim = f"lg-m{scenario.n_clusters - 1}"

    def shrink(c: Cluster) -> None:
        c.status.resource_summary.allocatable["cpu"] = Quantity.parse("7")
        c.metadata.labels["tier"] = "custom"

    plane.store.mutate(Cluster.KIND, "", victim, shrink)
    driver = LoadDriver(plane, scenario, clock=clock, model=model)
    driver._apply_cluster_event(  # noqa: SLF001
        ClusterEventSpec(0.0, "kill", count=1))
    assert plane.store.try_get(Cluster.KIND, "", victim) is None
    driver._apply_cluster_event(  # noqa: SLF001
        ClusterEventSpec(0.0, "revive", count=1))
    revived = plane.store.get(Cluster.KIND, "", victim)
    assert str(revived.status.resource_summary.allocatable["cpu"]) == "7"
    assert revived.metadata.labels["tier"] == "custom"


def test_pop_ready_records_dwell_by_origin():
    clk = Clock()
    q = SchedulingQueue(now=clk)
    h = sched_metrics.QUEUE_DWELL
    base_active = h.count(queue="active")
    base_backoff = h.count(queue="backoff")
    sum_active0 = h.sum(queue="active")
    q.push("fresh")
    clk.t += 5.0
    assert [i.key for i in q.pop_ready()] == ["fresh"]
    assert h.count(queue="active") == base_active + 1
    assert h.sum(queue="active") - sum_active0 == pytest.approx(5.0)
    q.push_backoff_if_not_present(QueuedBindingInfo(key="bk", attempts=1))
    clk.t += 1.1
    q.flush_backoff()
    clk.t += 0.4
    infos = q.pop_ready()
    assert [i.origin for i in infos] == ["backoff"]
    assert h.count(queue="backoff") == base_backoff + 1


def test_oldest_ages_per_queue():
    clk = Clock()
    q = SchedulingQueue(now=clk)
    q.push("a")
    clk.t += 3.0
    q.push("b")
    q.push_unschedulable_if_not_present(QueuedBindingInfo(key="u"))
    clk.t += 2.0
    ages = q.oldest_ages()
    assert ages["active"] == pytest.approx(5.0)
    assert ages["unschedulable"] == pytest.approx(2.0)
    assert ages["backoff"] == 0.0
    assert q.oldest_active_age() == pytest.approx(5.0)


def _service_scheduler(clk, batch_window=4, batch_deadline_s=None,
                       max_resident=None):
    store = ObjectStore()
    runtime = Runtime()
    sched = Scheduler(
        store, runtime, backend="serial", batch_window=batch_window,
        batch_deadline_s=batch_deadline_s,
        queue=SchedulingQueue(now=clk, max_resident=max_resident))
    return store, runtime, sched


def test_batch_formation_defers_until_deadline_or_size():
    clk = Clock()
    _, _, sched = _service_scheduler(clk, batch_window=4,
                                     batch_deadline_s=2.0)
    with sched._queue_lock:  # noqa: SLF001 — the policy directly
        assert not sched._batch_ready_locked()  # noqa: SLF001
        sched.queue.push(("ns", "a"))
        assert not sched._batch_ready_locked()  # noqa: SLF001
        clk.t += 2.0
        assert sched._batch_ready_locked()  # noqa: SLF001
        sched.queue.pop_ready(4)
        for i in range(4):
            sched.queue.push(("ns", f"b{i}"))
        assert sched._batch_ready_locked()  # noqa: SLF001


def test_batch_formation_legacy_without_deadline():
    clk = Clock()
    _, _, sched = _service_scheduler(clk, batch_window=4)
    with sched._queue_lock:  # noqa: SLF001
        assert not sched._batch_ready_locked()  # noqa: SLF001
        sched.queue.push(("ns", "a"))
        assert sched._batch_ready_locked()  # noqa: SLF001


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_batch_formation_property_never_empty_never_over_window(seed):
    scenario, driver, payload = run_scenario("steady", seed=seed)
    sizes = [s["attrs"]["bindings"]
             for s in lg_report._cycle_spans(  # noqa: SLF001
                 driver.recorder)]
    assert sizes, "no cycles recorded"
    assert all(1 <= b <= scenario.batch_window for b in sizes)
    assert payload["cycles"]["empty"] == 0


def test_overload_enter_exit_and_explain_suppression():
    clk = Clock()
    _, _, sched = _service_scheduler(clk, batch_window=4,
                                     batch_deadline_s=1.0)
    sched.explain = 1.0
    sched.decisions = object()  # armed marker; never dereferenced
    assert sched._explain_sample() is not None  # noqa: SLF001
    sched._update_overload(  # noqa: SLF001
        [0.5, 0.6, 3.0, 3.5], popped=4, active_after=9)
    assert sched._overload  # noqa: SLF001
    assert sched_metrics.OVERLOAD_MODE.value() == 1.0
    assert sched._explain_sample() is None  # noqa: SLF001
    with sched._queue_lock:  # noqa: SLF001
        sched.queue.push(("ns", "a"))
        clk.t += 2.0
        assert not sched._batch_ready_locked()  # noqa: SLF001
        clk.t += 2.5
        assert sched._batch_ready_locked()  # noqa: SLF001
        sched.queue.pop_ready(4)
    sched._update_overload([0.1, 0.2], popped=4,  # noqa: SLF001
                           active_after=9)
    assert not sched._overload  # noqa: SLF001
    assert sched._explain_sample() is not None  # noqa: SLF001


def test_overload_unlatches_on_sub_window_cut():
    clk = Clock()
    _, _, sched = _service_scheduler(clk, batch_window=4,
                                     batch_deadline_s=1.0)
    upd = sched._update_overload  # noqa: SLF001
    upd([3.0, 3.5, 4.0, 4.5], popped=4, active_after=9)
    assert sched._overload  # noqa: SLF001
    upd([], popped=0, active_after=3)
    assert sched._overload  # noqa: SLF001
    upd([4.0, 4.1], popped=2, active_after=9)
    assert not sched._overload  # noqa: SLF001
    assert sched_metrics.OVERLOAD_MODE.value() == 0.0
    upd([3.0, 3.5, 4.0, 4.5], popped=4, active_after=9)
    assert sched._overload  # noqa: SLF001
    upd([4.0, 4.1, 4.2, 4.3], popped=4, active_after=0)
    assert not sched._overload  # noqa: SLF001


def _unschedulable_binding(name: str):
    from karmada_tpu_torch.models.policy import (
        DYNAMIC_WEIGHT_AVAILABLE_REPLICAS,
        REPLICA_DIVISION_WEIGHTED,
        REPLICA_SCHEDULING_DIVIDED,
        ClusterPreferences,
        Placement,
        ReplicaSchedulingStrategy,
    )

    rb = lg_driver.build_binding(name)
    rb.spec.replicas = 10_000_000
    rb.spec.placement = Placement(
        replica_scheduling=ReplicaSchedulingStrategy(
            replica_scheduling_type=REPLICA_SCHEDULING_DIVIDED,
            replica_division_preference=REPLICA_DIVISION_WEIGHTED,
            weight_preference=ClusterPreferences(
                dynamic_weight=DYNAMIC_WEIGHT_AVAILABLE_REPLICAS)))
    return rb


def test_unschedulable_leftover_flushes_on_cycle_path():
    clk = Clock()
    store, runtime, sched = _service_scheduler(clk, batch_window=16)
    store.create(lg_driver.build_cluster("m1"))
    runtime.pump()
    store.create(_unschedulable_binding("parked"))
    runtime.pump()
    key = ("loadgen", "parked")
    assert sched.queue.depths()["unschedulable"] == 1
    assert sched.queue._info[key].attempts == 1  # noqa: SLF001
    clk.t += sched.queue.max_in_unschedulable_s + 1
    store.create(lg_driver.build_binding("fresh"))
    runtime.pump()
    assert sched.queue._info[key].attempts == 2  # noqa: SLF001


def test_steady_soak_no_overload_slo():
    scenario, driver, p = run_scenario("steady")
    deadline = scenario.deadline_s(driver.model)
    assert p["admission"]["shed"] == 0
    assert p["admission"]["displaced"] == 0
    assert p["scheduled"] == p["injected"] > 200
    assert p["residual_queue"] == {"active": 0, "backoff": 0,
                                   "unschedulable": 0}
    assert p["queue_dwell_s"]["p99"] < deadline
    assert p["queue_dwell_s"]["max"] <= deadline * 2
    assert p["starvation"]["overload_entered"] is False
    lat = p["schedule_latency_s"]
    assert lat["count"] == p["injected"]
    assert lat["p50"] <= lat["p95"] <= lat["p99"] <= lat["max"]
    assert driver.plane.scheduler.faults() == {}


def test_diurnal_soak_bounded_dwell():
    scenario, driver, p = run_scenario("diurnal")
    deadline = scenario.deadline_s(driver.model)
    assert p["admission"]["shed"] == 0
    assert p["scheduled"] == p["injected"]
    assert p["queue_dwell_s"]["max"] <= deadline * 2
    assert p["residual_queue"]["active"] == 0


def test_storm_soak_sheds_and_stays_bounded():
    scenario, driver, p = run_scenario("storm")
    bound = scenario.admission_limit()
    deadline = scenario.deadline_s(driver.model)
    assert p["admission"]["shed"] > 0
    assert (max(p["queue_depth"]["max"].values())
            <= bound + scenario.batch_window)
    assert p["starvation"]["overload_entered"] is True
    assert p["reschedules"] > 0
    assert p["residual_queue"] == {"active": 0, "backoff": 0,
                                   "unschedulable": 0}
    never_scheduled = p["injected"] - p["scheduled"]
    assert never_scheduled > 0
    assert p["admission"]["shed"] >= never_scheduled
    sched = driver.plane.scheduler
    dwell_cap = (bound * driver.model.per_binding_s
                 + deadline * sched.overload_deadline_factor)
    assert p["queue_dwell_s"]["max"] <= dwell_cap


def test_churn_soak_survives_capacity_flaps():
    scenario, driver, p = run_scenario("churn")
    assert p["scheduled"] == p["injected"]
    assert p["residual_queue"]["active"] == 0
    assert p["admission"]["shed"] == 0


def test_soak_determinism_same_seed_same_traffic():
    _, d1, p1 = run_scenario("steady", seed=42)
    _, d2, p2 = run_scenario("steady", seed=42)
    assert d1._arrivals == d2._arrivals  # noqa: SLF001
    assert p1["injected"] == p2["injected"]
    assert p1["admission"] == p2["admission"]
    assert p1["queue_dwell_s"] == p2["queue_dwell_s"]


def test_soak_report_shape_and_stage_utilization():
    _, driver, p = run_scenario("steady")
    assert p["version"] == 1
    for key in ("scenario", "model", "arrival", "schedule_latency_s",
                "queue_dwell_s", "driver_latency_s", "admission",
                "queue_depth", "starvation", "cycles", "stage_utilization",
                "injected", "scheduled", "events"):
        assert key in p, key
    assert p["slo"] is None and p["incidents"] is None
    assert "scheduler.cycle" in p["stage_utilization"]
    assert "scheduler.serial" in p["stage_utilization"]
    assert p["stage_utilization"]["scheduler.serial"]["of_cycle"] <= 1.0
    json.dumps(p)


def test_driver_restores_tracer_and_schedule_batch():
    clock = VirtualClock()
    model = ServiceModel()
    scenario = get_scenario("steady")
    plane = ServeSlice(scenario, clock, model)
    prev_recorder = obs.TRACER.recorder
    driver = LoadDriver(plane, scenario, clock=clock, model=model)
    driver.run()
    assert "schedule_batch" not in vars(plane.scheduler)
    assert obs.TRACER.recorder is prev_recorder
    assert load_state() == {"enabled": False}


def test_live_load_state_and_rendering():
    """The JAX test reads this over /debug/load; the port reads the same
    payload in process (load_state)."""
    assert load_state() == {"enabled": False}
    clock = VirtualClock()
    model = ServiceModel()
    scenario = get_scenario("steady")
    plane = ServeSlice(scenario, clock, model)
    driver = LoadDriver(plane, scenario, clock=clock, model=model)
    driver._install()  # noqa: SLF001 — the live-state window under test
    try:
        state = load_state()
        assert state["enabled"] is True
        assert state["scenario"] == "steady"
        assert state["queue"]["admission_limit"] == \
            scenario.admission_limit()
        text = lg_report.render_load_state(state)
        assert "steady" in text and "admission" in text
    finally:
        driver._uninstall()  # noqa: SLF001
    assert load_state() == {"enabled": False}
    assert "no load generator" in lg_report.render_load_state(load_state())


def test_oldest_age_gauge_exported_by_periodic_flush():
    clk = Clock()
    store, runtime, sched = _service_scheduler(clk, batch_window=4,
                                               batch_deadline_s=100.0)
    store.create(lg_driver.build_cluster("m1"))
    runtime.pump()
    store.create(lg_driver.build_binding("waiting"))
    runtime.pump()
    clk.t += 7.0
    sched._periodic_flush()  # noqa: SLF001 — the tick the gauge rides
    assert sched_metrics.QUEUE_OLDEST_AGE.value(queue="active") >= 7.0


def test_control_plane_duck_types_as_loadgen_plane():
    from karmada_tpu_torch.e2e import ControlPlane

    cp = ControlPlane(backend="serial", batch_window=16,
                      batch_deadline_s=0.02)
    cp.add_member("m1", cpu_milli=64_000)
    cp.add_member("m2", cpu_milli=64_000)
    cp.apply({"apiVersion": "apps/v1", "kind": "Deployment",
              "metadata": {"name": "lg-shared",
                           "namespace": lg_driver.LOADGEN_NS},
              "spec": {"replicas": 1, "template": {"spec": {
                  "containers": [{"name": "c"}]}}}})
    scenario = dataclasses.replace(get_scenario("steady"), n_bindings=40)
    driver = LoadDriver(cp, scenario, seed=5, resource_name="lg-shared")
    p = driver.run()
    assert p["scheduled"] == p["injected"] > 20
    assert p["admission"]["shed"] == 0
    works = [w for w in cp.store.list("Work")
             if w.metadata.name.startswith("lg-shared")]
    assert works


# -- SOAK payloads of both packages --------------------------------------------

@pytest.mark.parametrize("name", ["steady", "diurnal", "storm", "churn",
                                  "whatif"])
def test_soak_payload_equal_serial(name):
    (pj, dj, _), (pp, dp, plane) = (TS.soak(pkg, name) for pkg in PKGS)
    assert TS.comparable(pp) == TS.comparable(pj)
    assert TS.placements(plane) == TS.placements(dj.plane)
    assert plane.scheduler.faults() == {}
    assert dp.whatif_results == dj.whatif_results


def test_soak_payload_equal_megafleet_device():
    """megafleet on the device backend (the port's kernels' plain
    versions on device="cpu"), with the shortlist tier armed."""
    (pj, dj, _), (pp, dp, plane) = (TS.soak(pkg, "megafleet", "device")
                                    for pkg in PKGS)
    assert TS.comparable(pp) == TS.comparable(pj)
    assert TS.placements(plane) == TS.placements(dj.plane)
    assert pp["scheduled"] == pp["injected"]
    assert plane.scheduler.faults() == {}
    assert "pipeline.solve_wait" in pp["stage_utilization"]


def test_whatif_soak_placements_equal_a_control_run():
    p, d, plane = TS.soak("karmada_tpu_torch", "whatif")
    c, _, control = TS.soak("karmada_tpu_torch", "whatif",
                            strip_events=True)
    assert TS.placements(plane) == TS.placements(control)
    assert [r["query"] for r in d.whatif_results] == [
        "placement", "headroom", "cluster-loss", "placement", "headroom"]
    assert all(r["result"] for r in d.whatif_results)
    assert p["scheduled"] == p["injected"]


def test_events_section_counts_the_run():
    p, _, _ = TS.soak("karmada_tpu_torch", "storm")
    ev = p["events"]
    assert ev["armed"] is True and ev["recorded"] > 0
    for reason in ("BindingEnqueued", "BindingShed", "BatchFormed",
                   "ScheduleBindingSucceed", "EvictWorkloadFromCluster"):
        assert ev["by_reason"].get(reason, 0) > 0, reason


def _family_deltas(pkg, name):
    sm = mod(pkg, "scheduler.metrics")

    def snap():
        return {"admission": {d: sm.ADMISSION.value(decision=d)
                              for d in ("admitted", "shed", "displaced")},
                "attempts": {r: sm.SCHEDULE_ATTEMPTS.value(
                    result=r, schedule_type=sm.SCHEDULE_TYPE_RECONCILE)
                    for r in (sm.RESULT_SCHEDULED, sm.RESULT_ERROR,
                              sm.RESULT_UNSCHEDULABLE)},
                "batch": (sm.BATCH_SIZE.count(), sm.BATCH_SIZE.sum())}

    before = snap()
    TS.soak(pkg, name)
    after = snap()
    return {
        "admission": {k: after["admission"][k] - before["admission"][k]
                      for k in before["admission"]},
        "attempts": {k: after["attempts"][k] - before["attempts"][k]
                     for k in before["attempts"]},
        "batch": (after["batch"][0] - before["batch"][0],
                  after["batch"][1] - before["batch"][1])}


@pytest.mark.parametrize("name", ["steady", "storm"])
def test_metric_families_equal_after_the_same_run(name):
    j, p = (_family_deltas(pkg, name) for pkg in PKGS)
    assert p == j
    assert p["admission"]["admitted"] > 0 and p["batch"][0] > 0
