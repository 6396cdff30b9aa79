"""The runtime race detector (utils/locks) of the port against the JAX
package's, on the CPU, tolerance 0 (after tests/test_lock_order.py's
runtime half and tests/test_chaos.py's race-detector leg).

- The same scripted acquire orders, watchdog stalls and ownership
  breaches in both packages: the same InvariantViolation messages, the
  same inversion records and counter deltas, the same watchdog trips on
  an injected clock, and `state_payload()` equal over the scripted locks
  (each package's registry also lists the live locks the rest of the
  suite left, so the rows compared are the scripted ones; every other
  field is compared whole).
- A disarmed VetLock records nothing, and the `karmada_lock_*` families
  equal the JAX package's by name, type, labels, help and buckets.
- An inversion and a watchdog trip fire the incident plane's
  `lock-inversion` / `lock-watchdog` triggers, whose bundles carry the
  `locks` block, in both packages.
- The port's VetLocks carry the JAX package's names at the same sites.
- The race-detector leg: the port's chaos soak (tests/test_torch_chaos's
  plane, hang and guard) with analysis/guards armed and a LockWatchdog
  running: no InvariantViolation, 0 order inversions, 0 watchdog trips,
  no safety violation.
"""

import importlib
import threading

import pytest

import torch_soak as TS
from torch_fixtures import collect_jax_planes  # noqa: F401 — autouse

PKGS = TS.PKGS


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


@pytest.fixture
def armed():
    """Both packages' detectors armed for one test, edge tables cleared,
    then restored."""
    was = [mod(pkg, "analysis.guards").armed() for pkg in PKGS]
    for pkg in PKGS:
        mod(pkg, "utils.locks").reset_for_tests()
        mod(pkg, "analysis.guards").arm()
    yield
    for pkg, w in zip(PKGS, was):
        mod(pkg, "analysis.guards").arm(w)
        mod(pkg, "utils.locks").reset_for_tests()
        mod(pkg, "utils.locks").set_clock()
        mod(pkg, "obs.incidents").disarm()


def _scripted(payload, prefix="t."):
    """A state_payload with only the scripted locks' rows (and no hold
    durations, which read the clock)."""
    out = dict(payload)
    out["locks"] = [{**r, "held_for_s": r["held_for_s"] is not None}
                    for r in payload["locks"] if r["name"].startswith(prefix)]
    out["owner_threads"] = [o for o in payload["owner_threads"]
                            if o["name"].startswith(prefix)]
    out["inversions"] = dict(payload["inversions"])
    out["inversions"].pop("total")
    out["watchdog"] = dict(payload["watchdog"])
    out["watchdog"].pop("trips_total")
    return out


def _run(fn, name):
    t = threading.Thread(target=fn, name=name)
    t.start()
    t.join(timeout=10)


# -- ownership -------------------------------------------------------------------

def _ownership(pkg):
    locks = mod(pkg, "utils.locks")
    guards = mod(pkg, "analysis.guards")
    lock = locks.VetLock("t.guarded")
    errors = []
    entered, release = threading.Event(), threading.Event()

    def holder():
        with lock:
            entered.set()
            release.wait(timeout=5)

    def intruder():
        entered.wait(timeout=5)
        try:
            lock.require_held("t.state")
        except guards.InvariantViolation as e:
            errors.append(str(e))
        finally:
            release.set()

    th = threading.Thread(target=holder, name="holder")
    ti = threading.Thread(target=intruder, name="intruder")
    th.start()
    ti.start()
    th.join(timeout=5)
    ti.join(timeout=5)
    with lock:
        lock.require_held("t.state")  # the holder passes
        mine = lock.held_by_me()
    owner = locks.OwnerThread("t.plane")
    owner.check("cycle()")
    _run(lambda: _catch(owner.check, guards, errors, "cycle()"), "other")
    owner.reset()
    # the next owner stays alive while another thread checks: a finished
    # thread's ident may be handed to the next one
    owned, done = threading.Event(), threading.Event()

    def next_owner():
        owner.check("adopt()")
        owned.set()
        done.wait(timeout=5)

    t = threading.Thread(target=next_owner, name="next")
    t.start()
    owned.wait(timeout=5)
    _run(lambda: _catch(owner.check, guards, errors, "write_back()"),
         "late")
    done.set()
    t.join(timeout=5)
    return errors, mine, _scripted(locks.state_payload())


def _catch(fn, guards, errors, *args):
    try:
        fn(*args)
    except guards.InvariantViolation as e:
        errors.append(str(e))


def test_ownership_breaches_equal(armed):
    j, p = (_ownership(pkg) for pkg in PKGS)
    assert p == j
    errors, mine, _ = p
    assert mine is True and len(errors) == 3
    assert "touched without holding `t.guarded`" in errors[0]
    assert "owner: holder, this thread: intruder" in errors[0]
    assert "single-threaded by contract" in errors[1]


# -- order inversions ------------------------------------------------------------

def _inversion(pkg, reverse):
    locks = mod(pkg, "utils.locks")
    a, b, c = (locks.VetLock(f"t.inv.{x}") for x in "ABC")
    inv0 = locks._INVERSIONS.total()  # noqa: SLF001
    with a:
        with b:
            with c:
                pass

    def second():
        if reverse:
            with c:
                with a:
                    pass
        else:
            with a:
                with c:
                    pass

    _run(second, "second")
    return (locks._INVERSIONS.total() - inv0,  # noqa: SLF001
            _scripted(locks.state_payload()))


@pytest.mark.parametrize("reverse", [True, False],
                         ids=["inverted", "consistent"])
def test_order_inversions_equal(armed, reverse):
    j, p = (_inversion(pkg, reverse) for pkg in PKGS)
    assert p == j
    n, payload = p
    assert n == (1 if reverse else 0)
    assert payload["order_edges"] == (4 if reverse else 3)
    if reverse:
        assert payload["inversions"]["recent"] == [{
            "pair": "t.inv.A|t.inv.C", "held": "t.inv.C",
            "acquired": "t.inv.A", "thread": "second"}]


# -- the watchdog ------------------------------------------------------------------

def _watchdog(pkg):
    locks = mod(pkg, "utils.locks")
    now = [100.0]
    locks.set_clock(lambda: now[0])
    wd = locks.LockWatchdog(threshold_s=5.0)
    stalled = locks.VetLock("t.stall")
    trips0 = locks._TRIPS.total()  # noqa: SLF001
    seen = []
    stalled.acquire()
    try:
        seen.append(wd.check())
        now[0] = 106.0
        seen.append(wd.check())
        seen.append(wd.check())  # once per hold
        during = _scripted(locks.state_payload())
    finally:
        stalled.release()
    now[0] = 120.0
    seen.append(wd.check())
    return seen, locks._TRIPS.total() - trips0, during  # noqa: SLF001


def test_watchdog_stalls_equal(armed):
    j, p = (_watchdog(pkg) for pkg in PKGS)
    assert p == j
    seen, trips, during = p
    assert seen[0] == [] and seen[2] == [] and seen[3] == []
    assert [(t["lock"], t["held_s"]) for t in seen[1]] == [("t.stall", 6.0)]
    assert trips == 1
    assert during["locks"] == [{"name": "t.stall", "kind": "lock",
                                "owner": threading.current_thread().name,
                                "held_for_s": True}]


# -- triggers ----------------------------------------------------------------------

def _triggers(pkg):
    locks = mod(pkg, "utils.locks")
    inc = mod(pkg, "obs.incidents")
    store = inc.configure(None, cooldown_s=0.0)
    now = [10.0]
    locks.set_clock(lambda: now[0])
    a, b = locks.VetLock("t.trig.A"), locks.VetLock("t.trig.B")
    with a:
        with b:
            pass

    def reversed_order():
        with b:
            with a:
                pass

    _run(reversed_order, "reversed")
    a.acquire()
    now[0] = 20.0
    try:
        locks.LockWatchdog(threshold_s=5.0).check()
    finally:
        a.release()
    index = store.state_payload()
    bundles = [inc.bundle_payload(e["id"]) for e in index["incidents"]]
    return ([(e["trigger"], e["summary"]) for e in index["incidents"]],
            [(sorted(bd), bd["detail"].get("pair"),
              _scripted(bd["locks"], "t.trig")) for bd in bundles])


def test_lock_triggers_capture_equal_bundles(armed):
    j, p = (_triggers(pkg) for pkg in PKGS)
    assert p == j
    kinds = [k for k, _ in p[0]]
    assert sorted(kinds) == ["lock-inversion", "lock-watchdog"]
    assert all("locks" in sections for sections, _, _ in p[1])


# -- the disarmed path and the families ---------------------------------------------

def test_disarmed_lock_records_nothing():
    locks = mod("karmada_tpu_torch", "utils.locks")
    guards = mod("karmada_tpu_torch", "analysis.guards")
    assert not guards.armed()
    locks.reset_for_tests()
    lock = locks.VetLock("t.disarmed")
    hold0 = locks._HOLD.count(lock="t.disarmed")  # noqa: SLF001
    for _ in range(100):
        with lock:
            pass
    assert lock._owner is None and lock._acquired_at is None  # noqa: SLF001
    assert locks._HOLD.count(lock="t.disarmed") == hold0  # noqa: SLF001
    assert locks.state_payload()["order_edges"] == 0
    assert locks.LockWatchdog().check() == []


def _families(pkg):
    mod(pkg, "utils.locks")
    reg = mod(pkg, "utils.metrics").REGISTRY
    return {name: (type(m).__name__, tuple(m.label_names), m.help,
                   list(getattr(m, "buckets", [])))
            for name, m in reg._metrics.items()  # noqa: SLF001
            if name.startswith("karmada_lock_")}


def test_lock_families_equal():
    j, p = (_families(pkg) for pkg in PKGS)
    assert p == j and len(p) == 3


#: (module, attribute path) -> lock name, at the JAX package's sites
LOCK_SITES = [
    ("ops.shortlist", "_AGG_LOCK", "shortlist.agg"),
    ("ops.shortlist", "_T1_LOCK", "shortlist.t1"),
    ("rebalance", "_ACTIVE_LOCK", "rebalance.active"),
    ("loadgen.driver", "_ACTIVE_LOCK", "loadgen.active"),
]


@pytest.mark.parametrize("module,attr,name", LOCK_SITES,
                         ids=[s[2] for s in LOCK_SITES])
def test_module_locks_named_as_in_jax(module, attr, name):
    for pkg in PKGS:
        lock = getattr(mod(pkg, module), attr)
        assert type(lock).__name__ == "VetLock" and lock.name == name, pkg


def _instance_locks(pkg):
    """The names of the VetLocks a plane's objects hold, by class."""
    from torch_scenarios import FakeClock

    store_mod = mod(pkg, "store.store")
    worker = mod(pkg, "store.worker")
    store, rt = store_mod.ObjectStore(), worker.Runtime()
    kw = {"device": "cpu"} if pkg == "karmada_tpu_torch" else {}
    sched = mod(pkg, "scheduler").Scheduler(
        store, rt, rebalance=30.0, rebalance_clock=FakeClock(), **kw)
    plane = sched.rebalance_plane
    chaos = mod(pkg, "chaos.plane").ChaosPlane()
    client = mod(pkg, "estimator.client")
    acc = client.AccurateEstimatorClient()
    facade = mod(pkg, "facade").FacadeService(sched, store)
    L = mod(pkg, "loadgen")
    out = {
        "scheduler": sched._queue_lock.name,  # noqa: SLF001
        "rebalance": plane._lock.name,  # noqa: SLF001
        "budget": plane.budget._lock.name,  # noqa: SLF001
        "chaos": chaos._lock.name,  # noqa: SLF001
        "breaker": acc.breaker._lock.name,  # noqa: SLF001
        "memo": acc._memo_lock.name,  # noqa: SLF001
        "facade": (facade._lock.name,  # noqa: SLF001
                   facade._solve_lock.name),  # noqa: SLF001
        "events": mod(pkg, "obs.events").EventLedger()._lock.name,  # noqa: SLF001
        "recorder": mod(pkg, "obs.recorder").TraceRecorder()._lock.name,  # noqa: SLF001
        "clock": L.VirtualClock()._lock.name,  # noqa: SLF001
    }
    facade.close()
    if hasattr(acc, "close"):
        acc.close()
    else:
        acc._pool.shutdown()  # noqa: SLF001
    mod(pkg, "rebalance").set_active(None)
    return out


def test_instance_locks_named_as_in_jax():
    j, p = (_instance_locks(pkg) for pkg in PKGS)
    assert p == j
    assert p["scheduler"] == "scheduler.queue"


# -- the race-detector leg of the chaos soak ---------------------------------------

@pytest.mark.chaos
def test_chaos_soak_race_detector_leg():
    """The port's chaos soak (tests/test_torch_chaos's plane: resident,
    the widened hang, the guard, the recover cycles) with the runtime
    guards armed and a LockWatchdog polling: the soak ends clean (no
    InvariantViolation escaped, no safety violation), and neither the
    order-inversion nor the watchdog counter moved."""
    import test_torch_chaos as TC

    pkg = "karmada_tpu_torch"
    locks = mod(pkg, "utils.locks")
    guards = mod(pkg, "analysis.guards")
    was = guards.armed()
    locks.reset_for_tests()
    inv0 = locks._INVERSIONS.total()  # noqa: SLF001
    trips0 = locks._TRIPS.total()  # noqa: SLF001
    guards.arm()
    wd = locks.LockWatchdog(threshold_s=5.0, poll_s=0.2).start()
    try:
        payload, _, samples = TC._soak(pkg, "chaos", {  # noqa: SLF001
            "resident": True, "resident_audit_interval": 0,
            "device_cycle_timeout_s": TC.SOAK_GUARD_S,
            "device_recover_cycles": 2})
        edges = locks.state_payload()["order_edges"]
    finally:
        wd.stop()
        guards.arm(was)
        for name in ("chaos", "obs.timeseries", "obs.slo", "obs.incidents"):
            mod(pkg, name).disarm()
    assert locks._INVERSIONS.total() - inv0 == 0, (  # noqa: SLF001
        locks.state_payload()["inversions"])
    assert locks._TRIPS.total() - trips0 == 0  # noqa: SLF001
    assert edges > 0  # the armed locks saw nested acquires
    audit = payload["safety_audit"]
    assert audit["violations"] == []
    assert audit["fault_fires"]["device.cycle"] == 1
    assert audit["metric_deltas"]["backend_rearmed"] >= 1
    assert samples > 0
