"""Compressed loadgen soaks of either package, for the port's parity
tests (tests/test_torch_trace.py, test_torch_loadgen.py,
test_torch_cli.py).

`soak` runs one scenario through the package's LoadDriver on its
ServeSlice (the port's device backend with device="cpu") and returns the
SOAK payload, the driver and the plane.  Each run records into a fresh
process ledger (restored after): the ledger coalesces on each timeline's
tail, so an earlier run's events on the same binding names would change
this run's counts.

Each run also holds the Scheduler module's host clock still
(`frozen_cycle_clock`): both packages' Schedulers floor a binding's e2e
sample at its cycle's wall seconds (`max(e2e, cycle_elapsed)`), so with
the real clock the SOAK payloads would depend on how loaded the host is
whenever a cycle's wall outlasts its modeled cost on the virtual clock.
With the clock still, every cycle's wall reads 0 and the payloads are a
function of the traffic alone.  Only the `time` the scheduler/service
module sees is replaced (its perf_counter stands still; everything else
is the real module): the spans, the driver and the virtual clocks keep
their own.

`comparable` masks what the payloads may differ in: `wall_s` and the
seconds of `stage_utilization` (its span names and counts stay).
"""

import contextlib
import dataclasses
import importlib
import json
import time

PKGS = ("karmada_tpu", "karmada_tpu_torch")


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


class _StillPerfCounter:
    """The time module with perf_counter standing still."""

    def __getattr__(self, name):
        return getattr(time, name)

    @staticmethod
    def perf_counter() -> float:
        return 0.0


@contextlib.contextmanager
def frozen_cycle_clock():
    """Both packages' scheduler/service modules read a still
    perf_counter inside the block (module docstring)."""
    mods = [mod(pkg, "scheduler.service") for pkg in PKGS]
    prev = [m.time for m in mods]
    for m in mods:
        m.time = _StillPerfCounter()
    try:
        yield
    finally:
        for m, t in zip(mods, prev):
            m.time = t


@contextlib.contextmanager
def fresh_ledger(pkg):
    """A fresh process ledger of `pkg` inside the block."""
    events = mod(pkg, "obs.events")
    prev = events.ledger()
    events.configure()
    try:
        yield
    finally:
        events._LEDGER[0] = prev  # noqa: SLF001 — restore the ledger


def soak(pkg, name, backend="serial", seed=5, strip_events=False,
         **plane_kw):
    L = mod(pkg, "loadgen")
    scenario = L.get_scenario(name)
    if strip_events:
        scenario = dataclasses.replace(scenario, events=())
    clock = L.VirtualClock()
    model = L.ServiceModel()
    if pkg == "karmada_tpu_torch" and backend == "device":
        plane_kw.setdefault("device", "cpu")
    plane = L.ServeSlice(scenario, clock, model, backend=backend, **plane_kw)
    driver = L.LoadDriver(plane, scenario, clock=clock, model=model,
                          seed=seed)
    with fresh_ledger(pkg), frozen_cycle_clock():
        payload = driver.run()
    return payload, driver, plane


def comparable(payload):
    """The payload without `wall_s` and with `stage_utilization` reduced
    to span name -> count."""
    out = json.loads(json.dumps(payload, default=str))
    out.pop("wall_s")
    out["stage_utilization"] = {
        k: v["count"] for k, v in out["stage_utilization"].items()}
    return out


def placements(plane):
    return {(rb.metadata.namespace, rb.metadata.name): tuple(sorted(
        (t.name, t.replicas) for t in rb.spec.clusters))
        for rb in plane.store.list("ResourceBinding")}
