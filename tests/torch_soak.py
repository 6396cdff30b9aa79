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
their own.  Each run also holds back the Schedulers' wall-clock
deferred-cut timer (`held_cut_timers`): in a compressed soak whose wall
outlasts the batch deadline it would add a no-op cycle at a point the
host's load sets (tools/soak_hold.py).

`comparable` masks what the payloads may differ in: `wall_s` and the
seconds of `stage_utilization` (its span names and counts stay).
"""

import contextlib
import dataclasses
import importlib
import json

from tools import soak_hold

PKGS = ("karmada_tpu", "karmada_tpu_torch")


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _services():
    return [mod(pkg, "scheduler.service") for pkg in PKGS]


def frozen_cycle_clock():
    """Both packages' scheduler/service modules read a still
    perf_counter inside the block (module docstring;
    tools/soak_hold.still_cycle_clock)."""
    return soak_hold.still_cycle_clock(*_services())


def held_cut_timers():
    """Both packages' Schedulers arm no wall-clock deferred-cut timer
    inside the block (tools/soak_hold.held_cut_timers)."""
    return soak_hold.held_cut_timers(*_services())


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
    with fresh_ledger(pkg), frozen_cycle_clock(), held_cut_timers():
        payload = driver.run()
    return payload, driver, plane


def comparable(payload):
    """The payload without `wall_s`, with `stage_utilization` reduced to
    span name -> count, and with a chaos soak's fire log without its
    wall-clock stamps (`ts`)."""
    out = json.loads(json.dumps(payload, default=str))
    out.pop("wall_s")
    out["stage_utilization"] = {
        k: v["count"] for k, v in out["stage_utilization"].items()}
    for rec in (out.get("chaos") or {}).get("recent", ()):
        rec.pop("ts", None)
    return out


def placements(plane):
    return {(rb.metadata.namespace, rb.metadata.name): tuple(sorted(
        (t.name, t.replicas) for t in rb.spec.clusters))
        for rb in plane.store.list("ResourceBinding")}


#: keys of a SOAK section that only the port reports, as paths under the
#: section: dropped from the port's side.  Every key not named here or in
#: JAX_ONLY must be in both packages' section (cross_comparable asserts it).
PORT_ONLY = {
    "rebalance": (
        "device",                       # the card the plane scores on
        "cycle_faults",                 # faulted cycles by kind (chaos_skip)
        "evictions_by_cluster",         # evictions per source cluster
        "budget/granted_by_consumer",   # the budget is shared with the
        "budget/denied_by_consumer",    # descheduler: counts per consumer
    ),
    "resident": ("device",),            # the card the mirrors live on
}
#: keys that only the JAX package reports, dropped from its side
JAX_ONLY = {
    "resident": (
        "device_plane",     # its device plane can break and fall back to
        "fused/available",  # the host; the port's kernels raise instead
        "fused/gather_s",   # wall seconds of the fused gather
        "last_audit/ts",    # the audit's wall-clock stamp
    ),
}


def _drop(section, paths):
    for path in paths:
        *head, last = path.split("/")
        d = section
        for k in head:
            d = d.get(k) if isinstance(d, dict) else None
        if isinstance(d, dict):
            d.pop(last, None)


def key_paths(d, pre=""):
    """Every key path under `d` ("a/b/c")."""
    out = set()
    if isinstance(d, dict):
        for k, v in d.items():
            out.add(f"{pre}{k}")
            out |= key_paths(v, f"{pre}{k}/")
    return out


def cross_comparable(j_payload, p_payload):
    """Both packages' SOAK payloads, comparable (`comparable`), without
    the keys PORT_ONLY and JAX_ONLY name; every other key of those
    sections is asserted present on both sides."""
    j, p = comparable(j_payload), comparable(p_payload)
    for k in set(PORT_ONLY) | set(JAX_ONLY):
        if isinstance(p.get(k), dict):
            _drop(p[k], PORT_ONLY.get(k, ()))
        if isinstance(j.get(k), dict):
            _drop(j[k], JAX_ONLY.get(k, ()))
        jk, pk = key_paths(j.get(k)), key_paths(p.get(k))
        assert jk == pk, (k, sorted(jk - pk), sorted(pk - jk))
    return j, p
