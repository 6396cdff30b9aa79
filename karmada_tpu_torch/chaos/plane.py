"""ChaosPlane: deterministic, seeded fault injection at named seams
(counterpart of the JAX package's ``chaos/plane.py``).

The serve plane survives member-cluster death by *design* (taints,
graceful eviction, admission shedding) but none of the planes UNDER the
solver — estimator RPC, device dispatch, resident mirrors, the watch
bus, worker reconciles, lease heartbeats — had a way to fail on demand,
so their failure handling was untested guesswork.  This module gives
every such seam a named injection site:

    estimator.rpc      error | timeout | slow | garbage
    device.dispatch    raise
    device.d2h         raise | poison
    device.cycle       hang
    resident.mirror    corrupt
    store.watch        drop | dup | stall | reorder
    worker.reconcile   error
    lease.heartbeat    drop

Faults are armed process-wide (`configure(spec)`, `serve --chaos SPEC`,
`Scheduler(chaos=)`) from a spec string:

    SPEC  := FAULT (';' FAULT)*
    FAULT := SITE ':' MODE [':' ARG] ['@' PROB] ['#' COUNT]

e.g. ``estimator.rpc:error@0.5`` (half of all estimator calls fail),
``device.cycle:hang:0.3#1`` (exactly one device cycle sleeps 0.3s),
``resident.mirror:corrupt#1``.  Probability draws come from a
per-rule ``random.Random`` seeded from (plane seed, site, mode, rule
index), so the same spec + seed + call sequence fires the same faults —
loadgen scenarios schedule arm/clear events on their virtual clock and
the whole storm replays bit-identically.

Disarmed cost is one list read per seam traversal (``armed()``), the
same contract as analysis/guards: the seams live directly on the
production hot paths and must be free when off.  Every site is host-side:
no seam adds a device synchronisation or changes a kernel's arguments.
"""

from __future__ import annotations

import random
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

from karmada_tpu_torch.utils.locks import VetLock
from karmada_tpu_torch.utils.metrics import REGISTRY

INJECTIONS = REGISTRY.counter(
    "karmada_chaos_injections_total",
    "Faults fired by the chaos plane, by injection site and mode",
    ("site", "mode"),
)

# -- the injection-site catalog ----------------------------------------------
SITE_ESTIMATOR_RPC = "estimator.rpc"
SITE_DEVICE_DISPATCH = "device.dispatch"
SITE_DEVICE_D2H = "device.d2h"
SITE_DEVICE_CYCLE = "device.cycle"
SITE_RESIDENT_MIRROR = "resident.mirror"
SITE_STORE_WATCH = "store.watch"
SITE_WORKER_RECONCILE = "worker.reconcile"
SITE_LEASE_HEARTBEAT = "lease.heartbeat"
SITE_REBALANCE_PLAN = "rebalance.plan"

#: site -> modes it supports (parse_spec validates against this; a seam
#: only ever interprets its own modes, so an unknown mode cannot arm)
SITES: Dict[str, Tuple[str, ...]] = {
    SITE_ESTIMATOR_RPC: ("error", "timeout", "slow", "garbage"),
    SITE_DEVICE_DISPATCH: ("raise",),
    SITE_DEVICE_D2H: ("raise", "poison"),
    SITE_DEVICE_CYCLE: ("hang",),
    SITE_RESIDENT_MIRROR: ("corrupt",),
    SITE_STORE_WATCH: ("drop", "dup", "stall", "reorder"),
    SITE_WORKER_RECONCILE: ("error",),
    SITE_LEASE_HEARTBEAT: ("drop",),
    # rebalance plane (rebalance/plane.py run_cycle): "skip" drops the
    # whole planned cycle (the next interval re-detects), "raise" aborts
    # it mid-plan — both must be contained and counted, never lose a
    # binding or leak a partial drain
    SITE_REBALANCE_PLAN: ("skip", "raise"),
}


class ChaosFault(RuntimeError):
    """The exception injected faults raise at their seam.  Deliberately a
    plain RuntimeError subclass: the surrounding machinery must handle it
    through its NORMAL failure paths (retry, backoff, degrade), never
    through chaos-aware special cases — special-casing would test the
    chaos plane, not the plane under it."""

    def __init__(self, site: str, mode: str) -> None:
        super().__init__(f"chaos fault injected at {site} (mode={mode})")
        self.site = site
        self.mode = mode


class Fault:
    """One fired fault, returned to the seam for interpretation."""

    __slots__ = ("site", "mode", "arg")

    def __init__(self, site: str, mode: str, arg: Optional[float]) -> None:
        self.site = site
        self.mode = mode
        self.arg = arg

    @property
    def delay(self) -> float:
        return self.arg if self.arg is not None else 0.0


class FaultRule:
    """One armed fault: site + mode + optional arg, probability, and a
    remaining-fire budget (None = unlimited)."""

    def __init__(self, site: str, mode: str, arg: Optional[float],
                 prob: float, count: Optional[int], seed: int,
                 index: int) -> None:
        self.site = site
        self.mode = mode
        self.arg = arg
        self.prob = prob
        self.count = count
        self.fired = 0
        # deterministic per-rule stream: the draw sequence depends only on
        # (plane seed, site, mode, rule index) and the traversal order
        self.rng = random.Random(
            (seed & 0xFFFFFFFF) ^ hash_str(f"{site}|{mode}|{index}"))

    def spent(self) -> bool:
        return self.count is not None and self.fired >= self.count

    def draw(self) -> bool:
        if self.prob >= 1.0:
            return True
        return self.rng.random() < self.prob

    def to_dict(self) -> dict:
        return {"site": self.site, "mode": self.mode, "arg": self.arg,
                "prob": self.prob, "count": self.count, "fired": self.fired}


def hash_str(s: str) -> int:
    """Stable string hash (builtin hash() is randomized per process, and
    the chaos plane's whole point is replayable fault sequences)."""
    import zlib

    return zlib.crc32(s.encode("utf-8"))


def parse_spec(spec: str, seed: int = 0) -> List[FaultRule]:
    """Parse a fault spec string into rules; ValueError on an unknown
    site/mode or malformed grammar (a typo'd chaos spec must fail the
    serve command, never silently arm nothing)."""
    rules: List[FaultRule] = []
    for i, part in enumerate(p.strip() for p in spec.replace(",", ";")
                             .split(";")):
        if not part:
            continue
        count: Optional[int] = None
        prob = 1.0
        if "#" in part:
            part, _, c = part.rpartition("#")
            try:
                count = int(c)
            except ValueError:
                raise ValueError(f"chaos spec: bad count {c!r}") from None
        if "@" in part:
            part, _, pr = part.rpartition("@")
            try:
                prob = float(pr)
            except ValueError:
                raise ValueError(
                    f"chaos spec: bad probability {pr!r}") from None
            if not 0.0 < prob <= 1.0:
                raise ValueError(
                    f"chaos spec: probability must be in (0, 1], got {prob}")
        bits = part.split(":")
        if len(bits) < 2 or len(bits) > 3:
            raise ValueError(
                f"chaos spec: expected SITE:MODE[:ARG][@PROB][#COUNT], "
                f"got {part!r}")
        site, mode = bits[0].strip(), bits[1].strip()
        arg: Optional[float] = None
        if len(bits) == 3:
            try:
                arg = float(bits[2])
            except ValueError:
                raise ValueError(
                    f"chaos spec: bad arg {bits[2]!r} (must be a number)"
                ) from None
        modes = SITES.get(site)
        if modes is None:
            raise ValueError(
                f"chaos spec: unknown site {site!r}; sites: "
                f"{', '.join(sorted(SITES))}")
        if mode not in modes:
            raise ValueError(
                f"chaos spec: site {site!r} has no mode {mode!r}; "
                f"supported: {', '.join(modes)}")
        rules.append(FaultRule(site, mode, arg, prob, count, seed, i))
    return rules


class ChaosPlane:
    """The armed rule set + fire log.  All mutation under one lock (fire
    is called from worker/publisher/estimator-pool threads); the lock is
    only ever taken while ARMED, so the disarmed path stays lock-free."""

    def __init__(self, seed: int = 0, log_cap: int = 256) -> None:
        self.seed = seed
        self._lock = VetLock("chaos.plane")
        self._rules: List[FaultRule] = []  # guarded-by: _lock
        self._next_index = 0  # guarded-by: _lock
        # guarded-by: _lock — bounded fire log (site, mode, seq, ts)
        self._log: deque = deque(maxlen=log_cap)
        self._seq = 0  # guarded-by: _lock
        self.fired_by_site: Dict[str, int] = {}  # guarded-by: _lock
        # guarded-by: _lock — (site, mode) fire totals; survives clear()
        # so the safety auditor can reason about a CLOSED fault window's
        # modes (e.g. slow fires never produce typed errors)
        self.fired_by_mode: Dict[Tuple[str, str], int] = {}

    def add(self, spec: str) -> None:
        with self._lock:
            base = self._next_index
            rules = parse_spec(spec, seed=self.seed + base)
            self._next_index = base + max(len(rules), 1)
            self._rules.extend(rules)

    def clear(self, site: Optional[str] = None) -> int:
        """Remove every rule (site=None) or just one site's; returns the
        number removed.  Loadgen fault windows end with a clear event."""
        with self._lock:
            before = len(self._rules)
            self._rules = ([] if site is None else
                           [r for r in self._rules if r.site != site])
            return before - len(self._rules)

    def fire(self, site: str, **ctx) -> Optional[Fault]:
        """First matching rule with budget whose probability draw passes
        fires (and is consumed against its count); None = no fault."""
        with self._lock:
            for rule in self._rules:
                if rule.site != site or rule.spent():
                    continue
                if not rule.draw():
                    return None  # a draw was made: the traversal is spent
                rule.fired += 1
                self._seq += 1
                self.fired_by_site[site] = self.fired_by_site.get(site, 0) + 1
                mk = (site, rule.mode)
                self.fired_by_mode[mk] = self.fired_by_mode.get(mk, 0) + 1
                self._log.append({"seq": self._seq, "site": site,
                                  "mode": rule.mode, "ts": time.time(),
                                  "ctx": {k: str(v)[:64]
                                          for k, v in ctx.items()}})
                fault = Fault(site, rule.mode, rule.arg)
                break
            else:
                return None
        INJECTIONS.inc(site=site, mode=fault.mode)
        self._annotate_span(fault)
        # lifecycle ledger: every fired fault is a timeline fact (keyed
        # by site so one outage window coalesces into a counted entry);
        # the safety auditor's accountability leg can then point at the
        # exact virtual time a seam was hit
        from karmada_tpu_torch.obs import events as obs_events

        obs_events.emit(
            obs_events.ObjectRef(kind="ChaosPlane", name=site),
            obs_events.TYPE_WARNING, obs_events.REASON_CHAOS_FAULT_INJECTED,
            f"fault injected at {site} (mode={fault.mode})", origin="chaos")
        return fault

    @staticmethod
    def _annotate_span(fault: Fault) -> None:
        """Stamp the ambient flight-recorder span so a chaos-touched cycle
        is self-evident in its trace (the auditor's 'every fault surfaced
        in a trace span' leg reads exactly this)."""
        from karmada_tpu_torch import obs

        if not obs.TRACER.enabled:
            return
        sp = obs.TRACER.current()
        if sp is not None:
            sp.set_attr(chaos_site=fault.site, chaos_mode=fault.mode)

    def fires(self, site: Optional[str] = None) -> int:
        with self._lock:
            if site is not None:
                return self.fired_by_site.get(site, 0)
            return sum(self.fired_by_site.values())

    def fires_by_mode(self) -> Dict[Tuple[str, str], int]:
        with self._lock:
            return dict(self.fired_by_mode)

    def fire_log(self) -> List[dict]:
        with self._lock:
            return list(self._log)

    def unspent_rules(self) -> List[dict]:
        """Rules that still have budget left (a finished chaos soak with
        unspent single-shot rules means the fault never reached its seam
        — the safety auditor reports it)."""
        with self._lock:
            return [r.to_dict() for r in self._rules
                    if r.count is not None and r.fired < r.count]

    def state(self) -> dict:
        with self._lock:
            return {
                "enabled": True,
                "seed": self.seed,
                "rules": [r.to_dict() for r in self._rules],
                "fired_total": sum(self.fired_by_site.values()),
                "fired_by_site": dict(self.fired_by_site),
                "recent": list(self._log)[-32:],
            }


# -- process-wide arming ------------------------------------------------------
# guarded by convention, not a lock: configure/disarm happen at plane
# startup / soak install, fire() readers take the plane's own lock.  The
# disarmed fast path is exactly one list read (the guards._ARMED pattern).
_ARMED = [False]
_PLANE: List[Optional[ChaosPlane]] = [None]


def armed() -> bool:
    return _ARMED[0]


def active() -> Optional[ChaosPlane]:
    return _PLANE[0]


def configure(spec: str = "", seed: int = 0) -> ChaosPlane:
    """Arm the process-wide chaos plane with `spec` (may be empty: an
    armed-but-ruleless plane accepts scheduled add()/clear() events, the
    loadgen fault-window shape).  Raises ValueError on a bad spec with
    the plane left disarmed."""
    plane = ChaosPlane(seed=seed)
    if spec:
        plane.add(spec)  # validate before arming
    _PLANE[0] = plane
    _ARMED[0] = True
    return plane


def disarm() -> None:
    _ARMED[0] = False
    _PLANE[0] = None


def fire(site: str, **ctx) -> Optional[Fault]:
    """The seam entry: None when disarmed (one list read) or when no
    armed rule fires.  Call under an ``armed()`` guard so the disarmed
    path pays nothing but the guard itself."""
    plane = _PLANE[0]
    if plane is None:
        return None
    return plane.fire(site, **ctx)


def raise_if(site: str, **ctx) -> None:
    """Fire-and-raise convenience for sites whose only failure shape is
    an exception (worker.reconcile, device.dispatch)."""
    f = fire(site, **ctx)
    if f is not None and f.mode in ("raise", "error"):
        raise ChaosFault(site, f.mode)


def state_payload() -> dict:
    """/debug/chaos: the armed plane's state, or {"enabled": false} so
    dashboards can poll unconditionally."""
    plane = _PLANE[0]
    if plane is None or not _ARMED[0]:
        return {"enabled": False}
    return plane.state()
