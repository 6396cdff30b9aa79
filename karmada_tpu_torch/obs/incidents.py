"""Incident plane: flight recorder, trigger bus, and forensic bundles
(counterpart of the JAX package's ``obs/incidents.py``).

Every detection plane this repo has grown — SLO burn verdicts and the
RegressionWatchdog (obs/slo), the incremental dense audit
(scheduler/incremental), the LockWatchdog and order-inversion detector
(utils/locks), chaos SafetyAuditor violations (chaos/audit), backend
degrade and cycle-fault containment (scheduler/service), and the
InvariantViolation guards (analysis/guards) — fires a counter and then
throws away the context it fired in.  This module keeps that context:

* **Flight recorder** — a bounded ring of cheap structured per-cycle
  records (``kind="cycle"`` from the scheduler, ``"incremental"`` from
  the dirty-set plane, ``"facade"`` from coalesced facade dispatches).
  Armed by default like the lifecycle ledger; the disarmed cost of
  ``record()`` is one module-global list read, and the armed cost is a
  dict append under a plain lock -- pure host bookkeeping, no device
  work.

* **Trigger bus** — ``trigger(kind, ...)`` with one typed constant per
  detector (``TRIGGER_KINDS``).  Disarmed (no ``IncidentStore``
  configured) it is one list read.  Armed, each trigger kind is
  rate-limited by a per-kind cooldown on an injectable clock
  (compressed soaks pass their VirtualClock), so a flapping detector
  produces ONE bundle per cooldown window, not a bundle storm.

* **Incident bundles** — on an admitted trigger the store captures a
  self-contained JSON bundle: the flight ring, the last N MetricRing
  samples plus the SLO verdict, the lifecycle-ledger timelines of the
  implicated bindings, the ``/debug/state`` locks block, the trigger's
  own detail payload (e.g. the incremental audit divergence diff), and
  an optional bounded ``torch.profiler`` capture (obs/devprof).  Bundles
  are written under ``<dir>/<id>.json`` and indexed in memory for
  ``/debug/incidents[/{id}]`` (utils/httpserve) / ``karmadactl
  incidents``.

Capture is deliberately defensive: every section is independently
guarded, a failing plane records a ``capture_errors`` entry instead of
losing the bundle, and a thread-local reentrancy latch stops a capture
(or an InvariantViolation raised inside one) from re-triggering itself.

Metrics: ``karmada_incidents_total{trigger}``,
``karmada_incidents_suppressed_total{trigger}``,
``karmada_incident_capture_seconds`` (all registered at import; arming
the plane adds observations, never new families).
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence

from karmada_tpu_torch.utils.metrics import REGISTRY

INCIDENTS = REGISTRY.counter(
    "karmada_incidents_total",
    "incident bundles captured, by trigger kind",
    ("trigger",))
INCIDENTS_SUPPRESSED = REGISTRY.counter(
    "karmada_incidents_suppressed_total",
    "triggers suppressed by the per-kind capture cooldown",
    ("trigger",))
CAPTURE_SECONDS = REGISTRY.histogram(
    "karmada_incident_capture_seconds",
    "wall seconds spent assembling one incident bundle")

# -- typed trigger kinds (the bus vocabulary) --------------------------------

TRIGGER_SLO_UNHEALTHY = "slo-unhealthy"          # obs/slo healthy -> False
TRIGGER_REGRESSION = "regression-watchdog"       # obs/slo RegressionWatchdog
TRIGGER_LOCK_WATCHDOG = "lock-watchdog"          # utils/locks LockWatchdog
TRIGGER_LOCK_INVERSION = "lock-inversion"        # utils/locks order inversion
TRIGGER_AUDIT_DIVERGENCE = "audit-divergence"    # incremental dense audit
TRIGGER_SAFETY_VIOLATION = "safety-violation"    # chaos SafetyAuditor
TRIGGER_BACKEND_DEGRADE = "backend-degrade"      # scheduler degrade path
TRIGGER_CYCLE_FAULT = "cycle-fault"              # contained cycle fault
TRIGGER_INVARIANT_VIOLATION = "invariant-violation"  # analysis/guards

TRIGGER_KINDS = (
    TRIGGER_SLO_UNHEALTHY, TRIGGER_REGRESSION, TRIGGER_LOCK_WATCHDOG,
    TRIGGER_LOCK_INVERSION, TRIGGER_AUDIT_DIVERGENCE,
    TRIGGER_SAFETY_VIOLATION, TRIGGER_BACKEND_DEGRADE, TRIGGER_CYCLE_FAULT,
    TRIGGER_INVARIANT_VIOLATION,
)


# -- flight recorder ---------------------------------------------------------


class FlightRecorder:
    """Bounded ring of per-cycle flight records (plain dicts)."""

    def __init__(self, capacity: int = 512) -> None:
        self.capacity = max(1, int(capacity))
        self._ring: deque = deque(maxlen=self.capacity)  # guarded-by: _lock
        self._lock = threading.Lock()
        self.recorded = 0  # guarded-by: _lock

    def record(self, rec: dict) -> None:
        with self._lock:
            self._ring.append(rec)
            self.recorded += 1

    def snapshot(self, n: Optional[int] = None) -> List[dict]:
        """The most recent n records (all when None), oldest first."""
        with self._lock:
            out = list(self._ring)
        if n is None:
            return out
        n = int(n)
        return out[-n:] if n > 0 else []

    def stats(self) -> dict:
        with self._lock:
            return {"recorded": self.recorded, "retained": len(self._ring),
                    "capacity": self.capacity}


_FLIGHT_ARMED = [True]
_FLIGHT: List[FlightRecorder] = [FlightRecorder()]


def flight() -> FlightRecorder:
    return _FLIGHT[0]


def flight_armed() -> bool:
    return _FLIGHT_ARMED[0]


def arm_flight(on: bool = True) -> None:
    _FLIGHT_ARMED[0] = bool(on)


def configure_flight(capacity: int = 512) -> FlightRecorder:
    """Install a fresh flight ring (tests wanting isolation; serve keeps
    the default).  Re-arms recording."""
    rec = FlightRecorder(capacity=capacity)
    _FLIGHT[0] = rec
    _FLIGHT_ARMED[0] = True
    return rec


def record(kind: str, **fields) -> bool:
    """Append one flight record.  One list read when disarmed; callers
    computing expensive fields should hoist ``flight_armed()`` first
    (the obs_events.armed() pattern)."""
    if not _FLIGHT_ARMED[0]:
        return False
    fields["kind"] = kind
    _FLIGHT[0].record(fields)
    return True


# -- incident store ----------------------------------------------------------


class IncidentStore:
    """Cooldown-gated bundle capture + the bounded in-memory index.

    ``dir=None`` keeps bundles in memory only; serve passes
    ``<plane dir>/incidents``.  The clock is injectable so compressed
    soaks rate-limit on virtual time."""

    def __init__(self, dir: Optional[str] = None, *,  # noqa: A002 — dir
                 # mirrors the JAX package's signature
                 cooldown_s: float = 60.0, flight_n: int = 256,
                 ring_n: int = 64, keep: int = 64, profile_s: float = 0.0,
                 clock: Callable[[], float] = time.time) -> None:
        self.dir = dir
        self.cooldown_s = float(cooldown_s)
        self.flight_n = int(flight_n)
        self.ring_n = int(ring_n)
        self.keep = max(1, int(keep))
        self.profile_s = float(profile_s)
        self._clock = clock
        # plain Lock BY DESIGN: triggers fire from inside utils/locks'
        # own bookkeeping -- a VetLock here would self-trace
        self._lock = threading.Lock()
        self._seq = 0  # guarded-by: _lock
        self._last_fire: Dict[str, float] = {}  # guarded-by: _lock
        self._suppressed: Dict[str, int] = {}  # guarded-by: _lock
        self._by_trigger: Dict[str, int] = {}  # guarded-by: _lock
        self._index: deque = deque(maxlen=self.keep)  # guarded-by: _lock
        self._bundles: Dict[str, dict] = {}  # guarded-by: _lock

    # -- the bus entry --------------------------------------------------------
    def trigger(self, kind: str, summary: str = "", *,
                refs: Optional[Sequence] = None,
                detail: Optional[dict] = None) -> Optional[str]:
        """Admit-or-suppress one typed trigger; returns the bundle id
        when a capture ran, None when the cooldown suppressed it."""
        assert kind in TRIGGER_KINDS, f"unknown trigger kind {kind!r}"
        now = self._clock()
        with self._lock:
            last = self._last_fire.get(kind)
            if last is not None and now - last < self.cooldown_s:
                self._suppressed[kind] = self._suppressed.get(kind, 0) + 1
                INCIDENTS_SUPPRESSED.inc(trigger=kind)
                return None
            self._last_fire[kind] = now
            self._seq += 1
            iid = f"inc-{self._seq:04d}-{kind}"
        t0 = time.perf_counter()
        bundle = self._capture(iid, kind, summary, list(refs or []),
                               detail, now)
        capture_s = time.perf_counter() - t0
        bundle["capture_s"] = round(capture_s, 6)
        CAPTURE_SECONDS.observe(capture_s)
        INCIDENTS.inc(trigger=kind)
        entry = {"id": iid, "trigger": kind, "summary": summary,
                 "ts": round(now, 6), "capture_s": round(capture_s, 6),
                 "path": bundle.get("path")}
        with self._lock:
            self._by_trigger[kind] = self._by_trigger.get(kind, 0) + 1
            if len(self._index) == self._index.maxlen:
                evicted = self._index[0]
                self._bundles.pop(evicted["id"], None)
            self._index.append(entry)
            self._bundles[iid] = bundle
        return iid

    # -- bundle assembly ------------------------------------------------------
    def _capture(self, iid: str, kind: str, summary: str, refs: list,
                 detail: Optional[dict], now: float) -> dict:
        errors: List[str] = []

        def guard(name: str, fn):
            # forensics must never take down the plane it observes: a
            # broken section records its error and the rest still lands
            try:
                return fn()
            # vet: ignore[exception-hygiene] recorded in capture_errors
            except Exception as e:  # noqa: BLE001 — one bad plane must
                # not lose the whole bundle
                errors.append(f"{name}: {e!r}")
                return None

        bundle: dict = {
            "id": iid, "trigger": kind, "summary": summary,
            "ts": round(now, 6), "wall_unix": round(time.time(), 3),
            "cooldown_s": self.cooldown_s,
            "detail": detail or {},
        }

        def _flight_block():
            rec = flight()
            return {"armed": flight_armed(), **rec.stats(),
                    "records": rec.snapshot(self.flight_n)}

        bundle["flight"] = guard("flight", _flight_block)

        def _telemetry_block():
            from karmada_tpu_torch.obs import timeseries as obs_ts

            ring = obs_ts.active()
            if ring is None:
                return {"enabled": False, "samples": []}
            return {"enabled": True,
                    "samples": [[round(t, 6), snap]
                                for t, snap in ring.samples(self.ring_n)]}

        bundle["telemetry"] = guard("telemetry", _telemetry_block)

        def _slo_block():
            from karmada_tpu_torch.obs import slo as obs_slo

            return obs_slo.state_payload()

        bundle["slo"] = guard("slo", _slo_block)

        def _locks_block():
            from karmada_tpu_torch.utils import locks

            return locks.state_payload()

        bundle["locks"] = guard("locks", _locks_block)

        def _timelines_block():
            from karmada_tpu_torch.obs import events as obs_events

            led = obs_events.ledger()
            timelines: Dict[str, list] = {}
            for r in refs[:16]:
                if isinstance(r, str):
                    ns, _, nm = r.partition("/")
                else:
                    ns, nm = r
                timelines[f"{ns}/{nm}"] = led.timeline(
                    "ResourceBinding", ns, nm)
            return timelines

        bundle["timelines"] = guard("timelines", _timelines_block)

        def _recent_events_block():
            from karmada_tpu_torch.obs import events as obs_events

            return obs_events.ledger().recent(n=32)

        bundle["recent_events"] = guard("recent_events", _recent_events_block)

        if self.profile_s > 0 and self.dir:
            def _profile_block():
                from karmada_tpu_torch.obs import devprof

                return devprof.capture_profile(
                    self.profile_s, os.path.join(self.dir, f"{iid}-profile"))

            bundle["profile"] = guard("profile", _profile_block)

        def _emit_block():
            from karmada_tpu_torch.obs import events as obs_events

            obs_events.emit(
                obs_events.SCHEDULER_REF, obs_events.TYPE_WARNING,
                obs_events.REASON_INCIDENT_CAPTURED,
                f"incident {iid} captured (trigger {kind})"
                + (f": {summary}" if summary else ""),
                origin="incidents")

        guard("ledger_emit", _emit_block)

        if self.dir:
            def _write_block():
                os.makedirs(self.dir, exist_ok=True)
                path = os.path.join(self.dir, f"{iid}.json")
                with open(path, "w") as f:
                    json.dump(bundle, f, indent=2, default=str)
                return path

            bundle["path"] = guard("write", _write_block)
        else:
            bundle["path"] = None
        if errors:
            bundle["capture_errors"] = errors
        return bundle

    # -- read side ------------------------------------------------------------
    def bundle(self, iid: str) -> Optional[dict]:
        """One bundle by id: the in-memory copy, falling back to the
        on-disk artifact for entries the bounded index evicted."""
        with self._lock:
            b = self._bundles.get(iid)
        if b is not None:
            return b
        if self.dir:
            path = os.path.join(self.dir, f"{os.path.basename(iid)}.json")
            if os.path.exists(path):
                with open(path) as f:
                    return json.load(f)
        return None

    def state_payload(self) -> dict:
        """/debug/incidents: the index plus capture/suppression totals
        (bundles themselves are one fetch deeper)."""
        with self._lock:
            index = list(self._index)
            by_trigger = dict(self._by_trigger)
            suppressed = dict(self._suppressed)
        return {
            "enabled": True,
            "dir": self.dir,
            "cooldown_s": self.cooldown_s,
            "captured": sum(by_trigger.values()),
            "by_trigger": by_trigger,
            "suppressed": suppressed,
            "flight": flight().stats(),
            "incidents": index,
        }


# -- module-level plane (the serve/test arming surface) ----------------------

_STORE: List[Optional[IncidentStore]] = [None]
_TLS = threading.local()


def active() -> Optional[IncidentStore]:
    return _STORE[0]


def configure(dir: Optional[str] = None, *,  # noqa: A002 — mirrors
              # IncidentStore's constructor
              cooldown_s: float = 60.0, flight_n: int = 256,
              ring_n: int = 64, keep: int = 64, profile_s: float = 0.0,
              clock: Callable[[], float] = time.time) -> IncidentStore:
    """Arm the incident store (serve startup / soak tests).  The flight
    recorder is independent and armed by default."""
    store = IncidentStore(dir, cooldown_s=cooldown_s, flight_n=flight_n,
                          ring_n=ring_n, keep=keep, profile_s=profile_s,
                          clock=clock)
    _STORE[0] = store
    return store


def disarm() -> None:
    """Detach the store: triggers become one-list-read no-ops again.
    Captured bundle files stay on disk."""
    _STORE[0] = None


def trigger(kind: str, summary: str = "", *,
            refs: Optional[Sequence] = None,
            detail: Optional[dict] = None) -> Optional[str]:
    """The process-wide trigger bus.  One list read when no store is
    armed.  Reentrancy-latched: a capture's own work (or an
    InvariantViolation raised inside one) cannot recurse into another
    capture.  Never raises — forensics must not break the detector that
    fired it."""
    store = _STORE[0]
    if store is None:
        return None
    if getattr(_TLS, "in_trigger", False):
        return None
    _TLS.in_trigger = True
    try:
        return store.trigger(kind, summary, refs=refs, detail=detail)
    # vet: ignore[exception-hygiene] capture faults must never propagate into the detector paths that fired them
    except Exception:  # noqa: BLE001 — swallowed by contract (see above)
        return None
    finally:
        _TLS.in_trigger = False


def state_payload() -> dict:
    """/debug/incidents (module form): {"enabled": False} plus flight
    stats when no store is armed -- pollable unconditionally."""
    store = _STORE[0]
    if store is None:
        return {"enabled": False, "flight": flight().stats()}
    return store.state_payload()


def bundle_payload(iid: str) -> Optional[dict]:
    store = _STORE[0]
    if store is None:
        return None
    return store.bundle(iid)
