"""Post-soak safety auditor: conservation invariants over a chaos run
(counterpart of the JAX package's ``chaos/audit.py``).

A fault-injection soak is only evidence if something PROVES the plane
stayed safe while faults were flying.  This module does that proof over
one finished LoadDriver run:

  conservation   every injected binding is exactly one of scheduled /
                 still queued / shed-accounted — none lost, and no
                 scheduled binding is double-placed (duplicate target
                 clusters in spec.clusters);
  accountability every fired fault has an observable consequence: an
                 estimator fault is a typed error count or a broken-open
                 circuit, a device fault is a contained cycle fault or a
                 backend degrade, a resident corruption is an audit
                 mismatch + forced rebuild, a single-shot rule that
                 never reached its seam is itself reported;
  recovery       a degrade that happened re-armed (when recovery is
                 configured), an opened circuit is closed again by the
                 end of the run (when the outage was cleared).

`capture_baseline()` snapshots the relevant counters at soak install;
`audit_soak(driver, baseline)` returns the payload embedded in the SOAK
report (`safety_audit`) -- `violations` is the list the chaos tests
assert empty.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from karmada_tpu_torch.chaos import plane as chaos_plane
from karmada_tpu_torch.obs import events as obs_events


def _readers() -> Dict[str, object]:
    """name -> zero-arg reader.  Mostly cross-label Counter.total(); the
    resident-audit reader is pinned to outcome="mismatch" — the forced
    audit ALWAYS runs on a corruption fire, so counting its outcome="ok"
    leg too would make the mismatch proof vacuous."""
    from karmada_tpu_torch.estimator import client as est_client
    from karmada_tpu_torch.rebalance import plane as rebalance_plane
    from karmada_tpu_torch.resident import state as resident_state
    from karmada_tpu_torch.scheduler import metrics as sched_metrics
    from karmada_tpu_torch.store import worker as store_worker

    return {
        "rebalance_conservation":
            rebalance_plane.CONSERVATION_VIOLATIONS.total,
        "rebalance_cycle_faults": rebalance_plane.CYCLE_FAULTS.total,
        "estimator_errors": est_client.ESTIMATOR_ERRORS.total,
        "circuit_transitions": est_client.CIRCUIT_TRANSITIONS.total,
        "cycle_faults": sched_metrics.CYCLE_FAULTS.total,
        "backend_degraded": sched_metrics.BACKEND_DEGRADED.total,
        "backend_rearmed": sched_metrics.BACKEND_REARMED.total,
        "resident_audits_mismatch": (
            lambda: resident_state.RESIDENT_AUDITS.value(
                outcome="mismatch")),
        "resident_rebuilds": resident_state.RESIDENT_REBUILDS.total,
        "worker_errors": store_worker.RECONCILE_ERRORS.total,
        "chaos_injections": chaos_plane.INJECTIONS.total,
    }


def capture_baseline() -> Dict[str, float]:
    """Counter readings at soak install time (the registry is
    process-wide and cumulative; the audit reasons over this run's
    deltas only)."""
    return {name: read() for name, read in _readers().items()}


def _deltas(baseline: Dict[str, float]) -> Dict[str, float]:
    return {name: read() - baseline.get(name, 0.0)
            for name, read in _readers().items()}


def surface_violations(violations: List[dict]) -> None:
    """Surface each violation on the lifecycle ledger
    (``REASON_SafetyViolation``, keyed by the violated invariant, on the
    implicated binding's timeline when one is named) and fire the
    incident trigger per invariant kind so a forensic bundle lands."""
    if not violations:
        return
    by_kind: Dict[str, List[dict]] = {}
    for v in violations:
        kind = str(v.get("kind", "unknown"))
        by_kind.setdefault(kind, []).append(v)
        msg = (f"safety invariant {kind!r} violated: "
               f"{v.get('detail', '')}")
        ref = v.get("binding")
        if isinstance(ref, str) and "/" in ref:
            ns, _, nm = ref.partition("/")
            obs_events.emit_key((ns, nm), obs_events.TYPE_WARNING,
                                obs_events.REASON_SAFETY_VIOLATION,
                                msg, origin="chaos-audit")
        else:
            obs_events.emit(obs_events.SCHEDULER_REF,
                            obs_events.TYPE_WARNING,
                            obs_events.REASON_SAFETY_VIOLATION,
                            msg, origin="chaos-audit")
    from karmada_tpu_torch.obs import incidents as obs_incidents

    for kind, vs in sorted(by_kind.items()):
        obs_incidents.trigger(
            obs_incidents.TRIGGER_SAFETY_VIOLATION,
            f"safety auditor: {len(vs)} {kind!r} violation(s)",
            refs=[v["binding"] for v in vs
                  if isinstance(v.get("binding"), str)][:16],
            detail={"kind": kind, "count": len(vs),
                    "violations": vs[:10]})


def audit_soak(driver, baseline: Optional[Dict[str, float]] = None) -> dict:
    """The safety-audit payload for one finished LoadDriver run.  Must be
    called after `_drain` while the plane (store + queues) is intact and
    the chaos plane is still armed."""
    from karmada_tpu_torch.models.work import ResourceBinding

    baseline = baseline or {}
    deltas = _deltas(baseline)
    violations: List[dict] = []
    plane = chaos_plane.active()
    sched = driver.plane.scheduler
    store = driver.plane.store

    # -- conservation: injected == scheduled + queued + shed-accounted ------
    scheduled = queued = missing = double_placed = 0
    with driver._lock:  # noqa: SLF001 — the auditor is a driver-side report
        flights = dict(driver._flight)  # noqa: SLF001
    for key, rec in flights.items():
        if rec.done:
            scheduled += 1
            rb = store.try_get(ResourceBinding.KIND, key[0], key[1])
            if rb is not None:
                names = [t.name for t in rb.spec.clusters]
                if len(names) != len(set(names)):
                    double_placed += 1
                    violations.append({
                        "kind": "double-placed", "binding": "/".join(key),
                        "clusters": names})
            continue
        with sched._queue_lock:  # noqa: SLF001 — consistent queue membership
            resident = sched.queue.has(key)
        if resident:
            queued += 1
        else:
            missing += 1
    adm = driver.admission_delta()
    shed_budget = adm.get("shed", 0) + adm.get("displaced", 0)
    if missing > shed_budget:
        violations.append({
            "kind": "binding-lost",
            "detail": f"{missing} binding(s) neither scheduled nor queued "
                      f"but only {shed_budget} shed/displaced decisions "
                      "account for terminally-dropped bindings"})
    conservation = {
        "injected": len(flights),
        "scheduled": scheduled,
        "queued_residual": queued,
        "unaccounted": missing,
        "shed_budget": shed_budget,
        "double_placed": double_placed,
    }

    # -- ledger-derived conservation (the lifecycle-ledger variant) ----------
    # the same invariant proved a SECOND way, from the event timelines
    # alone: every injected binding has a non-empty timeline whose
    # terminal event is consistent with the store/queue state the
    # recompute above read.  A disagreement means one of the two
    # accountings lies — both land in `violations`.
    ledger_conservation = _ledger_conservation(flights, sched, driver,
                                               violations)

    # -- fault accountability ------------------------------------------------
    fires: Dict[str, int] = {}
    unspent: List[dict] = []
    if plane is not None:
        fires = dict(plane.fired_by_site)
        unspent = plane.unspent_rules()
    for rule in unspent:
        violations.append({
            "kind": "fault-unfired",
            "detail": "a budgeted fault never reached its seam "
                      "(site dead or scenario mis-ordered)", "rule": rule})
    # slow-mode fires delay but do not error; only the FAILING estimator
    # modes must have been classified as typed errors (retries traverse
    # the seam again, so errors can only exceed distinct logical calls).
    # Per-mode totals come from the plane's persistent (site, mode)
    # ledger — armed rules vanish on clear(), so a closed outage window
    # must still account here.
    est_fail_fires = 0
    if plane is not None:
        est_fail_fires = sum(
            n for (site, mode), n in plane.fires_by_mode().items()
            if site == chaos_plane.SITE_ESTIMATOR_RPC and mode != "slow")
    if est_fail_fires and deltas["estimator_errors"] <= 0:
        violations.append({
            "kind": "fault-unaccounted", "site": chaos_plane.SITE_ESTIMATOR_RPC,
            "detail": f"{est_fail_fires} failing estimator fault(s) fired "
                      "but karmada_estimator_errors_total never moved"})
    device_fires = (fires.get(chaos_plane.SITE_DEVICE_DISPATCH, 0)
                    + fires.get(chaos_plane.SITE_DEVICE_D2H, 0))
    if device_fires and deltas["cycle_faults"] <= 0:
        violations.append({
            "kind": "fault-unaccounted", "site": "device.dispatch/d2h",
            "detail": f"{device_fires} device fault(s) fired but no cycle "
                      "fault was contained "
                      "(karmada_scheduler_cycle_faults_total)"})
    hang_fires = fires.get(chaos_plane.SITE_DEVICE_CYCLE, 0)
    if hang_fires and deltas["backend_degraded"] <= 0:
        violations.append({
            "kind": "fault-unaccounted", "site": chaos_plane.SITE_DEVICE_CYCLE,
            "detail": f"{hang_fires} device-cycle hang(s) fired but the "
                      "backend never degraded"})
    # rebalance plane: the conservation invariant holds across the whole
    # soak (no binding with an in-flight rebalance drain ever served
    # fewer than its desired replicas), and a fired rebalance.plan fault
    # must be visible as a contained cycle fault
    if deltas["rebalance_conservation"] > 0:
        violations.append({
            "kind": "rebalance-conservation",
            "detail": f"{int(deltas['rebalance_conservation'])} binding(s) "
                      "dropped below their desired replica count while a "
                      "rebalance eviction was in flight"})
    plan_fires = fires.get(chaos_plane.SITE_REBALANCE_PLAN, 0)
    if plan_fires and deltas["rebalance_cycle_faults"] <= 0:
        violations.append({
            "kind": "fault-unaccounted",
            "site": chaos_plane.SITE_REBALANCE_PLAN,
            "detail": f"{plan_fires} rebalance.plan fault(s) fired but "
                      "no rebalance cycle fault was contained "
                      "(karmada_rebalance_cycle_faults_total)"})
    corrupt_fires = fires.get(chaos_plane.SITE_RESIDENT_MIRROR, 0)
    if corrupt_fires and deltas["resident_audits_mismatch"] <= 0:
        violations.append({
            "kind": "fault-unaccounted",
            "site": chaos_plane.SITE_RESIDENT_MIRROR,
            "detail": f"{corrupt_fires} resident corruption(s) fired but "
                      "the parity audit never reported a mismatch"})

    # -- recovery ------------------------------------------------------------
    recovery: Dict[str, object] = {}
    if deltas["backend_degraded"] > 0:
        recovery["backend_degraded"] = deltas["backend_degraded"]
        recovery["backend_rearmed"] = deltas["backend_rearmed"]
        rearm_cfg = getattr(sched, "device_recover_cycles", None)
        if rearm_cfg and deltas["backend_rearmed"] <= 0:
            violations.append({
                "kind": "recovery-missed",
                "detail": "the backend degraded and recovery is configured "
                          f"(device_recover_cycles={rearm_cfg}) but it "
                          "never re-armed"})
        if rearm_cfg and sched.backend != "device" and \
                deltas["backend_rearmed"] > 0:
            violations.append({
                "kind": "recovery-missed",
                "detail": f"backend ended the run on {sched.backend!r} "
                          "despite a re-arm (degraded again without "
                          "another hang?)"})
    breaker = getattr(driver, "estimator_breaker", None)
    if breaker is not None:
        states = breaker.states()
        recovery["circuit_states"] = states
        stuck = [c for c, s in states.items() if s != "closed"]
        if est_fail_fires and stuck and not _outage_still_armed(plane):
            violations.append({
                "kind": "recovery-missed",
                "detail": "estimator outage ended but circuit(s) "
                          f"{stuck} never closed again"})

    surface_violations(violations)

    return {
        "violations": violations,
        "conservation": conservation,
        "ledger_conservation": ledger_conservation,
        "fault_fires": fires,
        "metric_deltas": {k: round(v, 6) for k, v in deltas.items()},
        "recovery": recovery,
    }


#: lifecycle-ledger reason -> terminal-state class for the ledger-derived
#: conservation walk (newest matching event wins)
_TERMINAL_STATES = {
    obs_events.REASON_SCHEDULE_BINDING_SUCCEED: "scheduled",
    obs_events.REASON_BINDING_SHED: "shed",
    obs_events.REASON_BINDING_DISPLACED: "shed",
    obs_events.REASON_SCHEDULE_BINDING_FAILED: "queued",
    obs_events.REASON_BINDING_ENQUEUED: "queued",
    obs_events.REASON_EVICT_WORKLOAD_FROM_CLUSTER: "evicted",
    obs_events.REASON_REBALANCE_EVICTED: "evicted",
}


def _ledger_terminal(timeline) -> tuple:
    """(terminal state, reasons seen) of one timeline: the newest event
    whose reason names a terminal class decides."""
    seen = set()
    terminal = "missing"
    for evd in timeline:
        seen.add(evd["reason"])
    for evd in reversed(timeline):
        state = _TERMINAL_STATES.get(evd["reason"])
        if state is not None:
            terminal = state
            break
    return terminal, seen


def _ledger_conservation(flights, sched, driver, violations) -> dict:
    """The ledger-derived conservation verdict: classify every injected
    binding from its event timeline and cross-check against the live
    store/queue state (the legacy recompute's inputs).

    Consistency rules per binding:
      * still resident in a queue  -> terminal `queued` or `evicted`
        (an eviction's re-push lands an enqueued event next, so a
        resident binding's tail is one of exactly these);
      * observed scheduled (flight.done) and not resident -> terminal
        `scheduled`, or `shed` only when a ScheduleBindingSucceed event
        precedes it (a once-scheduled binding re-offered by a cluster
        kill may legitimately be shed while re-waiting);
      * neither -> terminal `shed` (the only legitimate way to drop);
      * an empty timeline is always a gap (the ledger missed a life).
    """
    if not obs_events.armed():
        return {"enabled": False}
    led = obs_events.ledger()
    # capacity eviction during THIS run: an early binding's whole
    # timeline may have been pruned oldest-first — that is the bounded
    # journal doing its job, not a missed life, so pruned timelines are
    # REPORTED (the gap_free flag still drops) but never violations.
    # With zero evictions, a missing timeline can only be a real gap.
    base = getattr(driver, "_events_base", None) or {}
    evicted_delta = led.counters()["evicted"] - base.get("evicted", 0)
    # run scoping: the process ledger outlives drivers (a pytest process
    # runs many soaks), and deterministic binding names recur across
    # runs — only events whose ACTIVITY postdates this run's install
    # baseline count, or a prior run's stale terminal would mask a real
    # gap in this one
    seq_base = base.get("seq", 0)
    counts: Dict[str, int] = {}
    disagreements: List[dict] = []
    pruned = 0
    for key, rec in flights.items():
        ns, name = key
        timeline = [e for e in led.timeline("ResourceBinding", ns, name)
                    if e["last_seq"] > seq_base]
        terminal, seen = _ledger_terminal(timeline)
        if terminal == "missing" and evicted_delta > 0:
            pruned += 1
            counts["pruned"] = counts.get("pruned", 0) + 1
            continue
        counts[terminal] = counts.get(terminal, 0) + 1
        with sched._queue_lock:  # noqa: SLF001 — consistent membership
            resident = sched.queue.has(key)
        if resident:
            ok = terminal in ("queued", "evicted")
            expect = "queued|evicted (still resident)"
        elif rec.done:
            ok = terminal == "scheduled" or (
                terminal == "shed"
                and obs_events.REASON_SCHEDULE_BINDING_SUCCEED in seen)
            expect = "scheduled (observed done)"
        else:
            ok = terminal == "shed"
            expect = "shed (terminally dropped)"
        if not ok:
            disagreements.append({
                "binding": f"{ns}/{name}", "terminal": terminal,
                "expected": expect, "events": len(timeline)})
    for d in disagreements[:8]:
        violations.append({
            "kind": ("timeline-gap" if d["terminal"] == "missing"
                     else "ledger-disagreement"),
            "detail": f"binding {d['binding']} timeline terminal "
                      f"{d['terminal']!r} but store state expects "
                      f"{d['expected']}", **d})
    if len(disagreements) > 8:
        violations.append({
            "kind": "ledger-disagreement",
            "detail": f"{len(disagreements) - 8} further timeline "
                      "disagreement(s) truncated"})
    return {
        "enabled": True,
        "checked": len(flights),
        "terminal": counts,
        "gap_free": counts.get("missing", 0) == 0 and pruned == 0,
        "pruned_by_eviction": pruned,
        "evicted_events": int(evicted_delta),
        "disagreements": len(disagreements),
        "agrees": not disagreements,
    }


def _outage_still_armed(plane) -> bool:
    """True while an unlimited estimator fault rule is still armed (the
    circuit legitimately stays open until the outage clears)."""
    if plane is None:
        return False
    with plane._lock:  # noqa: SLF001 — read-only introspection
        return any(r.site == chaos_plane.SITE_ESTIMATOR_RPC
                   and not r.spent() for r in plane._rules)  # noqa: SLF001
