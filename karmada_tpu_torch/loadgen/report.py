"""SOAK reporting: flight-recorder spans -> SLO payload.

Counterpart of the JAX package's ``loadgen/report.py``: the same payload,
field for field.  The port has no telemetry plane (obs/slo) and no
incident plane (obs/incidents) yet, so `slo` and `incidents` are None, as
the JAX payload gives them when those planes are not armed, and no chaos
section is written (the port refuses chaotic scenarios).

The scheduler's cycle spans (obs.SPAN_CYCLE) carry bounded per-binding
samples — `e2e_samples` (first-attempt-to-outcome schedule latency on
the queue clock) and `dwell_samples` (queue wait of the drained batch),
each with its deterministic stride (scheduler/service.py).  This module
aggregates those samples across every trace the soak recorded into
p50/p95/p99, folds in the admission counters, starvation ages, and
per-stage utilization, and shapes the single JSON payload `bench.py
--soak` emits (the SOAK_r*.json contract) and `watch_bench.py` streams
as an {"event": "soak", ...} line.
"""

from __future__ import annotations

from typing import Dict, Iterable, List

from karmada_tpu_torch import obs

SOAK_VERSION = 1


def percentiles(sorted_values: List[float],
                qs: Iterable[float] = (0.5, 0.95, 0.99)) -> Dict[str, float]:
    """Nearest-rank percentiles over an already-sorted sample list, plus
    mean/max/count — the SLO summary shape used throughout the payload."""
    return weighted_percentiles([(v, 1) for v in sorted_values], qs)


def weighted_percentiles(
        sorted_pairs: List, qs: Iterable[float] = (0.5, 0.95, 0.99),
) -> Dict[str, float]:
    """Percentiles over (value, weight) pairs sorted by value.  Weights
    are the span-sample strides: a 4096-binding cycle's 512 strided
    samples each stand for ~8 bindings, and ignoring that would
    underweight exactly the large overloaded cycles whose latency the
    SLO exists to expose.  `count` is the summed weight (~measurements
    represented), and the quantile walk is over cumulative weight."""
    if not sorted_pairs:
        return {"count": 0}
    total = sum(w for _, w in sorted_pairs)
    out: Dict[str, float] = {}
    for q in qs:
        rank = q * total
        acc = 0.0
        pick = sorted_pairs[-1][0]
        for v, w in sorted_pairs:
            acc += w
            if acc >= rank:
                pick = v
                break
        out[f"p{int(q * 100)}"] = round(pick, 6)
    out["mean"] = round(sum(v * w for v, w in sorted_pairs) / total, 6)
    out["max"] = round(sorted_pairs[-1][0], 6)
    out["count"] = int(total)
    return out


def _cycle_spans(recorder) -> List[dict]:
    spans: List[dict] = []
    if recorder is None:
        return spans
    for tr in recorder.recent():
        for s in tr["spans"]:
            if s["name"] == obs.SPAN_CYCLE:
                spans.append(s)
    return spans


def _stage_utilization(recorder) -> dict:
    """Per-span-name time totals across every recorded trace, with each
    stage's share of the summed cycle-span time — where a wall-clock
    second of scheduling actually goes."""
    if recorder is None:
        return {}
    agg: Dict[str, dict] = {}
    cycle_total = 0.0
    for tr in recorder.recent():
        for s in tr["spans"]:
            d = s["end_s"] - s["start_s"]
            a = agg.setdefault(s["name"], {"count": 0, "total_s": 0.0,
                                           "max_s": 0.0})
            a["count"] += 1
            a["total_s"] += d
            if d > a["max_s"]:
                a["max_s"] = d
            if s["name"] == obs.SPAN_CYCLE:
                cycle_total += d
    for name, a in agg.items():
        a["total_s"] = round(a["total_s"], 6)
        a["max_s"] = round(a["max_s"], 6)
        if cycle_total > 0:
            a["of_cycle"] = round(a["total_s"] / cycle_total, 4)
    return agg


def span_samples(recorder, attr: str, stride_attr: str) -> List:
    """Every `attr` sample across the soak's cycle spans as
    (value, stride) pairs sorted by value — the stride each span
    recorded (scheduler/service._span_samples) is the sample's weight."""
    pairs: List = []
    for s in _cycle_spans(recorder):
        stride = s["attrs"].get(stride_attr) or 1
        pairs.extend((v, stride) for v in (s["attrs"].get(attr) or ()))
    pairs.sort(key=lambda p: p[0])
    return pairs


def _ledger_summary(driver) -> dict:
    """Lifecycle-ledger deltas over one driver run (None baseline = the
    ledger section degrades to lifetime counters)."""
    from karmada_tpu_torch.obs import events as obs_events

    cur = obs_events.ledger().counters()
    base = getattr(driver, "_events_base", None) or {}
    recorded = cur["recorded"] - base.get("recorded", 0)
    coalesced = cur["coalesced"] - base.get("coalesced", 0)
    base_rsn = base.get("by_reason", {})
    by_reason = {r: n - base_rsn.get(r, 0)
                 for r, n in cur["by_reason"].items()
                 if n - base_rsn.get(r, 0) > 0}
    duration = max(float(getattr(driver, "duration_s", 0.0)), 1e-9)
    return {
        "armed": obs_events.armed(),
        "recorded": recorded,
        "coalesced": coalesced,
        "coalesce_ratio": round(coalesced / recorded, 4) if recorded else 0.0,
        "events_per_s": round(recorded / duration, 3),
        "evicted": cur["evicted"] - base.get("evicted", 0),
        "by_reason": by_reason,
    }


def build_soak_report(driver) -> dict:
    """The SOAK payload for one finished LoadDriver run."""
    recorder = getattr(driver, "recorder", None)
    e2e = span_samples(recorder, "e2e_samples", "e2e_stride")
    dwell = span_samples(recorder, "dwell_samples", "dwell_stride")
    cycles = _cycle_spans(recorder)
    batch_sizes = sorted(s["attrs"].get("bindings", 0) for s in cycles)
    fs = driver.flight_summary()
    lat = fs.pop("latencies_sorted")
    scenario = driver.scenario
    deadline_s = (scenario.deadline_s(driver.model)
                  if not driver.realtime else None)
    payload = {
        "version": SOAK_VERSION,
        "scenario": scenario.name,
        "description": scenario.description,
        "seed": driver.seed,
        "realtime": driver.realtime,
        "model": (None if driver.realtime else {
            "per_binding_s": driver.model.per_binding_s,
            "per_cycle_s": driver.model.per_cycle_s,
            "capacity_rate": round(driver.model.capacity_rate, 3),
        }),
        "arrival": {
            "load_factor": scenario.load_factor,
            "shape": scenario.shape,
            "mean_rate": round(driver.mean_rate, 3),
            "arrivals": len(driver._arrivals),  # noqa: SLF001 — report owner
        },
        "duration_s": round(driver.duration_s, 3),
        "wall_s": round(driver.wall_s, 3),
        # SLOs from the flight recorder (scheduler cycle-span samples,
        # stride-weighted so large strided cycles count fully)
        "schedule_latency_s": weighted_percentiles(e2e),
        "queue_dwell_s": weighted_percentiles(dwell),
        # driver-side ground truth (store-bus observed inject->scheduled),
        # cross-checking the span-derived quantiles above
        "driver_latency_s": percentiles(lat),
        "admission": driver.admission_delta(),
        "queue_depth": {
            "max": fs["max_depth"],
            "bound": scenario.admission_limit(),
        },
        "starvation": {
            "max_oldest_age_s": fs["max_oldest_age_s"],
            "deadline_s": deadline_s,
            "overload_entered": fs["overload_seen"],
        },
        "cycles": {
            "count": len(cycles),
            "batch_size": percentiles([float(b) for b in batch_sizes]),
            # an empty cut leaves NO span, so the spans cannot count it;
            # the scheduler counts the invariant breach at the pop site
            "empty": driver.plane.scheduler.queue_state()["empty_cuts"],
        },
        "stage_utilization": _stage_utilization(recorder),
        # resident-state plane (resident/): hit rate, rebuild
        # reasons and audit outcomes for the soak window; None when the
        # plane runs rebuild-per-cycle
        "resident": (driver.plane.scheduler.resident_state()
                     if hasattr(driver.plane.scheduler, "resident_state")
                     else None),
        # rebalance plane (rebalance/): cycle/eviction totals,
        # last detect scores per cluster, conservation-violation count;
        # None when the plane is disarmed
        "rebalance": (driver.plane.scheduler.rebalance_state()
                      if hasattr(driver.plane.scheduler, "rebalance_state")
                      else None),
        "residual_queue": getattr(driver, "residual", {}),
        **{k: fs[k] for k in ("injected", "scheduled", "failed_attempts",
                              "reschedules")},
    }
    # telemetry plane (obs/slo): not ported, so never armed
    payload["slo"] = None
    # lifecycle ledger (obs/events): this run's event deltas against the
    # driver's install-time baseline -- events/s on the soak's own clock,
    # the coalesce ratio (how much the tail-bump saved the ring), and
    # the per-reason tally the timeline summaries key on
    payload["events"] = _ledger_summary(driver)
    # incident plane (obs/incidents): not ported, so never armed
    payload["incidents"] = None
    return payload


def render_load_state(state: dict) -> str:
    """Human one-screen rendering of a /debug/load payload
    (karmadactl loadgen --endpoint)."""
    if not state.get("enabled"):
        return ("no load generator is active on this plane "
                "(serve --loadgen SCENARIO to start one)")
    lines = [
        f"scenario {state['scenario']} "
        f"({'realtime' if state.get('realtime') else 'compressed'}, "
        f"seed {state.get('seed')})",
        f"  t {state.get('t_s')}s / {state.get('duration_s')}s; "
        f"arrivals {state.get('arrivals_injected')}/"
        f"{state.get('arrivals_total')}; "
        f"events {state.get('events_applied')}/{state.get('events_total')}",
        f"  injected {state.get('injected')} scheduled "
        f"{state.get('scheduled')} failed-attempts "
        f"{state.get('failed_attempts')} reschedules "
        f"{state.get('reschedules')}",
        f"  admission {state.get('admission')}",
    ]
    q = state.get("queue") or {}
    lines.append(f"  queue depths {q.get('depths')} "
                 f"oldest {q.get('oldest_age_s')}")
    lines.append(f"  overload={q.get('overload')} "
                 f"batch_window={q.get('batch_window')} "
                 f"deadline={q.get('batch_deadline_s')} "
                 f"admission_limit={q.get('admission_limit')}")
    return "\n".join(lines)
