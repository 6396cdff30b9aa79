"""Explain plane: per-binding placement Decision records.

The port's copy of the JAX package's ``obs/decisions.py``.  The explain
variant of the device solve (ops/solver ``schedule_core(explain=True)``,
ops/spread ``solve_spread(explain=True)``) emits per-(binding, cluster)
filter-verdict bitmasks, a score/capacity breakdown and a per-binding
outcome code; they are decoded here into bounded, JSON-ready Decision
dicts.  The recorder is always passed in by the caller
(``schedule_items(explain=DecisionRecorder())``): there is no
process-wide recorder in the port.  Every recorded decision counts on
karmada_explain_decisions_total by outcome.

This module is the single authority for the verdict BIT LAYOUT.  Bit k
set means filter stage k REJECTED the cluster for that binding, and the
bit order IS the serial reference's first-rejection-wins plugin order
(ops/serial.FILTER_PLUGINS, then registry plugins), so the lowest set
bit of a mask equals the reason serial's diagnosis reports.  It imports
nothing of torch or the ops: the encoder and the kernels' wrappers read
the bit layout from here.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Dict, List, Optional, Sequence

from karmada_tpu_torch.utils.metrics import REGISTRY

# -- verdict bitmask layout ---------------------------------------------------
# Bits 0..5 mirror the serial filter chain's evaluation order; bits 6..8
# are device-path stages with no serial-diagnosis equivalent (capacity
# shortfalls surface as UnschedulableError there, deleting clusters are
# skipped, and selection trims are silent).
VERDICT_BIT_API_ENABLEMENT = 0   # APIEnablement
VERDICT_BIT_TOLERATION = 1       # TaintToleration
VERDICT_BIT_AFFINITY = 2         # ClusterAffinity
VERDICT_BIT_SPREAD_PROP = 3      # SpreadConstraint property filter
VERDICT_BIT_EVICTION = 4         # ClusterEviction (graceful eviction)
VERDICT_BIT_PLUGIN = 5           # out-of-tree registry filter
VERDICT_BIT_CAPACITY = 6         # estimator: zero replicas fit
VERDICT_BIT_NOT_SELECTED = 7     # feasible but eliminated by spread
                                 # selection / division trimming
VERDICT_BIT_CLUSTER_GONE = 8     # deleting cluster / padding lane

VERDICT_API_ENABLEMENT = 1 << VERDICT_BIT_API_ENABLEMENT
VERDICT_TOLERATION = 1 << VERDICT_BIT_TOLERATION
VERDICT_AFFINITY = 1 << VERDICT_BIT_AFFINITY
VERDICT_SPREAD_PROP = 1 << VERDICT_BIT_SPREAD_PROP
VERDICT_EVICTION = 1 << VERDICT_BIT_EVICTION
VERDICT_PLUGIN = 1 << VERDICT_BIT_PLUGIN
VERDICT_CAPACITY = 1 << VERDICT_BIT_CAPACITY
VERDICT_NOT_SELECTED = 1 << VERDICT_BIT_NOT_SELECTED
VERDICT_CLUSTER_GONE = 1 << VERDICT_BIT_CLUSTER_GONE

N_VERDICT_BITS = 9

#: bit index -> canonical reason name (the reason taxonomy the queue's
#: unschedulable map and karmada_schedule_unschedulable_total share)
VERDICT_BIT_NAMES = (
    "api_enablement", "toleration", "affinity", "spread_property",
    "eviction", "plugin_filter", "capacity", "not_selected", "cluster_gone",
)

#: classifier-only reasons (no per-cluster bit): group-DFS shortfalls and
#: everything the heuristics cannot place
REASON_SPREAD_SELECTION = "spread_selection"
REASON_UNKNOWN = "unknown"

#: reason name -> operator-facing phrase for the kube-scheduler-style
#: one-liner ("0/5 clusters are available: 3 insufficient capacity, ...")
REASON_LABEL = {
    "api_enablement": "API not enabled",
    "toleration": "untolerated taint",
    "affinity": "affinity mismatch",
    "spread_property": "missing spread topology property",
    "eviction": "eviction in progress",
    "plugin_filter": "rejected by plugin filter",
    "capacity": "insufficient capacity",
    "not_selected": "eliminated by spread selection",
    "cluster_gone": "cluster deleting",
    REASON_SPREAD_SELECTION: "spread group selection failed",
    REASON_UNKNOWN: "unschedulable",
}

#: outcome-code low byte (ops/tensors STATUS_*) -> outcome name
OUTCOME_NAMES = {0: "scheduled", 1: "no_fit", 2: "unschedulable",
                 3: "no_cluster"}

#: per-decision cluster-table bound: assigned clusters are always kept,
#: rejected ones up to this many (full per-reason counts are always kept)
MAX_DECISION_CLUSTERS = 128

DECISIONS_TOTAL = REGISTRY.counter(
    "karmada_explain_decisions_total",
    "Explain-plane placement decisions recorded, by outcome",
    ("outcome",),
)

def first_reason(mask: int) -> Optional[str]:
    """The serial-priority reason of a verdict mask: its LOWEST set bit
    (bit order == serial first-rejection-wins order), or None when the
    cluster passed every stage."""
    if not mask:
        return None
    return VERDICT_BIT_NAMES[(mask & -mask).bit_length() - 1]


def reasons_of(mask: int) -> List[str]:
    """Every stage a verdict mask names, in priority order."""
    return [name for k, name in enumerate(VERDICT_BIT_NAMES)
            if mask & (1 << k)]


def split_outcome(code: int) -> tuple:
    """(status, dominant reason name | None) of a per-binding outcome
    code: low byte is the solver STATUS_*, bits 8+ hold 1 + the dominant
    rejection stage's bit index (0 = no rejected clusters)."""
    status = int(code) & 0xFF
    dom = int(code) >> 8
    return status, (VERDICT_BIT_NAMES[dom - 1] if dom else None)


# substring -> bit, in the order the serial filter messages are probed;
# every in-tree reason string (ops/serial.filter_*) maps here, anything
# else is an out-of-tree plugin's reason
_SERIAL_REASON_BITS = (
    ("did not have the API resource", VERDICT_BIT_API_ENABLEMENT),
    ("untolerated taint", VERDICT_BIT_TOLERATION),
    ("cluster affinity constraint", VERDICT_BIT_AFFINITY),
    ("did not have provider property", VERDICT_BIT_SPREAD_PROP),
    ("did not have region property", VERDICT_BIT_SPREAD_PROP),
    ("did not have zones property", VERDICT_BIT_SPREAD_PROP),
    ("did not have spread label", VERDICT_BIT_SPREAD_PROP),
    ("process of eviction", VERDICT_BIT_EVICTION),
)


def bit_for_serial_reason(msg: str) -> int:
    """Map one serial filter diagnosis string to its verdict bit index
    (unrecognized reasons are out-of-tree plugin rejections)."""
    for sub, bit in _SERIAL_REASON_BITS:
        if sub in msg:
            return bit
    return VERDICT_BIT_PLUGIN


def classify_unschedulable(exc: Exception) -> str:
    """Dominant reason of an UnschedulableError for the queue's
    unschedulable map and karmada_schedule_unschedulable_total.  An
    explain-armed decode attaches the solver's dominant reason as
    `exc.reason`; otherwise the known message shapes classify."""
    r = getattr(exc, "reason", None)
    if r:
        return str(r)
    msg = str(exc)
    # the capacity shapes: the device/native decodes ("insufficient
    # capacity (batched|native)"), the serial selection swap-loop ("no
    # enough resource when selecting N clusters"), and the serial
    # divider ("Clusters available replicas N are not enough to
    # schedule.", ops/serial._dynamic_divide)
    if ("insufficient capacity" in msg or "no enough resource" in msg
            or "not enough to schedule" in msg):
        return "capacity"
    if "MinGroups" in msg or "spread" in msg.lower():
        return REASON_SPREAD_SELECTION
    return REASON_UNKNOWN


class DecisionRecorder:
    """Bounded storage for Decision dicts, mirroring obs/recorder: a ring
    of the most recent `capacity` decisions plus an always-retained shelf
    of the latest unschedulable/no-fit decision per binding (bounded to
    `unsched_keep` bindings, oldest evicted) — the decision an operator
    actually wants (why is X still pending?) survives a ring full of
    healthy scheduled ones.  Truncation is never silent (`dropped`)."""

    def __init__(self, capacity: int = 256, unsched_keep: int = 64) -> None:
        self.capacity = max(1, int(capacity))
        self.unsched_keep = max(0, int(unsched_keep))
        # guarded-by: _lock
        self._ring: "collections.deque[dict]" = collections.deque(
            maxlen=self.capacity)
        # guarded-by: _lock (key -> latest failed decision, insertion order)
        self._failed: "collections.OrderedDict[str, dict]" = \
            collections.OrderedDict()
        self._dropped = 0  # guarded-by: _lock
        self._next_id = 0  # guarded-by: _lock — per-recorder Decision ids
        self._lock = threading.Lock()

    def record(self, decision: dict) -> None:
        with self._lock:
            self._next_id += 1
            # the Decision's identity for the lifecycle ledger's
            # cross-reference (events carry decision_id, decisions carry
            # event_id once the outcome event links back)
            decision["id"] = self._next_id
            if len(self._ring) == self.capacity:
                self._dropped += 1
            self._ring.append(decision)
            if self.unsched_keep and decision["outcome"] != "scheduled":
                self._failed.pop(decision["key"], None)
                self._failed[decision["key"]] = decision
                while len(self._failed) > self.unsched_keep:
                    self._failed.popitem(last=False)
        DECISIONS_TOTAL.inc(outcome=decision["outcome"])

    def recent(self) -> List[dict]:
        with self._lock:
            return list(self._ring)

    def unschedulable(self) -> List[dict]:
        """Newest-first shelf of the latest failed decision per binding."""
        with self._lock:
            return list(reversed(self._failed.values()))

    def get(self, key: str) -> Optional[dict]:
        """The most recent decision for one `namespace/name` binding."""
        with self._lock:
            for d in reversed(self._ring):
                if d["key"] == key:
                    return d
            return self._failed.get(key)

    def link_event(self, key: str, event_id: int) -> Optional[int]:
        """Stamp the lifecycle-ledger event id onto the latest decision
        for `key`; returns that decision's id so the caller can stamp it
        back onto the event (obs/events.link_decision) -- the timeline
        and /debug/explain/{ns}/{name} then cross-reference."""
        with self._lock:
            target = None
            for d in reversed(self._ring):
                if d["key"] == key:
                    target = d
                    break
            if target is None:
                target = self._failed.get(key)
            if target is None:
                return None
            target["event_id"] = event_id
            return target.get("id")

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def stats(self) -> dict:
        with self._lock:
            by_reason: Dict[str, int] = {}
            for d in self._failed.values():
                r = d.get("reason") or REASON_UNKNOWN
                by_reason[r] = by_reason.get(r, 0) + 1
            return {"recent": len(self._ring), "capacity": self.capacity,
                    "unschedulable_kept": len(self._failed),
                    "unschedulable_by_reason": by_reason,
                    "dropped": self._dropped}


# -- decision builders --------------------------------------------------------


def _one_liner(outcome: str, reason_counts: Dict[str, int], n_clusters: int,
               targets: Sequence) -> str:
    """The kube-scheduler-style summary line."""
    if outcome == "scheduled":
        where = ", ".join(f"{t['name']}({t['replicas']})" for t in targets)
        return (f"scheduled to {len(targets)}/{n_clusters} cluster(s)"
                + (f": {where}" if where else ""))
    parts = [f"{n} {REASON_LABEL.get(r, r)}"
             for r, n in sorted(reason_counts.items(),
                                key=lambda kv: (-kv[1], kv[0]))]
    detail = "; ".join(parts) if parts else REASON_LABEL.get(outcome, outcome)
    return f"0/{n_clusters} clusters are available: {detail}."


def _base(key: str, outcome: str, reason: Optional[str],
          trace_id: Optional[str], backend: str) -> dict:
    return {"key": key, "outcome": outcome, "reason": reason,
            "trace_id": trace_id, "backend": backend,
            "ts": round(time.time(), 3)}


def decision_from_planes(
    key: str,
    cluster_names: Sequence[str],
    verdict_row,
    score_row,
    avail_row,
    outcome_code: int,
    result,
    trace_id: Optional[str] = None,
    backend: str = "device",
    static_w_row=None,
    plugin_row=None,
) -> dict:
    """One binding's Decision from the solver's dense explain planes.

    `result` is the decoded List[TargetCluster] | Exception for the row;
    the per-cluster table is bounded (MAX_DECISION_CLUSTERS) but the
    per-reason rejection counts always cover the whole fleet."""
    status, dom = split_outcome(int(outcome_code))
    outcome = OUTCOME_NAMES.get(status, str(status))
    targets = ([] if isinstance(result, Exception) or result is None
               else [{"name": t.name, "replicas": t.replicas}
                     for t in result])
    by_name = {t["name"]: t["replicas"] for t in targets}
    reason_counts: Dict[str, int] = {}
    rows: List[dict] = []
    omitted = 0
    for i, name in enumerate(cluster_names):
        mask = int(verdict_row[i])
        r = first_reason(mask)
        if r is not None:
            reason_counts[r] = reason_counts.get(r, 0) + 1
        row = {"name": name, "verdict": mask,
               "reasons": reasons_of(mask),
               "score": int(score_row[i]) if score_row is not None else None,
               "avail": int(avail_row[i]) if avail_row is not None else None,
               "replicas": by_name.get(name, 0)}
        if static_w_row is not None:
            row["static_weight"] = int(static_w_row[i])
        if plugin_row is not None:
            row["plugin_score"] = int(plugin_row[i])
        rows.append(row)
    if len(rows) > MAX_DECISION_CLUSTERS:
        # assigned/feasible clusters always make the table; rejected ones
        # fill the remaining budget (big fleets: the per-reason counts
        # stay exact, only rows truncate)
        keep = [r for r in rows if r["replicas"] > 0 or r["verdict"] == 0]
        rest = [r for r in rows if not (r["replicas"] > 0 or r["verdict"] == 0)]
        budget = max(MAX_DECISION_CLUSTERS - len(keep), 0)
        omitted = max(len(rest) - budget, 0)
        rows = keep + rest[:budget]
    d = _base(key, outcome, dom, trace_id, backend)
    d.update({
        "status": status,
        "clusters": rows,
        "clusters_total": len(cluster_names),
        "clusters_omitted": omitted,
        "reason_counts": reason_counts,
        "targets": targets,
        "message": _one_liner(outcome, reason_counts, len(cluster_names),
                              targets),
    })
    return d


def decision_from_result(key: str, result, n_clusters: int,
                         trace_id: Optional[str] = None,
                         backend: str = "device",
                         diagnosis: Optional[Dict[str, str]] = None) -> dict:
    """Outcome-level Decision for rows without dense explain planes (big
    lane tier, spread group-DFS failures, the serial host path).  A
    FitError's per-cluster diagnosis maps onto the same verdict bitmask
    (bit_for_serial_reason), so serial decisions stay parity-comparable."""
    diagnosis = diagnosis if diagnosis is not None else \
        getattr(result, "diagnosis", None)
    reason_counts: Dict[str, int] = {}
    rows: List[dict] = []
    if isinstance(result, Exception):
        exc_name = type(result).__name__
        if "FitError" in exc_name:
            outcome, status = "no_fit", 1
        elif "NoClusterAvailable" in exc_name:
            outcome, status = "no_cluster", 3
        else:
            outcome, status = "unschedulable", 2
        targets: List[dict] = []
        if diagnosis:
            for name, msg in diagnosis.items():
                bit = bit_for_serial_reason(msg)
                r = VERDICT_BIT_NAMES[bit]
                reason_counts[r] = reason_counts.get(r, 0) + 1
                if len(rows) < MAX_DECISION_CLUSTERS:
                    rows.append({"name": name, "verdict": 1 << bit,
                                 "reasons": [r], "detail": msg,
                                 "replicas": 0})
        reason = (classify_unschedulable(result) if outcome == "unschedulable"
                  else (max(reason_counts, key=reason_counts.get)
                        if reason_counts else None))
    else:
        outcome, status, reason = "scheduled", 0, None
        targets = [{"name": t.name, "replicas": t.replicas}
                   for t in (result or [])]
        rows = [{"name": t["name"], "verdict": 0, "reasons": [],
                 "replicas": t["replicas"]} for t in targets]
    d = _base(key, outcome, reason, trace_id, backend)
    d.update({
        "status": status,
        "clusters": rows,
        "clusters_total": n_clusters,
        "clusters_omitted": max((len(diagnosis) if diagnosis else 0)
                                - len(rows), 0) if isinstance(result, Exception)
        else 0,
        "reason_counts": reason_counts,
        "targets": targets,
        "message": (str(result) if isinstance(result, Exception)
                    else _one_liner(outcome, reason_counts, n_clusters,
                                    targets)),
    })
    return d


def default_key(spec) -> str:
    """The `namespace/name` identity of a binding spec's workload — used
    when the caller (bench) has no ResourceBinding names to offer."""
    ref = spec.resource
    return f"{ref.namespace or 'default'}/{ref.name}"
