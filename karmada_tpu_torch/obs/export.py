"""Trace export: JSON payloads, the text waterfall, stage aggregates
(counterpart of the JAX package's ``obs/export.py``).

Traces arrive here as the plain dicts Trace finalization produced (see
obs/trace.py) — everything is already JSON-able; this module only shapes
and renders.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional


def summarize(trace: dict) -> dict:
    """One list row for /debug/traces and `karmadactl trace`."""
    return {
        "trace_id": trace["trace_id"],
        "root": trace["root"],
        "start_unix": trace["start_unix"],
        "duration_ms": round(trace["duration_s"] * 1e3, 3),
        "spans": len(trace["spans"]),
        "cancelled": trace["cancelled"],
    }


def to_json(trace: dict, indent: Optional[int] = None) -> str:
    return json.dumps(trace, indent=indent, default=str)


def stage_summary(trace: dict, prefix: str = "pipeline.") -> Dict[str, dict]:
    """Aggregate a trace's spans by name (default: the pipeline stage
    spans): count / total / max seconds per stage.  This is what the
    bench embeds into BENCH_*.json so a perf regression can be attributed
    to a stage, not just a total."""
    agg: Dict[str, dict] = {}
    for s in trace["spans"]:
        if prefix and not s["name"].startswith(prefix):
            continue
        d = s["end_s"] - s["start_s"]
        a = agg.setdefault(s["name"], {"count": 0, "total_s": 0.0,
                                       "max_s": 0.0})
        a["count"] += 1
        a["total_s"] += d
        a["max_s"] = max(a["max_s"], d)
    for a in agg.values():
        a["total_s"] = round(a["total_s"], 6)
        a["max_s"] = round(a["max_s"], 6)
    return agg


def latest_pipeline_timeline(recorder, root: str = "pipeline.cycle"
                             ) -> Optional[dict]:
    """The most recent trace containing a `root` span, reduced to its
    per-stage timeline (bench payload helper)."""
    if recorder is None:
        return None
    for tr in reversed(recorder.recent()):
        if tr["root"] == root or any(s["name"] == root
                                     for s in tr["spans"]):
            return {
                "trace_id": tr["trace_id"],
                "duration_s": round(tr["duration_s"], 6),
                "cancelled": tr["cancelled"],
                "stages": stage_summary(tr),
            }
    return None


def _fmt_attrs(attrs: dict, limit: int = 3) -> str:
    shown = []
    for k, v in attrs.items():
        if isinstance(v, float):
            v = round(v, 4)
        shown.append(f"{k}={v}")
        if len(shown) >= limit:
            break
    return " ".join(shown)


def render_waterfall(trace: dict, width: int = 48,
                     label_width: int = 26) -> str:
    """Text waterfall of one trace: spans in tree order, each with a bar
    positioned on the shared [0, duration] timeline.  Overlap is visible
    directly — under the pipelined executor, chunk k+1's encode bar sits
    INSIDE chunk k's bar (host encode hiding behind device solve)."""
    spans = trace["spans"]
    dur = max(trace["duration_s"], 1e-9)
    children: Dict[Optional[int], List[dict]] = {}
    for s in spans:
        children.setdefault(s["parent_id"], []).append(s)
    for kids in children.values():
        kids.sort(key=lambda s: (s["start_s"], s["span_id"]))

    lines = [
        f"trace {trace['trace_id']} root={trace['root']} "
        f"duration={dur * 1e3:.2f}ms spans={len(spans)} "
        f"cancelled={trace['cancelled']}"
    ]

    emitted = set()

    def emit(s: dict, depth: int) -> None:
        if s["span_id"] in emitted:
            return
        emitted.add(s["span_id"])
        lo = int(round(s["start_s"] / dur * width))
        hi = int(round(s["end_s"] / dur * width))
        hi = min(max(hi, lo + 1), width)
        bar = " " * lo + "#" * (hi - lo) + " " * (width - hi)
        label = ("  " * depth + s["name"])[:label_width].ljust(label_width)
        ms = (s["end_s"] - s["start_s"]) * 1e3
        extra = _fmt_attrs(s["attrs"])
        lines.append(f"{label} |{bar}| {ms:9.3f}ms"
                     + (f"  {extra}" if extra else ""))
        for kid in children.get(s["span_id"], []):
            emit(kid, depth + 1)

    for root in children.get(None, []):
        emit(root, 0)
    # orphans (parent record missing): render flat so nothing hides
    for s in spans:
        emit(s, 0)
    return "\n".join(lines)
