"""Resident-state plane: solver tensors kept on the device between cycles.

  state.py    ResidentState -- frozen copy-on-write masters advanced by
              deltas, their device mirrors (K10 scatters, primed into the
              solver's transfer cache), the per-binding slot store (K11
              gather on the fused path) and the bit-exact audit
  deltas.py   the classes of cluster change, one cycle's change set and
              the DeltaTracker that coalesces it from the store's watch

Armed by `Scheduler(resident=True)` / `serve --resident` (device backend
only -- the native and serial backends never build SolverBatches).
Counterpart of the JAX package's ``karmada_tpu/resident``.  The active
state registers process-wide so /debug/resident (utils/httpserve) and
`karmadactl resident` can publish it without plumbing.  The payload is
the plane's host-side stats, read under its own bookkeeping: never the
device mirrors.
"""

from __future__ import annotations

import threading
from typing import Optional

from karmada_tpu_torch.resident.deltas import (  # noqa: F401
    CycleDeltas,
    DeltaTracker,
    classify_cluster_event,
)
from karmada_tpu_torch.resident.state import (  # noqa: F401
    ResidentState,
    RowToken,
    compare_batches,
)

_ACTIVE: Optional[ResidentState] = None  # guarded-by: _ACTIVE_LOCK
_ACTIVE_LOCK = threading.Lock()


def set_active(state: Optional[ResidentState]) -> None:
    global _ACTIVE
    with _ACTIVE_LOCK:
        _ACTIVE = state


def active() -> Optional[ResidentState]:
    with _ACTIVE_LOCK:
        return _ACTIVE


def state_payload(recent: int = 0) -> dict:
    """The /debug/resident payload; {"enabled": false} when no resident
    plane is armed so dashboards can poll unconditionally."""
    state = active()
    if state is None:
        return {"enabled": False}
    out = state.stats()
    if recent:
        out["recent_cycles"] = state.recent_cycles(recent)
    return out


def render_state(state: dict) -> str:
    """Human one-screen rendering of a /debug/resident payload
    (karmadactl resident --endpoint)."""
    if not state.get("enabled"):
        return ("no resident-state plane is armed on this plane "
                "(serve --resident with the device backend to arm one)")
    vocab = state.get("vocab") or {}
    audits = state.get("audits") or {}
    last = state.get("last_audit")
    lines = [
        f"resident-state plane: generation {state.get('generation')} "
        f"({'resident' if state.get('resident') else 'rebuild pending'}, "
        f"{state.get('cycles')} cycle(s))",
        f"  vocab: {vocab.get('clusters')} clusters "
        f"({vocab.get('cluster_lanes')} lanes), "
        f"{vocab.get('placements')} placements, "
        f"{vocab.get('classes')} classes, "
        f"{vocab.get('resources')} resources, {vocab.get('gvks')} gvks",
        f"  rows cached {state.get('rows_cached')}; "
        f"hits {state.get('row_hits')} misses {state.get('row_misses')} "
        f"(hit rate {state.get('hit_rate')})",
        f"  rebuilds {state.get('rebuilds')}",
        f"  audits ok={audits.get('ok')} mismatch={audits.get('mismatch')}"
        + (f"; last: cycle {last['cycle']} -> {last['outcome']}"
           + (f" {last['fields']}" if last.get("fields") else "")
           if last else ""),
        f"  device plane {'on' if state.get('device_plane') else 'off'}"
        f" (primed={state.get('device_primed')}); "
        f"last deltas {state.get('last_deltas')}",
    ]
    fused = state.get("fused") or {}
    if fused.get("armed"):
        lines.append(
            f"  fused gather {'on' if fused.get('available') else 'DEGRADED'}"
            f": {fused.get('cycles')} fused / {fused.get('host_cycles')} "
            f"host cycle(s), fallbacks {fused.get('fallbacks')}")
    for rec in state.get("recent_cycles") or ():
        lines.append(
            f"    cycle {rec['cycle']}: {rec['items']} item(s), "
            f"{rec['hits']} hit(s), {rec['misses']} miss(es)"
            + (" [rebuilt]" if rec.get("rebuilt") else ""))
    return "\n".join(lines)
