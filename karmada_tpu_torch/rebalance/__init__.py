"""Rebalance plane: descheduler-driven drain-and-re-place on the solver.

  plane.py    RebalancePlane -- the periodic detect (K13) -> drain ->
              re-place cycle, graceful-eviction drains, conservation audit
  pacing.py   EvictionBudget -- the shared per-cluster eviction-pacing
              ledger

Armed by `Scheduler(rebalance=INTERVAL_S)` / `serve --rebalance`.
Counterpart of the JAX package's ``karmada_tpu/rebalance``.  The active
plane registers process-wide so /debug/rebalance (utils/httpserve) and
`karmadactl rebalance` can publish it without plumbing.  The LATEST armed
plane wins the registry; a process that builds a second scheduler
without --rebalance keeps the previous plane visible -- harnesses that
need a clean slate call set_active(None).
"""

from __future__ import annotations

from typing import Optional

from karmada_tpu_torch.rebalance.pacing import EvictionBudget  # noqa: F401
from karmada_tpu_torch.rebalance.plane import (  # noqa: F401
    PRODUCER,
    RebalanceConfig,
    RebalancePlane,
)
from karmada_tpu_torch.utils.locks import VetLock

_ACTIVE: Optional[RebalancePlane] = None  # guarded-by: _ACTIVE_LOCK
_ACTIVE_LOCK = VetLock("rebalance.active")


def set_active(plane: Optional[RebalancePlane]) -> None:
    global _ACTIVE
    with _ACTIVE_LOCK:
        _ACTIVE = plane


def active() -> Optional[RebalancePlane]:
    with _ACTIVE_LOCK:
        return _ACTIVE


def state_payload() -> dict:
    """The /debug/rebalance payload; {"enabled": false} when no plane is
    armed so dashboards can poll unconditionally."""
    plane = active()
    if plane is None:
        return {"enabled": False}
    return plane.stats()


def render_state(state: dict) -> str:
    """Human one-screen rendering of a /debug/rebalance payload
    (karmadactl rebalance --endpoint)."""
    if not state.get("enabled"):
        return ("no rebalance plane is armed on this plane "
                "(serve --rebalance[=INTERVAL] to arm one)")
    cfg = state.get("config") or {}
    last = state.get("last") or {}
    lines = [
        f"rebalance plane: {state.get('cycles')} cycle(s), "
        f"{state.get('evictions')} eviction(s), "
        f"{state.get('conservation_violations')} conservation violation(s)",
        f"  thresholds: overcommit {cfg.get('overcommit_threshold_milli')}m "
        f"spread {cfg.get('spread_tolerance_milli')}m; "
        f"interval {cfg.get('interval_s')}s, "
        f"max {cfg.get('max_evictions_per_cycle')} eviction(s)/cycle",
        f"  budget: {state.get('budget')}",
    ]
    if last:
        lines.append(
            f"  last cycle: evicted {last.get('evicted')}, "
            f"{'converged' if last.get('converged') else 'draining'}")
        for name, row in sorted((last.get("clusters") or {}).items()):
            lines.append(
                f"    {name}: committed {row['committed']}/"
                f"{row['capacity']} (x{row['over_milli'] / 1000:.2f}, "
                f"divergence {row['div_milli'] / 1000:+.2f}), "
                f"drain_need {row['drain_need']}")
    return "\n".join(lines)
