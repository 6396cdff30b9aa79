"""Shared eviction pacing: one per-cluster token budget for every evictor.

Counterpart of the JAX package's ``rebalance/pacing.py``.  Evictors that
act on the same fleet (the rebalance plane's drain here; the JAX package's
descheduler too) draw from one ledger: at most `per_cluster` evictions
per cluster per `interval_s` window, whoever asks first wins, and every
grant and denial is counted by consumer (`spent`, `denied`, and the
karmada_rebalance_eviction_budget_* families).

The window is a fixed tumbling interval, so pacing replays exactly on an
injected clock.
"""

from __future__ import annotations

import time
from typing import Callable, Dict

from karmada_tpu_torch.utils.locks import VetLock
from karmada_tpu_torch.utils.metrics import REGISTRY

BUDGET_SPENT = REGISTRY.counter(
    "karmada_rebalance_eviction_budget_spent_total",
    "Eviction-pacing tokens granted from the shared per-cluster budget, "
    "by consumer (descheduler / rebalance)",
    ("consumer",),
)

BUDGET_DENIED = REGISTRY.counter(
    "karmada_rebalance_eviction_budget_denied_total",
    "Eviction attempts refused because the cluster's shared pacing "
    "budget for the current interval was exhausted, by consumer",
    ("consumer",),
)


class EvictionBudget:
    """Per-cluster tumbling-window eviction allowance shared by every
    evictor.  `try_acquire` is the only gate: False means the cluster
    absorbed its allowed evictions this window."""

    def __init__(self, per_cluster: int = 8, interval_s: float = 60.0,
                 clock: Callable[[], float] = time.time) -> None:
        self.per_cluster = max(1, int(per_cluster))
        self.interval_s = float(interval_s)
        self.clock = clock
        self._lock = VetLock("rebalance.budget")
        self._window_start = clock()
        # per-cluster spend in the current window
        self._spent: Dict[str, int] = {}
        #: tokens granted / attempts refused, by consumer (lifetime)
        self.spent: Dict[str, int] = {}
        self.denied: Dict[str, int] = {}

    def _roll(self) -> float:
        now = self.clock()
        if now - self._window_start >= self.interval_s:
            self._window_start = now
            self._spent = {}
        return now

    def try_acquire(self, cluster: str, consumer: str = "rebalance") -> bool:
        """One eviction token for `cluster`, or False when the cluster's
        budget for this window is spent."""
        with self._lock:
            self._roll()
            spent = self._spent.get(cluster, 0)
            if spent >= self.per_cluster:
                self.denied[consumer] = self.denied.get(consumer, 0) + 1
                BUDGET_DENIED.inc(consumer=consumer)
                return False
            self._spent[cluster] = spent + 1
            self.spent[consumer] = self.spent.get(consumer, 0) + 1
        BUDGET_SPENT.inc(consumer=consumer)
        return True

    def remaining(self, cluster: str) -> int:
        with self._lock:
            self._roll()
            return self.per_cluster - self._spent.get(cluster, 0)

    def state(self) -> dict:
        with self._lock:
            now = self.clock()
            return {
                "per_cluster": self.per_cluster,
                "interval_s": self.interval_s,
                "window_age_s": round(max(0.0, now - self._window_start), 6),
                "spent": dict(self._spent),
                "granted_by_consumer": dict(self.spent),
                "denied_by_consumer": dict(self.denied),
            }
