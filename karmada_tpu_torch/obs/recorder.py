"""Bounded storage for finished traces (counterpart of the JAX
package's ``obs/recorder.py``).

Two retention tiers, both bounded so a long-lived serve process can leave
tracing on indefinitely:

  * a ring of the most recent `capacity` traces (deque append/evict under
    one short lock — "lock-free-ish": record() never blocks on readers
    longer than a list copy), and
  * a "slowest N" shelf that always retains the worst cycles ever seen,
    so the trace an operator actually wants (the 30 s outlier from last
    night) survives a ring full of healthy 10 ms cycles.

Truncation is never silent: every ring eviction increments `dropped`,
exported through stats() into /debug/state and /debug/traces.
"""

from __future__ import annotations

import collections
from typing import List, Optional

from karmada_tpu_torch.utils.locks import VetLock


class TraceRecorder:
    def __init__(self, capacity: int = 256, slow_keep: int = 8) -> None:
        self.capacity = max(1, int(capacity))
        self.slow_keep = max(0, int(slow_keep))
        # guarded-by: _lock
        self._ring: "collections.deque[dict]" = collections.deque(
            maxlen=self.capacity)
        # guarded-by: _lock (ascending duration; [0] is fastest)
        self._slow: List[dict] = []
        self._dropped = 0  # guarded-by: _lock
        self._lock = VetLock("obs.recorder")

    def record(self, trace: dict) -> None:
        with self._lock:
            if len(self._ring) == self.capacity:
                self._dropped += 1  # counted eviction, never silent
            self._ring.append(trace)
            if self.slow_keep:
                self._slow.append(trace)
                self._slow.sort(key=lambda t: t["duration_s"])
                if len(self._slow) > self.slow_keep:
                    del self._slow[0]

    def recent(self) -> List[dict]:
        """Oldest-first list of the retained ring."""
        with self._lock:
            return list(self._ring)

    def slowest(self) -> List[dict]:
        """Slowest-first list of the always-retained shelf."""
        with self._lock:
            return list(reversed(self._slow))

    def get(self, trace_id: str) -> Optional[dict]:
        with self._lock:
            for tr in reversed(self._ring):
                if tr["trace_id"] == trace_id:
                    return tr
            for tr in self._slow:
                if tr["trace_id"] == trace_id:
                    return tr
        return None

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def stats(self) -> dict:
        with self._lock:
            return {"recent": len(self._ring), "capacity": self.capacity,
                    "slow_kept": len(self._slow),
                    "slow_keep": self.slow_keep, "dropped": self._dropped}
