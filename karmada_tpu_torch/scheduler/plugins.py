"""Out-of-tree scheduler plugin registry.

Reference: pkg/scheduler/framework/interface.go:45-66 (FilterPlugin /
ScorePlugin) + pkg/scheduler/framework/runtime/registry.go (named factory
registry) + cmd/scheduler app options `--plugins=*,-Foo` enablement.

TPU-first contract — deliberately narrower than the reference's
`Filter(ctx, bindingSpec, bindingStatus, cluster)`:

* Plugins are **placement-scoped**: `fn(placement, cluster)`.  Their
  outputs are per-(placement, cluster) ROWS, which is what lets one
  evaluation fold into every backend — the batched encoder's `pl_mask` /
  `pl_extra_score` tensors (one row per distinct placement, amortized over
  thousands of bindings), the serial control's filter/score chain, and the
  native C++ control's marshaled placement rows.  A spec-scoped plugin
  would force O(bindings x clusters) host work per cycle and could never
  ride the device path.
* Filter plugins return `None` (cluster passes) or a reason string (the
  per-cluster diagnosis, shown in FitError exactly like in-tree filters).
* Score plugins return an int; the registry SUMS enabled plugin scores per
  (placement, cluster) and clamps the total to [0, EXTRA_SCORE_CAP].  The
  clamp lives HERE so every backend composes the identical value (the
  solver's packed sort keys budget 8 bits for the score field: in-tree
  locality contributes 0 or 100, extras at most 100 more).

All three backends consult the SAME registry evaluation, so an
out-of-tree plugin behaves bit-identically on the serial, native and
device paths (asserted by tests/test_scheduler_plugins.py).
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Tuple

EXTRA_SCORE_CAP = 100

FilterFn = Callable[[object, object], Optional[str]]  # (placement, cluster)
ScoreFn = Callable[[object, object], int]


class PluginRegistry:
    """Named filter/score contributor registry with `*,-Name` enablement
    (the reference registry's semantics: `*` enables everything, `-Name`
    disables one, a bare `Name` force-enables it)."""

    def __init__(self) -> None:
        self._filters: Dict[str, FilterFn] = {}
        self._scores: Dict[str, ScoreFn] = {}
        self._star = True
        self._on: set = set()
        self._off: set = set()
        self._lock = threading.Lock()
        # bumped on every mutation: encoder caches key their memoized
        # placement rows on this so a plugin change invalidates them
        self.generation = 0

    # -- registration ------------------------------------------------------
    def register_filter(self, name: str, fn: FilterFn) -> None:
        with self._lock:
            self._filters[name] = fn
            self.generation += 1

    def register_score(self, name: str, fn: ScoreFn) -> None:
        with self._lock:
            self._scores[name] = fn
            self.generation += 1

    def unregister(self, name: str) -> None:
        with self._lock:
            self._filters.pop(name, None)
            self._scores.pop(name, None)
            self.generation += 1

    def set_enablement(self, spec: str) -> None:
        """Parse the `--plugins=*,-Foo,Bar` flag format."""
        star, on, off = False, set(), set()
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            if part == "*":
                star = True
            elif part.startswith("-"):
                off.add(part[1:])
            else:
                on.add(part)
        with self._lock:
            self._star, self._on, self._off = star, on, off
            self.generation += 1

    def _enabled(self, name: str) -> bool:
        if name in self._off:
            return False
        return self._star or name in self._on

    # -- evaluation (shared by serial / native / device encoders) ----------
    def enabled_filters(self) -> List[Tuple[str, FilterFn]]:
        with self._lock:
            return [(n, f) for n, f in self._filters.items()
                    if self._enabled(n)]

    def enabled_scores(self) -> List[Tuple[str, ScoreFn]]:
        with self._lock:
            return [(n, f) for n, f in self._scores.items()
                    if self._enabled(n)]

    def extra_filter(self, placement, cluster) -> Optional[str]:
        """First rejection reason among enabled out-of-tree filters, in
        registration order (mirrors the in-tree chain's first-hit-wins)."""
        return eval_filters(self.enabled_filters(), placement, cluster)

    def extra_score(self, placement, cluster) -> int:
        """Sum of enabled out-of-tree scores, clamped to
        [0, EXTRA_SCORE_CAP] — the single clamp every backend shares."""
        return eval_scores(self.enabled_scores(), placement, cluster)


def eval_filters(filters, placement, cluster) -> Optional[str]:
    """First rejection among pre-fetched (name, fn) filters — encoders
    hoist `enabled_filters()` once and evaluate O(placements x clusters)
    times without re-taking the registry lock."""
    for _, fn in filters:
        reason = fn(placement, cluster)
        if reason is not None:
            return reason
    return None


def eval_scores(scores, placement, cluster) -> int:
    """Clamped sum over pre-fetched (name, fn) scorers — THE clamp every
    backend shares."""
    total = 0
    for _, fn in scores:
        total += int(fn(placement, cluster))
    return max(0, min(total, EXTRA_SCORE_CAP))


# process-wide default instance; components accept an injected one in tests
REGISTRY = PluginRegistry()
