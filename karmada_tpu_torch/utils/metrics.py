"""Prometheus-style metrics primitives (counter / gauge / histogram;
counterpart of the JAX package's ``utils/metrics.py``).

The reference instruments every component with prometheus client_golang
(pkg/scheduler/metrics/metrics.go:60-142, pkg/metrics/cluster.go:57-132,
pkg/util/metrics/); this module is the framework's equivalent: a small
threadsafe registry with the same metric shapes (labeled counters,
gauges, exponential-bucket histograms) and a text exposition dump.

No external dependency: the scrape surface is `Registry.dump()` (the
Prometheus text format) so an HTTP handler or the bench can expose it.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional, Sequence, Tuple


def exponential_buckets(start: float, factor: float, count: int) -> List[float]:
    return [start * (factor ** i) for i in range(count)]


def quantile_from_buckets(bounds: Sequence[float], cum_counts: Sequence[int],
                          total: int, q: float) -> float:
    """Bucket-resolution quantile estimate from CUMULATIVE bucket counts
    (the shape Histogram keeps internally and Registry.snapshot()
    exposes).  Shared by Histogram.quantile, the SLO evaluator's
    windowed bucket-delta math (obs/slo), and the `karmadactl top`
    dashboard — one estimator, one bias (the returned value is the upper
    bound of the bucket the rank lands in; +inf past the last bound)."""
    if total <= 0:
        return math.nan
    rank = q * total
    for bound, c in zip(bounds, cum_counts):
        if c >= rank:
            return bound
    return math.inf


def _escape_label(value: str) -> str:
    """Prometheus text-format label-value escaping: backslash, double
    quote, and newline would otherwise break the exposition line."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _escape_help(text: str) -> str:
    """# HELP line escaping (backslash and newline per the text format)."""
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


class _Metric:
    def __init__(self, name: str, help_: str, label_names: Sequence[str]) -> None:
        self.name = name
        self.help = help_
        self.label_names = tuple(label_names)
        self._lock = threading.Lock()

    def _key(self, labels: Dict[str, str]) -> Tuple[str, ...]:
        if set(labels) != set(self.label_names):
            raise ValueError(
                f"{self.name}: labels {sorted(labels)} != {sorted(self.label_names)}"
            )
        return tuple(labels[n] for n in self.label_names)

    @staticmethod
    def _fmt_labels(names: Sequence[str], values: Sequence[str],
                    extra: Optional[Tuple[str, str]] = None) -> str:
        pairs = [f'{n}="{_escape_label(v)}"' for n, v in zip(names, values)]
        if extra is not None:
            pairs.append(f'{extra[0]}="{_escape_label(extra[1])}"')
        return "{" + ",".join(pairs) + "}" if pairs else ""


class _ScalarMetric(_Metric):
    """Shared one-value-per-label-set storage (Counter / Gauge): the
    render and snapshot shapes must never drift between the two."""

    def __init__(self, name, help_, label_names=()):
        super().__init__(name, help_, label_names)
        self._values: Dict[Tuple[str, ...], float] = {}  # guarded-by: _lock

    def value(self, **labels: str) -> float:
        with self._lock:
            return self._values.get(self._key(labels), 0.0)

    def _render(self) -> List[str]:
        with self._lock:
            return [
                f"{self.name}{self._fmt_labels(self.label_names, k)} {v}"
                for k, v in sorted(self._values.items())
            ]

    def _snap(self) -> List[dict]:
        with self._lock:
            return [{"labels": list(k), "value": v}
                    for k, v in sorted(self._values.items())]


class Counter(_ScalarMetric):
    TYPE = "counter"

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def total(self) -> float:
        """Sum across every label combination (delta accounting for the
        chaos safety auditor, which cannot enumerate label values that
        only exist after faults fire)."""
        with self._lock:
            return sum(self._values.values())


class Gauge(_ScalarMetric):
    TYPE = "gauge"

    def set(self, value: float, **labels: str) -> None:
        with self._lock:
            self._values[self._key(labels)] = float(value)

    def add(self, amount: float, **labels: str) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount


class Histogram(_Metric):
    TYPE = "histogram"

    def __init__(self, name, help_, label_names=(), buckets: Optional[List[float]] = None):
        super().__init__(name, help_, label_names)
        # exposition edge cases hardened while wiring GET /metrics:
        # duplicate bucket bounds would double-count an observation into
        # two identical `le` lines, and a caller-supplied +Inf bound would
        # collide with the synthetic +Inf line _render always emits —
        # dedupe and keep finite bounds only (int bounds coerce to float
        # so `le` renders uniformly, e.g. le="1.0")
        self.buckets = sorted({
            float(b) for b in (buckets or exponential_buckets(0.001, 2, 15))
            if math.isfinite(b)
        })
        self._counts: Dict[Tuple[str, ...], List[int]] = {}  # guarded-by: _lock
        self._sums: Dict[Tuple[str, ...], float] = {}  # guarded-by: _lock
        self._totals: Dict[Tuple[str, ...], int] = {}  # guarded-by: _lock

    def observe(self, value: float, **labels: str) -> None:
        key = self._key(labels)
        with self._lock:
            counts = self._counts.setdefault(key, [0] * len(self.buckets))
            for i, ub in enumerate(self.buckets):
                if value <= ub:
                    counts[i] += 1
            self._sums[key] = self._sums.get(key, 0.0) + value
            self._totals[key] = self._totals.get(key, 0) + 1

    def count(self, **labels: str) -> int:
        with self._lock:
            return self._totals.get(self._key(labels), 0)

    def sum(self, **labels: str) -> float:
        with self._lock:
            return self._sums.get(self._key(labels), 0.0)

    def quantile(self, q: float, **labels: str) -> float:
        """Bucket-resolution quantile estimate (for dumps/tests)."""
        key = self._key(labels)
        with self._lock:
            total = self._totals.get(key, 0)
            counts = list(self._counts.get(key, []))
        return quantile_from_buckets(self.buckets, counts, total, q)

    def _snap(self) -> List[dict]:
        with self._lock:
            return [{"labels": list(k),
                     "count": self._totals[k],
                     "sum": self._sums[k],
                     "buckets": list(self._counts.get(k, []))}
                    for k in sorted(self._totals)]

    def _render(self) -> List[str]:
        out: List[str] = []
        with self._lock:
            for key in sorted(self._totals):
                for i, ub in enumerate(self.buckets):
                    out.append(
                        f"{self.name}_bucket"
                        f"{self._fmt_labels(self.label_names, key, ('le', repr(ub)))}"
                        f" {self._counts[key][i]}"
                    )
                out.append(
                    f"{self.name}_bucket"
                    f"{self._fmt_labels(self.label_names, key, ('le', '+Inf'))}"
                    f" {self._totals[key]}"
                )
                out.append(
                    f"{self.name}_sum{self._fmt_labels(self.label_names, key)}"
                    f" {self._sums[key]}"
                )
                out.append(
                    f"{self.name}_count{self._fmt_labels(self.label_names, key)}"
                    f" {self._totals[key]}"
                )
        return out


class Registry:
    def __init__(self) -> None:
        self._metrics: Dict[str, _Metric] = {}  # guarded-by: _lock
        self._lock = threading.Lock()

    def register(self, metric: _Metric) -> _Metric:
        with self._lock:
            existing = self._metrics.get(metric.name)
            if existing is not None:
                return existing
            self._metrics[metric.name] = metric
            return metric

    def counter(self, name, help_="", label_names=()) -> Counter:
        return self.register(Counter(name, help_, label_names))  # type: ignore[return-value]

    def gauge(self, name, help_="", label_names=()) -> Gauge:
        return self.register(Gauge(name, help_, label_names))  # type: ignore[return-value]

    def histogram(self, name, help_="", label_names=(), buckets=None) -> Histogram:
        return self.register(Histogram(name, help_, label_names, buckets))  # type: ignore[return-value]

    def dump(self) -> str:
        """Prometheus text exposition format."""
        lines: List[str] = []
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        for m in metrics:
            lines.append(f"# HELP {m.name} {_escape_help(m.help)}".rstrip())
            lines.append(f"# TYPE {m.name} {m.TYPE}")
            lines.extend(m._render())  # noqa: SLF001
        return "\n".join(lines) + "\n"

    def snapshot(self) -> Dict[str, dict]:
        """Structured point-in-time view of every family — the telemetry
        plane's sampling surface (obs/timeseries), read under the same
        locks `dump()` renders under, with NO text-format round trip:

            {name: {"type": counter|gauge|histogram,
                    "help": str,
                    "labels": [label names...],
                    # counters/gauges:
                    "samples": [{"labels": [values...], "value": float}],
                    # histograms instead:
                    "bounds": [finite upper bounds...],
                    "samples": [{"labels": [...], "count": int,
                                 "sum": float,
                                 "buckets": [cumulative counts...]}]}}

        Histogram bucket counts are CUMULATIVE (the internal shape), so
        windowed deltas between two snapshots stay valid bucket arrays
        and feed `quantile_from_buckets` directly.  `dump()` stays the
        only text exposition; the two are regression-tested for
        consistency (tests/test_telemetry.py)."""
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        out: Dict[str, dict] = {}
        for m in metrics:
            fam: Dict[str, object] = {
                "type": m.TYPE,
                "help": m.help,
                "labels": list(m.label_names),
                "samples": m._snap(),  # noqa: SLF001 — registry owner
            }
            if isinstance(m, Histogram):
                fam["bounds"] = list(m.buckets)
            out[m.name] = fam
        return out


# the default registry every component instruments into (the reference's
# controller-runtime metrics.Registry equivalent)
REGISTRY = Registry()
