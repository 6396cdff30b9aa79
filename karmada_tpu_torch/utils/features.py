"""Feature-gate registry (reference pkg/features/features.go:34-157).

Counterpart of the JAX package's ``utils/features.py``.

Same registry semantics as k8s featuregate: every gate has a default, can
be flipped at runtime (`--feature-gates=Name=true,...` style strings are
accepted by `set_from_string`), and callers ask `enabled(name)`.
"""

from __future__ import annotations

import threading
from typing import Dict

# gate name -> default (mirrors features.go defaults in the reference)
DEFAULT_GATES: Dict[str, bool] = {
    "Failover": True,
    "GracefulEviction": True,
    "PropagateDeps": True,
    "CustomizedClusterResourceModeling": True,
    "PolicyPreemption": True,
    "MultiClusterService": False,
    "ResourceQuotaEstimate": False,
    "StatefulFailoverInjection": False,
    "PriorityBasedScheduling": True,
    "FederatedQuotaEnforcement": False,
    "MultiplePodTemplatesScheduling": True,
    "ControllerPriorityQueue": False,
}


class FeatureGates:
    def __init__(self, overrides: Dict[str, bool] | None = None) -> None:
        self._gates = dict(DEFAULT_GATES)
        self._lock = threading.Lock()
        if overrides:
            for k, v in overrides.items():
                self.set(k, v)

    def enabled(self, name: str) -> bool:
        with self._lock:
            if name not in self._gates:
                raise KeyError(f"unknown feature gate {name!r}")
            return self._gates[name]

    def set(self, name: str, value: bool) -> None:
        with self._lock:
            if name not in self._gates:
                raise KeyError(f"unknown feature gate {name!r}")
            self._gates[name] = bool(value)

    def set_from_string(self, spec: str) -> None:
        """Parse 'A=true,B=false' (the --feature-gates flag format)."""
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            name, _, val = part.partition("=")
            self.set(name.strip(), val.strip().lower() in ("true", "1", "yes"))

    def snapshot(self) -> Dict[str, bool]:
        with self._lock:
            return dict(self._gates)


# process-wide default instance (components accept an injected one for tests)
GATES = FeatureGates()
