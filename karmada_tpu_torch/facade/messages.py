"""Facade message schemas + the method registry.

Counterpart of the JAX package's ``facade/messages.py``.
`SelectClusters`/`AssignReplicas` live in estimator/wire.py (they are
wire-tier contract messages, alongside the pb equivalents); the
facade-only `WhatIf` query pair lives here.  Every message is a
dataclass with explicit camelCase to/from_json — the wire-drift test
(tests/test_facade.py; the port's in tests/test_torch_facade.py) round-trips seeded instances of each entry in
``FACADE_METHODS``/``FACADE_RESPONSES`` so a field rename cannot
silently fork the wire format.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

from karmada_tpu_torch.estimator.wire import (
    AssignReplicasRequest,
    AssignReplicasResponse,
    SelectClustersRequest,
    SelectClustersResponse,
)

QUERY_PLACEMENT = "placement"
QUERY_CLUSTER_LOSS = "cluster-loss"
QUERY_HEADROOM = "headroom"

QUERIES = (QUERY_PLACEMENT, QUERY_CLUSTER_LOSS, QUERY_HEADROOM)


@dataclass
class WhatIfRequest:
    """One capacity-planning question.  kinds:

    placement     where would `replicas` new replicas land right now
    cluster-loss  which single cluster loss strands the most replicas
                  (`cluster` restricts to one named candidate)
    headroom      the largest replica count that still fully schedules
                  (bisected; `replicas` seeds the search)
    """

    query: str = QUERY_PLACEMENT
    replicas: int = 1
    resource_request: Dict[str, str] = field(default_factory=dict)
    divided: bool = True
    cluster: str = ""
    # cluster-loss: per-cluster re-solve cap (truncation is reported)
    limit: int = 512

    def to_json(self) -> dict:
        return {"query": self.query, "replicas": self.replicas,
                "resourceRequest": self.resource_request,
                "divided": self.divided, "cluster": self.cluster,
                "limit": self.limit}

    @staticmethod
    def from_json(d: dict) -> "WhatIfRequest":
        return WhatIfRequest(
            query=d.get("query", QUERY_PLACEMENT),
            replicas=int(d.get("replicas", 1)),
            resource_request=dict(d.get("resourceRequest", {})),
            divided=bool(d.get("divided", True)),
            cluster=d.get("cluster", ""),
            limit=int(d.get("limit", 512)),
        )

    @staticmethod
    def from_params(params: dict) -> "WhatIfRequest":
        """HTTP query params (/whatif?query=...&replicas=...&cpu=...&
        memory=...) — every value arrives as a string."""
        req: Dict[str, str] = {}
        if params.get("cpu"):
            req["cpu"] = str(params["cpu"])
        if params.get("memory"):
            req["memory"] = str(params["memory"])
        return WhatIfRequest(
            query=str(params.get("query", QUERY_PLACEMENT)),
            replicas=int(params.get("replicas", 1)),
            resource_request=req,
            divided=str(params.get("divided", "true")).lower() != "false",
            cluster=str(params.get("cluster", "")),
            limit=int(params.get("limit", 512)),
        )


@dataclass
class WhatIfResponse:
    """`source` names the forked snapshot tier ("resident" when the
    resident masters' cluster view was forked, "store" otherwise);
    `result` is the per-query payload (whatif.py documents each)."""

    query: str = QUERY_PLACEMENT
    source: str = "store"
    result: Dict = field(default_factory=dict)

    def to_json(self) -> dict:
        return {"query": self.query, "source": self.source,
                "result": self.result}

    @staticmethod
    def from_json(d: dict) -> "WhatIfResponse":
        return WhatIfResponse(
            query=d.get("query", QUERY_PLACEMENT),
            source=d.get("source", "store"),
            result=dict(d.get("result", {})),
        )


#: facade wire methods -> request class (the _METHODS analogue)
FACADE_METHODS = {
    "SelectClusters": SelectClustersRequest,
    "AssignReplicas": AssignReplicasRequest,
    "WhatIf": WhatIfRequest,
}

#: facade wire methods -> response class (wire-drift fixture coverage)
FACADE_RESPONSES = {
    "SelectClusters": SelectClustersResponse,
    "AssignReplicas": AssignReplicasResponse,
    "WhatIf": WhatIfResponse,
}
