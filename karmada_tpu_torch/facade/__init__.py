"""Wire-compatible ReplicaEstimator facade: scheduler-as-a-service.

Counterpart of the JAX package's ``facade/``: the batched solver exposed
as a `ReplicaEstimator`-style service a Go scheduler would call, served
over the wire tier (estimator/wire.py's length-prefixed frames):

  * **Protocol** -- `SelectClusters` / `AssignReplicas` request /
    response messages (estimator/wire.py) plus the facade-only `WhatIf`
    query (messages.py): many independent callers each submit ONE small
    binding and get back a placement.
  * **Coalescing service** -- `FacadeService` (service.py) admits
    concurrent in-flight calls through a deadline-vs-size batch former,
    runs ONE detached solve (on backend "device" one device cycle on the
    card: K1-K4 and K3, K5 / K6 on spread rows) and demuxes per-call
    responses.
  * **What-if plane** -- capacity-planning queries (whatif.py) answered
    by hypothetical solves against a copy of the cluster view (the
    resident plane's, `ResidentState.fork_clusters`, when armed), never
    mutating live state.

The process-wide registry below: one armed service, read lazily; a
disarmed plane reports ``{"enabled": False}``.  The karmada_facade_*
families live in facade/metrics.py; `serve --facade[=ADDR]` arms the
plane, and the debug server (utils/httpserve) publishes it at
/debug/facade and /whatif (`karmadactl whatif --endpoint`).
"""

from __future__ import annotations

import threading
from typing import Optional

from karmada_tpu_torch.facade.client import FacadeClient
from karmada_tpu_torch.facade.messages import (
    FACADE_METHODS,
    WhatIfRequest,
    WhatIfResponse,
)
from karmada_tpu_torch.facade.service import FacadeService

__all__ = [
    "FACADE_METHODS",
    "FacadeClient",
    "FacadeService",
    "WhatIfRequest",
    "WhatIfResponse",
    "active",
    "set_active",
    "state_payload",
    "whatif_payload",
]

_LOCK = threading.Lock()
_ACTIVE: list = [None]


def set_active(service: Optional[FacadeService]) -> None:
    with _LOCK:
        _ACTIVE[0] = service


def active() -> Optional[FacadeService]:
    with _LOCK:
        return _ACTIVE[0]


def state_payload() -> dict:
    """/debug/facade: the armed service's coalescing / what-if counters,
    or the disarmed sentinel."""
    svc = active()
    if svc is None:
        return {"enabled": False}
    return svc.state_payload()


def whatif_payload(params: dict) -> dict:
    """/whatif: run one capacity-planning query from query parameters
    against the armed service (params -> WhatIfRequest -> hypothetical
    solve)."""
    svc = active()
    if svc is None:
        return {"enabled": False,
                "error": "facade plane not armed (serve --facade)"}
    try:
        req = WhatIfRequest.from_params(params)
        return svc.whatif(req).to_json()
    except ValueError as e:  # unknown query / unparseable number
        return {"enabled": True, "error": str(e)}
