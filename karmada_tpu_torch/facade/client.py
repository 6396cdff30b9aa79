"""Caller-side facade stub: the hardened wire path for facade verbs.

Counterpart of the JAX package's ``facade/client.py``.  Reuses the
estimator tier's failure machinery -- the typed error taxonomy
(classify_exception), the circuit breaker, and the `estimator.rpc` chaos
seam -- so a facade endpoint fault flows through the paths the
per-cluster estimator faults take: error / timeout / slow / garbage fired
at this transport surface as EstimatorUnreachable / EstimatorTimeout /
EstimatorMalformed, the breaker opens after consecutive failures and
half-open-recovers after its window.  Failures count on
karmada_estimator_errors_total and, by kind, on `errors`.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

from karmada_tpu_torch import chaos
from karmada_tpu_torch.estimator import wire
from karmada_tpu_torch.estimator.client import (
    ESTIMATOR_ERRORS,
    CircuitBreaker,
    EstimatorCircuitOpen,
    EstimatorError,
    EstimatorUnreachable,
    classify_exception,
)
from karmada_tpu_torch.facade.messages import WhatIfRequest, WhatIfResponse

#: the breaker "cluster" key for a facade endpoint (one endpoint = one
#: circuit, the per-cluster analogue)
FACADE_ENDPOINT = "facade"


class FacadeClient:
    """One facade endpoint: typed errors, retry, one breaker circuit.

    ``transport`` is any wire.Transport (TcpTransport against a served
    facade, LocalTransport(service.dispatch) in-process) or a bare
    ``(host, port)`` pair, dialed as a TcpTransport.  ``sleep`` is
    injectable so tests never wall-sleep."""

    def __init__(self, transport, *,
                 endpoint: str = FACADE_ENDPOINT,
                 breaker: Optional[CircuitBreaker] = None,
                 retry_attempts: int = 2,
                 retry_base_s: float = 0.02,
                 sleep: Callable[[float], None] = time.sleep) -> None:
        if isinstance(transport, (tuple, list)):
            transport = wire.TcpTransport(*transport)
        self.transport = transport
        self.endpoint = endpoint
        self.breaker = breaker if breaker is not None else CircuitBreaker()
        self.retry_attempts = max(1, retry_attempts)
        self.retry_base_s = retry_base_s
        self._sleep = sleep
        #: failures by typed kind (each failed attempt; "circuit_open" for
        #: each short-circuited call)
        self.errors: Dict[str, int] = {}

    def close(self) -> None:
        self.transport.close()

    # -- verbs ----------------------------------------------------------------
    def assign_replicas(
            self,
            req: wire.AssignReplicasRequest) -> wire.AssignReplicasResponse:
        if not req.trace_id:
            # the caller's ambient trace id rides the frame, so the
            # server's span of the coalesced batch names this caller
            from karmada_tpu_torch import obs

            sp = obs.TRACER.current()
            if sp is not None:
                req.trace_id = sp.trace.trace_id
        return wire.AssignReplicasResponse.from_json(
            self._call("AssignReplicas", req.to_json()))

    def select_clusters(
            self,
            req: wire.SelectClustersRequest) -> wire.SelectClustersResponse:
        return wire.SelectClustersResponse.from_json(
            self._call("SelectClusters", req.to_json()))

    def whatif(self, req: WhatIfRequest) -> WhatIfResponse:
        return WhatIfResponse.from_json(self._call("WhatIf", req.to_json()))

    # -- the hardened wire path ----------------------------------------------
    def _transport_call(self, method: str, payload: dict) -> dict:
        """One raw attempt with the chaos seam in front of the wire --
        the same `estimator.rpc` site the accurate tier fires, keyed by
        this endpoint, so one fault grammar covers both planes."""
        if chaos.armed():
            f = chaos.fire(chaos.SITE_ESTIMATOR_RPC, cluster=self.endpoint,
                           method=method)
            if f is not None:
                if f.mode == "error":
                    raise ConnectionError("chaos: facade connection refused")
                if f.mode == "timeout":
                    raise TimeoutError("chaos: facade call timed out")
                if f.mode == "slow":
                    self._sleep(f.delay)
                elif f.mode == "garbage":
                    # structurally unusable on every verb's parse path
                    return {"assignments": 0, "clusters": 0, "excluded": 0,
                            "result": 0}
        return self.transport.call(method, payload)

    def _call(self, method: str, payload: dict) -> dict:
        """Breaker gate, bounded retry, typed classification -- the
        estimator client's _request shape for a single endpoint."""
        if not self.breaker.allow(self.endpoint):
            self._count(EstimatorCircuitOpen.kind)
            ESTIMATOR_ERRORS.inc(kind=EstimatorCircuitOpen.kind)
            raise EstimatorCircuitOpen(
                f"facade circuit open for endpoint {self.endpoint!r}")
        err: EstimatorError = EstimatorUnreachable("no attempt made")
        for attempt in range(self.retry_attempts):
            if attempt:
                self._sleep(self.retry_base_s * (2 ** (attempt - 1)))
            try:
                reply = self._transport_call(method, payload)
                # force the parse NOW so a garbage reply classifies as
                # malformed inside the retry loop, not at the caller
                self._parse_check(method, reply)
            except Exception as exc:  # noqa: BLE001 — classified + counted
                err = classify_exception(exc)
                self._count(err.kind)
                ESTIMATOR_ERRORS.inc(kind=err.kind)
                continue
            self.breaker.record_success(self.endpoint)
            return reply
        self.breaker.record_failure(self.endpoint)
        raise err

    def _count(self, kind: str) -> None:
        self.errors[kind] = self.errors.get(kind, 0) + 1

    @staticmethod
    def _parse_check(method: str, reply: dict) -> None:
        if method == "AssignReplicas":
            wire.AssignReplicasResponse.from_json(reply)
        elif method == "SelectClusters":
            wire.SelectClustersResponse.from_json(reply)
        elif method == "WhatIf":
            WhatIfResponse.from_json(reply)
