"""FacadeService: server-side batch coalescing over the detached solver.

Counterpart of the JAX package's ``facade/service.py``.  Concurrent
`AssignReplicas` callers (one small binding each) enqueue into a
deadline-vs-size batch former -- the scheduler's own admission shape:
cut when the window fills OR the oldest caller has waited the deadline,
never cut empty -- and ONE detached solve (Scheduler.solve_batch with
``detached=True``: on backend "device" one device cycle on the card)
answers the whole batch.  Many small RPCs become one device dispatch:
the coalesce ratio (calls / batches in `state_payload`) is the plane's
headline number.

`SelectClusters` (a host-side feasibility filter) and `WhatIf`
(whatif.py's hypothetical solves) answer inline -- no coalescing; they
share the solve lock so facade work never races itself.  NOTHING in
this module mutates the store or the resident plane: the facade is a
solver service, not a second writer.  Its coalesced solves read a copy
of the store's Clusters, as the JAX service's do, taken again only when
a Cluster's resourceVersion moved, with the encoder's cluster side
derived once a copy (core.ClusterView).

Each coalesced dispatch is a `facade.cycle` span and each what-if query a
`facade.whatif` span; every caller's outcome lands on the lifecycle
ledger (FacadeAssigned / FacadeRejected), each dispatch is a "facade"
flight record (obs/incidents), and the karmada_facade_* families
(facade/metrics.py) count calls, batches and latency.  The counters also
live in `state_payload`, as in the JAX package, and `batch_walls` holds
the host seconds of the last coalesced solves.
"""

from __future__ import annotations

import collections
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from karmada_tpu_torch import obs
from karmada_tpu_torch.estimator import wire
from karmada_tpu_torch.facade import metrics as facade_metrics
from karmada_tpu_torch.facade import whatif as whatif_mod
from karmada_tpu_torch.facade.messages import WhatIfRequest, WhatIfResponse
from karmada_tpu_torch.models.cluster import Cluster
from karmada_tpu_torch.models.work import ResourceBindingStatus
from karmada_tpu_torch.obs import events as obs_events
from karmada_tpu_torch.obs import incidents as obs_incidents
from karmada_tpu_torch.ops import serial
from karmada_tpu_torch.scheduler.core import ClusterView

OUTCOME_SCHEDULED = "scheduled"
OUTCOME_UNSCHEDULABLE = "unschedulable"
OUTCOME_ERROR = "error"


@dataclass
class _Pending:
    request: wire.AssignReplicasRequest
    t_enqueue: float
    done: threading.Event = field(default_factory=threading.Event)
    response: Optional[wire.AssignReplicasResponse] = None


class PendingAssign:
    """An in-flight AssignReplicas call (FacadeService.assign_async):
    ``result()`` blocks until the coalesced dispatch demuxes this
    caller's slice."""

    __slots__ = ("_svc", "_p")

    def __init__(self, svc: "FacadeService", p: _Pending) -> None:
        self._svc = svc
        self._p = p

    def result(self,
               timeout: Optional[float] = None
               ) -> wire.AssignReplicasResponse:
        if not self._p.done.wait(timeout):
            raise TimeoutError("facade assign still in flight")
        return self._svc._finish(self._p)  # noqa: SLF001 -- owning service


class FacadeService:
    """One facade plane over one live Scheduler + store.

    ``batch_window`` defaults to the scheduler's own;
    ``batch_deadline_s`` is deliberately SHORT (an RPC caller is blocked
    for it) -- coalescing comes from concurrency, the deadline only
    bounds a straggler's wait."""

    #: coalesced solves whose host seconds `batch_walls` keeps
    WALLS_KEPT = 4096

    def __init__(self, scheduler, store, *,
                 batch_window: Optional[int] = None,
                 batch_deadline_s: float = 0.02,
                 clock=time.monotonic) -> None:
        self.scheduler = scheduler
        self.store = store
        self.batch_window = int(batch_window or scheduler.batch_window)
        self.batch_deadline_s = float(batch_deadline_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        # _cond wraps _lock: waiters and counter updates share one mutex
        self._pending: List[_Pending] = []  # guarded-by: _cond
        self._closed = False  # guarded-by: _cond
        self._calls = 0  # guarded-by: _cond
        self._batch_id = 0  # guarded-by: _cond
        self._batches = 0  # guarded-by: _lock
        self._coalesced_calls = 0  # guarded-by: _lock
        self._errors = 0  # guarded-by: _lock
        self._whatif_counts: Dict[str, int] = {}  # guarded-by: _lock
        self._last_batch_size = 0  # guarded-by: _lock
        #: (batch size, host seconds of its detached solve), newest last
        self.batch_walls: collections.deque = collections.deque(
            maxlen=self.WALLS_KEPT)  # guarded-by: _lock
        # serializes every detached solve this service issues (assign
        # batches and what-if probes) -- detached solves are safe against
        # the live cycle worker but not against each other
        self._solve_lock = threading.Lock()
        # the coalesced solves' copy of the Clusters and its (name,
        # resourceVersion) list
        self._view: Optional[ClusterView] = None  # guarded-by: _solve_lock
        self._view_key: Optional[list] = None  # guarded-by: _solve_lock
        self._server: Optional[wire.EstimatorTcpServer] = None
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="facade-coalescer")
        self._worker.start()

    # -- serving --------------------------------------------------------------
    def serve(self, host: str = "127.0.0.1", port: int = 0,
              ssl_context=None) -> tuple:
        """Expose the facade over the wire tier; returns the bound
        (host, port)."""
        self._server = wire.serve_tcp(self.dispatch, host, port,
                                      ssl_context=ssl_context)
        return self._server.server_address[:2]

    @property
    def address(self) -> Optional[tuple]:
        if self._server is None:
            return None
        return self._server.server_address[:2]

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        self._worker.join(timeout=2.0)

    def dispatch(self, method: str, body: dict) -> dict:
        """The wire handler (serve_tcp): method + JSON body in, JSON
        body out.  Unknown methods raise -- the transport serializes
        that as an error frame, which the client surfaces typed."""
        if method == "AssignReplicas":
            return self.assign(
                wire.AssignReplicasRequest.from_json(body)).to_json()
        if method == "SelectClusters":
            return self.select_clusters(
                wire.SelectClustersRequest.from_json(body)).to_json()
        if method == "WhatIf":
            return self.whatif(WhatIfRequest.from_json(body)).to_json()
        raise ValueError(f"unknown facade method {method!r}")

    # -- AssignReplicas (the coalesced verb) ----------------------------------
    def assign(self,
               req: wire.AssignReplicasRequest
               ) -> wire.AssignReplicasResponse:
        """Blocking per caller: enqueue, ride the next coalesced
        dispatch, return this caller's demuxed slice."""
        return self.assign_async(req).result()

    def assign_async(self,
                     req: wire.AssignReplicasRequest) -> PendingAssign:
        """Non-blocking admission: enqueue the call and return a handle
        whose ``result()`` blocks for the demuxed response.

        Caller-runs cut: the admission that FILLS the window dispatches
        the batch inline on its own thread instead of waking the former;
        the background former only fires DEADLINE cuts, i.e. when
        traffic stalls with a partial window."""
        p = _Pending(request=req, t_enqueue=self._clock())
        batch: Optional[List[_Pending]] = None
        with self._cond:
            if self._closed:
                raise RuntimeError("facade service is closed")
            self._pending.append(p)
            self._calls += 1
            n_pending = len(self._pending)
            if n_pending >= self.batch_window:
                batch = self._pending[:self.batch_window]
                del self._pending[:len(batch)]
                self._batch_id += 1
                bid = self._batch_id
            elif n_pending == 1:
                # the first pending call starts the former's deadline clock
                self._cond.notify_all()
        if batch is not None:
            self._dispatch(batch, bid)
        return PendingAssign(self, p)

    def _finish(self, p: _Pending) -> wire.AssignReplicasResponse:
        """Per-call epilogue once the dispatch demuxed: latency + result
        metrics, closed-race fallback (PendingAssign.result)."""
        facade_metrics.FACADE_CALL_LATENCY.observe(
            self._clock() - p.t_enqueue, method="AssignReplicas")
        resp = p.response
        if resp is None:  # close() raced the wait
            resp = wire.AssignReplicasResponse(
                outcome=OUTCOME_ERROR, message="facade service closed")
        facade_metrics.FACADE_CALLS.inc(method="AssignReplicas",
                                        result=resp.outcome)
        return resp

    def _run(self) -> None:
        """The batch former: cut when the window fills or the oldest
        caller has waited the deadline; never cut empty."""
        while True:
            with self._cond:
                while not self._closed:
                    if self._pending:
                        age = self._clock() - self._pending[0].t_enqueue
                        if (len(self._pending) >= self.batch_window
                                or age >= self.batch_deadline_s):
                            break
                        self._cond.wait(
                            timeout=max(self.batch_deadline_s - age, 0.001))
                    else:
                        self._cond.wait(timeout=0.5)
                if self._closed and not self._pending:
                    return
                batch = self._pending[:self.batch_window]
                del self._pending[:len(batch)]
                self._batch_id += 1
                bid = self._batch_id
            self._dispatch(batch, bid)

    def _dispatch(self, batch: List[_Pending], bid: int) -> None:
        """Run one cut batch to completion -- shared by the deadline
        former and the caller-runs window cut; every caller in the
        batch is unblocked no matter what the solve does."""
        try:
            self._solve_assign(batch, bid)
        except Exception as e:  # noqa: BLE001 — callers must unblock
            with self._lock:
                self._errors += 1
            for p in batch:
                p.response = wire.AssignReplicasResponse(
                    outcome=OUTCOME_ERROR, message=str(e),
                    batch_id=bid, batch_size=len(batch))
                p.done.set()

    def _solve_assign(self, batch: List[_Pending], bid: int) -> None:
        """One coalesced dispatch: synthesize bindings, read the cluster
        view, ONE detached solve, demux per caller."""
        bindings = [whatif_mod.synthesize_binding(p.request) for p in batch]
        # a caller-supplied (namespace, name) may collide across the
        # batch; the solve is positional
        t0 = time.perf_counter()
        tracer = obs.TRACER
        trace_id = ""
        # caller-side trace ids off the wire frames, stitched onto the
        # one coalesced dispatch they shared
        caller_traces = sorted({p.request.trace_id for p in batch
                                if p.request.trace_id})
        with tracer.span(obs.SPAN_FACADE_CYCLE, callers=len(batch),
                         batch_id=bid):
            sp = tracer.current()
            if sp is not None:
                trace_id = sp.trace.trace_id
                if caller_traces:
                    sp.set_attr(caller_trace_ids=caller_traces)
            with self._solve_lock:
                view = self._cluster_view()
                results, _ = self.scheduler.solve_batch(
                    bindings, view.clusters, detached=True, view=view)
        wall = time.perf_counter() - t0
        if obs_incidents.flight_armed():
            obs_incidents.record(
                "facade", t=round(time.time(), 6), batch_id=bid,
                trace_id=trace_id or None, batch=len(batch),
                caller_trace_ids=caller_traces)
        with self._lock:
            self._batches += 1
            self._coalesced_calls += len(batch)
            self._last_batch_size = len(batch)
            self.batch_walls.append((len(batch), wall))
        facade_metrics.FACADE_BATCHES.inc()
        facade_metrics.FACADE_BATCH_SIZE.observe(len(batch))
        # the armed() guard hoisted out of emit_key: a disarmed ledger
        # must not pay for the per-caller message strings
        ledger_armed = obs_events.armed()
        for i, p in enumerate(batch):
            res = results.get(i)
            key = (p.request.namespace, p.request.name)
            if isinstance(res, Exception) or res is None:
                msg = str(res) if res is not None else "no result"
                p.response = wire.AssignReplicasResponse(
                    outcome=OUTCOME_UNSCHEDULABLE, message=msg,
                    trace_id=trace_id, batch_id=bid, batch_size=len(batch))
                if ledger_armed:
                    obs_events.emit_key(
                        key, obs_events.TYPE_WARNING,
                        obs_events.REASON_FACADE_REJECTED,
                        f"facade batch {bid} ({len(batch)} callers): {msg}",
                        origin="facade", trace_id=trace_id or None)
            else:
                p.response = wire.AssignReplicasResponse(
                    assignments=[{"cluster": t.name, "replicas": t.replicas}
                                 for t in res],
                    outcome=OUTCOME_SCHEDULED, trace_id=trace_id,
                    batch_id=bid, batch_size=len(batch))
                if ledger_armed:
                    where = ", ".join(f"{t.name}({t.replicas})"
                                      for t in res)
                    obs_events.emit_key(
                        key, obs_events.TYPE_NORMAL,
                        obs_events.REASON_FACADE_ASSIGNED,
                        f"facade batch {bid} ({len(batch)} callers) "
                        "assigned" + (f" to {where}" if where else ""),
                        origin="facade", trace_id=trace_id or None)
            p.done.set()

    def _cluster_view(self) -> ClusterView:
        """The clusters a coalesced solve reads: a copy of the store's
        (ObjectStore.list), kept while every Cluster keeps its
        resourceVersion -- a write and a finalizer-gated delete's mark
        each move it -- so the solves of a quiet fleet share one copy and
        its cluster side.  Called under the solve lock."""
        key = [(c.metadata.name, c.metadata.resource_version)
               for c in self.store.visit(Cluster.KIND)]
        if self._view is None or key != self._view_key:
            copies = self.store.list(Cluster.KIND)
            self._view = ClusterView(copies)
            self._view_key = [(c.metadata.name, c.metadata.resource_version)
                              for c in copies]
        return self._view

    # -- SelectClusters (inline feasibility filter) ---------------------------
    def select_clusters(self,
                        req: wire.SelectClustersRequest
                        ) -> wire.SelectClustersResponse:
        rb = whatif_mod.synthesize_binding(wire.AssignReplicasRequest(
            namespace=req.namespace, name=req.name,
            resource_request=req.resource_request,
            cluster_names=req.cluster_names))
        with self._solve_lock:
            clusters = self._cluster_view().clusters
        fit, diagnosis = serial.find_clusters_that_fit(
            rb.spec, ResourceBindingStatus(), clusters)
        facade_metrics.FACADE_CALLS.inc(method="SelectClusters",
                                        result=OUTCOME_SCHEDULED)
        return wire.SelectClustersResponse(
            clusters=sorted(c.name for c in fit), excluded=diagnosis)

    # -- WhatIf (the capacity-planning plane) ---------------------------------
    def whatif(self, req: WhatIfRequest) -> WhatIfResponse:
        t0 = self._clock()
        with obs.TRACER.span(obs.SPAN_FACADE_WHATIF, query=req.query):
            resp = whatif_mod.run_query(self.scheduler, self.store, req,
                                        solve_lock=self._solve_lock)
        with self._lock:
            self._whatif_counts[req.query] = (
                self._whatif_counts.get(req.query, 0) + 1)
        facade_metrics.FACADE_WHATIF.inc(query=req.query)
        facade_metrics.FACADE_CALL_LATENCY.observe(
            self._clock() - t0, method="WhatIf")
        facade_metrics.FACADE_CALLS.inc(method="WhatIf",
                                        result=OUTCOME_SCHEDULED)
        return resp

    # -- the JAX package's /debug/facade payload ------------------------------
    def state_payload(self) -> dict:
        with self._lock:
            calls, batches = self._calls, self._batches
            payload = {
                "enabled": True,
                "batch_window": self.batch_window,
                "batch_deadline_s": self.batch_deadline_s,
                "calls": calls,
                "batches": batches,
                "coalesced_calls": self._coalesced_calls,
                "coalesce_ratio": (round(self._coalesced_calls / batches, 4)
                                   if batches else 0.0),
                "last_batch_size": self._last_batch_size,
                "inflight": len(self._pending),
                "errors": self._errors,
                "whatif": dict(self._whatif_counts),
            }
        addr = self.address
        payload["address"] = (f"{addr[0]}:{addr[1]}" if addr else None)
        return payload
