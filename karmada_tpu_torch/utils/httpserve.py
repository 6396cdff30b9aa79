"""Observability HTTP endpoint for long-running processes (counterpart
of the JAX package's ``utils/httpserve.py``: the same routes, payloads,
status codes and error bodies).

Reference: every binary exposes Prometheus metrics plus an opt-in pprof
server (pkg/sharedcli/profileflag/profileflag.go:58-70). Here one small
ThreadingHTTPServer serves:

    /metrics   Prometheus text exposition (utils/metrics.REGISTRY)
    /healthz   liveness ("ok")
    /readyz    readiness: the supplied probe callback (e.g. store reachable)
    /debug/state   JSON snapshot: object counts per kind, the device-probe
                   history (utils/deviceprobe: K14's last probe), the
                   solver mesh (the single-device fallback: device.py
                   mesh_info), trace-recorder stats
    /debug/traces        recent flight-recorder ring (JSON, full spans)
    /debug/traces/slow   the always-retained slowest-cycles shelf (JSON)
    /debug/traces/{id}   one trace as a text waterfall
                         (?format=json for the raw trace)
    /debug/explain       recent explain-plane decision summaries + the
                         always-retained unschedulable shelf (JSON)
    /debug/explain/{namespace}/{name}
                         one binding's full Decision (verdict table)
    /debug/load          live load-generator state (loadgen/,
                         armed by `serve --loadgen SCENARIO`): scenario
                         progress, admission/shed counts, queue depths
                         and oldest-resident ages; {"enabled": false}
                         when no driver is active
    /debug/resident      resident-state plane (resident/, armed by `serve
                         --resident`): generation, vocab sizes, row-cache
                         hit rate, delta depth, audit outcomes
                         (?recent=N adds per-cycle records): host-side
                         counters read under the plane's stats lock,
                         never the device mirrors K10-K12 keep;
                         {"enabled": false} when rebuild-per-cycle
    /debug/rebalance     rebalance plane (rebalance/, serve --rebalance):
                         last detect (K13) scores per cluster,
                         eviction/conservation totals, pacing budget;
                         render with `karmadactl rebalance --endpoint`

    /debug/facade        facade plane (facade/, armed by
                         `serve --facade[=ADDR]`): call/batch totals,
                         the coalesce ratio, in-flight depth, what-if
                         query tallies, the bound wire address;
                         {"enabled": false} when disarmed
    /whatif              capacity-planning queries against the armed
                         facade plane (?query=placement|cluster-loss|
                         headroom&replicas=N&cpu=Q&memory=Q&divided=
                         &cluster=&limit=): a hypothetical solve on a
                         copy-on-write fork of live state (the facade's
                         detached solve: its own workspaces, beside the
                         live cycle) — never mutates a placement; what
                         `karmadactl whatif` polls
    /debug/chaos         chaos fault-injection plane (chaos/,
                         armed by `serve --chaos SPEC`): armed rules with
                         fire counts, per-site totals, the recent fire
                         log; {"enabled": false} when disarmed
    /debug/timeseries    telemetry plane ring (obs/timeseries, armed by
                         `serve --telemetry`): per-series point lists
                         over the retained window, counters with
                         reset-aware window deltas; ?n=N limits samples,
                         ?prefix=karmada_scheduler filters families,
                         ?points=0 keeps only the window aggregates
                         (delta/last — what karmadactl top polls);
                         {"enabled": false} when disarmed
    /debug/slo           SLO error budgets (obs/slo): per-objective
                         multi-window burn rates, budget remaining, the
                         regression-watchdog verdict; {"enabled": false}
                         when disarmed
    /debug/incidents     incident plane (obs/incidents): flight-ring
                         stats, capture/suppression totals by trigger,
                         the bounded bundle index; {"enabled": false}
                         when the store is disarmed (the flight ring
                         itself is armed by default)
    /debug/incidents/{id}
                         one self-contained forensic bundle: the flight
                         ring, MetricRing samples + SLO verdict,
                         implicated-binding timelines, the locks block,
                         and the trigger's own detail (e.g. the audit
                         divergence diff)
    /debug/profile?seconds=N
                         on-demand torch.profiler capture (obs/devprof):
                         opens a bounded trace window with K15 markers on
                         the server's device, writes the chrome trace
                         under the serve dir, answers the artifact
                         inventory and the device kernels the window
                         recorded; one capture at a time (HTTP 409 while
                         busy); without a card and without device="cpu"
                         the capture answers a JSON 500
    /debug/events        lifecycle ledger (obs/events, armed by
                         default): counters, per-reason tallies, the
                         recent event ring; ?n=N bounds the ring slice,
                         ?since=SEQ returns only events with activity
                         after the cursor (last_seq — coalesced repeats
                         included; the `karmadactl events --watch`
                         cursor)
    /debug/events/{ns}/{name}
                         one binding's gap-free event timeline plus a
                         status summary from the live store (clusters,
                         Scheduled condition, eviction tasks) — what
                         `karmadactl describe ns/name --endpoint`
                         renders kube-style

The trace endpoints read the process-wide tracer (obs.TRACER, armed by
`karmadactl serve --trace-buffer N`) unless an explicit recorder is
injected; with tracing disabled they answer {"enabled": false} rather
than 404 so a dashboard can poll unconditionally.  The explain endpoints
read the injected decision recorder: the port keeps one per Scheduler
(no process-wide ring), and `serve --explain` injects
``cp.scheduler.decisions``; with none they answer {"enabled": false}
too.  Unknown trace/decision ids answer a JSON 404 body ({"error":
...}), and a handler exception answers a JSON 500 — never a closed
connection.
"""

from __future__ import annotations

import json
import threading
from typing import Callable, Optional


class ObservabilityServer:
    def __init__(
        self,
        store=None,
        registry=None,
        ready_probe: Optional[Callable[[], bool]] = None,
        recorder=None,
        decisions=None,
        # /debug/profile artifact root (serve passes <plane dir>/profiles);
        # None lazily falls back to a tmp dir on the first capture
        profile_dir: Optional[str] = None,
        # the device /debug/profile captures on: None is the first CUDA
        # card (and, without one, a JSON 500), "cpu" a CPU-only window
        device=None,
    ) -> None:
        from karmada_tpu_torch.utils.metrics import REGISTRY

        self.store = store
        self.registry = registry if registry is not None else REGISTRY
        self.ready_probe = ready_probe
        self._recorder = recorder
        self._decisions = decisions
        self.profile_dir = profile_dir
        self.device = device
        self._httpd = None
        self._thread: Optional[threading.Thread] = None

    def _trace_recorder(self):
        if self._recorder is not None:
            return self._recorder
        from karmada_tpu_torch import obs

        return obs.TRACER.recorder  # None while tracing is disabled

    def _decision_recorder(self):
        # the port's explain plane is per Scheduler: None when no
        # recorder was injected (module docstring)
        return self._decisions

    def _state(self) -> dict:
        from karmada_tpu_torch import resident
        from karmada_tpu_torch.device import mesh_info
        from karmada_tpu_torch.obs import events as obs_events
        from karmada_tpu_torch.ops import aotcache
        from karmada_tpu_torch.utils import deviceprobe, locks

        counts = self.store.counts_by_kind() if self.store is not None else {}
        rec = self._trace_recorder()
        dec = self._decision_recorder()
        return {"objects_by_kind": counts,
                # the lifecycle ledger's counters (obs/events): recorded/
                # coalesced/evicted totals + retained window size
                "events": obs_events.ledger().counters(),
                "total": sum(counts.values()),
                "device_probe": deviceprobe.last_probe(),
                # the warm hook (ops/aotcache): the per-(shape x
                # variant) warm-start ledger
                "aot": aotcache.state_payload(),
                # the solver mesh: the single-device fallback (the port
                # has no mesh plan yet); never touches a device
                "mesh": mesh_info(),
                # the resident-state plane (karmada_tpu/resident):
                # generation, vocab sizes, row-cache hit rate, last audit
                # — {"enabled": false} when running rebuild-per-cycle
                "resident": resident.state_payload(),
                # the shortlist plane (ops/shortlist): dispatch/fallback
                # counters + the last shortlisted chunk's geometry.
                # Read through sys.modules so a host-backend plane that
                # never armed the two-tier solve pays no jax import
                "shortlist": self._shortlist_state(),
                # the runtime race detector (utils/locks): armed flag,
                # per-VetLock owner/held-for, single-thread ownership
                # contracts, order-edge + inversion counts, watchdog —
                # the first page to pull when a serve process wedges
                "locks": locks.state_payload(),
                "traces": rec.stats() if rec is not None else None,
                "explain": dec.stats() if dec is not None else None}

    @staticmethod
    def _shortlist_state() -> dict:
        import sys as _sys

        mod = _sys.modules.get("karmada_tpu_torch.ops.shortlist")
        if mod is None:
            return {"active": False}
        payload = mod.state_payload()
        # "active" means the tier actually ran, not merely that some
        # other plane imported the module
        return {"active": payload["dispatches"] > 0, **payload}

    def _traces_payload(self, which: str) -> dict:
        from karmada_tpu_torch.obs import export

        rec = self._trace_recorder()
        if rec is None:
            return {"enabled": False, "traces": []}
        traces = rec.slowest() if which == "slow" else rec.recent()
        return {
            "enabled": True,
            "dropped": rec.dropped,
            "summaries": [export.summarize(t) for t in traces],
            "traces": traces,
        }

    @staticmethod
    def _query_params(query: str) -> dict:
        """k=v pairs of a raw query string (no repeats expected on the
        debug surface; the last value wins)."""
        out = {}
        for part in (query or "").split("&"):
            if "=" in part:
                k, v = part.split("=", 1)
                out[k] = v
        return out

    @staticmethod
    def _json_error(message: str, code: int):
        """A well-formed JSON error body: unknown ids and handler faults
        must never surface as an unhandled exception / empty response."""
        return (json.dumps({"error": message}).encode(),
                "application/json", code)

    def _one_trace(self, trace_id: str, as_json: bool):
        """(body, ctype, code) for /debug/traces/{id}."""
        from karmada_tpu_torch.obs import export

        rec = self._trace_recorder()
        tr = rec.get(trace_id) if rec is not None else None
        if tr is None:
            return self._json_error(f"trace {trace_id!r} not found", 404)
        if as_json:
            return export.to_json(tr).encode(), "application/json", 200
        return (export.render_waterfall(tr).encode() + b"\n",
                "text/plain", 200)

    @staticmethod
    def _decision_summary(d: dict) -> dict:
        return {"key": d["key"], "outcome": d["outcome"],
                "reason": d.get("reason"), "message": d.get("message"),
                "trace_id": d.get("trace_id"), "ts": d.get("ts"),
                "backend": d.get("backend"), "event_id": d.get("event_id")}

    def _explain_payload(self) -> dict:
        rec = self._decision_recorder()
        if rec is None:
            return {"enabled": False, "decisions": [], "unschedulable": []}
        return {
            "enabled": True,
            "stats": rec.stats(),
            "dropped": rec.dropped,
            "decisions": [self._decision_summary(d) for d in rec.recent()],
            "unschedulable": [self._decision_summary(d)
                              for d in rec.unschedulable()],
        }

    def _one_timeline(self, key: str):
        """(body, ctype, code) for /debug/events/{namespace}/{name}: the
        binding's ordered event timeline + a live status summary (the
        `karmadactl describe --endpoint` payload)."""
        from karmada_tpu_torch.obs import events as obs_events

        if "/" not in key:
            return self._json_error(
                f"expected namespace/name, got {key!r}", 404)
        ns, name = key.split("/", 1)
        payload = obs_events.timeline_payload(ns, name)
        payload["binding"] = self._binding_summary(ns, name)
        # the explain cross-reference: the latest Decision's identity so
        # the describe renderer can show the verdict one fetch away
        dec = self._decision_recorder()
        d = dec.get(f"{ns}/{name}") if dec is not None else None
        if d is not None:
            payload["decision"] = {
                "id": d.get("id"), "outcome": d.get("outcome"),
                "reason": d.get("reason"), "message": d.get("message"),
                "event_id": d.get("event_id")}
        return json.dumps(payload).encode(), "application/json", 200

    def _binding_summary(self, ns: str, name: str):
        """A kube-describe-style status block from the live store (None
        when the server carries no store or the binding is gone)."""
        if self.store is None:
            return None
        rb = self.store.try_get("ResourceBinding", ns, name)
        if rb is None:
            return None
        cond = next((c for c in rb.status.conditions
                     if c.type == "Scheduled"), None)
        return {
            "exists": True,
            "generation": rb.metadata.generation,
            "observed_generation": rb.status.scheduler_observed_generation,
            "replicas": rb.spec.replicas,
            "clusters": [{"name": t.name, "replicas": t.replicas}
                         for t in rb.spec.clusters],
            "eviction_tasks": [{"from_cluster": t.from_cluster,
                                "reason": t.reason, "producer": t.producer}
                               for t in rb.spec.graceful_eviction_tasks],
            "scheduled_condition": (None if cond is None else {
                "status": cond.status, "reason": cond.reason,
                "message": cond.message}),
        }

    def _one_decision(self, key: str):
        """(body, ctype, code) for /debug/explain/{namespace}/{name}."""
        rec = self._decision_recorder()
        if rec is None:
            return self._json_error(
                "explain plane is disabled (serve --explain to arm it)", 404)
        d = rec.get(key)
        if d is None:
            return self._json_error(f"no decision recorded for {key!r}", 404)
        return json.dumps(d).encode(), "application/json", 200

    def _route(self, path: str, query: str):
        """(body, ctype, code) for one GET."""
        if path == "/metrics":
            return (self.registry.dump().encode(),
                    "text/plain; version=0.0.4", 200)
        if path == "/healthz":
            return b"ok", "text/plain", 200
        if path == "/readyz":
            ok = self.ready_probe() if self.ready_probe else True
            return (b"ok" if ok else b"not ready", "text/plain",
                    200 if ok else 503)
        if path == "/debug/state":
            return json.dumps(self._state()).encode(), "application/json", 200
        if path in ("/debug/traces", "/debug/traces/slow"):
            which = "slow" if path.endswith("/slow") else "recent"
            return (json.dumps(self._traces_payload(which)).encode(),
                    "application/json", 200)
        if path.startswith("/debug/traces/"):
            trace_id = path[len("/debug/traces/"):]
            return self._one_trace(trace_id, "format=json" in (query or ""))
        if path == "/debug/load":
            from karmada_tpu_torch.loadgen import driver as loadgen_driver

            return (json.dumps(loadgen_driver.load_state()).encode(),
                    "application/json", 200)
        if path == "/debug/resident":
            from karmada_tpu_torch import resident

            recent = 0
            for part in (query or "").split("&"):
                if part.startswith("recent="):
                    try:
                        recent = max(0, int(part[len("recent="):]))
                    except ValueError:
                        pass
            return (json.dumps(resident.state_payload(recent)).encode(),
                    "application/json", 200)
        if path == "/debug/chaos":
            from karmada_tpu_torch import chaos

            return (json.dumps(chaos.state_payload()).encode(),
                    "application/json", 200)
        if path == "/debug/rebalance":
            from karmada_tpu_torch import rebalance

            return (json.dumps(rebalance.state_payload()).encode(),
                    "application/json", 200)
        if path == "/debug/facade":
            from karmada_tpu_torch import facade

            return (json.dumps(facade.state_payload()).encode(),
                    "application/json", 200)
        if path == "/whatif":
            from karmada_tpu_torch import facade

            payload = facade.whatif_payload(self._query_params(query))
            code = 200 if "error" not in payload else (
                503 if not payload.get("enabled", True) else 400)
            return json.dumps(payload).encode(), "application/json", code
        if path == "/debug/timeseries":
            from karmada_tpu_torch.obs import timeseries

            params = self._query_params(query)
            n = None
            try:
                if params.get("n"):
                    n = max(0, int(params["n"]))
            except ValueError:
                pass
            return (json.dumps(timeseries.state_payload(
                        n=n, prefix=params.get("prefix") or None,
                        include_points=params.get("points") != "0")).encode(),
                    "application/json", 200)
        if path == "/debug/slo":
            from karmada_tpu_torch.obs import slo

            return (json.dumps(slo.state_payload()).encode(),
                    "application/json", 200)
        if path == "/debug/incidents":
            from karmada_tpu_torch.obs import incidents

            return (json.dumps(incidents.state_payload(),
                               default=str).encode(),
                    "application/json", 200)
        if path.startswith("/debug/incidents/"):
            from karmada_tpu_torch.obs import incidents

            iid = path[len("/debug/incidents/"):]
            bundle = incidents.bundle_payload(iid)
            if bundle is None:
                return self._json_error(
                    f"no incident bundle {iid!r} (incident plane "
                    "disarmed, id unknown, or bundle evicted)", 404)
            return (json.dumps(bundle, default=str).encode(),
                    "application/json", 200)
        if path == "/debug/profile":
            from karmada_tpu_torch.obs import devprof

            params = self._query_params(query)
            try:
                seconds = float(params.get("seconds", "1"))
            except ValueError:
                return self._json_error(
                    f"seconds must be a number, got "
                    f"{params.get('seconds')!r}", 400)
            out_dir = self.profile_dir
            if out_dir is None:
                import tempfile

                out_dir = self.profile_dir = tempfile.mkdtemp(
                    prefix="karmada-profile-")
            rec = devprof.capture_profile(seconds, out_dir,
                                          device=self.device)
            code = 200 if rec.get("ok") else (
                409 if rec.get("busy") else 500)
            return json.dumps(rec).encode(), "application/json", code
        if path == "/debug/events":
            from karmada_tpu_torch.obs import events as obs_events

            params = self._query_params(query)
            n, since = 64, None
            try:
                if params.get("n"):
                    n = max(0, int(params["n"]))
                if params.get("since"):
                    since = int(params["since"])
            except ValueError:
                pass
            return (json.dumps(obs_events.state_payload(
                        n=n, since=since)).encode(),
                    "application/json", 200)
        if path.startswith("/debug/events/"):
            return self._one_timeline(path[len("/debug/events/"):])
        if path == "/debug/explain":
            return (json.dumps(self._explain_payload()).encode(),
                    "application/json", 200)
        if path.startswith("/debug/explain/"):
            key = path[len("/debug/explain/"):]
            return self._one_decision(key)
        if path.startswith("/debug/"):
            return self._json_error(f"no such debug endpoint {path!r}", 404)
        return b"not found", "text/plain", 404

    def start(self, port: int = 0, host: str = "127.0.0.1") -> str:
        import http.server
        import urllib.parse

        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — http.server convention
                parsed = urllib.parse.urlsplit(self.path)
                try:
                    body, ctype, code = outer._route(parsed.path,
                                                     parsed.query)
                except Exception as e:  # noqa: BLE001 — JSON 500, never a
                    # closed connection with no body
                    body, ctype, code = outer._json_error(repr(e), 500)
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # quiet per-request stderr
                pass

        self._httpd = http.server.ThreadingHTTPServer((host, port), Handler)
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        h, p = self._httpd.server_address
        return f"http://{h}:{p}"

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
