"""Interpreter webhook tier — out-of-process customizations over HTTP.

Counterpart of the JAX package's ``interpreter/webhook.py``.

Reference: pkg/resourceinterpreter/customized/webhook/ (the engine: match a
manifest against ResourceInterpreterWebhook configs, POST an
InterpreterContext, apply the response) and pkg/webhook/interpreter/ (the
host serving the protocol inside the user's interpreter process).

Wire protocol (the InterpreterContext analog,
pkg/apis/config/v1alpha1/interpretercontext_types.go):

    request  = {"operation": OP_*, "object": {...},
                "desiredReplicas": int?, "observedObject": {...}?,
                "aggregatedStatusItems": [{"cluster": str, "status": {}}]?}
    response = {"successful": bool, "message": str?,
                "replicas": int?, "requirements": {res: "qty"}?,
                "components": [...]?, "revised": {...}?, "retained": {...}?,
                "status": {...}?, "healthy": bool?, "dependencies": [...]?}

Transports: ``http://host:port/path`` via http.client (loopback services),
or ``local:<name>`` resolving to an in-process handler registered with
:func:`register_local_endpoint` — tests and embedded interpreters use the
latter, mirroring estimator/wire.LocalTransport.
"""

from __future__ import annotations

import json
import threading
from typing import Any, Callable, Dict, Optional, Tuple

from karmada_tpu_torch.models.config import ResourceInterpreterWebhook

# in-process endpoints: name -> handler(request_dict) -> response_dict
_LOCAL_ENDPOINTS: Dict[str, Callable[[dict], dict]] = {}
_LOCAL_LOCK = threading.Lock()


class WebhookCallError(Exception):
    """Transport failure or unsuccessful response from an interpreter
    webhook — surfaced to the caller instead of silently falling through
    to a lower tier (interpreter.go treats webhook errors as errors, not
    as absence)."""


def register_local_endpoint(name: str, handler: Callable[[dict], dict]) -> None:
    with _LOCAL_LOCK:
        _LOCAL_ENDPOINTS[f"local:{name}"] = handler


def unregister_local_endpoint(name: str) -> None:
    with _LOCAL_LOCK:
        _LOCAL_ENDPOINTS.pop(f"local:{name}", None)


def _call_endpoint(endpoint: str, request: dict, timeout_s: float) -> dict:
    if endpoint.startswith("local:"):
        with _LOCAL_LOCK:
            handler = _LOCAL_ENDPOINTS.get(endpoint)
        if handler is None:
            raise WebhookCallError(f"no local endpoint {endpoint!r}")
        # JSON round-trip for transport parity with http://: a handler must
        # never receive references into live control-plane manifests
        try:
            return json.loads(json.dumps(handler(json.loads(json.dumps(request)))))
        except WebhookCallError:
            raise
        except Exception as e:  # noqa: BLE001 — handler/serialization fault
            raise WebhookCallError(f"{endpoint}: {e!r}") from e
    if endpoint.startswith("http://"):
        import http.client
        from urllib.parse import urlparse

        u = urlparse(endpoint)
        conn = http.client.HTTPConnection(u.hostname, u.port, timeout=timeout_s)
        try:
            body = json.dumps(request)
            conn.request("POST", u.path or "/", body,
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            data = resp.read()
            if resp.status != 200:
                raise WebhookCallError(
                    f"{endpoint}: HTTP {resp.status} {data[:200]!r}")
            return json.loads(data)
        except WebhookCallError:
            raise
        except Exception as e:  # noqa: BLE001 — network layer
            raise WebhookCallError(f"{endpoint}: {e!r}") from e
        finally:
            conn.close()
    raise WebhookCallError(f"unsupported endpoint scheme {endpoint!r}")


def _rule_matches(rule, api_version: str, kind: str, op: str) -> bool:
    """Wildcards must be EXPLICIT ("*") on every axis: an empty pattern
    list matches nothing, so a partially-filled InterpreterRule can never
    hijack kinds or operations the user did not spell out."""
    def hit(patterns, value) -> bool:
        return any(p == "*" or p == value for p in patterns)

    return (hit(rule.api_versions, api_version)
            and hit(rule.kinds, kind)
            and hit(rule.operations, op))


class WebhookManager:
    """Store-fed registry of ResourceInterpreterWebhook configs; produces
    facade hooks (same calling conventions as declarative.make_hooks) that
    forward over the wire."""

    def __init__(self) -> None:
        self._configs: Dict[str, ResourceInterpreterWebhook] = {}
        self._lock = threading.Lock()
        # resolved-hook cache, invalidated wholesale on any config change —
        # hook() sits on every controller's interpretation hot path
        self._gen = 0
        self._hook_cache: Dict[Tuple[str, str, str],
                               Tuple[int, Optional[Callable]]] = {}

    def attach_store(self, store) -> None:
        # subscribe FIRST, then rebuild: a config created in the gap is
        # delivered as an event instead of being lost forever
        store.bus.subscribe(self._on_event, kind=ResourceInterpreterWebhook.KIND)
        with self._lock:
            for obj in store.list(ResourceInterpreterWebhook.KIND):
                self._configs[obj.metadata.name] = obj

    def _on_event(self, event) -> None:
        obj = event.obj
        with self._lock:
            if event.type == "DELETED" or obj.metadata.deleting:
                self._configs.pop(obj.metadata.name, None)
            else:
                self._configs[obj.metadata.name] = obj
            self._gen += 1
            self._hook_cache.clear()

    def _find(self, api_version: str, kind: str, op: str):
        with self._lock:
            configs = sorted(self._configs.values(), key=lambda c: c.metadata.name)
        for cfg in configs:
            for rule in cfg.spec.rules:
                if _rule_matches(rule, api_version, kind, op):
                    return cfg
        return None

    def hook(self, api_version: str, kind: str, op: str) -> Optional[Callable]:
        key = (api_version, kind, op)
        with self._lock:
            gen = self._gen
            cached = self._hook_cache.get(key)
            if cached is not None and cached[0] == gen:
                return cached[1]
        resolved = self._resolve(api_version, kind, op)
        with self._lock:
            if self._gen == gen:  # a config change mid-resolve invalidates
                self._hook_cache[key] = (gen, resolved)
        return resolved

    def _resolve(self, api_version: str, kind: str, op: str) -> Optional[Callable]:
        cfg = self._find(api_version, kind, op)
        if cfg is None:
            return None
        endpoint = cfg.spec.endpoint
        timeout_s = cfg.spec.timeout_s

        def call(request: dict) -> dict:
            request["operation"] = op
            resp = _call_endpoint(endpoint, request, timeout_s)
            if not isinstance(resp, dict):
                raise WebhookCallError(
                    f"{endpoint}: response is {type(resp).__name__}, "
                    "expected an object")
            if not resp.get("successful", False):
                raise WebhookCallError(
                    f"{endpoint}: {resp.get('message', 'unsuccessful')}")
            return resp

        return _bind_hook(op, call)


def _to_requirements(req: Optional[Dict[str, Any]], namespace: str):
    from karmada_tpu_torch.interpreter.declarative import _to_requirements as conv

    return conv(req, namespace)


def _bind_hook(op: str, call: Callable[[dict], dict]) -> Callable:
    """Adapt the wire response to the facade hook convention for `op`
    (mirrors declarative.make_hooks signatures)."""
    from karmada_tpu_torch.interpreter.interpreter import (
        HEALTHY,
        OP_AGGREGATE_STATUS,
        OP_INTERPRET_COMPONENT,
        OP_INTERPRET_DEPENDENCY,
        OP_INTERPRET_HEALTH,
        OP_INTERPRET_REPLICA,
        OP_INTERPRET_STATUS,
        OP_RETAIN,
        OP_REVISE_REPLICA,
        UNHEALTHY,
        DependentObjectReference,
    )

    if op == OP_INTERPRET_REPLICA:
        def get_replicas(manifest):
            ns = (manifest.get("metadata") or {}).get("namespace", "")
            r = call({"object": manifest})
            return int(r.get("replicas", 0)), _to_requirements(
                r.get("requirements"), ns)
        return get_replicas

    if op == OP_INTERPRET_COMPONENT:
        def get_components(manifest):
            from karmada_tpu_torch.models.work import Component

            ns = (manifest.get("metadata") or {}).get("namespace", "")
            r = call({"object": manifest})
            return [
                Component(
                    name=c.get("name", ""),
                    replicas=int(c.get("replicas", 0)),
                    replica_requirements=_to_requirements(
                        c.get("requirements"), ns),
                )
                for c in r.get("components", [])
            ]
        return get_components

    if op == OP_REVISE_REPLICA:
        return lambda manifest, replicas: call(
            {"object": manifest, "desiredReplicas": int(replicas)}
        ).get("revised", manifest)

    if op == OP_RETAIN:
        return lambda desired, observed: call(
            {"object": desired, "observedObject": observed}
        ).get("retained", desired)

    if op == OP_AGGREGATE_STATUS:
        def aggregate(manifest, items):
            plain = [{"cluster": i.cluster_name, "status": (i.status or {})}
                     for i in items]
            r = call({"object": manifest, "aggregatedStatusItems": plain})
            # the hook contract returns a FULL manifest (like every other
            # tier); accept either a whole object ("aggregated") or a bare
            # status dict folded onto the input
            if "aggregated" in r:
                return r["aggregated"]
            if "status" in r:
                return {**manifest, "status": r["status"]}
            return manifest
        return aggregate

    if op == OP_INTERPRET_STATUS:
        return lambda manifest: call({"object": manifest}).get("status")

    if op == OP_INTERPRET_HEALTH:
        return lambda manifest: (
            HEALTHY if call({"object": manifest}).get("healthy") else UNHEALTHY
        )

    if op == OP_INTERPRET_DEPENDENCY:
        def dependencies(manifest):
            ns = (manifest.get("metadata") or {}).get("namespace", "")
            r = call({"object": manifest})
            return [
                DependentObjectReference(
                    api_version=d.get("apiVersion", ""),
                    kind=d.get("kind", ""),
                    namespace=d.get("namespace", ns),
                    name=d.get("name", ""),
                )
                for d in r.get("dependencies", [])
            ]
        return dependencies

    return None


# ---------------------------------------------------------------------------
# Host side: serve the protocol for user-implemented interpreters
# (pkg/webhook/interpreter — the karmada-webhook binary's interpreter host)
# ---------------------------------------------------------------------------


class InterpreterWebhookServer:
    """Minimal HTTP host: register per-operation python callables, serve
    them under the wire protocol.  `start()` binds 127.0.0.1 on an
    ephemeral port and returns the endpoint URL."""

    def __init__(self) -> None:
        self._ops: Dict[Tuple[str, str, str], Callable[[dict], dict]] = {}
        self._httpd = None
        self._thread: Optional[threading.Thread] = None

    def handle(self, api_version: str, kind: str, op: str,
               fn: Callable[[dict], dict]) -> None:
        """fn receives the request dict, returns the response dict body
        (successful defaults True)."""
        self._ops[(api_version, kind, op)] = fn

    def _dispatch(self, request: dict) -> dict:
        obj = request.get("object") or {}
        key = (obj.get("apiVersion", ""), obj.get("kind", ""),
               request.get("operation", ""))
        fn = self._ops.get(key)
        if fn is None:
            return {"successful": False,
                    "message": f"no handler for {key}"}
        try:
            resp = fn(request)
            if not isinstance(resp, dict):
                raise TypeError(
                    f"handler for {key} returned {type(resp).__name__}, "
                    "expected a response dict")
            resp.setdefault("successful", True)
            return resp
        except Exception as e:  # noqa: BLE001 — user handler fault
            return {"successful": False, "message": repr(e)}

    def as_local_endpoint(self, name: str) -> str:
        """Register in-process (no socket) under ``local:<name>``."""
        register_local_endpoint(name, self._dispatch)
        return f"local:{name}"

    def start(self) -> str:
        import http.server

        dispatch = self._dispatch

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):  # noqa: N802 — http.server convention
                length = int(self.headers.get("Content-Length", 0))
                try:
                    request = json.loads(self.rfile.read(length))
                    body = json.dumps(dispatch(request)).encode()
                    self.send_response(200)
                except Exception as e:  # noqa: BLE001
                    body = json.dumps(
                        {"successful": False, "message": repr(e)}).encode()
                    self.send_response(500)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # silence per-request stderr noise
                pass

        self._httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        host, port = self._httpd.server_address
        return f"http://{host}:{port}/interpret"

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
