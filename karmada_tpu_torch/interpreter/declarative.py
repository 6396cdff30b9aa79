"""Declarative interpreter tier: restricted, data-driven customizations.

Counterpart of the JAX package's ``interpreter/declarative.py``.

Reference: pkg/resourceinterpreter/customized/declarative/ — user-supplied
Lua scripts from ResourceInterpreterCustomization objects run in a
restricted gopher-lua VM (luavm/lua.go:1-422) per operation, ranked above
the third-party bundle and the native defaults.

This framework's script dialect is a restricted EXPRESSION language with
Python syntax, evaluated over a whitelisted AST — no imports, no attribute
access, no statements, no dunder anything; only literals, arithmetic,
comparisons, conditionals, comprehensions, subscripts, and calls to the
helper functions below.  A customization is pure data: it can be created,
updated and deleted at runtime through the store, and changes take effect
without touching framework code (the point of the feature).

Bound names per operation (mirroring the reference's Lua conventions,
luavm/lua.go GetReplicas(obj)/ReviseReplica(obj, replicas)/...):

  InterpretReplica    obj                       -> int | {"replicas": int,
                                                   "requirements": {res: qty}}
  InterpretComponent  obj                       -> [{"name","replicas",
                                                     "requirements"}]
  ReviseReplica       obj, replicas             -> manifest
  Retain              desired, observed         -> manifest
  AggregateStatus     obj, items ([{cluster,status}]) -> manifest
  InterpretStatus     obj                       -> dict (reflected status)
  InterpretHealth     obj                       -> bool
  InterpretDependency obj                       -> [{apiVersion,kind,
                                                    namespace,name}]

Helpers: get(d, "a.b", default), set(d, "a.b", v) (copy-on-write),
merge(a, b), quantity("500m") -> milli, plus len/int/float/str/bool/min/
max/sum/round/sorted/any/all/abs.
"""

from __future__ import annotations

import ast
import copy
from typing import Any, Callable, Dict, Optional, Tuple

from karmada_tpu_torch.models.config import ResourceInterpreterCustomization
from karmada_tpu_torch.models.meta import deep_get, deep_set
from karmada_tpu_torch.utils.quantity import Quantity


class ScriptError(Exception):
    """Compile- or eval-time failure of a customization script."""


_ALLOWED_NODES = (
    ast.Expression, ast.BoolOp, ast.BinOp, ast.UnaryOp, ast.IfExp,
    ast.Dict, ast.List, ast.Tuple, ast.Set, ast.Compare, ast.Call,
    # Store appears only as comprehension-target context in eval mode
    # (assignment statements cannot parse); real stores are unreachable
    ast.Constant, ast.Name, ast.Load, ast.Store, ast.Subscript, ast.Slice,
    ast.ListComp, ast.DictComp, ast.SetComp, ast.GeneratorExp,
    ast.comprehension, ast.keyword, ast.Starred,
    # operators
    ast.And, ast.Or, ast.Not, ast.Add, ast.Sub, ast.Mult, ast.Div,
    ast.FloorDiv, ast.Mod, ast.Pow, ast.USub, ast.UAdd,
    ast.Eq, ast.NotEq, ast.Lt, ast.LtE, ast.Gt, ast.GtE,
    ast.In, ast.NotIn, ast.Is, ast.IsNot,
)


def _safe_get(d: Any, path: str, default: Any = None) -> Any:
    return deep_get(d, path, default)


def _safe_set(d: Dict[str, Any], path: str, value: Any) -> Dict[str, Any]:
    out = copy.deepcopy(d)
    deep_set(out, path, value)
    return out


def _safe_merge(a: Dict[str, Any], b: Dict[str, Any]) -> Dict[str, Any]:
    out = copy.deepcopy(a)
    for k, v in (b or {}).items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _safe_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def _safe_quantity(raw: Any) -> int:
    return Quantity.parse(raw).milli


_SAFE_FUNCS: Dict[str, Callable] = {
    "get": _safe_get,
    "set": _safe_set,
    "merge": _safe_merge,
    "quantity": _safe_quantity,
    # attribute access is forbidden, so dict methods become helpers
    "items": lambda d: list((d or {}).items()),
    "keys": lambda d: list((d or {}).keys()),
    "values": lambda d: list((d or {}).values()),
    "len": len, "int": int, "float": float, "str": str, "bool": bool,
    "min": min, "max": max, "sum": sum, "round": round, "sorted": sorted,
    "any": any, "all": all, "abs": abs, "enumerate": enumerate,
    "range": range, "zip": zip, "list": list,
}


def compile_script(script: str) -> Callable[[Dict[str, Any]], Any]:
    """Compile one restricted expression; returns eval(env_names) -> value."""
    try:
        tree = ast.parse(script, mode="eval")
    except SyntaxError as e:
        raise ScriptError(f"syntax error: {e}") from e
    for node in ast.walk(tree):
        if not isinstance(node, _ALLOWED_NODES):
            raise ScriptError(
                f"forbidden construct {type(node).__name__} in script"
            )
        if isinstance(node, ast.Name) and node.id.startswith("__"):
            raise ScriptError("dunder names are forbidden")
    code = compile(tree, "<customization>", "eval")

    def run(env: Dict[str, Any]) -> Any:
        full = dict(_SAFE_FUNCS)
        full.update(env)
        try:
            return eval(code, {"__builtins__": {}}, full)  # noqa: S307 — whitelisted AST
        except Exception as e:  # noqa: BLE001
            raise ScriptError(f"script failed: {e!r}") from e

    return run


# -- operation adapters: script values -> facade types -----------------------


def _to_requirements(req: Optional[Dict[str, Any]], namespace: str):
    from karmada_tpu_torch.models.work import ReplicaRequirements

    if not req:
        return None
    return ReplicaRequirements(
        resource_request={k: Quantity.parse(v) for k, v in req.items()},
        namespace=namespace,
    )


def make_hooks(scripts: Dict[str, str]) -> Dict[str, Callable]:
    """Compile a customization's op->script table into facade hooks."""
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
    from karmada_tpu_torch.models.work import Component

    hooks: Dict[str, Callable] = {}
    compiled = {op: compile_script(s) for op, s in scripts.items()}

    if OP_INTERPRET_REPLICA in compiled:
        fn = compiled[OP_INTERPRET_REPLICA]

        def get_replicas(manifest, fn=fn):
            ns = deep_get(manifest, "metadata.namespace", "")
            v = fn({"obj": manifest})
            if isinstance(v, dict):
                return int(v.get("replicas", 0)), _to_requirements(
                    v.get("requirements"), ns
                )
            return int(v or 0), None
        hooks[OP_INTERPRET_REPLICA] = get_replicas

    if OP_INTERPRET_COMPONENT in compiled:
        fn = compiled[OP_INTERPRET_COMPONENT]

        def get_components(manifest, fn=fn):
            ns = deep_get(manifest, "metadata.namespace", "")
            out = []
            for c in fn({"obj": manifest}) or []:
                out.append(Component(
                    name=c.get("name", ""),
                    replicas=int(c.get("replicas", 0)),
                    replica_requirements=_to_requirements(
                        c.get("requirements"), ns
                    ),
                ))
            return out
        hooks[OP_INTERPRET_COMPONENT] = get_components

    if OP_REVISE_REPLICA in compiled:
        fn = compiled[OP_REVISE_REPLICA]
        hooks[OP_REVISE_REPLICA] = lambda manifest, replicas, fn=fn: fn(
            {"obj": manifest, "replicas": int(replicas)}
        )

    if OP_RETAIN in compiled:
        fn = compiled[OP_RETAIN]
        hooks[OP_RETAIN] = lambda desired, observed, fn=fn: fn(
            {"desired": desired, "observed": observed}
        )

    if OP_AGGREGATE_STATUS in compiled:
        fn = compiled[OP_AGGREGATE_STATUS]

        def aggregate(manifest, items, fn=fn):
            plain = [
                {"cluster": i.cluster_name, "status": (i.status or {})}
                for i in items
            ]
            return fn({"obj": manifest, "items": plain})
        hooks[OP_AGGREGATE_STATUS] = aggregate

    if OP_INTERPRET_STATUS in compiled:
        fn = compiled[OP_INTERPRET_STATUS]
        hooks[OP_INTERPRET_STATUS] = lambda manifest, fn=fn: fn({"obj": manifest})

    if OP_INTERPRET_HEALTH in compiled:
        fn = compiled[OP_INTERPRET_HEALTH]
        hooks[OP_INTERPRET_HEALTH] = lambda manifest, fn=fn: (
            HEALTHY if fn({"obj": manifest}) else UNHEALTHY
        )

    if OP_INTERPRET_DEPENDENCY in compiled:
        fn = compiled[OP_INTERPRET_DEPENDENCY]

        def dependencies(manifest, fn=fn):
            out = []
            for d in fn({"obj": manifest}) or []:
                out.append(DependentObjectReference(
                    api_version=d.get("apiVersion", ""),
                    kind=d.get("kind", ""),
                    namespace=d.get("namespace",
                                    deep_get(manifest, "metadata.namespace", "")),
                    name=d.get("name", ""),
                ))
            return out
        hooks[OP_INTERPRET_DEPENDENCY] = dependencies

    return hooks


class DeclarativeManager:
    """Store-driven customization tier: watches
    ResourceInterpreterCustomization objects and keeps a compiled hook
    table per (apiVersion, kind).  Multiple customizations targeting the
    same kind merge in name order (alphabetically first wins per op),
    matching the reference's deterministic config ordering."""

    def __init__(self) -> None:
        self._store = None
        self._compiled: Dict[Tuple[str, str], Dict[str, Callable]] = {}

    def attach_store(self, store) -> None:
        self._store = store
        store.bus.subscribe(
            self._on_event, kind=ResourceInterpreterCustomization.KIND
        )
        self._rebuild()

    def _on_event(self, event) -> None:
        self._rebuild()

    def _rebuild(self) -> None:
        if self._store is None:
            return
        table: Dict[Tuple[str, str], Dict[str, Callable]] = {}
        customizations = sorted(
            self._store.list(ResourceInterpreterCustomization.KIND),
            key=lambda c: c.metadata.name,
        )
        for cust in customizations:
            if cust.metadata.deleting:
                continue
            key = (cust.spec.target.api_version, cust.spec.target.kind)
            try:
                hooks = make_hooks(cust.spec.customizations)
            except ScriptError:
                continue  # invalid scripts never shadow working tiers
            slot = table.setdefault(key, {})
            for op, hook in hooks.items():
                slot.setdefault(op, hook)  # first (alphabetical) wins
        self._compiled = table

    def hook(self, api_version: str, kind: str, op: str) -> Optional[Callable]:
        return self._compiled.get((api_version, kind), {}).get(op)
