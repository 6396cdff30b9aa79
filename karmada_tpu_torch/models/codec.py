"""Manifest <-> typed-model codec.

Counterpart of the JAX package's ``models/codec.py``.

The reference's client machinery decodes YAML/JSON manifests into typed Go
structs via generated deepcopy/scheme code; here one generic loader walks
the dataclass tree instead (no generated code): camelCase manifest keys map
to snake_case fields, nested dataclasses / lists / dicts / Optionals
recurse, and `Quantity` values parse from their k8s string forms.

Used by karmadactl apply/create/edit (a `PropagationPolicy` YAML becomes a
real models.policy.PropagationPolicy, so admission mutators/validators and
controllers see typed objects) and usable by any API ingress.
"""

from __future__ import annotations

import dataclasses
import re
import typing
from typing import Any, Dict, Optional

from karmada_tpu_torch.utils.quantity import Quantity


def model_registry() -> Dict[str, type]:
    """kind -> dataclass for every registered API type."""
    from karmada_tpu_torch.models import (autoscaling, certs, cluster,
                                          config, extras, networking, policy,
                                          search, work)

    out: Dict[str, type] = {}
    for mod in (cluster, policy, work, config, extras,
                autoscaling, networking, search, certs):
        for obj in vars(mod).values():
            kind = getattr(obj, "KIND", None)
            if dataclasses.is_dataclass(obj) and isinstance(kind, str) and kind:
                out[kind] = obj
    return out


_SNAKE_RE = re.compile(r"(?<!^)(?=[A-Z])")


def _snake(key: str) -> str:
    return _SNAKE_RE.sub("_", key).lower()


def _load_value(tp, value):
    """Coerce a manifest value into the annotated type."""
    if value is None:
        return None
    origin = typing.get_origin(tp)
    if origin is typing.Union:  # Optional[X] and friends
        for arg in typing.get_args(tp):
            if arg is type(None):
                continue
            return _load_value(arg, value)
        return value
    if origin in (list, typing.List):
        (item_tp,) = typing.get_args(tp) or (Any,)
        return [_load_value(item_tp, v) for v in value]
    if origin in (dict, typing.Dict):
        args = typing.get_args(tp)
        val_tp = args[1] if len(args) == 2 else Any
        return {k: _load_value(val_tp, v) for k, v in dict(value).items()}
    if tp is Quantity or (isinstance(tp, type) and issubclass(tp, Quantity)):
        if isinstance(value, Quantity):
            return value
        return Quantity.parse(str(value))
    if dataclasses.is_dataclass(tp):
        return _load_dataclass(tp, value)
    if tp is float and isinstance(value, (int, float)):
        return float(value)
    if tp is int and isinstance(value, str) and value.isdigit():
        return int(value)
    return value


def _load_dataclass(cls, data: Dict[str, Any]):
    if not isinstance(data, dict):
        return data
    hints = typing.get_type_hints(cls)
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for key, value in data.items():
        # no special-casing of the manifest envelope's apiVersion/kind:
        # root models carry them as ClassVars (not fields), so the
        # unknown-key skip below drops them — while NESTED dataclasses
        # (ObjectReference, ResourceSelector) legitimately have
        # api_version/kind as DATA fields and must receive them
        name = key if key in fields else _snake(key)
        if name not in fields:
            continue  # forward-compat: unknown manifest keys are ignored
        kwargs[name] = _load_value(hints.get(name, Any), value)
    return cls(**kwargs)


def from_manifest_typed(manifest: Dict[str, Any]):
    """Decode a manifest into its registered typed model, or None when the
    kind is not a registered API type (callers fall back to Unstructured).

    A manifest arriving at a registered SERVED (non-storage) version is
    converted up to the storage version first (models/conversion.py) — the
    decode half of the reference's CRD conversion webhook."""
    kind = manifest.get("kind")
    cls = model_registry().get(kind)
    if cls is None:
        return None
    api_version = manifest.get("apiVersion")
    if api_version and api_version != cls.API_VERSION:
        from karmada_tpu_torch.models.conversion import REGISTRY as conv

        if not conv.served(kind, api_version):
            # rejecting beats silently decoding version-specific fields
            # into nothing (a v9 manifest's renamed field would vanish)
            raise ValueError(
                f"{kind} is not served at apiVersion {api_version!r}; "
                f"served: {conv.served_versions(kind)}")
        manifest = conv.to_storage(manifest)
    return _load_dataclass(cls, manifest)


def registered_kind(kind: Optional[str]) -> bool:
    return kind in model_registry() if kind else False


def _camel(name: str) -> str:
    head, *rest = name.split("_")
    return head + "".join(p[:1].upper() + p[1:] for p in rest)


def _dump_value(value):
    if isinstance(value, Quantity):  # a dataclass too: must win this check
        return str(value)
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        out = {}
        for f in dataclasses.fields(value):
            v = getattr(value, f.name)
            # lean manifests: omit fields still at their default (the
            # loader refills them), keep everything the user set
            if f.default is not dataclasses.MISSING and v == f.default:
                continue
            if (f.default_factory is not dataclasses.MISSING  # type: ignore[misc]
                    and v == f.default_factory()):  # type: ignore[misc]
                continue
            out[_camel(f.name)] = _dump_value(v)
        return out
    if isinstance(value, list):
        return [_dump_value(v) for v in value]
    if isinstance(value, dict):
        # mapping KEYS are data (resource names, label keys): never cameled
        return {k: _dump_value(v) for k, v in value.items()}
    return value


def to_manifest_typed(obj, version: Optional[str] = None) -> Dict[str, Any]:
    """Encode a typed model back into a camelCase manifest (inverse of
    from_manifest_typed; field defaults are omitted).  `version` re-encodes
    at a registered served version via models/conversion.py — the encode
    half of the reference's CRD conversion webhook."""
    manifest = {"apiVersion": type(obj).API_VERSION, "kind": type(obj).KIND}
    manifest.update(_dump_value(obj))
    if version and version != type(obj).API_VERSION:
        from karmada_tpu_torch.models.conversion import REGISTRY as conv

        manifest = conv.convert(manifest, version)
    return manifest
