"""config.karmada.io API types (reference pkg/apis/config/v1alpha1).

Counterpart of the JAX package's ``models/config.py``.

ResourceInterpreterCustomization: DATA-DRIVEN per-kind interpreter scripts
(the reference ships Lua executed by gopher-lua,
resourceinterpretercustomization_types.go + customized/declarative/luavm/
lua.go).  This framework's script language is a restricted expression
dialect (interpreter/declarative.py); each operation carries one
expression string evaluated against the operation's bound names.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

from karmada_tpu_torch.models.meta import ObjectMeta, TypedObject


@dataclass
class CustomizationTarget:
    api_version: str = ""
    kind: str = ""


@dataclass
class ResourceInterpreterCustomizationSpec:
    target: CustomizationTarget = field(default_factory=CustomizationTarget)
    # operation name (interpreter.OP_*) -> restricted expression script
    customizations: Dict[str, str] = field(default_factory=dict)


@dataclass
class ResourceInterpreterCustomization(TypedObject):
    KIND = "ResourceInterpreterCustomization"
    API_VERSION = "config.karmada.io/v1alpha1"

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: ResourceInterpreterCustomizationSpec = field(
        default_factory=ResourceInterpreterCustomizationSpec
    )


@dataclass
class InterpreterRule:
    """Which (apiVersion, kind, operations) a webhook serves
    (resourceinterpreterwebhook_types.go RuleWithOperations)."""

    # wildcards are EXPLICIT on every axis: an empty list matches nothing
    api_versions: list = field(default_factory=list)  # ["apps/v1"] or ["*"]
    kinds: list = field(default_factory=list)         # ["Deployment"] or ["*"]
    operations: list = field(default_factory=list)    # interpreter.OP_* or ["*"]


@dataclass
class ResourceInterpreterWebhookSpec:
    """Endpoint + rules (resourceinterpreterwebhook_types.go:34-77).  The
    reference dials HTTPS with CA bundles; this framework's transport is a
    pluggable URL (http:// for loopback services, or the in-process
    `local:` scheme used in tests) — the mTLS story lives one layer down
    in estimator/wire.py's transport seam."""

    endpoint: str = ""
    rules: list = field(default_factory=list)  # List[InterpreterRule]
    timeout_s: float = 5.0


@dataclass
class ResourceInterpreterWebhook(TypedObject):
    KIND = "ResourceInterpreterWebhook"
    API_VERSION = "config.karmada.io/v1alpha1"

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: ResourceInterpreterWebhookSpec = field(
        default_factory=ResourceInterpreterWebhookSpec
    )
