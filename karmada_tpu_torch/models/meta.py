"""Object metadata, conditions, and label-selector semantics.

Mirrors the slices of k8s apimachinery the reference relies on:
ObjectMeta (labels/annotations/uid/generation/deletionTimestamp/finalizers),
metav1.Condition, and LabelSelector matching (matchLabels + matchExpressions
with In/NotIn/Exists/DoesNotExist/Gt/Lt) used by ClusterAffinity
(reference pkg/util/cluster.go ClusterMatches).
"""

from __future__ import annotations

import time
import uuid as _uuid
from dataclasses import dataclass, field
from typing import Any, ClassVar, Dict, List, Optional


def new_uid() -> str:
    return str(_uuid.uuid4())


def now() -> float:
    return time.time()


@dataclass
class ObjectMeta:
    name: str = ""
    namespace: str = ""
    uid: str = ""
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    resource_version: int = 0
    generation: int = 0
    creation_timestamp: float = 0.0
    deletion_timestamp: Optional[float] = None
    finalizers: List[str] = field(default_factory=list)
    owner_references: List["OwnerReference"] = field(default_factory=list)

    def key(self) -> str:
        return f"{self.namespace}/{self.name}" if self.namespace else self.name

    @property
    def deleting(self) -> bool:
        return self.deletion_timestamp is not None


@dataclass
class OwnerReference:
    api_version: str = ""
    kind: str = ""
    name: str = ""
    uid: str = ""


@dataclass
class Condition:
    type: str = ""
    status: str = "Unknown"  # "True" | "False" | "Unknown"
    reason: str = ""
    message: str = ""
    last_transition_time: float = 0.0
    observed_generation: int = 0


def get_condition(conditions: List[Condition], cond_type: str) -> Optional[Condition]:
    for c in conditions:
        if c.type == cond_type:
            return c
    return None


def set_condition(conditions: List[Condition], new: Condition) -> bool:
    """Upsert keeping last_transition_time stable when status unchanged.

    Returns True when the condition list changed.
    """
    existing = get_condition(conditions, new.type)
    if existing is None:
        if not new.last_transition_time:
            new.last_transition_time = now()
        conditions.append(new)
        return True
    if (
        existing.status == new.status
        and existing.reason == new.reason
        and existing.message == new.message
    ):
        return False
    if existing.status != new.status:
        new.last_transition_time = now()
    else:
        new.last_transition_time = existing.last_transition_time
    conditions[conditions.index(existing)] = new
    return True


def is_condition_true(conditions: List[Condition], cond_type: str) -> bool:
    c = get_condition(conditions, cond_type)
    return c is not None and c.status == "True"


@dataclass
class LabelSelectorRequirement:
    key: str = ""
    operator: str = "In"  # In | NotIn | Exists | DoesNotExist | Gt | Lt
    values: List[str] = field(default_factory=list)


@dataclass
class LabelSelector:
    match_labels: Dict[str, str] = field(default_factory=dict)
    match_expressions: List[LabelSelectorRequirement] = field(default_factory=list)

    def matches(self, labels: Dict[str, str]) -> bool:
        for k, v in self.match_labels.items():
            if labels.get(k) != v:
                return False
        for req in self.match_expressions:
            have = req.key in labels
            val = labels.get(req.key)
            if req.operator == "In":
                if not have or val not in req.values:
                    return False
            elif req.operator == "NotIn":
                if have and val in req.values:
                    return False
            elif req.operator == "Exists":
                if not have:
                    return False
            elif req.operator == "DoesNotExist":
                if have:
                    return False
            elif req.operator == "Gt":
                if not have or not _int_ok(val) or int(val) <= int(req.values[0]):
                    return False
            elif req.operator == "Lt":
                if not have or not _int_ok(val) or int(val) >= int(req.values[0]):
                    return False
            else:
                raise ValueError(f"unknown selector operator {req.operator}")
        return True


def _int_ok(v: Optional[str]) -> bool:
    try:
        int(v)  # type: ignore[arg-type]
        return True
    except (TypeError, ValueError):
        return False


@dataclass
class TypedObject:
    """Base for every API object: kind + metadata."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)

    KIND: ClassVar[str] = ""
    API_VERSION: ClassVar[str] = ""

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def namespace(self) -> str:
        return self.metadata.namespace

    def key(self) -> str:
        return self.metadata.key()


def deep_get(obj: Any, path: str, default: Any = None) -> Any:
    """Fetch a dotted path from nested dicts (manifest helpers)."""
    cur = obj
    for part in path.split("."):
        if isinstance(cur, dict) and part in cur:
            cur = cur[part]
        else:
            return default
    return cur


def deep_set(obj: Dict[str, Any], path: str, value: Any) -> None:
    parts = path.split(".")
    cur = obj
    for part in parts[:-1]:
        cur = cur.setdefault(part, {})
    cur[parts[-1]] = value
