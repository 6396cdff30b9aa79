"""Override manager: per-cluster manifest mutation before Work rendering.

Counterpart of the JAX package's ``controllers/override.py``.

Mirrors reference pkg/util/overridemanager/overridemanager.go:95
ApplyOverridePolicies: ClusterOverridePolicies apply first, then namespaced
OverridePolicies (both name-ordered), each rule gated on the target-cluster
affinity; overriders are image / command / args / labels / annotations /
plaintext in that order (overridemanager.go applyJSONPatchs order).
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional

from karmada_tpu_torch.models.cluster import Cluster
from karmada_tpu_torch.models.meta import deep_get, deep_set
from karmada_tpu_torch.models.policy import (
    ClusterOverridePolicy,
    CommandArgsOverrider,
    ImageOverrider,
    LabelAnnotationOverrider,
    OverridePolicy,
    Overriders,
    PlaintextOverrider,
    ResourceSelector,
)
from karmada_tpu_torch.store.store import ObjectStore


def selector_matches(sel: ResourceSelector, manifest: Dict[str, Any]) -> bool:
    if sel.api_version and sel.api_version != manifest.get("apiVersion"):
        return False
    if sel.kind and sel.kind != manifest.get("kind"):
        return False
    md = manifest.get("metadata", {})
    if sel.namespace and sel.namespace != md.get("namespace", ""):
        return False
    if sel.name and sel.name != md.get("name", ""):
        return False
    if sel.label_selector is not None and not sel.label_selector.matches(
        md.get("labels", {}) or {}
    ):
        return False
    return True


def _split_image(image: str):
    """registry/repository:tag -> (registry, repository, tag)."""
    registry, rest = "", image
    if "/" in image:
        head, tail = image.split("/", 1)
        if "." in head or ":" in head or head == "localhost":
            registry, rest = head, tail
    tag = ""
    if ":" in rest:
        rest, tag = rest.rsplit(":", 1)
    return registry, rest, tag


def _join_image(registry: str, repository: str, tag: str) -> str:
    out = f"{registry}/{repository}" if registry else repository
    if tag:
        out = f"{out}:{tag}"
    return out


def _apply_image(ov: ImageOverrider, manifest: Dict[str, Any]) -> None:
    containers = deep_get(manifest, "spec.template.spec.containers") or deep_get(
        manifest, "spec.containers"
    ) or []
    for c in containers:
        image = c.get("image", "")
        if not image:
            continue
        registry, repo, tag = _split_image(image)
        part = {"Registry": registry, "Repository": repo, "Tag": tag}[ov.component]
        if ov.operator == "remove":
            part = ""
        elif ov.operator in ("add", "replace"):
            part = (part + ov.value) if ov.operator == "add" else ov.value
        if ov.component == "Registry":
            registry = part
        elif ov.component == "Repository":
            repo = part
        else:
            tag = part
        c["image"] = _join_image(registry, repo, tag)


def _apply_cmdargs(ov: CommandArgsOverrider, manifest: Dict[str, Any], fld: str) -> None:
    containers = deep_get(manifest, "spec.template.spec.containers") or deep_get(
        manifest, "spec.containers"
    ) or []
    for c in containers:
        if c.get("name") != ov.container_name:
            continue
        cur = list(c.get(fld, []) or [])
        if ov.operator == "add":
            cur.extend(ov.value)
        elif ov.operator == "remove":
            cur = [v for v in cur if v not in set(ov.value)]
        c[fld] = cur


def _apply_map(ov: LabelAnnotationOverrider, manifest: Dict[str, Any], fld: str) -> None:
    md = manifest.setdefault("metadata", {})
    cur = dict(md.get(fld, {}) or {})
    if ov.operator in ("add", "replace"):
        cur.update(ov.value)
    elif ov.operator == "remove":
        for k in ov.value:
            cur.pop(k, None)
    md[fld] = cur


def _apply_plaintext(ov: PlaintextOverrider, manifest: Dict[str, Any]) -> None:
    if ov.operator in ("add", "replace"):
        deep_set(manifest, ov.path, copy.deepcopy(ov.value))
    elif ov.operator == "remove":
        parts = ov.path.split(".")
        cur: Any = manifest
        for p in parts[:-1]:
            if not isinstance(cur, dict) or p not in cur:
                return
            cur = cur[p]
        if isinstance(cur, dict):
            cur.pop(parts[-1], None)


def apply_overriders(overriders: Overriders, manifest: Dict[str, Any]) -> None:
    for ov in overriders.image_overrider:
        _apply_image(ov, manifest)
    for ov in overriders.command_overrider:
        _apply_cmdargs(ov, manifest, "command")
    for ov in overriders.args_overrider:
        _apply_cmdargs(ov, manifest, "args")
    for ov in overriders.labels_overrider:
        _apply_map(ov, manifest, "labels")
    for ov in overriders.annotations_overrider:
        _apply_map(ov, manifest, "annotations")
    for ov in overriders.plaintext:
        _apply_plaintext(ov, manifest)


class OverrideManager:
    """Applies matching override policies to a manifest for one cluster."""

    def __init__(self, store: ObjectStore) -> None:
        self.store = store

    def apply(
        self, manifest: Dict[str, Any], cluster: Optional[Cluster]
    ) -> Dict[str, Any]:
        out = copy.deepcopy(manifest)
        namespace = deep_get(manifest, "metadata.namespace", "")
        # read-only scans (ObjectStore.visit): the overriders are applied
        # to `out`, never to the stored policies
        cops: List[ClusterOverridePolicy] = sorted(
            self.store.visit(ClusterOverridePolicy.KIND), key=lambda p: p.name
        )
        ops: List[OverridePolicy] = sorted(
            self.store.visit(OverridePolicy.KIND, namespace),
            key=lambda p: p.name,
        )
        for policy in list(cops) + list(ops):
            if not any(selector_matches(s, out) for s in policy.spec.resource_selectors):
                continue
            for rule in policy.spec.override_rules:
                if rule.target_cluster is not None and (
                    cluster is None or not rule.target_cluster.matches(cluster)
                ):
                    # no Cluster object (deleted / not yet registered) means
                    # the affinity cannot match -- reference only applies a
                    # rule when the target affinity affirmatively matches
                    continue
                apply_overriders(rule.overriders, out)
        return out
