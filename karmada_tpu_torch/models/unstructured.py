"""Unstructured API objects: arbitrary workload manifests in the store.

Counterpart of the JAX package's ``models/unstructured.py``.

The reference detector watches every ListWatch-able GVR via dynamic
informers (pkg/detector/detector.go:183 discoverResources) and handles
objects as unstructured.Unstructured.  This is the equivalent: a manifest
dict (apiVersion/kind/metadata/spec/status) wrapped as a TypedObject whose
KIND comes from the manifest, so templates of any kind live in the same
ObjectStore next to the framework's own CRD-style types.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from karmada_tpu_torch.models.meta import ObjectMeta, TypedObject


@dataclass
class Unstructured(TypedObject):
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    manifest: Dict[str, Any] = field(default_factory=dict)

    # KIND/API_VERSION are instance-derived for unstructured objects
    @property  # type: ignore[override]
    def KIND(self) -> str:  # noqa: N802 - mirrors the TypedObject contract
        return self.manifest.get("kind", "")

    @property  # type: ignore[override]
    def API_VERSION(self) -> str:  # noqa: N802
        return self.manifest.get("apiVersion", "")

    @staticmethod
    def from_manifest(manifest: Dict[str, Any]) -> "Unstructured":
        manifest = copy.deepcopy(manifest)
        md = manifest.setdefault("metadata", {})
        meta = ObjectMeta(
            name=md.get("name", ""),
            namespace=md.get("namespace", ""),
            labels=dict(md.get("labels", {})),
            annotations=dict(md.get("annotations", {})),
        )
        return Unstructured(metadata=meta, manifest=manifest)

    def to_manifest(self) -> Dict[str, Any]:
        """Manifest with metadata synced back from ObjectMeta."""
        m = copy.deepcopy(self.manifest)
        md = m.setdefault("metadata", {})
        md["name"] = self.metadata.name
        if self.metadata.namespace:
            md["namespace"] = self.metadata.namespace
        if self.metadata.labels:
            md["labels"] = dict(self.metadata.labels)
        if self.metadata.annotations:
            md["annotations"] = dict(self.metadata.annotations)
        if self.metadata.uid:
            md["uid"] = self.metadata.uid
        if self.metadata.resource_version:
            md["resourceVersion"] = self.metadata.resource_version
        return m

    def spec(self) -> Dict[str, Any]:
        return self.manifest.setdefault("spec", {})

    def status(self) -> Optional[Dict[str, Any]]:
        return self.manifest.get("status")

    def spec_view(self) -> Dict[str, Any]:
        """Generation-relevant content: the manifest sans status (the store
        bumps metadata.generation only when this changes)."""
        return {k: v for k, v in self.manifest.items() if k != "status"}
