"""Multi-version API conversion registry (CRD conversion-webhook parity).

Counterpart of the JAX package's ``models/conversion.py``.

The reference serves several versions per API group and converts between
them through the webhook's `/convert` endpoint
(cmd/webhook/app/webhook.go:186-232 wires
ConversionReview handling; pkg/apis/work carries the v1alpha1/v1alpha2
pair).  Evolving a live control plane's schema without rewriting stored
objects is the capability; the machinery here is the k8s hub-and-spoke
model made explicit:

- every kind's dataclass in models/ IS the hub (storage) version — the
  store holds exactly one representation, like etcd's storage version;
- additional *served* versions register manifest-level up/down converters
  (conversions are renames/moves of unstructured fields, exactly what a
  CRD conversion webhook sees — it converts unstructured objects, not
  typed ones);
- ingress (codec.from_manifest_typed) converts served -> storage before
  decoding; egress (codec.to_manifest_typed(version=...)) converts
  storage -> served after encoding.  Reads and watches can therefore ask
  for any served version while the store round-trips one schema.

Served today: work.karmada.io/v1alpha1 `Work` is also served at
work.karmada.io/v1alpha2, where `spec.suspendDispatching` is renamed to
`spec.suspend` (the field-rename class of schema evolution).

DELIBERATE DIVERGENCE from the reference API surface: in the reference,
the work.karmada.io/v1alpha2 group contains only the binding kinds —
`Work` exists solely at v1alpha1 (with spec.suspendDispatching) and was
never re-served.  The synthetic Work v1alpha2 here is kept ON PURPOSE as
the living exercise of the field-RENAME conversion class (the binding
v1alpha1 pair below exercises the structural-MOVE class); /apis discovery
therefore advertises one served version the upstream surface does not
have.  Clients comparing discovery output against upstream should ignore
Work@v1alpha2; everything else matches.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict, List, Optional, Tuple

Manifest = Dict[str, Any]
Converter = Callable[[Manifest], Manifest]


class ConversionRegistry:
    """(kind, served_version) -> up/down converters to the storage version."""

    def __init__(self) -> None:
        # (kind, version) -> (to_storage, from_storage)
        self._by_version: Dict[Tuple[str, str], Tuple[Converter, Converter]] = {}

    def register(self, kind: str, version: str,
                 to_storage: Converter, from_storage: Converter) -> None:
        self._by_version[(kind, version)] = (to_storage, from_storage)

    def served(self, kind: str, version: str) -> bool:
        if self._by_version.get((kind, version)) is not None:
            return True
        from karmada_tpu_torch.models.codec import model_registry

        cls = model_registry().get(kind)
        return cls is not None and cls.API_VERSION == version

    def served_versions(self, kind: str) -> List[str]:
        from karmada_tpu_torch.models.codec import model_registry

        out = []
        cls = model_registry().get(kind)
        if cls is not None:
            out.append(cls.API_VERSION)
        out.extend(v for (k, v) in self._by_version if k == kind)
        return out

    def storage_version(self, kind: str) -> Optional[str]:
        from karmada_tpu_torch.models.codec import model_registry

        cls = model_registry().get(kind)
        return cls.API_VERSION if cls is not None else None

    def to_storage(self, manifest: Manifest) -> Manifest:
        """Convert a served-version manifest up to the storage version."""
        kind = manifest.get("kind", "")
        version = manifest.get("apiVersion", "")
        if version == self.storage_version(kind):
            return manifest
        pair = self._by_version.get((kind, version))
        if pair is None:
            raise KeyError(f"{kind} has no served version {version!r}")
        out = pair[0](copy.deepcopy(manifest))
        out["apiVersion"] = self.storage_version(kind)
        return out

    def convert(self, manifest: Manifest, target_version: str) -> Manifest:
        """The /convert verb: any served version -> any served version,
        always routed through the storage hub (spoke-to-spoke conversions
        compose the two halves — no N^2 converter matrix)."""
        kind = manifest.get("kind", "")
        if manifest.get("apiVersion") == target_version:
            return manifest
        hub = self.to_storage(manifest)
        if target_version == self.storage_version(kind):
            return hub
        pair = self._by_version.get((kind, target_version))
        if pair is None:
            raise KeyError(f"{kind} has no served version {target_version!r}")
        out = pair[1](copy.deepcopy(hub))
        out["apiVersion"] = target_version
        return out


REGISTRY = ConversionRegistry()


def _rename(spec: Manifest, old: str, new: str) -> None:
    if old in spec:
        spec[new] = spec.pop(old)


def _work_v1alpha2_to_storage(m: Manifest) -> Manifest:
    _rename(m.get("spec") or {}, "suspend", "suspendDispatching")
    return m


def _work_storage_to_v1alpha2(m: Manifest) -> Manifest:
    _rename(m.get("spec") or {}, "suspendDispatching", "suspend")
    return m


WORK_V1ALPHA2 = "work.karmada.io/v1alpha2"

# Synthetic served version — a deliberate divergence from the reference,
# where Work is v1alpha1-only; see the module docstring before matching
# /apis discovery against the upstream surface.
REGISTRY.register("Work", WORK_V1ALPHA2,
                  _work_v1alpha2_to_storage, _work_storage_to_v1alpha2)


# -- ResourceBinding / ClusterResourceBinding at work/v1alpha1 ---------------
# The reference's REAL legacy pair: bindings began life at v1alpha1 where
# per-replica demand and the replica count lived INSIDE spec.resource
# (ObjectReference.ReplicaResourceRequirements / .Replicas); the v1alpha2
# hub hoisted them to spec.replicaRequirements.resourceRequest and
# spec.replicas (pkg/apis/work/v1alpha1/
# binding_types_conversion.go:77-128).  These converters perform the same
# structural MOVES; the down-convert keeps only the fields v1alpha1
# carries (resource + clusters in spec, conditions + the four
# aggregatedStatus scalars in status), exactly like ConvertBindingSpec/
# StatusFromHub — an old served version is inherently lossy about newer
# spec machinery (placement, eviction tasks, components).

BINDING_V1ALPHA1 = "work.karmada.io/v1alpha1"


def _binding_v1alpha1_to_storage(m: Manifest) -> Manifest:
    spec = m.get("spec") or {}
    res = spec.get("resource") or {}
    if "replicaResourceRequirements" in res:
        spec.setdefault("replicaRequirements", {})["resourceRequest"] = (
            res.pop("replicaResourceRequirements"))
    if "replicas" in res:
        spec["replicas"] = res.pop("replicas")
    return m


def _binding_storage_to_v1alpha1(m: Manifest) -> Manifest:
    spec = m.get("spec") or {}
    # only the five ObjectReference fields v1alpha1 defines survive
    # (ConvertBindingSpecFromHub copies exactly these; hub-only fields
    # like uid have no v1alpha1 home and must not leak into the old
    # schema — CRD pruning there would reject them)
    res = {k: v for k, v in (spec.get("resource") or {}).items()
           if k in ("apiVersion", "kind", "namespace", "name",
                    "resourceVersion")}
    rr = spec.get("replicaRequirements") or {}
    if "resourceRequest" in rr:  # membership: {} must round-trip as {}
        res["replicaResourceRequirements"] = rr["resourceRequest"]
    if "replicas" in spec:
        res["replicas"] = spec["replicas"]
    out_spec: Manifest = {"resource": res}
    if "clusters" in spec:
        out_spec["clusters"] = spec["clusters"]
    m["spec"] = out_spec
    status = m.get("status") or {}
    out_status: Manifest = {}
    if "conditions" in status:
        out_status["conditions"] = status["conditions"]
    if "aggregatedStatus" in status:
        out_status["aggregatedStatus"] = [
            {k: v for k, v in item.items()
             if k in ("clusterName", "status", "applied", "appliedMessage")}
            for item in status["aggregatedStatus"]
        ]
    if out_status:
        m["status"] = out_status
    elif "status" in m:
        del m["status"]
    return m


for _kind in ("ResourceBinding", "ClusterResourceBinding"):
    REGISTRY.register(_kind, BINDING_V1ALPHA1,
                      _binding_v1alpha1_to_storage,
                      _binding_storage_to_v1alpha1)
