"""search.karmada.io API types (reference pkg/apis/search).

Counterpart of the JAX package's ``models/search.py``.

ResourceRegistry (searchregistry_types.go) selects which resources to cache
from which member clusters; the multi-cluster cache (search/cache.py) is
driven by these objects exactly like the reference's registry controller
(pkg/search/controller.go:79-248) builds per-cluster informers.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

from karmada_tpu_torch.models.meta import ObjectMeta, TypedObject
from karmada_tpu_torch.models.policy import ClusterAffinity


@dataclass
class ResourceRegistrySelector:
    """One (apiVersion, kind) the registry caches."""

    api_version: str = ""
    kind: str = ""


@dataclass
class BackendStoreConfig:
    """Optional external sink (the reference supports OpenSearch); the
    in-tree default store is the in-memory cache itself."""

    kind: str = "Default"  # Default | OpenSearch (external; not bundled)
    addresses: List[str] = field(default_factory=list)


@dataclass
class ResourceRegistrySpec:
    target_cluster: ClusterAffinity = field(default_factory=ClusterAffinity)
    resource_selectors: List[ResourceRegistrySelector] = field(default_factory=list)
    backend_store: BackendStoreConfig = field(default_factory=BackendStoreConfig)


@dataclass
class ResourceRegistryStatus:
    conditions: List = field(default_factory=list)


@dataclass
class ResourceRegistry(TypedObject):
    KIND = "ResourceRegistry"
    API_VERSION = "search.karmada.io/v1alpha1"

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: ResourceRegistrySpec = field(default_factory=ResourceRegistrySpec)
    status: ResourceRegistryStatus = field(default_factory=ResourceRegistryStatus)
