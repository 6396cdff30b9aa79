"""networking.karmada.io + mcs.k8s.io API types.

Counterpart of the JAX package's ``models/networking.py``.

Reference: pkg/apis/networking/v1alpha1 (MultiClusterService,
MultiClusterIngress) and the upstream MCS API kinds karmada consumes
(ServiceExport / ServiceImport, sigs.k8s.io/mcs-api).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

from karmada_tpu_torch.models.meta import Condition, ObjectMeta, TypedObject

# MultiClusterService exposure types (service_types.go)
EXPOSURE_CROSS_CLUSTER = "CrossCluster"
EXPOSURE_LOAD_BALANCER = "LoadBalancer"


@dataclass
class ExposureRange:
    cluster_names: List[str] = field(default_factory=list)


@dataclass
class MultiClusterServiceSpec:
    types: List[str] = field(default_factory=lambda: [EXPOSURE_CROSS_CLUSTER])
    ports: List[dict] = field(default_factory=list)
    provider_clusters: List[ExposureRange] = field(default_factory=list)
    consumer_clusters: List[ExposureRange] = field(default_factory=list)


@dataclass
class MultiClusterServiceStatus:
    conditions: List[Condition] = field(default_factory=list)


@dataclass
class MultiClusterService(TypedObject):
    KIND = "MultiClusterService"
    API_VERSION = "networking.karmada.io/v1alpha1"

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: MultiClusterServiceSpec = field(default_factory=MultiClusterServiceSpec)
    status: MultiClusterServiceStatus = field(
        default_factory=MultiClusterServiceStatus
    )

    def provider_names(self) -> List[str]:
        return [n for r in self.spec.provider_clusters for n in r.cluster_names]

    def consumer_names(self) -> List[str]:
        return [n for r in self.spec.consumer_clusters for n in r.cluster_names]


@dataclass
class MultiClusterIngressSpec:
    rules: List[dict] = field(default_factory=list)
    default_backend: dict = field(default_factory=dict)


@dataclass
class MultiClusterIngress(TypedObject):
    KIND = "MultiClusterIngress"
    API_VERSION = "networking.karmada.io/v1alpha1"

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: MultiClusterIngressSpec = field(default_factory=MultiClusterIngressSpec)


# -- mcs.k8s.io (ServiceExport / ServiceImport) ------------------------------


@dataclass
class ServiceExport(TypedObject):
    KIND = "ServiceExport"
    API_VERSION = "multicluster.x-k8s.io/v1alpha1"

    metadata: ObjectMeta = field(default_factory=ObjectMeta)


@dataclass
class ServiceImportSpec:
    type: str = "ClusterSetIP"
    ports: List[dict] = field(default_factory=list)


@dataclass
class ServiceImport(TypedObject):
    KIND = "ServiceImport"
    API_VERSION = "multicluster.x-k8s.io/v1alpha1"

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: ServiceImportSpec = field(default_factory=ServiceImportSpec)
