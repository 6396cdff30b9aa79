"""Controllers of the port's control plane (counterparts of the JAX
package's ``karmada_tpu/controllers`` modules of the same names).

  detector.py   ResourceDetector: template + policy -> ResourceBinding
  override.py   OverrideManager: per-cluster manifest overrides
  binding.py    BindingController: binding -> one Work per cluster
  execution.py  ExecutionController: Work -> member cluster
  status.py     Work / binding / cluster status reflection
  namespace.py  NamespaceSyncController: namespaces to every member
  failover.py   evict_cluster, not-ready taints, the NoExecute taint
                manager, graceful eviction, application failover
  lease.py      the collector's heartbeat Leases and their monitor
  cluster.py    cluster lifecycle (finalizer, execution space, unjoin)
                and the rate-limited eviction queue
  dependencies.py  DependenciesDistributor: attached bindings
  extras.py     rebalancer, taint policies, remedies, quotas
  certificates.py  agent CSR approval and credential rotation
"""
