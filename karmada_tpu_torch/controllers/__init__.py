"""Controllers of the port's control plane (counterparts of the JAX
package's ``karmada_tpu/controllers`` modules of the same names).

  detector.py   ResourceDetector: template + policy -> ResourceBinding
  override.py   OverrideManager: per-cluster manifest overrides
  binding.py    BindingController: binding -> one Work per cluster
  execution.py  ExecutionController: Work -> member cluster
  status.py     Work / binding / cluster status reflection
  namespace.py  NamespaceSyncController: namespaces to every member
  failover.py   evict_cluster + GracefulEvictionController (the graceful
                eviction chain the rebalance plane drains through)
"""
