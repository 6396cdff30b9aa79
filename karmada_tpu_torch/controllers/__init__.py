"""Controllers of the port's control plane.

  failover.py   evict_cluster + GracefulEvictionController (the graceful
                eviction chain the rebalance plane drains through)
"""
