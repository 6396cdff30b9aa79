"""karmada_tpu_torch: the PyTorch/CUDA port of the karmada-tpu scheduler.

The device scheduling cycle (encode -> solve -> compact -> decode) of the
JAX package, the control plane it serves in (store, runtime, scheduling
queue, Scheduler), the propagation loop around it (detector, binding,
execution and status controllers, member clusters, admission; e2e.py's
ControlPlane) and the rebalance plane, rewritten for PyTorch with
hand-written Hopper kernels (`ops/csrc/*.cu`).  The package imports
torch and numpy and never jax; it keeps its own copies of the models, the
serial golden path and the encoder it needs.

Layout mirrors the JAX package where that helps find the counterpart:
  e2e.py      ControlPlane: the propagation loop in one process
  models/     the API models (meta, cluster, policy, work, config) and
              unstructured templates
  ops/        tensors (encoder/decoder), serial, webster, solver (wave
              loop, kernel wrappers and their plain versions), kernels
              (build + ctypes binding + launch counters), csrc/ (CUDA)
  scheduler/  pipeline (chunked executor + carry chain), core
              (schedule_items: the cycle's entry point), plugins,
              incremental (the dirty-set steady state), queue +
              service (the store-watching Scheduler)
  store/      ObjectStore (apiserver semantics) and the Runtime that
              pumps the controllers' reconcile queues
  controllers/ detector, override, binding, execution, status (work,
              binding, cluster), namespace sync, graceful eviction
  interpreter/ the resource interpreter: native defaults, the third-party
              bundle, declarative customizations, webhooks
  members/    FakeMemberCluster, the member clusters' simulator
  webhook/    admission: the chain and the built-in policy plugins
  rebalance/  the rebalance plane (K13 detect -> drain -> re-place) and
              the shared eviction-pacing budget
  resident/   the resident-state plane and the watch-driven DeltaTracker
  estimator/  GeneralEstimator (scheduler side) and the modeling producer
  utils/      quantities, feature gates, well-known labels
  device.py   resolves the `device` argument every entry point takes
"""
