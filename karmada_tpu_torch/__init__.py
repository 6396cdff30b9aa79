"""karmada_tpu_torch: the PyTorch/CUDA port of the karmada-tpu scheduler.

The device scheduling cycle (encode -> solve -> compact -> decode) of the
JAX package, the control plane it serves in (store, runtime, scheduling
queue, Scheduler) and the rebalance plane, rewritten for PyTorch with
hand-written Hopper kernels (`ops/csrc/*.cu`).  The package imports
torch and numpy and never jax; it keeps its own copies of the models, the
serial golden path and the encoder it needs.

Layout mirrors the JAX package where that helps find the counterpart:
  models/     the four API model modules the encoder and serial path read
  ops/        tensors (encoder/decoder), serial, webster, solver (wave
              loop, kernel wrappers and their plain versions), kernels
              (build + ctypes binding + launch counters), csrc/ (CUDA)
  scheduler/  pipeline (chunked executor + carry chain), core
              (schedule_items: the cycle's entry point), plugins,
              incremental (the dirty-set steady state), queue +
              service (the store-watching Scheduler)
  store/      ObjectStore (apiserver semantics) and the Runtime that
              pumps the controllers' reconcile queues
  controllers/ graceful eviction (evict_cluster + its controller)
  rebalance/  the rebalance plane (K13 detect -> drain -> re-place) and
              the shared eviction-pacing budget
  resident/   the resident-state plane and the watch-driven DeltaTracker
  estimator/  GeneralEstimator (scheduler side)
  device.py   resolves the `device` argument every entry point takes
"""
