"""karmada_tpu_torch: the PyTorch/CUDA port of the karmada-tpu scheduler.

The device scheduling cycle (encode -> solve -> compact -> decode) of the
JAX package, rewritten for PyTorch with hand-written Hopper kernels
(`ops/csrc/*.cu`).  The package imports torch and numpy and never jax; it
keeps its own copies of the models, the serial golden path and the
encoder it needs.

Layout mirrors the JAX package where that helps find the counterpart:
  models/     the four API model modules the encoder and serial path read
  ops/        tensors (encoder/decoder), serial, webster, solver (wave
              loop, kernel wrappers and their plain versions), kernels
              (build + ctypes binding + launch counters), csrc/ (CUDA)
  scheduler/  pipeline (chunked executor + carry chain), core
              (schedule_items: the cycle's entry point), plugins
  estimator/  GeneralEstimator (scheduler side)
  device.py   resolves the `device` argument every entry point takes
"""
