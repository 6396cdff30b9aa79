"""Fixtures shared by the tests/test_torch_*.py suites that build JAX
ControlPlanes or Schedulers; a suite imports the ones it uses by name."""

import gc

import pytest


@pytest.fixture(autouse=True, scope="module")
def collect_jax_planes():
    """Collect the JAX ControlPlanes and Schedulers a module's tests
    dropped, at its end.  A JAX Scheduler sits in reference cycles (its
    bound methods subscribe to its store's bus), so its VetLocks stay in
    the JAX package's process-wide lock registry
    (karmada_tpu.utils.locks._ALL, a WeakSet) until a full collection,
    which a large heap defers; without this they pile up there for the
    next files on the same worker (tests/test_lock_order.py::
    test_state_payload_shape lists the first 64 by name)."""
    yield
    gc.collect()
