"""Resident-state plane: solver tensors kept on the device between cycles.

  state.py    ResidentState -- frozen copy-on-write masters advanced by
              deltas, their device mirrors (K10 scatters, primed into the
              solver's transfer cache), the per-binding slot store (K11
              gather on the fused path) and the bit-exact audit
  deltas.py   the classes of cluster change, one cycle's change set and
              the DeltaTracker that coalesces it from the store's watch

Counterpart of the JAX package's ``karmada_tpu/resident``; its debug
endpoint waits for the port's debug server.
"""

from __future__ import annotations

from karmada_tpu_torch.resident.deltas import (  # noqa: F401
    CycleDeltas,
    DeltaTracker,
    classify_cluster_event,
)
from karmada_tpu_torch.resident.state import (  # noqa: F401
    ResidentState,
    RowToken,
    compare_batches,
)
