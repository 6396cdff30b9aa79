"""Armed runtime invariants (KARMADA_CHECK_INVARIANTS=1, or `arm()`):
counterpart of the JAX package's ``analysis/guards.py``.

Checks at the two boundaries of a device solve: the host->device one
(solver entry: every SolverBatch field against the canonical dtype / axis
tables in ops/tensors.py) and the device->host one (the compact COO read
back: index bounds, value sanity, status codes, NaN).

Disarmed cost is one list read per dispatch (``armed()``), so the hooks
live directly on the production paths (ops/solver.solve /
dispatch_compact / finalize_compact, ops/spread.solve_spread).  The d2h
check reads the host arrays finalize_compact already copied back: it adds
no device synchronisation.  A violation raises InvariantViolation -- loud
and early, instead of a kernel reading a wrongly typed buffer.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np


class InvariantViolation(AssertionError):
    """An armed shape/dtype/value invariant failed at a checked boundary.

    Construction fires the incident plane's invariant-violation trigger
    (obs/incidents): one hook covers every raise site (check_batch /
    check_used / check_d2h).
    The trigger is reentrancy-latched and never raises, so building the
    exception stays safe even mid-capture."""

    def __init__(self, *args) -> None:
        super().__init__(*args)
        from karmada_tpu_torch.obs import incidents as obs_incidents

        obs_incidents.trigger(
            obs_incidents.TRIGGER_INVARIANT_VIOLATION,
            str(args[0]) if args else "invariant violation",
            detail={"message": str(args[0]) if args else ""})


_ARMED = [os.environ.get("KARMADA_CHECK_INVARIANTS", "") not in ("", "0")]


def arm(on: bool = True) -> None:
    """Arm/disarm the runtime checks process-wide (before any controller
    thread runs)."""
    _ARMED[0] = bool(on)


def armed() -> bool:
    return _ARMED[0]


def _dims_of(batch) -> dict:
    return {"B": batch.B, "C": batch.C}


#: FIELD_DTYPES entries that may legitimately be absent/None on a batch:
#: the shortlist kernel's OUTPUT planes (ops/shortlist — typed in the
#: table for the dtype-contract pass, never SolverBatch attributes) and
#: the sub-vocabulary lane map (dense batches carry none; when present
#: on a shortlisted sub-batch it is checked like any other field)
_OPTIONAL_FIELDS = frozenset(
    {"shortlist_idx", "shortlist_fcount", "sub_lanes"})


def check_batch(batch, where: str = "solver-entry") -> None:
    """Validate a SolverBatch against the canonical per-field dtype table
    (tensors.FIELD_DTYPES) and axis table (tensors.FIELD_AXES): dtype
    match, dimensionality, and B/C axis extents.  Raises
    InvariantViolation on the first mismatch."""
    from karmada_tpu_torch.ops.tensors import FIELD_AXES, FIELD_DTYPES

    dims = _dims_of(batch)
    for field_name, want in FIELD_DTYPES.items():
        arr = getattr(batch, field_name, None)
        if arr is None:
            if field_name in _OPTIONAL_FIELDS:
                continue
            raise InvariantViolation(
                f"[{where}] SolverBatch.{field_name} is None")
        arr = np.asarray(arr)
        got = "bool" if arr.dtype == np.bool_ else str(arr.dtype)
        if got != want:
            raise InvariantViolation(
                f"[{where}] SolverBatch.{field_name} dtype {got} != "
                f"canonical {want} (FIELD_DTYPES) — s64/s32 drift")
        axes = FIELD_AXES.get(field_name)
        if axes is None:
            continue
        if arr.ndim != len(axes):
            raise InvariantViolation(
                f"[{where}] SolverBatch.{field_name} has {arr.ndim} dims, "
                f"expected {len(axes)} {axes}")
        for i, ax in enumerate(axes):
            if ax in dims and arr.shape[i] != dims[ax]:
                raise InvariantViolation(
                    f"[{where}] SolverBatch.{field_name} axis {i} ({ax}) "
                    f"is {arr.shape[i]}, batch says {dims[ax]}")
        if np.issubdtype(arr.dtype, np.floating) and \
                not np.isfinite(arr).all():
            raise InvariantViolation(
                f"[{where}] SolverBatch.{field_name} contains "
                "NaN/Inf values")


def check_used(used: Optional[Sequence], where: str = "carry") -> None:
    """Validate a (used_milli, used_pods, used_sets) carry triple's dtypes
    against tensors.CARRY_DTYPES (tensors on the card are inspected by
    dtype attribute only -- no host sync)."""
    if used is None:
        return
    from karmada_tpu_torch.ops.tensors import CARRY_DTYPES
    names = tuple(CARRY_DTYPES)
    if len(used) != len(names):
        raise InvariantViolation(
            f"[{where}] carry triple has {len(used)} members, "
            f"expected {len(names)} {names}")
    for name, arr in zip(names, used):
        dt = getattr(arr, "dtype", None)
        if dt is None:
            continue
        got = "bool" if dt == np.bool_ else str(dt).replace("torch.", "")
        if got != CARRY_DTYPES[name]:
            raise InvariantViolation(
                f"[{where}] carry {name} dtype {got} != canonical "
                f"{CARRY_DTYPES[name]} (CARRY_DTYPES)")


def check_d2h(idx: np.ndarray, val: np.ndarray, status: np.ndarray,
              dense_nnz: int, where: str = "d2h") -> None:
    """Validate a compact COO result at the device->host boundary: int32
    planes, indices within [-1, dense_nnz), non-negative replica values,
    known status codes, and finiteness (NaN guard on any float input)."""
    from karmada_tpu_torch.ops.tensors import (
        STATUS_FIT_ERROR,
        STATUS_NO_CLUSTER,
        STATUS_OK,
        STATUS_UNSCHEDULABLE,
    )

    idx = np.asarray(idx)
    val = np.asarray(val)
    status = np.asarray(status)
    for name, arr in (("idx", idx), ("val", val), ("status", status)):
        if np.issubdtype(arr.dtype, np.floating):
            if not np.isfinite(arr).all():
                raise InvariantViolation(
                    f"[{where}] compact {name} contains NaN/Inf")
            raise InvariantViolation(
                f"[{where}] compact {name} is float ({arr.dtype}); the "
                "COO planes are int32 by contract")
        if arr.dtype != np.int32:
            raise InvariantViolation(
                f"[{where}] compact {name} dtype {arr.dtype} != int32")
    if idx.size and (int(idx.min()) < -1 or int(idx.max()) >= dense_nnz):
        raise InvariantViolation(
            f"[{where}] compact idx out of range [-1, {dense_nnz}): "
            f"min={int(idx.min())}, max={int(idx.max())}")
    if val.size and int(val[idx >= 0].min(initial=0)) < 0:
        raise InvariantViolation(
            f"[{where}] compact val has negative replica counts")
    known = {STATUS_OK, STATUS_FIT_ERROR, STATUS_UNSCHEDULABLE,
             STATUS_NO_CLUSTER}
    bad = set(np.unique(status).tolist()) - known
    if bad:
        raise InvariantViolation(
            f"[{where}] unknown solver status code(s) {sorted(bad)}")
