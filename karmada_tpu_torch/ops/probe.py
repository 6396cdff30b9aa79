"""K14 probe_mm and K15 marker_affine: the device lifecycle's kernels.

Counterparts of the JAX package's two lifecycle programs:
``utils/deviceprobe._PROBE_SNIPPET``'s ``jax.jit(lambda a: a @ a)`` (the
probe subprocess launches K14 on every visible card, utils/deviceprobe.py)
and ``obs/devprof.capture_profile``'s marker op ``jax.jit(lambda a: a * 2
+ 1)`` (K15, stamped into each profiler window, obs/devprof.py).  The
kernels live in ``ops/csrc/probe.cu``.  Each wrapper runs its plain
PyTorch version for a CPU tensor and launches its kernel for a CUDA one
(or raises); neither calls a library kernel on the card.

The launch path is lean, since at the probe's and the marker's sizes a
call's time is its host cost: one fused operand test, ``torch.empty_like``
and an ``array("q")`` argument block (``block``, laid out like probe.cu's
ProbeMmArgs and MarkerArgs: two pointers, n, the operand's device index).
No Python device context: the C entry makes the operand's device current
only when it is not, and restores the previous one after.
"""

from __future__ import annotations

from array import array
from typing import Optional

import torch

from karmada_tpu_torch.ops import kernels

#: K15's element type: jnp.arange's under the JAX package's x64 config
MARKER_DTYPE = torch.int64
#: the fields of probe.cu's ProbeMmArgs and MarkerArgs, in order: the
#: input's and the output's addresses, n, the device index
BLOCK_FIELDS = ("src", "dst", "n", "device")


def block(src: int, dst: int, n: int, device: int) -> array:
    """K14's and K15's argument block, an int64 a field (BLOCK_FIELDS)."""
    return array("q", (src, dst, n, device))


def probe_mm_plain(a: torch.Tensor) -> torch.Tensor:
    """a @ a for a square bf16 matrix, summed in float32 and rounded once
    to bf16 (XLA's bf16 dot)."""
    return (a.float() @ a.float()).to(torch.bfloat16)


def probe_mm_shape_error(n: int, address: int = 0) -> Optional[str]:
    """Why K14 cannot take an n x n operand at `address`, or None: its TMA
    loads read A's rows at a stride of n * 2 bytes, which must be a
    multiple of 16 bytes (n % 8 == 0), from a 16-byte aligned A."""
    if n % 8:
        return (f"probe_mm on the card needs n % 8 == 0, got n = {n}: its "
                "TMA loads need a row stride (n * 2 bytes) that is a "
                "multiple of 16 bytes")
    if address % 16:
        return ("probe_mm on the card needs a 16-byte aligned operand "
                "(its TMA loads' base address)")
    return None


def probe_mm(a: torch.Tensor) -> torch.Tensor:
    """K14 on a CUDA tensor (on its own card's current stream),
    probe_mm_plain on a CPU one: a bf16[n, n] -> a @ a, bf16[n, n].

    On the card n must be a multiple of 8 (n % 8 == 0) and A 16-byte
    aligned: TMA reads A by 64 x 64 boxes at a row stride of n * 2 bytes,
    which must be a multiple of 16 bytes.  Raises ValueError otherwise
    (probe_mm_shape_error says why); the plain version takes any n."""
    if not (a.is_cuda and a.dtype == torch.bfloat16 and a.dim() == 2
            and a.shape[0] == a.shape[1] and a.is_contiguous()):
        if a.device.type == "cpu":
            return probe_mm_plain(a)
        kernels.check(a, torch.bfloat16,
                      (a.shape[0],) * 2 if a.dim() == 2 else (-1, -1))
    n = a.shape[0]
    bad = probe_mm_shape_error(n, a.data_ptr())
    if bad:
        raise ValueError(bad)
    c = torch.empty_like(a)
    if n:
        dev = a.get_device()
        kernels.launch("probe", block(a.data_ptr(), c.data_ptr(), n, dev),
                       entry="probe_mm", count="probe_mm", device=dev)
    return c


def marker_affine_plain(a: torch.Tensor) -> torch.Tensor:
    return a * 2 + 1


def marker_affine(a: torch.Tensor) -> torch.Tensor:
    """K15 on a CUDA tensor, marker_affine_plain on a CPU one: a 1-D int64
    tensor -> a * 2 + 1 (wrapping), int64.  Any 8-byte offset and length
    (the kernel's scalar head and tail)."""
    if not (a.is_cuda and a.dtype == MARKER_DTYPE and a.dim() == 1
            and a.is_contiguous()):
        if a.device.type == "cpu":
            return marker_affine_plain(a)
        kernels.check(a, MARKER_DTYPE, (a.numel(),))
    out = torch.empty_like(a)
    n = a.shape[0]
    if n:
        dev = a.get_device()
        kernels.launch("probe", block(a.data_ptr(), out.data_ptr(), n, dev),
                       entry="marker_affine", count="marker_affine",
                       device=dev)
    return out
