"""K14 probe_mm and K15 marker_affine: the device lifecycle's kernels.

Counterparts of the JAX package's two lifecycle programs:
``utils/deviceprobe._PROBE_SNIPPET``'s ``jax.jit(lambda a: a @ a)`` (the
probe subprocess launches K14 on every visible card, utils/deviceprobe.py)
and ``obs/devprof.capture_profile``'s marker op ``jax.jit(lambda a: a * 2
+ 1)`` (K15, stamped into each profiler window, obs/devprof.py).  The
kernels live in ``ops/csrc/probe.cu``.  Each wrapper runs its plain
PyTorch version for a CPU tensor and launches its kernel for a CUDA one
(or raises); neither calls a library kernel on the card.
"""

from __future__ import annotations

import torch

from karmada_tpu_torch.ops import kernels

#: K15's element type: jnp.arange's under the JAX package's x64 config
MARKER_DTYPE = torch.int64


def probe_mm_plain(a: torch.Tensor) -> torch.Tensor:
    """a @ a for a square bf16 matrix, summed in float32 and rounded once
    to bf16 (XLA's bf16 dot)."""
    return (a.float() @ a.float()).to(torch.bfloat16)


def probe_mm(a: torch.Tensor) -> torch.Tensor:
    """K14 on a CUDA tensor (on its own card's current stream),
    probe_mm_plain on a CPU one: a bf16[n, n] -> a @ a, bf16[n, n]."""
    if a.device.type == "cpu":
        return probe_mm_plain(a)
    n = a.shape[0] if a.dim() == 2 else -1
    kernels.check(a, torch.bfloat16, (n, n))
    c = torch.empty_like(a)
    if n:
        with torch.cuda.device(a.device):
            kernels.launch("probe", kernels.ProbeMmArgs(
                kernels.ptr(a), kernels.ptr(c), n), entry="probe_mm",
                count="probe_mm", device=a.device.index)
    return c


def marker_affine_plain(a: torch.Tensor) -> torch.Tensor:
    return a * 2 + 1


def marker_affine(a: torch.Tensor) -> torch.Tensor:
    """K15 on a CUDA tensor, marker_affine_plain on a CPU one: a 1-D int64
    tensor -> a * 2 + 1 (wrapping), int64."""
    if a.device.type == "cpu":
        return marker_affine_plain(a)
    kernels.check(a, MARKER_DTYPE, (a.numel(),))
    out = torch.empty_like(a)
    if a.numel():
        with torch.cuda.device(a.device):
            kernels.launch("probe", kernels.MarkerArgs(
                kernels.ptr(a), kernels.ptr(out), a.numel()),
                entry="marker_affine",
                count="marker_affine", device=a.device.index)
    return out
