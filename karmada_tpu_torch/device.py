"""Device resolution for every entry point of the port.

Entry points run on the card unless the caller asks for the CPU: with no
card and no explicit ``device="cpu"`` they raise instead of drifting to
the CPU, so a run can never silently measure the wrong device.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means the first CUDA card; a CUDA device is checked to
    exist; ``"cpu"`` (or a CPU torch.device) runs the plain versions."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def mesh_info() -> dict:
    """The `mesh` block of /debug/state: the JAX package's
    ``ops/meshing.mesh_info()`` single-device fallback.  The port runs on
    one card (a solver mesh is ROADMAP Queue A item 10), so no mesh plan
    is ever active; reading it touches no device."""
    return {"enabled": False, "shape": None, "devices": 1,
            "platform": None}
