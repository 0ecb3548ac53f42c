"""Where the port runs: on the card unless the caller asks for the CPU."""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means CUDA and raises when no card is visible; there is no
    silent CPU fallback. ``"cpu"`` is only ever an explicit request (the CPU
    tests make it), and then every kernel wrapper runs its plain version."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; the port runs on the GPU by "
                "default (pass device='cpu' explicitly for the plain "
                "PyTorch reference path)"
            )
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is unavailable")
    return dev
