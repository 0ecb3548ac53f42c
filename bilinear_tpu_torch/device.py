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


def disable_tf32() -> None:
    """f32 matmuls and cuDNN convolutions in full f32, not TF32 (torch
    leaves cuDNN's on TF32 by default, a 10-bit mantissa). Every CLI calls
    this at the start: the configs' float32 is the JAX package's float32,
    and in a bf16 run the f32 parts (BN, the loss, the stem) stay f32.
    Library modules never set it. This is torch's legacy pair of switches;
    setting the newer ``fp32_precision`` attributes instead makes a later
    read of these raise."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
