"""The detectors End2End can hold, by variant name, and the one place that
builds them. Each class says in attributes beside its ``variant`` what the
port runs it with: ``fused_blocks`` (kernels K3/K4), ``int8_convs``
(``quantize="int8"``), ``trainable`` and ``spatial_sharding``
(``parallel/spatial.py``). Callers read those, never the variant's name.
"""
from __future__ import annotations

from typing import Optional

import torch

from bilinear_tpu_torch.models.hourglass import StackedHourglass
from bilinear_tpu_torch.models.hourglass_torch7 import MainModel
from bilinear_tpu_torch.models.hrnet import WIDTH, PoseHighResolutionNet

DETECTORS = {"torch7": MainModel, "preact": StackedHourglass,
             "hrnet": PoseHighResolutionNet}


def detector(variant: str) -> type:
    """The class of ``variant``; an unknown one raises."""
    if variant not in DETECTORS:
        raise ValueError(f"unknown hourglass variant {variant!r}")
    return DETECTORS[variant]


def check_trainable(variant: str) -> None:
    """Raise for a detector the port serves and does not train."""
    if not detector(variant).trainable:
        raise ValueError(f"the {variant!r} variant has no trainer: the port "
                         "serves it, it does not train it")


def make_model(variant: str = "torch7", dtype=torch.float32, n_stacks=None,
               features=None, depth=None, fused=False, n_modules=None,
               generator: Optional[torch.Generator] = None, quantize=None):
    """'torch7' = the MainModel the MPII training trains, 'preact' = the
    StackedHourglass the H36M fine-tuning trains, 'hrnet' = HRNet-W48,
    which the port serves. Size overrides of None keep the reference's 8
    stacks, 256 features, depth 4 (HRNet's 48-wide first branch;
    ``features`` is its width, and it takes no other override). ``fused``
    (the ResModule kernels) and ``quantize="int8"`` (the eval-mode int8
    convs) raise for a detector that has none, rather than being
    ignored."""
    cls = detector(variant)
    if fused and not cls.fused_blocks:
        raise ValueError("fused blocks exist for the torch7 variant only; "
                         f"the {variant} variant has no kernel path")
    if quantize is not None and not cls.int8_convs:
        raise ValueError(f"the {variant!r} variant has no int8 convolutions "
                         f"(quantize={quantize!r})")
    kw = {k: v for k, v in dict(n_stacks=n_stacks, features=features,
                                depth=depth, n_modules=n_modules).items()
          if v is not None}
    if cls is PoseHighResolutionNet:  # sized by its width alone
        other = sorted(set(kw) - {"features"})
        if other:
            raise ValueError(f"the {variant!r} variant takes no {other}")
        return cls(kw.get("features", WIDTH), dtype=dtype,
                   generator=generator)
    if cls.fused_blocks:
        kw["fused"] = fused
    return cls(dtype=dtype, generator=generator, quantize=quantize, **kw)
