"""The detectors End2End can hold, by variant name, and the one place that
builds them. Each class says in attributes beside its ``variant`` what the
port runs it with: ``fused_blocks`` (kernels K3/K4), ``int8_convs``
(``quantize="int8"``), ``trainable``, ``spatial_sharding``
(``parallel/spatial.py``) and ``eval_plan`` (an eval model's
``build_eval_plan()``, which ``End2EndServer`` calls on each model it
builds); and what it takes and gives: ``size_args``, ``make_model``'s size
arguments it takes, each mapped to its constructor's keyword,
``input_size``, the (H, W) of its frames, and ``heatmap_size``, the (H, W)
of its heatmaps (a model built at another size holds its own). Callers
read those, never the variant's name.
"""
from __future__ import annotations

from typing import Optional

import torch

from bilinear_tpu_torch.models.hourglass import StackedHourglass
from bilinear_tpu_torch.models.hourglass_torch7 import MainModel
from bilinear_tpu_torch.models.hrnet import PoseHighResolutionNet
from bilinear_tpu_torch.models.vitpose import ViTPose

DETECTORS = {"torch7": MainModel, "preact": StackedHourglass,
             "hrnet": PoseHighResolutionNet, "vitpose": ViTPose}


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
               generator: Optional[torch.Generator] = None, quantize=None,
               embed_dim=None, heads=None, image_size=None):
    """'torch7' = the MainModel the MPII training trains, 'preact' = the
    StackedHourglass the H36M fine-tuning trains, 'hrnet' = HRNet-W48 and
    'vitpose' = ViTPose-H, which the port serves. Size overrides of None
    keep the reference's 8 stacks, 256 features, depth 4 (HRNet's 48-wide
    first branch; ``features`` is its width, and it takes no other
    override; ViTPose's 1280 wide, 32 deep, 16 heads at 256 x 192, which
    ``embed_dim``, ``depth``, ``heads`` and ``image_size`` (H, W) change,
    and it takes no other override). ``fused`` (the ResModule kernels) and
    ``quantize="int8"`` (the eval-mode int8 convs) raise for a detector
    that has none, rather than being ignored."""
    cls = detector(variant)
    if fused and not cls.fused_blocks:
        raise ValueError("fused blocks exist for the torch7 variant only; "
                         f"the {variant} variant has no kernel path")
    if quantize is not None and not cls.int8_convs:
        raise ValueError(f"the {variant!r} variant has no int8 convolutions "
                         f"(quantize={quantize!r})")
    given = {k: v for k, v in dict(
        n_stacks=n_stacks, features=features, depth=depth,
        n_modules=n_modules, embed_dim=embed_dim, heads=heads,
        image_size=image_size).items() if v is not None}
    other = sorted(set(given) - set(cls.size_args))
    if other:
        raise ValueError(f"the {variant!r} variant takes no {other}")
    kw = {cls.size_args[k]: v for k, v in given.items()}
    if cls.fused_blocks:
        kw["fused"] = fused
    if cls.int8_convs:
        kw["quantize"] = quantize
    return cls(dtype=dtype, generator=generator, **kw)
