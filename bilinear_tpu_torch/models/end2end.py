"""End to end: hourglass -> soft-argmax -> lifting, as one differentiable
module (counterpart of ``bilinear_tpu/models/end2end.py``).

Per batch:
  images (B, H, W, 3) (the detector's ``input_size``: 256 x 256, ViTPose's
  256 x 192) -> the detector (``hourglass``: torch7 or preact, 8 stacks,
  HRNet-W48 or ViTPose-H, one stage) -> last-stack heatmaps ->
  softargmax (x10 temperature)
  -> heatmap space -> image space (centre/scale, each axis by its own
  heatmap size) -> MPII -> H36M-16 (nose
  deleted) -> z-score with the H36M train-split part statistics ->
  ``bilinear`` (BilinearUnit) -> normalized 48-d 3D pose.

SPACE CONTRACT: ``centers``/``scales`` describe the crop box in the SAME
coordinate space as ``mean_part``/``std_part`` were computed in; for the
H36M bins that is the ORIGINAL image space. The canvas-space box of the
host pipeline is for cropping only: z-scoring the lifter's input with
original-space statistics from canvas-space keypoints feeds it the wrong
distribution (the JAX package measured 488 mm against 44 mm of fused
MPJPE). ``train/end2end.py`` carries ``decode_centers``/``decode_scales``
for exactly this.

The submodules are named ``hourglass`` and ``bilinear``, so the state_dict
keys are ``hourglass.<reference names>`` and ``bilinear.<reference
names>`` and independently trained checkpoints assemble into this module
(``assemble_variables``, ``utils/weights.py::end2end_from_jax``).

``fused=True`` runs the torch7 detector's ResModules through kernels K3
(forward) and K4 (backward) on a CUDA tensor; ``quantize="int8"`` gives a
hourglass its eval-mode int8 convolutions (``ops/int8.py``, kernels K6/K7;
an int8 eval forward launches no K3). A detector without them raises
(``models/detectors.py``). The submodule keeps the name ``hourglass`` for
every variant, so each variant's tree sits under the same key. The lifting
half stays in ``dtype`` and never goes through the lifting kernels K1/K2
(as in JAX). Train-mode dropout
draws its masks from the ``generator`` given to ``forward``, on the
activations' device.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from bilinear_tpu_torch.models.bilinear import BilinearUnit
from bilinear_tpu_torch.models.detectors import make_model
from bilinear_tpu_torch.ops.decode import decode_to_normalized
from bilinear_tpu_torch.utils.weights import end2end_from_jax


class End2End(nn.Module):
    end2end = True  # utils/weights.py::converters_of tells it by this

    def __init__(self, variant: str = "torch7", temperature: float = 10.0,
                 dtype=torch.float32, n_stacks: Optional[int] = None,
                 features: Optional[int] = None, depth: Optional[int] = None,
                 fused: bool = False, quantize: Optional[str] = None,
                 n_modules: Optional[int] = None,
                 generator: Optional[torch.Generator] = None,
                 embed_dim: Optional[int] = None,
                 heads: Optional[int] = None, image_size=None):
        """``variant`` and the size overrides: the detector's
        (``models/detectors.py::make_model``). ``quantize="int8"``: the
        detector's int8 convolutions in eval mode (the lifter stays in
        ``dtype``, as in JAX). ``generator`` seeds the initialisation of
        both halves."""
        super().__init__()
        self.variant = variant
        self.temperature = temperature
        self.dtype = dtype
        self.fused = fused
        self.hourglass = make_model(variant, dtype, n_stacks=n_stacks,
                                    features=features, depth=depth,
                                    fused=fused, n_modules=n_modules,
                                    generator=generator, quantize=quantize,
                                    embed_dim=embed_dim, heads=heads,
                                    image_size=image_size)
        self.bilinear = BilinearUnit(generator=generator, dtype=dtype)

    @property
    def input_size(self):
        """(H, W) of the frames the detector takes."""
        return self.hourglass.input_size

    @property
    def heatmap_size(self):
        """(H, W) of the heatmaps it gives."""
        return self.hourglass.heatmap_size

    def forward(self, images: torch.Tensor, centers: torch.Tensor,
                scales: torch.Tensor, mean_part: torch.Tensor,
                std_part: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        """images (B, H, W, 3) f32 in [0, 1]; centers (B, 2), scales
        (B,) of the decode box; the part statistics (32,). Train or eval
        mode from ``self.training``. Returns (per-stack heatmaps (S, B, H,
        W, J), pose_img (B, 16, 2) in MPII order, normalized pose_3d (B,
        48))."""
        heatmaps = self.hourglass(images)
        pose_img, normalized = decode_to_normalized(
            heatmaps[-1], centers, scales, mean_part, std_part,
            self.temperature, self.heatmap_size)
        return heatmaps, pose_img, self.bilinear(normalized, generator)

    def load_jax(self, state) -> "End2End":
        """Load a ``.save`` payload's ``state`` (``{"params",
        "batch_stats"}``, JAX End2End trees of this variant) in place."""
        self.load_state_dict(end2end_from_jax(
            state["params"], state["batch_stats"], self.variant))
        return self


def assemble_variables(hourglass_state: dict, bilinear_state: dict) -> dict:
    """An End2End state_dict from a detector's and a lifter's, trained
    apart (the JAX ``assemble_variables`` merges the two trees the same
    way)."""
    out = {f"hourglass.{k}": v for k, v in hourglass_state.items()}
    out.update({f"bilinear.{k}": v for k, v in bilinear_state.items()})
    return out
