"""The plain reference of End2End with an HRNet detector: HRNet, the x10
soft-argmax decode and the 3d-pose-baseline lifter in float32 PyTorch, read
straight from the benchmark's seeded leaves (``hrnet_layout.py``).

A functional forward of ``lib/models/pose_hrnet.py``
(deep-high-resolution-net.pytorch) as configured by the cell's
configuration (the yaml's stages): conv (bias-free but ``final_layer``),
then BN in eval mode, ``(x - mean) / sqrt(var + eps) * scale + bias``;
Bottleneck and BasicBlock sum the residual before their last ReLU; an
exchange output is the ReLU of its inputs summed in branch order (the
identity, 1x1 conv + BN + nearest upsample from a lower resolution,
strided 3x3 convs + BN from a higher one, ReLU between those convs but not
after the last); the last module gives branch 0 only; the heatmaps are
``final_layer`` of branch 0. Departures from pose_hrnet.py: none. The
decode and the lifter are ``model.py``'s. Nothing is folded, fused or
cast: every operation is float32, and the caller turns TF32 off.

The modes of ``model.Net`` hold here too: ``dtype`` runs the served
precision (each conv in ``dtype``, each BN in f32 on the rounded input and
rounded back, the sums, ReLUs and upsamples in ``dtype``); ``fp8`` gives
every conv and Linear float8 e4m3 operands (the control); while
``calibrating`` is set each conv first loses its response to its input's
mean, each BN takes its input's statistics, and each residual or exchange
sum is centred through the bias of its last BN term (the benchmark's
data-dependent initialisation of the seeded weights).
"""
from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F

from portbench.reference.hrnet_layout import STAGES
from portbench.reference.model import Net, Stats, _centre, fp8, \
    mpii_to_lifter, softargmax, to_frame

PRE = ("hourglass",)


class HRNet(Net):
    """``model.Net`` with HRNet's detector over the leaves of
    ``hrnet_layout.model_leaves``."""

    def __init__(self, leaves, cfg: dict):
        super().__init__(leaves, cfg["bn_eps"])
        self.cfg = cfg

    def conv(self, path: tuple, x: torch.Tensor, stride: int = 1
             ) -> torch.Tensor:
        leaf = self.leaves[path]
        if self.calibrating:
            _centre(leaf["kernel"], x.mean(dim=(0, 2, 3)))
            self._oihw.pop(path, None)
        w = self._oihw.get(path)
        if w is None:
            w = self._oihw[path] = leaf["kernel"].permute(3, 2, 0, 1) \
                .contiguous()
        pad = (w.shape[-1] - 1) // 2
        bias = leaf.get("bias")
        if self.fp8:
            y = F.conv2d(fp8(x), fp8(w), None, stride, pad)
        elif self.dtype is not None:
            dt = self.dtype
            y = F.conv2d(x.to(dt), w.to(dt), None, stride, pad)
            return y if bias is None else y + bias.to(dt).view(1, -1, 1, 1)
        else:
            y = F.conv2d(x, w, None, stride, pad)
        return y if bias is None else y + bias.view(1, -1, 1, 1)

    def _cb(self, p: tuple, x: torch.Tensor, stride: int = 1
            ) -> torch.Tensor:
        """A published (conv, BN) pair ``{p}.0``, ``{p}.1``."""
        return self.bn(p + ("1",), self.conv(p + ("0",), x, stride))

    def _sum(self, terms: List[torch.Tensor], bn: Optional[tuple]
             ) -> torch.Tensor:
        """The sum of ``terms`` in order; while calibrating, its
        per-channel mean is taken out through the bias of ``bn``."""
        y = terms[0]
        for t in terms[1:]:
            y = y + t
        if self.calibrating and bn is not None:
            mean = y.mean(dim=(0, 2, 3))
            self.leaves[bn]["bias"].sub_(mean)
            y = y - mean.view(1, -1, 1, 1)
        return F.relu(y)

    # ---------------------------------------------------------- blocks
    def bottleneck(self, p: tuple, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn(p + ("bn1",), self.conv(p + ("conv1",), x)))
        h = F.relu(self.bn(p + ("bn2",), self.conv(p + ("conv2",), h)))
        h = self.bn(p + ("bn3",), self.conv(p + ("conv3",), h))
        skip = self._cb(p + ("downsample",), x) \
            if p + ("downsample", "0") in self.leaves else x
        return self._sum([h, skip], p + ("bn3",))

    def basic(self, p: tuple, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn(p + ("bn1",), self.conv(p + ("conv1",), x)))
        h = self.bn(p + ("bn2",), self.conv(p + ("conv2",), h))
        return self._sum([h, x], p + ("bn2",))

    def fused(self, f: tuple, i: int, j: int, x: torch.Tensor
              ) -> torch.Tensor:
        """Input j's term of exchange output i."""
        if j > i:
            return F.interpolate(self._cb(f, x), scale_factor=2 ** (j - i),
                                 mode="nearest")
        for k in range(i - j):
            x = self._cb(f + (str(k),), x, stride=2)
            if k < i - j - 1:
                x = F.relu(x)
        return x

    def module(self, p: tuple, xs: List[torch.Tensor], blocks,
               outputs: int) -> List[torch.Tensor]:
        for i in range(len(xs)):
            for k in range(blocks[i]):
                xs[i] = self.basic(p + ("branches", str(i), str(k)), xs[i])
        if len(xs) == 1:
            return xs
        out = []
        for i in range(outputs):
            terms, last = [], None
            for j, x in enumerate(xs):
                if j == i:
                    terms.append(x)
                    continue
                f = p + ("fuse_layers", str(i), str(j))
                terms.append(self.fused(f, i, j, x))
                last = f + ("1",) if j > i else f + (str(i - j - 1), "1")
            out.append(self._sum(terms, last))
        return out

    def transition(self, t: tuple, xs: List[torch.Tensor], cur
                   ) -> List[torch.Tensor]:
        """pose_hrnet.py: an entry that exists takes the last branch's
        output; a branch without one passes through."""
        out = []
        for i in range(len(cur)):
            p = t + (str(i),)
            if p + ("0",) in self.leaves:  # one conv + BN + ReLU
                out.append(F.relu(self._cb(p, xs[-1])))
            elif p + ("0", "0") in self.leaves:  # a chain of them
                x, k = xs[-1], 0
                while p + (str(k), "0") in self.leaves:
                    x = F.relu(self._cb(p + (str(k),), x, stride=2))
                    k += 1
                out.append(x)
            else:
                out.append(xs[i])
        return out

    # -------------------------------------------------------- detector
    def detector(self, images: torch.Tensor) -> torch.Tensor:
        """images (B, H, W, 3) f32 in [0, 1] -> heatmaps (B, J, H/4, W/4)
        f32."""
        cfg = self.cfg
        x = images.permute(0, 3, 1, 2)
        if self.dtype is not None:
            x = x.to(self.dtype)
        x = F.relu(self.bn(PRE + ("bn1",),
                           self.conv(PRE + ("conv1",), x, stride=2)))
        x = F.relu(self.bn(PRE + ("bn2",),
                           self.conv(PRE + ("conv2",), x, stride=2)))
        for k in range(cfg["layer1"]["num_blocks"]):
            x = self.bottleneck(PRE + ("layer1", str(k)), x)
        xs = [x]
        for s, stage in enumerate(STAGES):
            st = cfg[stage]
            xs = self.transition(PRE + (f"transition{s + 1}",), xs,
                                 st["num_channels"])
            for m in range(st["num_modules"]):
                last = s == len(STAGES) - 1 and m == st["num_modules"] - 1
                xs = self.module(PRE + (stage, str(m)), xs,
                                 st["num_blocks"], 1 if last else len(xs))
        return self.conv(PRE + ("final_layer",), xs[0]).to(torch.float32)


def end2end(net: HRNet, stats: Stats, frames: torch.Tensor,
            centers: Optional[torch.Tensor] = None,
            scales: Optional[torch.Tensor] = None):
    """frames (B, H, W, 3) u8 -> (pose2d (B, 16, 2) frame pixels in MPII
    order, pose3d (B, 16, 3) mm), the answer of End2End serving
    (``model.end2end`` with this detector)."""
    cfg = net.cfg
    b = frames.shape[0]
    dev = frames.device
    if centers is None:
        centers = torch.full((b, 2), cfg["inputRes"] / 2.0, device=dev)
    if scales is None:
        scales = torch.full((b,), cfg["inputRes"] / 200.0, device=dev)
    heat = net.detector(frames.to(torch.float32) / 255.0)
    pose2d = to_frame(softargmax(heat, cfg["softargmax_temperature"]),
                      centers, scales, cfg["outputRes"])
    x = (mpii_to_lifter(pose2d) - stats.mean_part) / stats.std_part
    out = net.lifter(x, ("bilinear",))
    return pose2d, (out * stats.std_s + stats.mean_s).reshape(b, 16, 3)
