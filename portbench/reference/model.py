"""The plain reference: the torch7 stacked hourglass, soft-argmax decode and
the 3d-pose-baseline lifter in float32 PyTorch, read straight from the
benchmark's seeded weights in the JAX ``.save`` layout.

It follows the published models (see ``layout.py``): BN in eval mode is
``(x - mean) / sqrt(var + eps) * scale + bias``; the soft-argmax takes each
axis's marginal sum of a heatmap, scales it by the temperature, subtracts
its maximum, clips the exponent to [-80, 0] and takes the softmax's
expectation over the pixel index; a heatmap pixel p maps to the frame as
``centre + (p - 32) / 64 * scale * 200``; the lifter's input is the 16 MPII
joints in H36M order (the 'SH preprocess' remap with the nose slot
deleted), z-scored, and its output is un-normalised to mm. Nothing is
folded, fused or cast: every operation is float32, and the caller turns
TF32 off.

While ``calibrating`` is set, each conv first takes from its kernel the
response to its input's mean, each BN takes the statistics of its own
input as its running statistics, and each residual block's last bias
centres the stream it leaves: the benchmark's data-dependent
initialisation of the seeded weights (``weights.py``).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

# 16 MPII detections -> the lifter's 16 H36M joints (pose-hg / SH
# preprocess's 17-joint remap [6, 3, 4, 5, 2, 1, 0, 7, 8, 9, 9, 13, 14, 15,
# 12, 11, 10] with its duplicated thorax, the 'nose' slot 9, deleted).
H36M16_FROM_MPII = (6, 3, 4, 5, 2, 1, 0, 7, 8, 9, 13, 14, 15, 12, 11, 10)


class Net:
    """Forward passes over one model's leaves ``{path: {name: tensor}}``
    (``weights.Weights.leaves``), with the conv kernels re-laid once for
    ``F.conv2d``."""

    def __init__(self, leaves: Dict[tuple, Dict[str, torch.Tensor]],
                 eps: float = 1e-5):
        self.leaves = leaves
        self.eps = eps
        self.calibrating = False
        self.fp8 = False  # the control: every Linear's operands in fp8
        # The served precision, to measure what its rounding alone does:
        # each conv and Linear in ``dtype`` (operands cast, the bias
        # rounded and added in ``dtype``), each BN in f32 on the rounded
        # input and rounded back, the heatmaps and the output in f32.
        self.dtype: Optional[torch.dtype] = None
        self._oihw: Dict[tuple, torch.Tensor] = {}

    def forget_layouts(self) -> None:
        """Drop the re-laid kernels after a kernel was changed in place."""
        self._oihw.clear()

    # ---------------------------------------------------------- layers
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
        if self.dtype is None:
            return F.conv2d(x, w, leaf["bias"], stride, pad)
        dt = self.dtype
        return F.conv2d(x.to(dt), w.to(dt), None, stride, pad) \
            + leaf["bias"].to(dt).view(1, -1, 1, 1)

    def bn(self, path: tuple, x: torch.Tensor) -> torch.Tensor:
        leaf = self.leaves[path]
        if self.calibrating:
            dims = [d for d in range(x.dim()) if d != 1]
            var, mean = torch.var_mean(x, dim=dims, unbiased=False)
            leaf["mean"].copy_(mean)
            leaf["var"].copy_(var)
        view = (1, -1) + (1,) * (x.dim() - 2)
        inv = torch.rsqrt(leaf["var"] + self.eps) * leaf["scale"]
        y = (x.to(torch.float32) - leaf["mean"].view(view)) * inv.view(view) \
            + leaf["bias"].view(view)
        return y if self.dtype is None else y.to(self.dtype)

    def dense(self, path: tuple, x: torch.Tensor) -> torch.Tensor:
        leaf = self.leaves[path]
        if self.calibrating:
            _centre(leaf["kernel"], x.mean(dim=0))
        if self.fp8:
            return fp8(x) @ fp8(leaf["kernel"]) + leaf["bias"]
        if self.dtype is not None:
            dt = self.dtype
            return x.to(dt) @ leaf["kernel"].to(dt) + leaf["bias"].to(dt)
        return x @ leaf["kernel"] + leaf["bias"]

    def _centred(self, conv: tuple, stream: torch.Tensor) -> torch.Tensor:
        """While calibrating, the residual stream's per-channel mean taken
        out through the bias of ``conv``, the branch's last conv: the
        stream leaves every block centred. Max-pooling otherwise adds some
        1.3 standard deviations of mean at each level of an hourglass, and
        bf16 rounds away the variation of a stream whose mean is several
        times its spread."""
        if not self.calibrating:
            return stream
        mean = stream.mean(dim=(0, 2, 3))
        self.leaves[conv]["bias"].sub_(mean)
        return stream - mean.view(1, -1, 1, 1)

    # -------------------------------------------------------- detector
    def res_module(self, p: tuple, x: torch.Tensor) -> torch.Tensor:
        skip = self.conv(p + ("conv_skip",), x) \
            if p + ("conv_skip",) in self.leaves else x
        h = self.conv(p + ("conv1",), F.relu(self.bn(p + ("bn1",), x)))
        h = self.conv(p + ("conv2",), F.relu(self.bn(p + ("bn2",), h)))
        h = self.conv(p + ("conv3",), F.relu(self.bn(p + ("bn3",), h)))
        return self._centred(p + ("conv3",), skip + h)

    def hourglass(self, p: tuple, x: torch.Tensor) -> torch.Tensor:
        up = self.res_module(p + ("res1",), x)
        low = self.res_module(p + ("res2",), F.max_pool2d(x, 2, 2))
        if p + ("sub", "res1", "bn1") in self.leaves:
            low = self.hourglass(p + ("sub",), low)
        else:
            low = self.res_module(p + ("waist",), low)
        low = self.res_module(p + ("res3",), low)
        return up + F.interpolate(low, scale_factor=2, mode="nearest")

    def detector(self, images: torch.Tensor, n_stacks: int
                 ) -> torch.Tensor:
        """images (B, H, W, 3) f32 in [0, 1] -> the last stack's heatmaps
        (B, J, H/4, W/4). Prefix ``("hourglass",)`` is the End2End tree's."""
        pre = ("hourglass",)
        x = images.permute(0, 3, 1, 2)
        if self.dtype is not None:
            x = x.to(self.dtype)
        h = F.relu(self.bn(pre + ("stem_bn",),
                           self.conv(pre + ("stem_conv",), x, stride=2)))
        h = self.res_module(pre + ("stem_res1",), h)
        h = self.res_module(pre + ("stem_res2",), F.max_pool2d(h, 2, 2))
        inter = self.res_module(pre + ("stem_res3",), h)
        for i in range(n_stacks):
            ll = self.hourglass(pre + (f"hg_{i}",), inter)
            ll = F.relu(self.bn(pre + (f"lin_{i}", "bn"),
                                self.conv(pre + (f"lin_{i}", "conv"), ll)))
            htmap = self.conv(pre + (f"htmap_{i}",), ll)
            if i < n_stacks - 1:
                inter = self._centred(
                    pre + (f"ll_bar_{i}",),
                    inter + self.conv(pre + (f"ll_bar_{i}",), ll)
                    + self.conv(pre + (f"htmap_bar_{i}",), htmap))
        return htmap.to(torch.float32)

    # ---------------------------------------------------------- lifter
    def lifter(self, x: torch.Tensor, prefix: tuple = ()) -> torch.Tensor:
        """(N, 32) z-scored 2D -> (N, 48) normalised 3D (eval mode: no
        dropout)."""
        def heavy(name, h):
            return F.relu(self.bn(prefix + (name, "bn"),
                                  self.dense(prefix + (name, "linear"), h)))

        h = heavy("encode", x if self.dtype is None else x.to(self.dtype))
        b = 0
        while prefix + (f"bilinear_{b}_0", "linear") in self.leaves:
            skip = h
            h = heavy(f"bilinear_{b}_1", heavy(f"bilinear_{b}_0", h))
            h = h + skip
            b += 1
        return self.dense(prefix + ("decode",), h).to(torch.float32)


def _centre(kernel: torch.Tensor, mean_in: torch.Tensor) -> None:
    """In place: take from a (kh, kw, in, out) kernel its response to the
    input's per-channel mean, so that the conv's output has the mean of its
    bias. Otherwise a conv output whose mean is several of its standard
    deviations loses most of its variation to bf16 rounding before the BN
    that follows takes the mean away."""
    v = mean_in.expand(kernel.shape[:-2] + (-1,)).reshape(-1)
    k = kernel.view(-1, kernel.shape[-1])
    k.sub_(torch.outer(v, v @ k) / (v @ v).clamp_min(1e-30))


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale for the tensor (its
    largest magnitude at e4m3's largest value, 448), back in f32: the
    precision below bf16 that fp8 inference computes in."""
    scale = t.abs().amax().clamp_min(1e-30) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def softargmax(heatmaps: torch.Tensor, temperature: float) -> torch.Tensor:
    """(B, J, H, W) -> (B, J, 2) soft (x, y) in heatmap pixels."""
    def expectation(marginal: torch.Tensor) -> torch.Tensor:
        z = temperature * marginal
        z = z - z.amax(dim=-1, keepdim=True)
        p = torch.exp(z.clamp(-80.0, 0.0))
        p = p / p.sum(dim=-1, keepdim=True)
        idx = torch.arange(marginal.shape[-1], dtype=marginal.dtype,
                           device=marginal.device)
        return (p * idx).sum(dim=-1)

    return torch.stack([expectation(heatmaps.sum(dim=-2)),
                        expectation(heatmaps.sum(dim=-1))], dim=-1)


def to_frame(pose_hm: torch.Tensor, centers: torch.Tensor,
             scales: torch.Tensor, size: int) -> torch.Tensor:
    """Heatmap pixels -> frame pixels of the crop box."""
    return centers[:, None, :] + (pose_hm - size // 2) / size * (
        scales[:, None, None] * 200.0)


def mpii_to_lifter(pose_img: torch.Tensor) -> torch.Tensor:
    """(B, 16, 2) MPII order -> (B, 32) H36M-16 order."""
    idx = torch.as_tensor(H36M16_FROM_MPII, device=pose_img.device)
    return pose_img.index_select(1, idx).reshape(pose_img.shape[0], -1)


class Stats:
    """The normalisation statistics both sides are given (f32, flat)."""

    def __init__(self, mean_part, std_part, mean_s, std_s):
        self.mean_part, self.std_part = mean_part, std_part
        self.mean_s, self.std_s = mean_s, std_s


def end2end(net: Net, cfg: dict, stats: Stats, frames: torch.Tensor,
            centers: Optional[torch.Tensor] = None,
            scales: Optional[torch.Tensor] = None):
    """frames (B, 256, 256, 3) u8 -> (pose2d (B, 16, 2) frame pixels in MPII
    order, pose3d (B, 16, 3) mm), the answer of End2End serving."""
    b = frames.shape[0]
    dev = frames.device
    if centers is None:
        centers = torch.full((b, 2), cfg["inputRes"] / 2.0, device=dev)
    if scales is None:
        scales = torch.full((b,), cfg["inputRes"] / 200.0, device=dev)
    images = frames.to(torch.float32) / 255.0
    heat = net.detector(images, cfg["nStack"])
    pose2d = to_frame(softargmax(heat, cfg["softargmax_temperature"]),
                      centers, scales, cfg["outputRes"])
    x = (mpii_to_lifter(pose2d) - stats.mean_part) / stats.std_part
    out = net.lifter(x, ("bilinear",))
    return pose2d, (out * stats.std_s + stats.mean_s).reshape(b, 16, 3)


def lift(net: Net, stats: Stats, keypoints: torch.Tensor) -> torch.Tensor:
    """(N, 16, 2) image-space keypoints -> (N, 16, 3) mm."""
    x = (keypoints.reshape(-1, 32).to(torch.float32) - stats.mean_part) \
        / stats.std_part
    out = net.lifter(x)
    return (out * stats.std_s + stats.mean_s).reshape(-1, 16, 3)
