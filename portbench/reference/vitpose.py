"""The plain reference of End2End with a ViTPose detector: ViTPose, the x10
soft-argmax decode and the 3d-pose-baseline lifter in float32 PyTorch,
read straight from the benchmark's seeded leaves (``vitpose_layout.py``).

A functional forward of ViTAE-Transformer/ViTPose's
``mmpose/models/backbones/vit.py`` and ``TopdownHeatmapSimpleHead`` as
``ViTPose_huge_mpii_256x192.py`` configures them, written op by op:

- the patch embedding, a conv (kernel ``patch_size``, stride ``patch_size
  // ratio``, padding ``4 + 2 * (ratio // 2 - 1)``) with its bias, the
  tokens in row-major order, then ``x + pos_embed[:, 1:] + pos_embed[:,
  :1]`` (no class token in the sequence);
- each block ``x = x + proj(attn(LN1(x)))``, ``x = x + fc2(GELU(fc1(
  LN2(x))))``: LayerNorm ``(x - mean) / sqrt(var + eps) * scale + bias``
  over the channels (biased variance, eps 1e-6); ``qkv`` split into q, k,
  v of ``num_heads`` heads; ``softmax(q k^T * head_dim^-0.5) v`` written
  out (the maximum subtracted, ``exp``, over the sum); GELU exact, ``0.5 x
  (1 + erf(x / sqrt 2))``;
- ``last_norm``, the tokens back to a (B, C, rows, columns) map, and the
  head: per deconvolution ``ConvTranspose2d`` (stride 2, kernel 4, padding
  1, no output padding, no bias), BN in eval mode, ReLU; then
  ``final_layer``, a 1x1 conv with a bias.

Departures from the published code: drop-path (0.55) is the identity, as
in eval mode; frames enter as u8 / 255, without mmpose's ImageNet
normalisation (the seeded weights are no trained ones). The decode and the
lifter are ``model.py``'s, but a heatmap pixel maps to the frame per axis
(``to_frame``). Nothing is folded, fused or cast: every operation is
float32, and the caller turns TF32 off.

The modes of ``model.Net`` hold here too. ``dtype`` (bf16) rounds where
the served program rounds: the patch conv's output, and after it the
patch bias and both position terms summed in f32 and rounded once; each
Linear's output (``addmm``: f32 accumulation, the bias added before one
rounding); each LayerNorm's output (f32 statistics on the rounded input,
its scale and bias rounded to ``dtype``); q, k and v, the unnormalised
softmax weights before their product with v (as flash attention does),
and the heads' output; GELU's output; each residual sum; each
deconvolution's output and each BN's; the heatmaps leave in f32. ``fp8``
gives every Linear and conv float8 e4m3 operands (the control). While
``calibrating`` is set the patch embedding's kernel first loses its
response to its input's per-channel mean and each BN takes its input's
statistics (the benchmark's data-dependent initialisation of the seeded
weights).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from portbench.reference.model import Net, Stats, _centre, fp8, \
    mpii_to_lifter, softargmax
from portbench.reference.vitpose_layout import grid, padding

PRE = ("hourglass",)
BB = PRE + ("backbone",)
HEAD = PRE + ("keypoint_head",)
F32 = torch.float32


def to_frame(pose_hm: torch.Tensor, centers: torch.Tensor,
             scales: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Heatmap pixels of an (H, W) heatmap -> frame pixels of the crop box,
    ``scale * 200`` px tall and ``scale * 200 * W / H`` wide, each axis by
    its own size."""
    h, w = size
    tall = scales[:, None] * 200.0
    x = centers[:, None, 0] + (pose_hm[..., 0] - w // 2) / w * (tall * w
                                                                / h)
    y = centers[:, None, 1] + (pose_hm[..., 1] - h // 2) / h * tall
    return torch.stack([x, y], dim=-1)


class ViTPose(Net):
    """``model.Net`` with ViTPose's detector over the leaves of
    ``vitpose_layout.model_leaves``."""

    def __init__(self, leaves, cfg: dict):
        super().__init__(leaves, cfg["bn_eps"])
        self.cfg = cfg
        self.ln_eps = cfg["backbone"]["ln_eps"]

    # ---------------------------------------------------------- layers
    def _w(self, path: tuple, order: tuple) -> torch.Tensor:
        """A (kh, kw, in, out) kernel permuted to ``order``, kept."""
        w = self._oihw.get(path)
        if w is None:
            w = self._oihw[path] = self.leaves[path]["kernel"] \
                .permute(*order).contiguous()
        return w

    def linear(self, path: tuple, x: torch.Tensor) -> torch.Tensor:
        """x (..., in) @ kernel + bias."""
        leaf = self.leaves[path]
        k, b = leaf["kernel"], leaf["bias"]
        if self.fp8:
            return fp8(x) @ fp8(k) + b
        if self.dtype is None:
            return x @ k + b
        dt = self.dtype
        y = torch.addmm(b.to(dt), x.reshape(-1, x.shape[-1]).to(dt),
                        k.to(dt))
        return y.view(x.shape[:-1] + (-1,))

    def ln(self, path: tuple, x: torch.Tensor) -> torch.Tensor:
        leaf = self.leaves[path]
        w, b = leaf["scale"], leaf["bias"]
        if self.dtype is not None:
            w, b = w.to(self.dtype).to(F32), b.to(self.dtype).to(F32)
        xf = x.to(F32)
        mean = xf.mean(dim=-1, keepdim=True)
        var = (xf - mean).square().mean(dim=-1, keepdim=True)
        y = (xf - mean) / torch.sqrt(var + self.ln_eps) * w + b
        return y if self.dtype is None else y.to(self.dtype)

    def conv(self, path: tuple, x: torch.Tensor, stride: int = 1,
             pad: Optional[int] = None) -> torch.Tensor:
        """A conv and its bias (``patch_embed.proj``'s bias is added by
        ``patch_embed``)."""
        w = self._w(path, (3, 2, 0, 1))
        pad = (w.shape[-1] - 1) // 2 if pad is None else pad
        bias = self.leaves[path]["bias"]
        if self.fp8:
            return F.conv2d(fp8(x), fp8(w), bias, stride, pad)
        if self.dtype is None:
            return F.conv2d(x, w, bias, stride, pad)
        dt = self.dtype
        return F.conv2d(x.to(dt), w.to(dt), None, stride, pad) \
            + bias.to(dt).view(1, -1, 1, 1)

    def deconv(self, path: tuple, x: torch.Tensor) -> torch.Tensor:
        """ConvTranspose2d, stride 2, bias-free; padding 1 and no output
        padding for a kernel of 4 (mmpose's ``_get_deconv_cfg``)."""
        w = self._w(path, (2, 3, 0, 1))  # (in, out, kh, kw)
        k = w.shape[-1]
        pad, out_pad = {4: (1, 0), 3: (1, 1), 2: (0, 0)}[k]
        if self.fp8:
            x, w = fp8(x), fp8(w)
        elif self.dtype is not None:
            x, w = x.to(self.dtype), w.to(self.dtype)
        return F.conv_transpose2d(x, w, None, 2, pad, out_pad)

    # ---------------------------------------------------------- blocks
    def patch_embed(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) -> tokens (B, rows x columns, C), positions
        added."""
        cfg = self.cfg["backbone"]
        path = BB + ("patch_embed", "proj")
        x = images.permute(0, 3, 1, 2)
        stride = cfg["patch_size"] // cfg["ratio"]
        pos = self.leaves[BB + ("pos_embed",)]["value"]
        bias = self.leaves[path]["bias"]
        if self.calibrating:
            _centre(self.leaves[path]["kernel"], x.mean(dim=(0, 2, 3)))
            self._oihw.pop(path, None)
        if self.dtype is not None and not self.fp8:
            dt = self.dtype
            w = self._w(path, (3, 2, 0, 1))
            y = F.conv2d(x.to(dt), w.to(dt), None, stride, padding(
                self.cfg))
            tokens = y.flatten(2).transpose(1, 2)
            return tokens + (bias + pos[:, 1:] + pos[:, :1]).to(dt)
        y = self.conv(path, x, stride, padding(self.cfg))
        tokens = y.flatten(2).transpose(1, 2)
        return tokens + pos[:, 1:] + pos[:, :1]

    def attention(self, p: tuple, x: torch.Tensor) -> torch.Tensor:
        b, t, c = x.shape
        heads = self.cfg["backbone"]["num_heads"]
        d = c // heads
        qkv = self.linear(p + ("qkv",), x).reshape(b, t, 3, heads, d) \
            .permute(2, 0, 3, 1, 4)
        q, k, v = (z.to(F32) for z in qkv)
        z = (q @ k.transpose(-2, -1)) * d ** -0.5
        e = torch.exp(z - z.amax(dim=-1, keepdim=True))
        total = e.sum(dim=-1, keepdim=True)
        if self.dtype is not None and not self.fp8:
            e = e.to(self.dtype).to(F32)
        o = (e @ v) / total
        o = o.transpose(1, 2).reshape(b, t, c)
        if self.dtype is not None:
            o = o.to(self.dtype)
        return self.linear(p + ("proj",), o)

    def mlp(self, p: tuple, x: torch.Tensor) -> torch.Tensor:
        h = self.linear(p + ("fc1",), x).to(F32)
        g = 0.5 * h * (1.0 + torch.erf(h / math.sqrt(2.0)))
        if self.dtype is not None:
            g = g.to(self.dtype)
        return self.linear(p + ("fc2",), g)

    def block(self, p: tuple, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attention(p + ("attn",), self.ln(p + ("norm1",), x))
        return x + self.mlp(p + ("mlp",), self.ln(p + ("norm2",), x))

    # -------------------------------------------------------- detector
    def detector(self, images: torch.Tensor) -> torch.Tensor:
        """images (B, H, W, 3) f32 in [0, 1] -> heatmaps (B, J, 4 rows, 4
        columns) f32."""
        cfg = self.cfg
        x = self.patch_embed(images)
        for i in range(cfg["backbone"]["depth"]):
            x = self.block(BB + ("blocks", str(i)), x)
        x = self.ln(BB + ("last_norm",), x)
        rows, cols = grid(cfg)
        x = x.transpose(1, 2).reshape(x.shape[0], -1, rows, cols)
        for n in range(cfg["keypoint_head"]["num_deconv_layers"]):
            p = HEAD + ("deconv_layers",)
            y = self.deconv(p + (str(3 * n),), x)
            x = F.relu(self.bn(p + (str(3 * n + 1),), y))
        return self.conv(HEAD + ("final_layer",), x).to(F32)


def end2end(net: ViTPose, stats: Stats, frames: torch.Tensor,
            centers: Optional[torch.Tensor] = None,
            scales: Optional[torch.Tensor] = None):
    """frames (B, H, W, 3) u8 -> (pose2d (B, 16, 2) frame pixels in MPII
    order, pose3d (B, 16, 3) mm), the answer of End2End serving; the
    default box is centred on the crop, ``H / 200`` its scale."""
    cfg = net.cfg
    b, h, w = frames.shape[:3]
    dev = frames.device
    if centers is None:
        centers = torch.tensor([[w / 2.0, h / 2.0]], device=dev).expand(b, 2)
    if scales is None:
        scales = torch.full((b,), h / 200.0, device=dev)
    heat = net.detector(frames.to(F32) / 255.0)
    pose2d = to_frame(softargmax(heat, cfg["softargmax_temperature"]),
                      centers, scales, tuple(heat.shape[-2:]))
    x = (mpii_to_lifter(pose2d) - stats.mean_part) / stats.std_part
    out = net.lifter(x, ("bilinear",))
    return pose2d, (out * stats.std_s + stats.mean_s).reshape(b, 16, 3)
