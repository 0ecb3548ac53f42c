"""ViTPose-H, the pose detector of Xu, Zhang, Zhang, Tao: ViTPose: Simple
Vision Transformer Baselines for Human Pose Estimation (NeurIPS 2022), as
ViTAE-Transformer/ViTPose's ``mmpose/models/backbones/vit.py`` and
``TopdownHeatmapSimpleHead`` build it for
``configs/body/2d_kpt_sview_rgb_img/topdown_heatmap/mpii/
ViTPose_huge_mpii_256x192.py``, with their state_dict names
(``backbone.patch_embed.proj``, ``backbone.pos_embed``,
``backbone.blocks.{i}.{norm1, attn.qkv, attn.proj, norm2, mlp.fc1,
mlp.fc2}``, ``backbone.last_norm``, ``keypoint_head.deconv_layers.{0, 1,
3, 4}``, ``keypoint_head.final_layer``), so a published checkpoint maps
onto it by name.

- Patch embedding: a 16 x 16 conv, stride 16, padding 2, 3 -> 1280, with a
  bias: 16 x 12 = 192 tokens of a 256 x 192 crop, in row-major order;
  then ``x + pos_embed[:, 1:] + pos_embed[:, :1]`` (``pos_embed`` holds
  one more row than there are tokens; no class token is in the sequence).
- 32 pre-norm blocks: ``x = x + proj(attn(norm1(x)))``, ``x = x + fc2(
  GELU(fc1(norm2(x))))``; LayerNorm eps 1e-6; ``qkv`` a Linear 1280 ->
  3840 with a bias, 16 heads of 80, ``softmax(q k^T / sqrt(80)) v`` over
  all tokens; the MLP 1280 -> 5120 -> 1280 with exact (erf) GELU.
  Drop-path is the identity in eval mode.
- ``last_norm``, then the tokens as a (B, 1280, 16, 12) map.
- Head: twice a ConvTranspose2d (kernel 4, stride 2, padding 1, no bias)
  to 256 channels, BN, ReLU; then ``final_layer``, a 1x1 conv 256 -> 16
  with a bias: 64 x 48 heatmaps, one per MPII joint.

``forward`` takes (B, H, W, 3) images in [0, 1] and returns (1, B, H/4,
W/4, J) f32 heatmaps: the detectors' layout, with one stage where the
hourglasses have one per stack. ``embed_dim``, ``depth``, ``heads`` and
``image_size`` default to ViT-H's at 256 x 192; smaller ones are for the
CPU tests. ``input_size`` and ``heatmap_size`` (H, W) say what a server
feeds and decodes.

Precision, in ``dtype`` (bf16 on the card): parameters in f32 and each
Linear in ``dtype`` with f32 accumulation, its bias added before the one
rounding; each LayerNorm's statistics in f32 on the rounded input, its
scale and bias in ``dtype``, the output rounded to ``dtype``; attention by
``F.scaled_dot_product_attention`` on ``dtype`` q, k and v, and on a card
with no math fallback (flash, cuDNN or memory-efficient attention only; if
none takes the shapes it raises); GELU and the residual adds in
``dtype``; the patch conv's output rounded, then the patch bias and both
position rows summed in f32 and added as one rounded table; each
deconvolution in ``dtype`` and its BN in f32 on the rounded output,
rounded back; the head's final conv in f32 out.

Eval plan. The model runs in eval mode only (it is served, not trained; a
forward in train mode raises) and always from its plan: ``build_eval_plan``
casts every Linear and LayerNorm weight and bias to ``dtype`` once
(``qkv`` whole), the convs' and deconvolutions' weights to ``dtype`` in
channels_last, sums the position table, and turns each head BN into an f32
(scale, shift) table (``ops.conv_epilogue.bn_affine``). ``End2EndServer``
builds it on each model it builds, after the load and the move to its
device; otherwise the first eval forward builds it, and ``train()``, a
move or cast (``.to``, ``.cuda``, ...) and ``load_state_dict`` drop it, so
it always reads the parameters as they are. A forward casts no weight:
each head BN and its ReLU, and ``final_layer``'s bias and f32 output, run
as one ``ops.conv_epilogue.conv_epilogue`` call each (kernel K8 on the
card): 3 a forward. The class attributes say what the port runs it with:
no int8 path, no spatially sharded forward, served and not trained.

Spans (``utils/profiling.py::span``), ``SPANS``: ``vit.patch_embed``,
``vit.blocks`` (around all blocks), ``vit.attention`` and ``vit.mlp`` (in
each block: its norm, its products and its residual add) and ``vit.head``.
``ATTENTION_CALLS`` counts the attention calls by the backend torch
chooses for them (``flash``, ``cudnn``, ``efficient``; ``math`` on the CPU
only), asked once for each shape, dtype and device; a trace's kernel names
say which kernel ran.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from bilinear_tpu_torch.core.norm import BatchNorm2d
from bilinear_tpu_torch.core.precision import CL, wide
from bilinear_tpu_torch.ops.conv_epilogue import bn_affine, conv_epilogue
from bilinear_tpu_torch.utils.profiling import span

EMBED_DIM = 1280
DEPTH = 32
HEADS = 16
MLP_RATIO = 4
PATCH = 16
PATCH_PADDING = 2  # vit.py's 4 + 2 * (ratio // 2 - 1) at ratio 1
IMAGE_SIZE = (256, 192)  # (H, W)
DECONV = (256, 256)
N_JOINTS = 16
LN_EPS = 1e-6
BN_MOMENTUM = 0.1
SPANS = ("vit.patch_embed", "vit.blocks", "vit.attention", "vit.mlp",
         "vit.head")

# Attention calls by the backend torch chooses for them.
ATTENTION_CALLS = {"flash": 0, "cudnn": 0, "efficient": 0, "math": 0}
# torch's SDPBackend values, as ``torch._fused_sdp_choice`` returns them.
_BACKENDS = {0: "math", 1: "flash", 2: "efficient", 3: "cudnn"}
# (shape, dtype, device) of q -> the backend chosen for it.
_CHOICES: Dict[tuple, str] = {}


def _grid(image_size: Sequence[int]) -> Tuple[int, int]:
    """(rows, columns) of patch tokens of an (H, W) crop."""
    return tuple((n + 2 * PATCH_PADDING - PATCH) // PATCH + 1
                 for n in image_size)


class EvalPlan(NamedTuple):
    """What an eval forward reads in place of the parameters: each Linear's,
    LayerNorm's and conv's (weight, bias) in the model's dtype (convs in
    channels_last, bias None where the conv's is added elsewhere), the
    position table (the patch bias and both position rows, summed in f32,
    rounded), and the head's f32 (2, C) tables: each BN's (scale, shift),
    ``final_layer``'s (1, its bias rounded to the dtype)."""

    weights: Dict[nn.Module, Tuple[torch.Tensor, Optional[torch.Tensor]]]
    positions: torch.Tensor
    affines: Dict[nn.Module, torch.Tensor]


class PatchEmbed(nn.Module):
    def __init__(self, embed_dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, embed_dim, PATCH, stride=PATCH,
                              padding=PATCH_PADDING)


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class Block(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, MLP_RATIO * dim)


class ViT(nn.Module):
    """The backbone's parameters: ``patch_embed``, ``pos_embed``, ``blocks``
    and ``last_norm``."""

    def __init__(self, embed_dim: int, depth: int, heads: int,
                 tokens: int):
        super().__init__()
        self.patch_embed = PatchEmbed(embed_dim)
        self.pos_embed = nn.Parameter(torch.zeros(1, tokens + 1, embed_dim))
        self.blocks = nn.ModuleList(Block(embed_dim, heads)
                                    for _ in range(depth))
        self.last_norm = nn.LayerNorm(embed_dim, eps=LN_EPS)


class Head(nn.Module):
    """TopdownHeatmapSimpleHead's parameters: ``deconv_layers`` (deconv,
    BN, ReLU, twice) and ``final_layer``."""

    def __init__(self, in_channels: int, n_joints: int):
        super().__init__()
        layers = []
        for c in DECONV:
            layers += [nn.ConvTranspose2d(in_channels, c, 4, stride=2,
                                          padding=1, bias=False),
                       BatchNorm2d(c, momentum=BN_MOMENTUM), nn.ReLU()]
            in_channels = c
        self.deconv_layers = nn.Sequential(*layers)
        self.final_layer = nn.Conv2d(in_channels, n_joints, 1)


def _fused_only(device: torch.device):
    """On a card, a context in which attention may take the flash, cuDNN
    or memory-efficient kernels and not the math backend (torch raises if
    none takes the shapes); on the CPU, no context."""
    if device.type != "cuda":
        return contextlib.nullcontext()
    from torch.nn.attention import SDPBackend, sdpa_kernel

    return sdpa_kernel([SDPBackend.FLASH_ATTENTION,
                        SDPBackend.CUDNN_ATTENTION,
                        SDPBackend.EFFICIENT_ATTENTION])


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
          ) -> torch.Tensor:
    """``F.scaled_dot_product_attention`` at its default scale, counted by
    the backend torch chooses for it (``torch._fused_sdp_choice``, the
    choice the call makes, asked on a shape's first call)."""
    key = (q.shape, q.dtype, q.device)
    if key not in _CHOICES:
        _CHOICES[key] = _BACKENDS[int(torch._fused_sdp_choice(q, k, v))]
    ATTENTION_CALLS[_CHOICES[key]] += 1
    return F.scaled_dot_product_attention(q, k, v)


class ViTPose(nn.Module):
    """The whole detector: ``backbone`` and ``keypoint_head``."""

    # No spatial sharding: attention joins every token of the crop.
    variant = "vitpose"
    fused_blocks = False
    int8_convs = False
    trainable = False
    spatial_sharding = False
    eval_plan = True
    input_size = IMAGE_SIZE
    heatmap_size = (64, 48)  # 4 x the 16 x 12 tokens
    size_args = {k: k for k in ("embed_dim", "depth", "heads",
                                "image_size")}

    def __init__(self, embed_dim: int = EMBED_DIM, depth: int = DEPTH,
                 heads: int = HEADS,
                 image_size: Sequence[int] = IMAGE_SIZE,
                 n_joints: int = N_JOINTS, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if embed_dim % heads:
            raise ValueError(f"embed_dim {embed_dim} is no multiple of "
                             f"{heads} heads")
        self.dtype = dtype
        self.grid = _grid(image_size)
        self.input_size = tuple(image_size)
        self.heatmap_size = tuple(4 * n for n in self.grid)
        self.plan: Optional[EvalPlan] = None
        self.backbone = ViT(embed_dim, depth, heads,
                            self.grid[0] * self.grid[1])
        self.keypoint_head = Head(embed_dim, n_joints)
        init_weights(self, generator)

    @torch.no_grad()
    def build_eval_plan(self) -> "ViTPose":
        """Prepare the eval plan from the parameters and running statistics
        as they are now, on their device. Returns the model."""
        dt = self.dtype
        at = wide(dt)
        weights, affines = {}, {}
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.LayerNorm)):
                weights[m] = (m.weight.to(dt), m.bias.to(dt))
            elif isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                weights[m] = (m.weight.to(dt).contiguous(memory_format=CL),
                              None)
            elif isinstance(m, nn.BatchNorm2d):
                affines[m] = bn_affine(m, at)
        final = self.keypoint_head.final_layer
        bias = final.bias.to(dt).to(at)
        affines[final] = torch.stack([torch.ones_like(bias), bias])
        self.plan = EvalPlan(weights, self._positions(), affines)
        return self

    def _positions(self) -> torch.Tensor:
        """The patch bias and both position rows, summed in f32 and rounded
        to the dtype: (1, tokens, C)."""
        pos = self.backbone.pos_embed
        table = self.backbone.patch_embed.proj.bias + pos[:, 1:] + pos[:, :1]
        return table.to(self.dtype)

    def train(self, mode: bool = True) -> "ViTPose":
        if mode:
            self.plan = None
        return super().train(mode)

    def _apply(self, *args, **kwargs):
        self.plan = None  # a move or a cast: the plan holds the old tensors
        return super()._apply(*args, **kwargs)

    def _load_from_state_dict(self, *args, **kwargs):
        self.plan = None
        return super()._load_from_state_dict(*args, **kwargs)

    # ---------------------------------------------------------- layers
    def _linear(self, m: nn.Linear, x: torch.Tensor,
                plan: EvalPlan) -> torch.Tensor:
        return F.linear(x, *plan.weights[m])

    def _norm(self, m: nn.LayerNorm, x: torch.Tensor,
              plan: EvalPlan) -> torch.Tensor:
        return F.layer_norm(x, m.normalized_shape, *plan.weights[m], m.eps)

    def _attention(self, blk: Block, x: torch.Tensor,
                   plan: EvalPlan) -> torch.Tensor:
        b, t, c = x.shape
        heads = blk.attn.heads
        qkv = self._linear(blk.attn.qkv, self._norm(blk.norm1, x, plan),
                           plan)
        q, k, v = qkv.view(b, t, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
        o = _sdpa(q, k, v).transpose(1, 2).reshape(b, t, c)
        return x + self._linear(blk.attn.proj, o, plan)

    def _mlp(self, blk: Block, x: torch.Tensor,
             plan: EvalPlan) -> torch.Tensor:
        h = self._linear(blk.mlp.fc1, self._norm(blk.norm2, x, plan), plan)
        return x + self._linear(blk.mlp.fc2, F.gelu(h), plan)

    def _head(self, x: torch.Tensor, plan: EvalPlan) -> torch.Tensor:
        """(B, C, rows, columns) in the dtype -> (B, J, 4 rows, 4
        columns) f32 heatmaps."""
        layers = self.keypoint_head.deconv_layers
        for deconv, bn in ((layers[0], layers[1]), (layers[3], layers[4])):
            y = F.conv_transpose2d(x, plan.weights[deconv][0], None,
                                   deconv.stride, deconv.padding)
            x = conv_epilogue([(y.contiguous(memory_format=CL),
                                plan.affines[bn])], relu=True)
        final = self.keypoint_head.final_layer
        heat = F.conv2d(x, plan.weights[final][0])
        return conv_epilogue([(heat.contiguous(memory_format=CL),
                               plan.affines[final])],
                             out_dtype=wide(self.dtype))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise ValueError("the 'vitpose' variant runs in eval mode only: "
                             "the port serves it, it does not train it; "
                             "call .eval() first")
        if self.plan is None:
            self.build_eval_plan()
        plan, dt, bb = self.plan, self.dtype, self.backbone
        b = images.shape[0]
        rows, cols = self.grid
        with span("vit.patch_embed"):
            x = images.permute(0, 3, 1, 2).to(dt).contiguous(
                memory_format=CL)
            y = F.conv2d(x, plan.weights[bb.patch_embed.proj][0], None,
                         PATCH, PATCH_PADDING)
            # channels_last (B, C, rows, cols) read as (B, tokens, C)
            x = y.permute(0, 2, 3, 1).reshape(b, rows * cols, -1) \
                + plan.positions
        with span("vit.blocks"), _fused_only(x.device):
            for blk in bb.blocks:
                with span("vit.attention"):
                    x = self._attention(blk, x, plan)
                with span("vit.mlp"):
                    x = self._mlp(blk, x, plan)
        with span("vit.head"):
            x = self._norm(bb.last_norm, x, plan)
            # (B, tokens, C) read as a channels_last (B, C, rows, cols)
            x = x.view(b, rows, cols, -1).permute(0, 3, 1, 2)
            heat = self._head(x, plan)
            return heat.permute(0, 2, 3, 1).unsqueeze(0)


@torch.no_grad()
def init_weights(model: ViTPose,
                 generator: Optional[torch.Generator] = None) -> None:
    """vit.py's and the head's initialisation without a checkpoint, drawn
    from ``generator``: Linears and ``pos_embed`` N(0, 0.02^2) (vit.py
    truncates at 2 standard deviations; this does not), their biases 0,
    LayerNorms at 1 and 0; the patch conv N(0, 2 / fan_in), its bias 0;
    the head's deconvolutions and ``final_layer`` N(0, 0.001^2),
    ``final_layer``'s bias 0; BN at gamma 1, beta 0."""
    for m in model.modules():
        if isinstance(m, nn.Linear):
            m.weight.normal_(0.0, 0.02, generator=generator)
            m.bias.zero_()
        elif isinstance(m, (nn.ConvTranspose2d, nn.Conv2d)):
            fan_in = m.weight[0].numel()
            std = math.sqrt(2.0 / fan_in) if m is \
                model.backbone.patch_embed.proj else 0.001
            m.weight.normal_(0.0, std, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
    model.backbone.pos_embed.normal_(0.0, 0.02, generator=generator)
