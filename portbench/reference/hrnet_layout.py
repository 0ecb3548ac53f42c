"""The leaves of End2End with an HRNet detector, in the ``.save`` tree the
port's ``End2EndServer(variant="hrnet")`` takes: the detector under
``hourglass`` with pose_hrnet.py's module names, one tree level per dotted
component (``stage2.0.branches.1.3.conv1`` is the path ``("stage2", "0",
"branches", "1", "3", "conv1")``), and the lifter under ``bilinear`` as
``layout.py`` lays it out.

A leaf is ``(path, kind, shape)`` as in ``layout.py``, with one more kind:

- ``conv``: a bias-free conv, ``kernel`` (kh, kw, in, out) alone;
- ``conv_b``: ``kernel`` and ``bias`` (out,) (``final_layer``);
- ``bn``, ``dense``: as in ``layout.py``.

``walk`` gives the same leaves with one more field, a conv's output stride
(frame pixels per output pixel; None for a BN), which ``work_hrnet.py``
counts operations from.

The network (``lib/models/pose_hrnet.py``, configured by a yaml such as
``experiments/mpii/hrnet/w48_256x256_adam_lr1e-3.yaml``): a stem of two
3x3/s2 convs with BN; ``layer1``, Bottlenecks (1x1, 3x3, 1x1 x4, each conv
then BN; a 1x1 + BN downsample where the channels change); then per stage a
transition (a 3x3 conv + BN where a branch's channels change, a chain of
3x3/s2 convs + BN from the last branch for a new one) and its modules, each
of BasicBlocks per branch (3x3 + BN twice) and the exchange
``fuse_layers.{i}.{j}`` (j > i: 1x1 conv + BN; j < i: i - j 3x3/s2 convs +
BN, the last to branch i's channels); the last module of the last stage
gives branch 0 only; ``final_layer`` a 1x1 conv with a bias.
"""
from __future__ import annotations

from typing import Iterator, Optional, Tuple

from portbench.reference import layout

Step = Tuple[tuple, str, tuple, Optional[int]]
STAGES = ("stage2", "stage3", "stage4")


def _conv(path: tuple, k: int, ci: int, co: int, stride: int,
          bias: bool = False) -> Iterator[Step]:
    yield path, "conv_b" if bias else "conv", (k, k, ci, co), stride


def _conv_bn(path: tuple, k: int, ci: int, co: int, stride: int
             ) -> Iterator[Step]:
    """A published (conv, BN, ...) Sequential: ``{path}.0``, ``{path}.1``."""
    yield from _conv(path + ("0",), k, ci, co, stride)
    yield path + ("1",), "bn", (co,), None


def walk(cfg: dict) -> Iterator[Step]:
    """Every leaf of the detector in registration order, with each conv's
    output stride."""
    l1 = cfg["layer1"]
    c0, wide = l1["num_channels"], l1["num_channels"] * l1["expansion"]
    yield from _conv(("conv1",), 3, 3, c0, 2)
    yield ("bn1",), "bn", (c0,), None
    yield from _conv(("conv2",), 3, c0, c0, 4)
    yield ("bn2",), "bn", (c0,), None
    inplanes = c0
    for k in range(l1["num_blocks"]):
        p = ("layer1", str(k))
        for name, size, ci, co in (("1", 1, inplanes, c0), ("2", 3, c0, c0),
                                   ("3", 1, c0, wide)):
            yield from _conv(p + ("conv" + name,), size, ci, co, 4)
            yield p + ("bn" + name,), "bn", (co,), None
        if inplanes != wide:
            yield from _conv_bn(p + ("downsample",), 1, inplanes, wide, 4)
        inplanes = wide
    pre = [wide]
    for s, stage in enumerate(STAGES):
        st = cfg[stage]
        cur = st["num_channels"]
        t = (f"transition{s + 1}",)
        for i, c in enumerate(cur):
            if i < len(pre):
                if c != pre[i]:
                    yield from _conv_bn(t + (str(i),), 3, pre[i], c,
                                        4 * 2 ** i)
                continue
            for k in range(i + 1 - len(pre)):
                co = c if k == i - len(pre) else pre[-1]
                yield from _conv_bn(t + (str(i), str(k)), 3, pre[-1], co,
                                    4 * 2 ** (len(pre) + k))
        for m in range(st["num_modules"]):
            p = (stage, str(m))
            for i, c in enumerate(cur):
                for k in range(st["num_blocks"][i]):
                    b = p + ("branches", str(i), str(k))
                    for n in ("1", "2"):
                        yield from _conv(b + ("conv" + n,), 3, c, c,
                                         4 * 2 ** i)
                        yield b + ("bn" + n,), "bn", (c,), None
            last = s == len(STAGES) - 1 and m == st["num_modules"] - 1
            for i in range(1 if last else len(cur)):
                for j, cj in enumerate(cur):
                    f = p + ("fuse_layers", str(i), str(j))
                    if j > i:
                        yield from _conv_bn(f, 1, cj, cur[i], 4 * 2 ** j)
                    for k in range(i - j):
                        co = cur[i] if k == i - j - 1 else cj
                        yield from _conv_bn(f + (str(k),), 3, cj, co,
                                            4 * 2 ** (j + k + 1))
        pre = cur
    yield from _conv(("final_layer",), cfg["final_conv_kernel"], pre[0],
                     cfg["nParts"], 4, bias=True)


def model_leaves(cfg: dict) -> Iterator[layout.Leaf]:
    """Every leaf of End2End, the detector's under ``hourglass`` and the
    lifter's under ``bilinear``."""
    for path, kind, shape, _ in walk(cfg):
        yield ("hourglass",) + path, kind, shape
    for path, kind, shape in layout.lifter_leaves(cfg["lifter"]):
        yield ("bilinear",) + path, kind, shape
