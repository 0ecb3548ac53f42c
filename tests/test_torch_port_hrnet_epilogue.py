"""Kernel K8 (``ops/conv_epilogue.py``) and HRNet's eval plan
(``models/hrnet.py::PoseHighResolutionNet.build_eval_plan``). On the CPU:
the plain epilogue against the composition it replaces (``conv_in``,
``bn_in``, the adds, ``nn.Upsample`` and ``torch.relu``) at each of its uses
in f32 and bf16; a planned model at width 8 against the same model without
a plan and the benchmark's reference; the plan's lifetime (``train()``
drops it, ``End2EndServer.reload`` builds a new one); the epilogues and
spans of a forward. The tests marked ``cuda`` run on the card (``python -m
pytest tests/test_torch_port_hrnet_epilogue.py -m cuda --noconftest -q``)
and skip without one: K8 against its plain version at HRNet-W48's served
shapes, and a served 128-frame chunk through K8. The file imports no
JAX."""
import copy
import json
import os
import types

import numpy as np
import pytest
import torch
from torch import nn
from torch.profiler import ProfilerActivity, profile

from bilinear_tpu_torch.core.norm import BatchNorm2d
from bilinear_tpu_torch.io.checkpoint import save_checkpoint
from bilinear_tpu_torch.models import hrnet
from bilinear_tpu_torch.core.precision import CL, bn_in, conv_in
from bilinear_tpu_torch.ops import conv_epilogue as ce
from bilinear_tpu_torch.serving import End2EndServer
from portbench import pose_hrnet, seeds
from torch_port_hrnet_fixtures import (ROOT, WIDTH, _images, _max_rel,
                                       _port, _reference, _stats,
                                       _whole_batch, seeded)  # noqa: F401

F32, BF16 = torch.float32, torch.bfloat16
DTYPES = {"f32": F32, "bf16": BF16}

# Each use of the epilogue in HRNet: (channels, output size, terms, ReLU).
# A term is ("bn", m), a conv's raw output at 1/2^m of the output's size
# with its BN, or ("x", m), an activation; "head" is final_layer's conv
# with its bias, written in f32.
USES = {
    "stem": (64, 32, [("bn", 0)], True),
    "basic_block_conv1": (16, 16, [("bn", 0)], True),
    "basic_block_conv2": (16, 16, [("bn", 0), ("x", 0)], True),
    "bottleneck_identity": (32, 16, [("bn", 0), ("x", 0)], True),
    "bottleneck_downsample": (32, 16, [("bn", 0), ("bn", 0)], True),
    "exchange_row0_up_1_2_3": (8, 32, [("x", 0), ("bn", 1), ("bn", 2),
                                       ("bn", 3)], True),
    "exchange_row2_down_down_up": (32, 8, [("bn", 0), ("bn", 0), ("x", 0),
                                           ("bn", 1)], True),
    "exchange_strided_step": (8, 8, [("bn", 0)], True),
    "transition": (24, 16, [("bn", 0)], True),
    "head": (16, 16, [("head", 0)], False),
}
BATCH = 4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Torch on one intra-op thread, as ``torch_port_fixtures.
    one_torch_thread`` (whose module imports JAX): the suite's worker
    processes share the machine."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _bn(c: int, gen: torch.Generator) -> BatchNorm2d:
    """An eval BN with scrambled parameters and running statistics."""
    bn = BatchNorm2d(c, momentum=0.1).eval()
    with torch.no_grad():
        bn.weight.uniform_(0.2, 2.0, generator=gen)
        bn.bias.normal_(0.0, 0.5, generator=gen)
        bn.running_mean.normal_(0.0, 0.5, generator=gen)
        bn.running_var.uniform_(0.5, 2.0, generator=gen)
    return bn


def _act(c: int, size: int, dtype, gen: torch.Generator,
         batch: int) -> torch.Tensor:
    x = torch.randn(batch, c, size, size, generator=gen)
    return x.to(dtype).contiguous(memory_format=CL)


def _use(spec, dtype, seed: int, device="cpu", batch: int = BATCH):
    """(terms for the epilogue, today's composition of the same terms, the
    per-element largest magnitude along the way, relu, out dtype) for one
    use (an entry of ``USES``), on seeded data."""
    c, size, kinds, relu = spec
    gen = torch.Generator().manual_seed(seed)
    terms, comp, mags = [], None, None
    with torch.no_grad():
        for kind, m in kinds:
            x = _act(WIDTH if kind == "head" else c, size >> m, dtype, gen,
                     batch)
            if kind == "x":
                terms.append((x, None))
                t = x
            elif kind == "bn":
                bn = _bn(c, gen)
                table = ce.bn_affine(bn)
                terms.append((x, table))
                t = bn_in(bn, x, dtype)
                product = x.float() * table[0].view(1, -1, 1, 1)
                if m:
                    product = nn.Upsample(scale_factor=2 ** m)(product)
                mag = product.abs()
                mags = mag if mags is None else torch.maximum(mags, mag)
            else:
                conv = nn.Conv2d(WIDTH, c, 1)
                conv.bias.normal_(0.0, 0.5, generator=gen)
                raw = torch.nn.functional.conv2d(x, conv.weight.to(dtype))
                bias = conv.bias.to(dtype).float()
                terms.append((raw, torch.stack([torch.ones_like(bias),
                                                bias])))
                t = conv_in(conv, x, dtype)
            if m:
                t = nn.Upsample(scale_factor=2 ** m, mode="nearest")(t)
            mag = t.float().abs()
            mags = mag if mags is None else torch.maximum(mags, mag)
            comp = t if comp is None else comp + t
        if relu:
            comp = torch.relu(comp)
    out_dtype = F32 if kinds[0][0] == "head" else None
    if out_dtype is not None:
        comp = comp.to(out_dtype)
    terms = [(x.to(device), None if a is None else a.to(device))
             for x, a in terms]
    return terms, comp.to(device), torch.maximum(
        mags, comp.float().abs()).to(device), relu, out_dtype


def _ulp_bf16(v: torch.Tensor) -> torch.Tensor:
    """One unit in the last place of bf16 at |v| (8 significant bits)."""
    _, e = torch.frexp(v.float().abs())
    return torch.ldexp(torch.ones_like(v, dtype=F32), e - 8)


def _assert_rounding_flips_only(got, want, mags, dtype, terms: int,
                                share=1e-3):
    """f32: within 1e-6 of the largest; bf16: equal, but for at most
    ``share`` of the elements, each off by at most one bf16 unit of the
    largest magnitude along the element's way (a term's x * scale, the
    term after its BN, either sum) per rounding of one of the ``terms``: a
    BN whose f32 formulation rounds one last bit the other way (most often
    where the shift cancels the product), and each later rounded add, which
    may move the two sums one unit further apart (two ties rounded to even
    in opposite directions)."""
    assert got.shape == want.shape and got.dtype == want.dtype
    d = (got.float() - want.float()).abs()
    if dtype == F32:
        assert float(d.max()) <= 1e-6 * float(want.abs().max())
        return
    assert float((d > 0).float().mean()) <= share
    mags = torch.maximum(mags, got.float().abs())
    assert bool((d <= terms * _ulp_bf16(mags)).all())


@pytest.mark.parametrize("dtype", list(DTYPES.values()), ids=list(DTYPES))
@pytest.mark.parametrize("use", list(USES))
def test_plain_epilogue_is_the_composition(use, dtype):
    terms, comp, mags, relu, out_dtype = _use(USES[use], dtype,
                                              list(USES).index(use))
    got = ce.conv_epilogue(terms, relu, out_dtype)
    assert got.is_contiguous(memory_format=CL)
    _assert_rounding_flips_only(got, comp, mags, dtype, len(terms))


@pytest.mark.parametrize("dtype", list(DTYPES.values()), ids=list(DTYPES))
def test_planned_model_against_unplanned_and_reference(seeded, dtype):
    """The planned model's heatmaps against the same model without a plan
    and the benchmark's reference, within the bounds of
    ``test_torch_port_hrnet.py``: f32 within 1e-5 of the largest; bf16 no
    farther from the unplanned bf16 model than half of what bf16 rounding
    does to the reference, and from f32 than 1.5 times that."""
    w, _, tree = seeded
    images = _images()
    model = _port(tree, dtype)
    with torch.no_grad():
        plain = model(images)[0].permute(0, 3, 1, 2)
        planned = model.build_eval_plan()(images)[0].permute(0, 3, 1, 2)
    assert planned.dtype == F32
    ref32 = _reference(w, images)
    if dtype == F32:
        assert _max_rel(planned, plain) < 1e-5
        assert _max_rel(planned, ref32) < 1e-5
        return
    own = _max_rel(_reference(w, images, BF16), ref32)
    assert own > 1e-3
    assert _max_rel(planned, plain) < 0.5 * own
    assert _max_rel(planned, ref32) < 1.5 * own


def test_the_plan_follows_the_model():
    """A plan holds every conv's weight in the model's dtype and every BN's
    table (and the head's); ``train()`` drops it, ``eval()`` does not
    bring it back."""
    model = hrnet.PoseHighResolutionNet(width=WIDTH, dtype=BF16).eval()
    assert model.plan is None
    assert model.build_eval_plan() is model
    convs = [m for m in model.modules() if isinstance(m, nn.Conv2d)]
    bns = [m for m in model.modules() if isinstance(m, nn.BatchNorm2d)]
    assert set(model.plan.weights) == set(convs)
    assert all(w.dtype == BF16 for w in model.plan.weights.values())
    assert set(model.plan.affines) == set(bns) | {model.final_layer}
    assert all(a.dtype == F32 and a.shape[0] == 2
               for a in model.plan.affines.values())
    assert "plan" not in "".join(model.state_dict())
    model.train()
    assert model.plan is None
    model.eval()
    assert model.plan is None


def epilogues_per_forward() -> int:
    """The epilogues of one planned forward: two stem convs, three a
    Bottleneck, one a transition conv, two a BasicBlock, and per exchange
    row one for the sum and one for each strided conv before the last of a
    j < i chain, and the head."""
    n = 2 + 3 * hrnet.LAYER1_BLOCKS + 1
    branches_before = 1
    for s, (modules, branches, blocks) in enumerate(hrnet.STAGES):
        n += 1 if s == 0 else 0  # transition1's 256 -> 48 conv
        n += sum(i + 1 - branches_before
                 for i in range(branches_before, branches))
        for m in range(modules):
            n += 2 * blocks * branches
            last = s == len(hrnet.STAGES) - 1 and m == modules - 1
            n += sum(1 + sum(i - j - 1 for j in range(i))
                     for i in range(1 if last else branches))
        branches_before = branches
    return n


@pytest.mark.parametrize("planned", [True, False], ids=["planned",
                                                        "unplanned"])
def test_epilogues_of_one_forward(monkeypatch, planned):
    """A planned forward makes 262 epilogue calls (every conv's, as
    ``epilogues_per_forward`` counts them), and K8 launches none on the
    CPU; a model without a plan makes none."""
    calls = []

    def counted(*a, **k):
        calls.append(1)
        return ce.conv_epilogue(*a, **k)

    monkeypatch.setattr(hrnet, "conv_epilogue", counted)
    model = hrnet.PoseHighResolutionNet(width=WIDTH).eval()
    if planned:
        model.build_eval_plan()
    before = ce.LAUNCHES
    with torch.no_grad():
        model(_images(1))
    assert epilogues_per_forward() == 262
    assert len(calls) == (262 if planned else 0)
    assert ce.LAUNCHES == before


def test_spans_of_a_planned_forward():
    """The 21 spans of a forward hold on the planned path."""
    model = hrnet.PoseHighResolutionNet(width=WIDTH).eval().build_eval_plan()
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        model(_images(1))
    counts = {name: 0 for name in hrnet.SPANS}
    for e in prof.events():
        if e.name in counts:
            counts[e.name] += 1
    assert counts == {"hrnet.stem": 1, "hrnet.transition": 3,
                      "hrnet.branches": 8, "hrnet.exchange": 8,
                      "hrnet.head": 1}


def test_reload_brings_a_new_plan(seeded, tmp_path):
    """Epoch 2 moves BN statistics and parameters (which the plan's tables
    hold): after ``reload`` the server answers as a whole-batch forward
    of epoch 2, not as epoch 1."""
    _, stats, tree = seeded
    pdir = os.path.join(str(tmp_path), "parameter")
    save_checkpoint(pdir, 1, tree["params"], tree["batch_stats"])
    split = types.SimpleNamespace(**dict(zip(
        ("mean_part", "std_part", "mean_s", "std_s"), _stats(stats))))
    server = End2EndServer.from_run_dir(
        str(tmp_path), split, variant="hrnet", model_kw={"features": WIDTH},
        dtype=F32, batch_sizes=(2,), device="cpu")
    assert server._model.hourglass.plan is not None
    frames = seeds.frame_pool(17, 2)
    first = server.predict(frames)
    params = copy.deepcopy(tree["params"])
    batch_stats = copy.deepcopy(tree["batch_stats"])
    stem = batch_stats["hourglass"]["bn1"]
    stem["mean"] = stem["mean"] + np.float32(0.5)
    bn = params["hourglass"]["stage4"]["2"]["branches"]["0"]["3"]["bn2"]
    bn["scale"] = bn["scale"] * np.float32(3.0)
    save_checkpoint(pdir, 2, params, batch_stats)
    assert server.reload() and server.epoch == 2
    again = server.predict(frames)
    want = _whole_batch({"params": params, "batch_stats": batch_stats},
                        stats, frames)
    np.testing.assert_allclose(again[0], want[0], rtol=0, atol=1e-4)
    np.testing.assert_allclose(again[1], want[1], rtol=0, atol=1e-3)
    assert not np.allclose(again[0], first[0], atol=1e-2)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

# HRNet-W48's epilogues at its served batch of 128: (use, channels, size).
SERVED = {
    "branch0_block": ("basic_block_conv2", 48, 64),
    "branch1_block": ("basic_block_conv2", 96, 32),
    "branch2_block": ("basic_block_conv2", 192, 16),
    "branch3_block": ("basic_block_conv2", 384, 8),
    "stem_conv1": ("stem", 64, 128),
    "bottleneck_downsample": ("bottleneck_downsample", 256, 64),
    "exchange_row0_stage4": ("exchange_row0_up_1_2_3", 48, 64),
    "exchange_row2_stage4": ("exchange_row2_down_down_up", 192, 16),
    "head": ("head", 16, 64),
}


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES.values()), ids=list(DTYPES))
@pytest.mark.parametrize("name", list(SERVED))
def test_k8_matches_its_plain_version_at_served_shapes(card, name, dtype):
    """One launch per call; bf16 equal to the plain version on the same
    tensors but for rare last-bit flips (the kernel's BN is one fused
    multiply-add, the plain version's a multiply and an add), f32 within
    1e-6; the head (scale 1) bit for bit."""
    use, c, size = SERVED[name]
    terms, _, mags, relu, out_dtype = _use(
        (c, size) + USES[use][2:], dtype, list(SERVED).index(name), card,
        batch=128)
    before = ce.LAUNCHES
    got = ce.conv_epilogue(terms, relu, out_dtype)
    torch.cuda.synchronize()
    assert ce.LAUNCHES == before + 1
    want = ce.conv_epilogue_ref(terms, relu, out_dtype)
    if name == "head":
        assert torch.equal(got, want)
    _assert_rounding_flips_only(got, want, mags, dtype, len(terms))


@pytest.mark.cuda
def test_a_served_chunk_runs_through_k8(card):
    """A 128-frame chunk of the seeded, calibrated W48 through
    ``End2EndServer``: 262 K8 launches, and its heatmaps against the same
    model without a plan and the reference within the CPU test's bounds."""
    with open(os.path.join(ROOT, "portbench", "configs",
                           "e2e-hrnet-w48.json")) as f:
        cfg = json.load(f)
    w, stats = pose_hrnet.hrnet_weights(cfg, 20, card)

    def host(t):
        return t.detach().cpu().numpy()

    server = End2EndServer(
        w.tree(), host(stats.mean_part), host(stats.std_part),
        host(stats.mean_s), host(stats.std_s), variant="hrnet", dtype=BF16,
        batch_sizes=(128,), device=card)
    frames = seeds.frame_pool(21, 128)
    before = ce.LAUNCHES
    pose2d, _ = server.predict(frames)
    assert ce.LAUNCHES - before == epilogues_per_forward() == 262
    assert np.isfinite(pose2d).all()
    model = server._model.hourglass
    images = torch.as_tensor(frames, device=card).float() / 255.0
    with torch.no_grad():
        planned = model(images)[0].permute(0, 3, 1, 2)
        plan, model.plan = model.plan, None
        plain = model(images)[0].permute(0, 3, 1, 2)
        model.plan = plan
    ref32 = _reference(w, images)
    own = _max_rel(_reference(w, images, BF16), ref32)
    assert _max_rel(planned, plain) < 0.5 * own
    assert _max_rel(planned, ref32) < 1.5 * own
