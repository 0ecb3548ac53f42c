"""The port's MPII data path and augmentation against the JAX package's, on
synthetic trees written by each package, with the same draws fed to both
(the draws come from numpy seeds; torch's and JAX's generators differ).

Tolerances: file bytes (but for the .mat header's creation time),
records, canvases and masks exact; float image ops
1e-5 absolute (f32 matmuls and blends summed in another order); heatmap
coordinates 1e-4 px.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bilinear_tpu.data import mpii as jmpii
from bilinear_tpu.data import pipeline as jpipe
from bilinear_tpu.data import synthetic as jsyn
from bilinear_tpu.ops import affine as jaff
from bilinear_tpu.ops import augment as jaug
from bilinear_tpu.ops import heatmap as jhm
from bilinear_tpu.ops.joints import MPII_FLIP_SWAP as J_SWAP
from bilinear_tpu_torch.data import mpii as pmpii
from bilinear_tpu_torch.data import pipeline as ppipe
from bilinear_tpu_torch.data import synthetic as psyn
from bilinear_tpu_torch.ops import affine as paff
from bilinear_tpu_torch.ops import augment as paug
from bilinear_tpu_torch.ops import heatmap as phm
from bilinear_tpu_torch.ops.joints import MPII_FLIP_SWAP
from torch_port_fixtures import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("mpii")
    kw = dict(n_train_images=10, n_test_images=2, learnable=True, seed=3)
    jsyn.write_mpii_dataset(str(root / "jax"), **kw)
    psyn.write_mpii_dataset(str(root / "port"), **kw)
    return str(root / "jax"), str(root / "port")


def test_written_trees_are_byte_equal(trees):
    jdir, pdir = trees
    files = []
    for base, _, names in os.walk(jdir):
        files += [os.path.relpath(os.path.join(base, n), jdir) for n in names]
    assert any(f.endswith(".mat") for f in files)
    assert sum(f.endswith(".jpg") for f in files) == 12
    for rel in files:
        with open(os.path.join(jdir, rel), "rb") as f:
            a = f.read()
        with open(os.path.join(pdir, rel), "rb") as f:
            b = f.read()
        if rel.endswith(".mat"):
            # The 116-byte text header ends with the creation time.
            assert a[:116].split(b"Created on")[0] == \
                b[:116].split(b"Created on")[0]
            a, b = a[116:], b[116:]
        assert a == b, rel


def test_annotations_records_are_equal(trees):
    jdir, pdir = trees
    ja = jmpii.MPIIAnnotations(jdir, "train", split_seed=5)
    pa = pmpii.MPIIAnnotations(pdir, "train", split_seed=5)
    assert len(ja) == len(pa) == 9
    for i in range(len(ja)):
        a, b = ja.record(i), pa.record(i)
        assert (a.image_name, a.scale, a.head, a.img_idx, a.r_idx) == \
            (b.image_name, b.scale, b.head, b.img_idx, b.r_idx)
        np.testing.assert_array_equal(a.center, b.center)
        np.testing.assert_array_equal(a.keypoints, b.keypoints)
        np.testing.assert_array_equal(a.valid, b.valid)


@pytest.mark.parametrize("transport", ["u8", "f32"])
def test_pipeline_batches_are_equal(trees, transport):
    jdir, pdir = trees
    jp = jpipe.MPIIHostPipeline(jmpii.MPIIAnnotations(jdir, "train"), 4,
                                canvas=256, shuffle=True, seed=7,
                                transport=transport)
    pp = ppipe.MPIIHostPipeline(pmpii.MPIIAnnotations(pdir, "train"), 4,
                                canvas=256, shuffle=True, seed=7,
                                transport=transport)
    jb, pb = list(jp.epoch(2)), list(pp.epoch(2))
    assert [b.images.shape[0] for b in pb] == [4, 4, 1]
    for a, b in zip(jb, pb):
        for f in ("centers", "scales", "keypoints", "valid", "heads",
                  "index"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
        assert a.pad == b.pad
        if transport == "u8":
            np.testing.assert_array_equal(a.images, b.images)
        else:  # the JAX package's native copy scales by 1/255 in C++
            np.testing.assert_allclose(a.images, b.images, rtol=0,
                                       atol=1e-7)


def _canvas_batch(trees, transport):
    _, pdir = trees
    pp = ppipe.MPIIHostPipeline(pmpii.MPIIAnnotations(pdir, "train"), 4,
                                canvas=256, seed=0, transport=transport)
    return next(iter(pp.epoch(0, prefetch=0)))


@pytest.mark.parametrize("transport", ["u8", "f32"])
@pytest.mark.parametrize("rotated", [False, True], ids=["plain", "rotated"])
def test_crop_batch_matches_jax(trees, transport, rotated):
    b = _canvas_batch(trees, transport)
    rng = np.random.RandomState(1)
    rot = (rng.uniform(-40, 40, 4) * rotated).astype(np.float32)
    scales = (b.scales * rng.uniform(0.8, 1.2, 4)).astype(np.float32)
    ref = jaff.crop_batch(jnp.asarray(b.images), jnp.asarray(b.centers),
                          jnp.asarray(scales), jnp.asarray(rot), res=64)
    out = paff.crop_batch(torch.from_numpy(b.images),
                          torch.from_numpy(b.centers),
                          torch.from_numpy(scales), torch.from_numpy(rot),
                          res=64)
    assert out.shape == (4, 64, 64, 3) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(paff.hflip(out).numpy(),
                                  np.asarray(jaff.hflip(jnp.asarray(out))))


def test_color_jitter_application_matches_jax():
    """The same factors and op order through both packages' ops (the JAX
    side composes its own adjust_* in the order its _ORDERS gives)."""
    rng = np.random.RandomState(2)
    img = rng.rand(3, 16, 16, 3).astype(np.float32)
    fb, fc, fs = (rng.uniform(0.7, 1.3, 3).astype(np.float32)
                  for _ in range(3))
    fh = rng.uniform(-0.3, 0.3, 3).astype(np.float32)
    assert paug.ORDERS == jaug._ORDERS
    for order in (0, 7, 23):
        out = paug.apply_color_jitter(torch.from_numpy(img), paug.JitterParams(
            *(torch.from_numpy(f) for f in (fb, fc, fs, fh)), order))
        ref = jnp.asarray(img)
        ops = [lambda im: jaug.adjust_brightness(im, fb[:, None, None, None]),
               lambda im: jaug.adjust_contrast(im, fc[:, None, None, None]),
               lambda im: jaug.adjust_saturation(im, fs[:, None, None, None]),
               lambda im: jaug.adjust_hue(im, fh[:, None, None])]
        for k in jaug._ORDERS[order]:
            ref = ops[k](ref)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-5, err_msg=str(order))


def test_geometry_draws_follow_the_reference_rules():
    gen = torch.Generator().manual_seed(0)
    p = paug.sample_geometry(gen, 4096, flip_prob=0.4)
    lo, hi = 2.0 ** -0.5, 2.0 ** 0.5
    assert bool(((p.scale_factor >= lo - 1e-6)
                 & (p.scale_factor <= hi + 1e-6)).all())
    assert bool((p.rotate_deg.abs() <= 60.0).all())
    assert 0.55 < float((p.rotate_deg == 0).float().mean()) < 0.65
    assert 0.35 < float(p.flip.float().mean()) < 0.45


def test_flip_and_heatmap_ops_match_jax():
    rng = np.random.RandomState(4)
    kp = rng.uniform(0, 256, (3, 16, 2)).astype(np.float32)
    centers = rng.uniform(100, 150, (3, 2)).astype(np.float32)
    scales = rng.uniform(0.8, 1.2, 3).astype(np.float32)
    rot = rng.uniform(-30, 30, 3).astype(np.float32)
    valid = rng.rand(3, 16) < 0.8
    np.testing.assert_array_equal(MPII_FLIP_SWAP, J_SWAP)
    mj = jaug.flip_keypoints_x(jnp.asarray(kp), jnp.asarray(centers[:, 0:1]),
                               J_SWAP)
    mp = paug.flip_keypoints_x(torch.from_numpy(kp),
                               torch.from_numpy(centers[:, 0:1]),
                               MPII_FLIP_SWAP)
    np.testing.assert_array_equal(mp.numpy(), np.asarray(mj))
    hj = jhm.keypoints_to_heatmap_space(jnp.asarray(kp), jnp.asarray(centers),
                                        jnp.asarray(scales), jnp.asarray(rot))
    hp = phm.keypoints_to_heatmap_space(
        torch.from_numpy(kp), torch.from_numpy(centers),
        torch.from_numpy(scales), torch.from_numpy(rot))
    np.testing.assert_allclose(hp.numpy(), np.asarray(hj), rtol=0, atol=1e-4)
    rj = jhm.render_heatmaps(hj, jnp.asarray(valid))
    rp = phm.render_heatmaps(torch.from_numpy(np.array(hj)),
                             torch.from_numpy(valid))
    assert rp.shape == (3, 16, 64, 64)
    np.testing.assert_allclose(rp.numpy(), np.asarray(rj), rtol=0, atol=1e-6)
