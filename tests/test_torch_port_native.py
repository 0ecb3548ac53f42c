"""The port's host packer (``bilinear_tpu_torch/native``: a copy of the
JAX package's ``fastpack.cpp``, built with g++ at first use), the canvas
cache of ``data/pipeline.py`` (``cache_dir``, ``--cache-canvases``) and the
crop oracle of ``ops/affine.py`` (``crop_image``, ``crop_batch_gather``),
against the JAX package on the CPU.

- The packer: ``pack_canvas_f32`` / ``pack_canvas_u8`` bit-equal to JAX's
  native library and to the port's numpy version (``pack_region_np``) at
  the region offsets of ``tests/test_native.py``; ``resize_linear_u8``
  bit-equal to JAX's and within one step of PIL's BILINEAR.
- The cache, on one synthetic MPII tree: the ``.u8`` memmap byte-equal to
  the one JAX's pipeline writes and the ``.npz`` arrays equal; each package
  reads the other's cache into the batches it gives uncached; a cached
  epoch decodes no JPEG.
- The crops: ``crop_batch_gather`` within 1e-4 of JAX's at three
  rotations, and ``crop_batch`` within 1e-5 of it at rotation 0 when the
  box upscales (JAX's own gate between its two paths).
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from bilinear_tpu import native as jax_native
from bilinear_tpu.data.mpii import MPIIAnnotations as JaxAnnotations
from bilinear_tpu.data.pipeline import MPIIHostPipeline as JaxPipeline
from bilinear_tpu.ops import affine as jaffine
from bilinear_tpu_torch import native
from bilinear_tpu_torch.data.h36m import Task
from bilinear_tpu_torch.data.mpii import MPIIAnnotations
from bilinear_tpu_torch.data.pipeline import MPIIHostPipeline, \
    pack_region_np
from bilinear_tpu_torch.data.synthetic import write_mpii_dataset
from bilinear_tpu_torch.ops import affine as paffine
from torch_port_fixtures import one_torch_thread  # noqa: F401

OFFSETS = [(-20, 30), (0, 0), (100, 80), (-300, -300), (119, 89)]


@pytest.mark.parametrize("ul", OFFSETS)
def test_pack_matches_jax_native_and_numpy(ul):
    rng = np.random.RandomState(1)
    src = (rng.rand(90, 120, 3) * 255).astype(np.uint8)
    f32 = native.pack_canvas_f32(src, 64, *ul)
    u8 = native.pack_canvas_u8(src, 64, *ul)
    np.testing.assert_array_equal(f32, pack_region_np(src, 64, *ul))
    np.testing.assert_array_equal(u8, pack_region_np(src, 64, *ul,
                                                     as_u8=True))
    assert f32.dtype == np.float32 and u8.dtype == np.uint8
    if jax_native.load() is None:
        pytest.skip("the JAX package's packer did not build here")
    np.testing.assert_array_equal(f32, jax_native.pack_canvas_f32(src, 64,
                                                                  *ul))
    np.testing.assert_array_equal(u8, jax_native.pack_canvas_u8(src, 64,
                                                                *ul))


def test_resize_matches_jax_native_and_pil():
    rng = np.random.RandomState(0)
    src = (rng.rand(123, 200, 3) * 255).astype(np.uint8)
    for dh, dw in [(61, 100), (50, 77), (246, 400), (123, 200)]:
        ours = native.resize_linear_u8(src, dh, dw)
        ref = np.asarray(Image.fromarray(src).resize((dw, dh),
                                                     Image.BILINEAR))
        assert np.abs(ours.astype(int) - ref.astype(int)).max() <= 1
        if jax_native.load() is not None:
            np.testing.assert_array_equal(
                ours, jax_native.resize_linear_u8(src, dh, dw))


def test_failed_build_raises_with_the_compiler_output(tmp_path,
                                                      monkeypatch):
    bad = tmp_path / "fastpack.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()
    assert not os.listdir(tmp_path / "build")  # no half-written library


@pytest.fixture(scope="module")
def mpii(tmp_path_factory):
    data = str(tmp_path_factory.mktemp("mpii"))
    write_mpii_dataset(data, n_train_images=5, n_test_images=1)
    return data


def _batches(pipe, epoch):
    return list(pipe.epoch(epoch, prefetch=0))


def _same_batches(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        for k in ("images", "centers", "scales", "keypoints", "valid",
                  "heads", "index"):
            np.testing.assert_array_equal(getattr(x, k), getattr(y, k), k)
        assert x.pad == y.pad


def test_cache_files_equal_jax_and_cross_read(mpii, tmp_path):
    kw = dict(canvas=256, shuffle=True, seed=3, transport="u8")
    ours, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    plain = MPIIHostPipeline(MPIIAnnotations(mpii, Task.Train), 3, **kw)
    cached = MPIIHostPipeline(MPIIAnnotations(mpii, Task.Train), 3,
                              cache_dir=ours, **kw)
    jcached = JaxPipeline(JaxAnnotations(mpii, "train"), 3, cache_dir=theirs,
                          **kw)
    want = _batches(plain, 1)
    _same_batches(_batches(cached, 1), want)
    decoded = cached.decoded
    _same_batches(_batches(cached, 2), _batches(plain, 2))
    assert decoded == len(plain.annotations) and cached.decoded == decoded
    jcached.materialize()
    n = len(plain.annotations)
    tag = f"canvas256_n{n}_v2"
    assert sorted(os.listdir(ours)) == sorted(os.listdir(theirs)) == \
        [f"{tag}.npz", f"{tag}.u8"]
    with open(os.path.join(ours, f"{tag}.u8"), "rb") as f, \
            open(os.path.join(theirs, f"{tag}.u8"), "rb") as g:
        assert f.read() == g.read()
    a, b = (np.load(os.path.join(d, f"{tag}.npz")) for d in (ours, theirs))
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], k)
    # Each package reads the other's cache.
    cross = MPIIHostPipeline(MPIIAnnotations(mpii, Task.Train), 3,
                             cache_dir=theirs, **kw)
    _same_batches(_batches(cross, 1), want)
    assert cross.decoded == 0
    jcross = JaxPipeline(JaxAnnotations(mpii, "train"), 3, cache_dir=ours,
                         **kw)
    _same_batches(_batches(jcross, 1), want)


def test_cache_refuses_f32_transport(mpii, tmp_path):
    with pytest.raises(ValueError, match="uint8"):
        MPIIHostPipeline(MPIIAnnotations(mpii, Task.Train), 2,
                         transport="f32", cache_dir=str(tmp_path))


def _crop_inputs():
    rng = np.random.RandomState(0)
    imgs = (rng.rand(3, 90, 120, 3) * 255).astype(np.uint8)
    centers = np.array([[60, 45], [10, 80], [100, 20]], np.float32)
    scales = np.array([0.3, 0.5, 0.2], np.float32)
    return imgs, centers, scales


@pytest.mark.parametrize("rot", [0.0, 25.0, -40.0])
def test_crop_batch_gather_matches_jax(rot):
    imgs, centers, scales = _crop_inputs()
    rots = np.full(3, rot, np.float32)
    want = np.asarray(jaffine.crop_batch_gather(
        jnp.asarray(imgs), jnp.asarray(centers), jnp.asarray(scales),
        jnp.asarray(rots), res=64))
    got = paffine.crop_batch_gather(
        torch.from_numpy(imgs), torch.from_numpy(centers),
        torch.from_numpy(scales), torch.from_numpy(rots), res=64).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
    one = paffine.crop_image(torch.from_numpy(imgs[1]).float() / 255.0,
                             centers[1], scales[1], rot, res=64).numpy()
    np.testing.assert_allclose(one, want[1], atol=1e-4)


def test_crop_batch_matches_the_oracle_when_upscaling():
    imgs, centers, scales = _crop_inputs()
    args = (torch.from_numpy(imgs), torch.from_numpy(centers),
            torch.from_numpy(scales), torch.zeros(3))
    up = [0, 2]  # boxes of 60 and 40 px into 64: upscales
    got = paffine.crop_batch(*args, res=64).numpy()[up]
    want = paffine.crop_batch_gather(*args, res=64).numpy()[up]
    np.testing.assert_allclose(got, want, atol=1e-5)
