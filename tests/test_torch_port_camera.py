"""The port's camera model and bin generation (bilinear_tpu_torch/data/
camera.py, data/h36m_generate.py, data/synthetic.py::
write_h36m_learnable_dataset) against the JAX package, on calibration files
the test writes (H36M-like: f ~ 1145 px, c ~ 512 px, small k and p).

Tolerances: ``project_np``, the bins and the learnable tree's images are
numpy on both sides in the same operation order: bit for bit. ``project``
(torch) against JAX's jnp ``project``: both f32 in the same order, held to
1e-4 px (XLA's CPU compiler may contract or reorder; measured equal here).
``unproject`` round trip within 0.05 mm, JAX's own gate.
"""
import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bilinear_tpu.data import camera as jcam
from bilinear_tpu.data import h36m as jh36m
from bilinear_tpu.data import h36m_generate as jgen
from bilinear_tpu.data import synthetic as jsyn
from bilinear_tpu_torch.data import camera as pcam
from bilinear_tpu_torch.data import h36m as ph36m
from bilinear_tpu_torch.data import h36m_generate as pgen
from bilinear_tpu_torch.data import synthetic as psyn
from torch_port_fixtures import one_torch_thread  # noqa: F401


def write_calibration(root, seed: int = 0) -> str:
    """``{camera}_{c,f,k,p}.txt`` for the four H36M cameras."""
    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    for cid in pcam.H36M_CAMERA_IDS:
        vals = dict(
            f=1145.0 + rng.uniform(-5, 5, 2),
            c=512.0 + rng.uniform(-10, 10, 2),
            k=rng.uniform(-0.2, 0.2, 3) * np.asarray([1.0, 0.5, 0.05]),
            p=rng.uniform(-2e-3, 2e-3, 2),
        )
        for suffix, v in vals.items():
            np.savetxt(os.path.join(root, f"{cid}_{suffix}.txt"), v)
    return root


@pytest.fixture(scope="module")
def calib(tmp_path_factory):
    return write_calibration(str(tmp_path_factory.mktemp("calib")))


def _points(n, seed=0):
    rng = np.random.RandomState(seed)
    pts = rng.randn(n, 17, 3).astype(np.float32) * 300
    pts[..., 2] = np.abs(pts[..., 2]) + 4000
    return pts


def test_load_all_cameras_matches_jax(calib):
    ours = pcam.load_all_cameras(calib)
    theirs = jcam.load_all_cameras(calib)
    assert set(ours) == set(pcam.H36M_CAMERA_IDS) == set(theirs)
    for cid in ours:
        for f in ("f", "c", "k", "p"):
            a, b = getattr(ours[cid], f), getattr(theirs[cid], f)
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)
        assert ours[cid].name == cid


@pytest.mark.parametrize("cid", pcam.H36M_CAMERA_IDS)
def test_project_matches_jax(calib, cid):
    cam = pcam.load_camera(calib, cid)
    jc = jcam.load_camera(calib, cid)
    pts = _points(64, seed=int(cid) % 97)
    np.testing.assert_array_equal(pcam.project_np(pts, cam),
                                  jcam.project_np(pts, jc))
    ours = pcam.project(torch.from_numpy(pts), cam).numpy()
    theirs = np.asarray(jcam.project(jnp.asarray(pts), jc))
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-4)
    np.testing.assert_allclose(ours, pcam.project_np(pts, cam), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("cid", pcam.H36M_CAMERA_IDS)
def test_unproject_round_trip_and_jax(calib, cid):
    cam = pcam.load_camera(calib, cid)
    pts = _points(32, seed=3).reshape(-1, 3)
    px = pcam.project(torch.from_numpy(pts), cam)
    back = pcam.unproject(px, torch.from_numpy(pts[:, 2]), cam).numpy()
    np.testing.assert_allclose(back, pts, atol=0.05)
    theirs = np.asarray(jcam.unproject(jnp.asarray(px.numpy()),
                                       jnp.asarray(pts[:, 2]),
                                       jcam.load_camera(calib, cid)))
    np.testing.assert_allclose(back, theirs, rtol=0, atol=1e-3)


def test_bins_bit_equal_and_read_by_both(calib, tmp_path):
    cam, jc = pcam.load_camera(calib, "54138969"), \
        jcam.load_camera(calib, "54138969")
    s = _points(40, seed=5)
    names = [f"S1_Posing.54138969_t{i:06d}.jpg" for i in range(40)]
    a = pgen.build_gt_bin(s, names, cam)
    b = jgen.build_gt_bin(s, names, jc)
    assert pickle.dumps(a, protocol=pickle.HIGHEST_PROTOCOL) == \
        pickle.dumps(b, protocol=pickle.HIGHEST_PROTOCOL)
    ours, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    splits = {"train": dict(S=s, images=names, camera=cam),
              "valid": dict(S=s[:16], images=names[:16], camera=cam)}
    jsplits = {k: dict(v, camera=jc) for k, v in splits.items()}
    pgen.write_gt_bins(ours, splits)
    jgen.write_gt_bins(theirs, jsplits)
    for task in ("train", "valid"):
        with open(os.path.join(ours, f"{task}_GT.bin"), "rb") as f1, \
                open(os.path.join(theirs, f"{task}_GT.bin"), "rb") as f2:
            assert f1.read() == f2.read()
    p = ph36m.load_h36m(ours, "GT")["train"]
    j = jh36m.load_h36m(ours, "GT")["train"]
    np.testing.assert_array_equal(p.part, j.part)
    np.testing.assert_array_equal(p.s, j.s)


def test_learnable_dataset_bit_equal(calib, tmp_path):
    ours, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    kw = dict(n_train=3, n_valid=2, calibration_dir=calib)  # 1000 px
    psyn.write_h36m_learnable_dataset(ours, **kw)
    jsyn.write_h36m_learnable_dataset(theirs, **kw)
    files = []
    for dirpath, _, names in os.walk(theirs):
        files += [os.path.relpath(os.path.join(dirpath, n), theirs)
                  for n in names]
    assert len(files) == 2 + 5
    for rel in files:
        with open(os.path.join(ours, rel), "rb") as f1, \
                open(os.path.join(theirs, rel), "rb") as f2:
            assert f1.read() == f2.read(), rel
    split = ph36m.load_h36m(ours, "GT")["train"]
    assert split.part.shape == (3, 32)
    # Each marker that no other overlaps (outer radius 5 ring) has its
    # white centre at its projected joint (JPEG's chroma subsampling greys
    # a disc under 2 px: those are not read).
    from PIL import Image

    with open(os.path.join(ours, "train_GT.bin"), "rb") as f:
        bins = pickle.load(f)
    total = 0
    for name, part, scale in zip(bins["image"], bins["part"],
                                 bins["scale"]):
        img = np.asarray(Image.open(os.path.join(ours, "S1", name)))
        xy = np.asarray(part)[[h for h in range(17) if h != 9]]
        ring = max(1.3, 2.0 * float(scale))
        d = np.linalg.norm(xy[:, None] - xy[None], axis=-1)
        np.fill_diagonal(d, np.inf)
        for (x, y), near in zip(np.rint(xy).astype(int), d.min(1)):
            if ring >= 2.0 and near > 10 * ring + 2 and 0 <= x < 1000 \
                    and 0 <= y < 1000:
                total += 1
                # JPEG blurs the white disc (radius >= 1.3 px): its
                # brightest pixel within 1 px of the joint.
                win = img[max(y - 1, 0):y + 2, max(x - 1, 0):x + 2]
                assert win.min(axis=-1).max() > 200, (name, x, y)
    assert total > 0
