"""Synthetic, schema-exact H36M annotation bins and MPII trees for tests and
the chip smoke run (the port's own copy of ``make_h36m_bin``,
``write_h36m_dataset``, ``make_mpii_mat``, ``write_mpii_dataset`` and
``write_h36m_learnable_dataset`` from ``bilinear_tpu/data/synthetic.py``;
same seeds give the same arrays, the same ``.mat`` bytes and the same
images).

- 'image': ``{subject}_{action}.{camera}_{frame}.jpg`` names
- 'S':      (N, 17, 3) float camera-space mm
- 'part':   (N, 17, 2) float pixel keypoints
- 'center': list of (2,) arrays
- 'scale':  float, person bbox = 200*scale px
"""
from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional

import numpy as np

ACTIONS = ["Directions", "Eating", "Posing", "Walking", "Walking_1"]
CAMERAS = ["54138969", "55011271", "58860488", "60457274"]


def make_h36m_bin(
    n: int,
    seed: int = 0,
    subjects: Optional[List[str]] = None,
    img_size: int = 256,
) -> Dict[str, list]:
    """A plausible random H36M annotation dict: 3D skeletons around camera
    space z~5000 mm, 2D parts placed inside an img_size^2 frame."""
    rng = np.random.RandomState(seed)
    subjects = subjects or ["S1", "S5"]

    s = rng.randn(n, 17, 3).astype(np.float32) * 200.0
    s[:, :, 2] += 5000.0
    # Pelvis anchors the skeleton near the body center.
    s[:, 0, :] = s.mean(axis=1)

    centers = [
        np.asarray(
            [img_size / 2 + rng.uniform(-20, 20), img_size / 2 + rng.uniform(-20, 20)],
            np.float32,
        )
        for _ in range(n)
    ]
    scales = [float(rng.uniform(0.5, 0.8)) for _ in range(n)]  # box 100-160 px
    part = np.stack(
        [
            centers[i]
            + (s[i, :, :2] - s[i, :, :2].mean(0)) * (100.0 * scales[i] / 700.0)
            for i in range(n)
        ]
    ).astype(np.float32)

    images = []
    for i in range(n):
        subject = subjects[i % len(subjects)]
        action = ACTIONS[i % len(ACTIONS)]
        camera = CAMERAS[i % len(CAMERAS)]
        images.append(f"{subject}_{action}.{camera}_{i:06d}.jpg")

    return {
        "image": images,
        "S": [s[i] for i in range(n)],
        "part": [part[i] for i in range(n)],
        "center": centers,
        "scale": scales,
    }


def write_h36m_dataset(
    data_dir: str,
    n_train: int = 128,
    n_valid: int = 64,
    protocol: str = "GT",
    seed: int = 0,
    with_images: bool = False,
    img_size: int = 256,
) -> str:
    """Write ``{train,valid}_{protocol}.bin`` into ``data_dir`` and, with
    ``with_images``, a JPEG per frame at ``{data_dir}/{subject}/{image_name}``
    for the detector paths (fine-tuning, the SH conversion)."""
    os.makedirs(data_dir, exist_ok=True)
    for task, n, s in [("train", n_train, seed), ("valid", n_valid, seed + 1)]:
        data = make_h36m_bin(n, seed=s, img_size=img_size)
        with open(os.path.join(data_dir, f"{task}_{protocol}.bin"), "wb") as f:
            pickle.dump(data, f)
        if with_images:
            from PIL import Image

            rng = np.random.RandomState(seed + 7)
            for name in data["image"]:
                subject = name.split("_")[0]
                os.makedirs(os.path.join(data_dir, subject), exist_ok=True)
                small = (rng.rand(img_size // 8, img_size // 8, 3)
                         * 255).astype(np.uint8)
                img = Image.fromarray(small).resize((img_size, img_size),
                                                    Image.BILINEAR)
                img.save(os.path.join(data_dir, subject, name), quality=90)
    return data_dir


# Body-structured 16-joint template in MPII id order (R ankle..L wrist),
# units of 100*scale px relative to objpos (x right, y down). Used by the
# `learnable` synthetic mode: a consistent figure layout makes every joint
# identifiable from image structure, like a real person.
MPII_TEMPLATE = np.asarray(
    [
        (-0.24, 0.90), (-0.22, 0.50), (-0.22, 0.10),   # R ankle/knee/hip
        (0.22, 0.10), (0.22, 0.50), (0.24, 0.90),      # L hip/knee/ankle
        (0.00, 0.22), (0.00, -0.45), (0.00, -0.72),    # pelvis/thorax/neck
        (0.00, -0.98),                                  # head top
        (-0.44, 0.08), (-0.38, -0.22), (-0.27, -0.52),  # R wrist/elbow/shldr
        (0.27, -0.52), (0.38, -0.22), (0.44, 0.08),     # L shldr/elbow/wrist
    ],
    np.float32,
)  # every pairwise distance >= ~0.22 so markers never cover a neighbor's
#    center (marker outer radius is ~0.10-0.13 of the figure scale)


def _joint_colors():
    """16 maximally-spread hues at full saturation (uint8 RGB)."""
    import colorsys

    return np.asarray(
        [
            [int(c * 255) for c in colorsys.hsv_to_rgb(j / 16.0, 1.0, 1.0)]
            for j in range(16)
        ],
        np.uint8,
    )


def make_mpii_mat(
    n_train_images: int = 8,
    n_test_images: int = 2,
    img_size=(240, 320),
    seed: int = 0,
    learnable: bool = False,
    jitter: float = 3.0,
    scale_range=None,  # (lo, hi) raw person scale; defaults per mode. Big
    # values (>2.05) exercise the reference's crop_ratio>=2 early-downscale
    # path (H36M/util.py:38-52) — used by benchmarks/crop_ratio_probe.py.
):
    """Build a RELEASE-shaped dict that scipy.io round-trips into the same
    attribute structure the official mpii_human_pose_v1_u12_1.mat loads as
    (MPII/data.py:23-25): annolist[i].image.name / .annorect[r].{scale,
    objpos.{x,y}, x1..y2, annopoints.point[k].{x,y,id}}, img_train,
    single_person.

    ``learnable=True`` places every rect's keypoints on the body-structured
    MPII_TEMPLATE (per-joint jitter, all 16 joints annotated, one rect
    per image) so that images rendered from these annotations carry a
    visually learnable pose signal; default keypoints are positionally
    random, which is schema-exact but unlearnable by construction.

    ``jitter`` (units of ``scale`` px, i.e. relative to the 200*scale person
    box) is the per-joint pose variance around the template, clipped at
    2*jitter like the reference's augment rand (MPII/util.py:10-11). At the
    default 3.0 the template prior alone localizes every joint well inside
    the PCKh@0.5 threshold (15*scale px with this generator's head rect), so
    a detector can saturate PCKh without reading the image; raising it to
    ~20 makes the prior worth only ~25% PCKh and forces marker reading."""
    rng = np.random.RandomState(seed)
    h, w = img_size
    annolist = []
    img_train = []
    single_person = []
    n = n_train_images + n_test_images
    for i in range(n):
        rects = []
        n_rects = 1 if learnable else 1 + int(rng.rand() < 0.5)
        for _ in range(n_rects):
            if learnable:
                lo, hi = scale_range or (0.6, 0.9)
                scale = float(rng.uniform(lo, hi))
                cx = float(rng.uniform(w * 0.35, w * 0.65))
                cy = float(rng.uniform(h * 0.4, h * 0.6))
            else:
                lo, hi = scale_range or (0.5, 1.2)
                scale = float(rng.uniform(lo, hi))
                cx = float(rng.uniform(w * 0.3, w * 0.7))
                cy = float(rng.uniform(h * 0.3, h * 0.7))
            if learnable:
                noise = np.clip(rng.randn(16, 2), -2.0, 2.0).astype(np.float32)
                kp = (
                    np.asarray([cx, cy], np.float32)
                    + MPII_TEMPLATE * 100.0 * scale
                    + noise * jitter * scale
                )
                ids = np.arange(16)
                points = [
                    {
                        "x": float(np.clip(kp[j, 0], 0, w - 1)),
                        "y": float(np.clip(kp[j, 1], 0, h - 1)),
                        "id": int(j),
                    }
                    for j in ids
                ]
            else:
                n_pts = int(rng.randint(12, 17))
                ids = rng.permutation(16)[:n_pts]
                points = [
                    {
                        "x": float(np.clip(cx + rng.randn() * 40 * scale, 0, w - 1)),
                        "y": float(np.clip(cy + rng.randn() * 60 * scale, 0, h - 1)),
                        "id": int(j),
                    }
                    for j in ids
                ]
            rects.append(
                {
                    "scale": scale,
                    "objpos": {"x": cx, "y": cy},
                    "x1": cx - 15 * scale,
                    "y1": cy - 80 * scale,
                    "x2": cx + 15 * scale,
                    "y2": cy - 40 * scale,
                    "annopoints": {"point": np.asarray(points, dtype=object)},
                }
            )
        annolist.append(
            {
                "image": {"name": f"{i:09d}.jpg"},
                "annorect": np.asarray(rects, dtype=object),
            }
        )
        is_train = i < n_train_images
        img_train.append(1 if is_train else 0)
        single_person.append(np.asarray([1], dtype=np.int64))
    return {
        "RELEASE": {
            "annolist": np.asarray(annolist, dtype=object),
            "img_train": np.asarray(img_train, dtype=np.int64),
            "single_person": np.asarray(single_person, dtype=object),
        }
    }


def _stamp_marker(img, x, y, j, ring, colors) -> None:
    """One concentric-ring "bullseye" marker (in place)."""
    h, w, _ = img.shape
    dark = np.asarray([25, 25, 25], np.uint8)
    white = np.asarray([255, 255, 255], np.uint8)
    bits = [(j >> b) & 1 for b in (3, 2, 1, 0)]  # outer -> inner
    radii = [ring * k for k in (5, 4, 3, 2, 1)]
    fills = [colors[j] if b else dark for b in bits] + [white]
    x0, x1 = int(max(0, x - radii[0] - 1)), int(min(w, x + radii[0] + 2))
    y0, y1 = int(max(0, y - radii[0] - 1)), int(min(h, y + radii[0] + 2))
    if x0 >= x1 or y0 >= y1:
        return
    yy, xx = np.mgrid[y0:y1, x0:x1]
    d2 = (xx - x) ** 2 + (yy - y) ** 2
    patch = img[y0:y1, x0:x1]
    for r, fill in zip(radii, fills):
        patch[d2 <= r * r] = fill


def _render_markers(img: np.ndarray, rects, colors: np.ndarray,
                    rng=None, occlusion_prob: float = 0.0,
                    n_distractors: int = 0) -> None:
    """Stamp a concentric-ring "bullseye" marker at every annotated joint of
    every rect (in place). Joint identity is encoded in the LUMINANCE
    pattern: 4 rings (outer to inner) carry the 4 bits of the joint id —
    bright where the bit is 1, dark where 0 — with an always-bright center
    dot. The train-time ColorJitter(.3,.3,.3,.3) applies global affine maps
    to brightness/contrast/saturation and rotates hue, but bright-vs-dark
    ring CONTRAST survives all of them (hue alone does not — measured: a
    hue-coded variant plateaued at ~18% PCKh under jitter vs ~42%+ without).
    Bright rings use the joint's hue so color remains a secondary cue. Ring
    width scales with the person scale, so on-crop marker size is stable
    after the 200*scale->256 crop.

    Difficulty knobs (both keep the .mat annotations untouched, so occluded
    joints still count in the PCKh denominator — exactly how invisible real
    joints behave):

    - ``occlusion_prob``: each joint's marker is skipped with this
      probability. No detector can localize a skipped joint beyond the pose
      prior, which caps attainable PCKh at
      (1-p)*100 + p*prior — a DESIGNED-IN ceiling below saturation.
    - ``n_distractors``: decoy markers with random joint ids stamped at
      random in-figure positions, each >= 45*scale px from the true joint of
      the same id (3x the PCKh threshold, so locking onto a decoy is a
      definite miss and body-layout context is required to disambiguate).
    """
    h, w, _ = img.shape
    for rect in rects:
        scale = float(rect["scale"])
        ring = max(1.3, 2.0 * scale)
        pts = rect["annopoints"]["point"]
        true_xy = {int(p["id"]): (float(p["x"]), float(p["y"])) for p in pts}
        cx = float(rect["objpos"]["x"])
        cy = float(rect["objpos"]["y"])
        for pt in pts:
            if rng is not None and occlusion_prob > 0.0 \
                    and rng.rand() < occlusion_prob:
                continue
            _stamp_marker(img, float(pt["x"]), float(pt["y"]),
                          int(pt["id"]), ring, colors)
        for _ in range(n_distractors if rng is not None else 0):
            j = int(rng.randint(16))
            for _attempt in range(20):
                dx = cx + rng.uniform(-60, 60) * scale
                dy = cy + rng.uniform(-110, 110) * scale
                tx, ty = true_xy.get(j, (1e9, 1e9))
                if (dx - tx) ** 2 + (dy - ty) ** 2 >= (45.0 * scale) ** 2:
                    _stamp_marker(img, dx, dy, j, ring, colors)
                    break


def write_mpii_dataset(
    root: str,
    n_train_images: int = 8,
    n_test_images: int = 2,
    img_size=(240, 320),
    seed: int = 0,
    learnable: bool = False,
    jitter: float = 3.0,
    occlusion_prob: float = 0.0,
    n_distractors: int = 0,
    scale_range=None,
) -> str:
    """Write a synthetic MPII tree: images/ + the .mat at the official
    relative path. With ``learnable=True`` the keypoints follow the
    body-structured template AND are rendered into the images as distinct
    markers, so a detector trained on this tree can actually localize them
    (PCKh above chance); the default is schema-exact noise (contract tests
    only — keypoints are not visually encoded).

    The difficulty knobs (``jitter`` — pose variance around the template;
    ``occlusion_prob`` — markers skipped at render time; ``n_distractors`` —
    decoy markers needing layout context to reject; see make_mpii_mat and
    _render_markers) exist because the default learnable task SATURATES: the
    production 8-stack detector hits PCKh 100.0 by its first validation,
    leaving the metric no discriminative power. With jitter=20,
    occlusion_prob=0.25, n_distractors=4 the designed-in ceiling is
    0.75*100 + 0.25*~25 ~= 81 PCKh, and the prior-only floor is ~25, so a
    production budget run shows an actual learning curve."""
    import scipy.io
    from PIL import Image

    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    os.makedirs(os.path.join(root, "mpii_human_pose_v1_u12_2"), exist_ok=True)
    mat = make_mpii_mat(n_train_images, n_test_images, img_size, seed,
                        learnable=learnable, jitter=jitter,
                        scale_range=scale_range)
    scipy.io.savemat(
        os.path.join(root, "mpii_human_pose_v1_u12_2", "mpii_human_pose_v1_u12_1.mat"),
        mat,
        long_field_names=True,
    )
    rng = np.random.RandomState(seed + 100)
    h, w = img_size
    n = n_train_images + n_test_images
    colors = _joint_colors()
    annolist = mat["RELEASE"]["annolist"]
    for i in range(n):
        small = (rng.rand(h // 8, w // 8, 3) * 255).astype(np.uint8)
        if learnable:
            # Dim the background so the markers dominate local contrast.
            small = (small * 0.35 + 20).astype(np.uint8)
        img = Image.fromarray(small).resize((w, h), Image.BILINEAR)
        if learnable:
            arr = np.asarray(img).copy()
            _render_markers(arr, list(annolist[i]["annorect"]), colors,
                            rng=rng, occlusion_prob=occlusion_prob,
                            n_distractors=n_distractors)
            img = Image.fromarray(arr)
        img.save(os.path.join(root, "images", f"{i:09d}.jpg"), quality=92)
    return root


def learnable_canvases(data_dir: str, seed: int = 0, img_size: int = 1000):
    """Yield ``(path, canvas, xy, ring)`` for every image of a learnable
    H36M tree whose bins are written, in ``write_h36m_learnable_dataset``'s
    order: the uint8 canvas its JPEG encodes, and the (16, 2) pixels and
    ring width of its markers, MPII id m's marker at ``xy[m]``. MPII id m's
    marker goes to the H36M joint whose SH slot reads detection m and
    survives the nose deletion (slot 9 is deleted by the lifting loader,
    so only slot 10 takes the duplicated thorax id 9)."""
    from PIL import Image

    from bilinear_tpu_torch.data.h36m import Task
    from bilinear_tpu_torch.ops.joints import FROM_MPII_TO_H36M

    mpii_to_h36m_slot = {}
    for h, m in enumerate(FROM_MPII_TO_H36M):
        if h == 9:
            continue
        mpii_to_h36m_slot[int(m)] = h
    assert len(mpii_to_h36m_slot) == 16
    slots = [mpii_to_h36m_slot[m] for m in range(16)]

    colors = _joint_colors()
    rng = np.random.RandomState(seed + 7)
    for task in (Task.Train, Task.Valid):
        with open(os.path.join(data_dir, f"{task}_GT.bin"), "rb") as f:
            bin_data = pickle.load(f)
        for i, name in enumerate(bin_data["image"]):
            subject = name.split("_")[0]
            small = (rng.rand(img_size // 8, img_size // 8, 3) * 255)
            small = (small * 0.35 + 20).astype(np.uint8)
            img = Image.fromarray(small).resize(
                (img_size, img_size), Image.BILINEAR
            )
            arr = np.asarray(img).copy()
            xy = np.asarray(bin_data["part"][i])[slots]  # (16, 2)
            ring = max(1.3, 2.0 * float(bin_data["scale"][i]))
            for m in range(16):
                _stamp_marker(arr, float(xy[m, 0]), float(xy[m, 1]), m,
                              ring, colors)
            yield os.path.join(data_dir, subject, name), arr, xy, ring


def write_h36m_learnable_dataset(
    data_dir: str,
    n_train: int = 512,
    n_valid: int = 128,
    rank: int = 5,
    seed: int = 0,
    img_size: int = 1000,
    calibration_dir: str = "/root/reference/calibration",
    camera: str = "54138969",
) -> str:
    """A geometrically consistent, visually learnable H36M tree for the
    whole SH chain (detector -> sh_preprocess -> SH lifting), the same
    bins and images as the JAX package's for the same arguments:

    - 3D poses on a shared low-rank manifold (2D determines 3D, so the
      lifting task has a floor near zero);
    - 2D 'part' through the camera calibration and the full distortion
      model (``data/h36m_generate.py``);
    - images carry the bullseye markers an MPII-trained detector reads, at
      each joint's projected pixel, with ids chosen so that the SH
      conversion's ``FROM_MPII_TO_H36M`` gather lands every detection on
      the H36M slot that survives the loader's nose deletion.
    """
    from PIL import Image

    from bilinear_tpu_torch.data.camera import load_camera
    from bilinear_tpu_torch.data.h36m import Task
    from bilinear_tpu_torch.data.h36m_generate import write_gt_bins

    struct = np.random.RandomState(seed + 1000)
    base = struct.randn(17, 3) * 150
    basis = struct.randn(rank, 17, 3) * 80

    def poses(n, s):
        z = np.random.RandomState(s).randn(n, rank)
        out = base[None] + np.einsum("nr,rjd->njd", z, basis)
        out[:, :, 2] += 5000.0
        return out.astype(np.float32)

    def names(n, tag):
        return [f"S1_Posing.{camera}_{tag}{i:06d}.jpg" for i in range(n)]

    cam = load_camera(calibration_dir, camera)
    splits = {
        Task.Train: {"S": poses(n_train, seed), "images": names(n_train, "t"),
                     "camera": cam},
        Task.Valid: {"S": poses(n_valid, seed + 1),
                     "images": names(n_valid, "v"), "camera": cam},
    }
    write_gt_bins(data_dir, splits)
    for path, arr, _, _ in learnable_canvases(data_dir, seed, img_size):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        Image.fromarray(arr).save(path, quality=92)
    return data_dir
