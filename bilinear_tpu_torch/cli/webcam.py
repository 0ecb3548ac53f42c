"""Live or offline pose demo (counterpart of ``bilinear_tpu/cli/webcam.py``),
on the GPU.

Captures frames (a camera, a video file, or a synthetic moving pattern for
headless runs), resizes each to 256x256, runs the End2End forward
(hourglass -> soft-argmax -> lifting) and draws the 16 detected keypoints
as red squares on a 4x upscaled frame, as the reference's webcam.py:27-45
does; 'q' quits.

Usage:
  python -m bilinear_tpu_torch.cli.webcam                 # camera 0
  python -m bilinear_tpu_torch.cli.webcam --video in.mp4  # offline file
  python -m bilinear_tpu_torch.cli.webcam --synthetic --frames 10 \\
      --out-dir out/

The model is the newest checkpoint of ``{save_root}/{comment}/parameter``
(a fresh initialisation, epoch 0, when there is none, as in the JAX CLI),
in f32, with the lifting statistics at mean 0 and std 1 (the JAX CLI's).
``--n-stacks/--features/--depth`` are the port's. The torch7 detector's
ResModules run through kernel K3; ``--device cpu`` runs the plain PyTorch
path and is meant for tests only. ``cv2`` is imported only on the
capture path.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from bilinear_tpu_torch.device import disable_tf32, resolve_device
from bilinear_tpu_torch.io.checkpoint import latest_epoch, load_checkpoint
from bilinear_tpu_torch.models.detectors import detector
from bilinear_tpu_torch.train.end2end import End2EndTrainer


def build_forward(variant: str, save_root: str, comment: str, seed: int = 0,
                  device=None, model_kw=None):
    """(forward, model, epoch): ``forward(frame)`` takes one (256, 256, 3)
    f32 frame in [0, 1] and returns (pose2d (16, 2) in frame pixels, pose3d
    (48,) normalized) as numpy arrays."""
    trainer = End2EndTrainer(variant=variant, model_kw=model_kw,
                             device=device)
    model = trainer.make_model(seed).eval()
    pdir = os.path.join(save_root, comment, "parameter")
    epoch = max(latest_epoch(pdir), 0)
    if epoch:
        model.load_jax(load_checkpoint(pdir, epoch)["state"])
    dev = trainer.device
    mean = torch.zeros(32, device=dev)
    std = torch.ones(32, device=dev)
    centers = torch.tensor([[128.0, 128.0]], device=dev)
    scales = torch.tensor([256.0 / 200.0], device=dev)

    @torch.no_grad()
    def forward(frame):
        images = torch.as_tensor(np.asarray(frame, np.float32),
                                 device=dev)[None]
        _, pose2d, pose3d = model(images, centers, scales, mean, std)
        return pose2d[0].cpu().numpy(), pose3d[0].cpu().numpy()

    return forward, model, epoch


def draw_keypoints(frame_u8: np.ndarray, pose2d: np.ndarray,
                   upscale: int = 4) -> np.ndarray:
    """Red 4x4 squares at the 4x upscaled keypoint positions
    (webcam.py:33-43)."""
    big = np.repeat(np.repeat(frame_u8, upscale, 0), upscale, 1).copy()
    h, w = big.shape[:2]
    for x, y in pose2d:
        xi, yi = int(x * upscale), int(y * upscale)
        if 0 <= xi < w - 4 and 0 <= yi < h - 4:
            big[yi:yi + 4, xi:xi + 4] = (255, 0, 0)
    return big


def synthetic_frames(n: int):
    """``n`` 256x256 u8 frames: a seeded 32x32 pattern at 8x, shifted 8
    pixels right per frame."""
    rng = np.random.RandomState(0)
    base = (rng.rand(32, 32, 3) * 255).astype(np.uint8)
    for i in range(n):
        yield np.roll(np.kron(base, np.ones((8, 8, 1))).astype(np.uint8),
                      shift=8 * i, axis=1)


def main(argv=None) -> None:
    disable_tf32()
    parser = argparse.ArgumentParser()
    parser.add_argument("--variant", default="torch7")
    parser.add_argument("--save-root", default="save")
    parser.add_argument("--comment", default="End2End")
    parser.add_argument("--video", default=None)
    parser.add_argument("--camera", type=int, default=0)
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--frames", type=int, default=30)
    parser.add_argument("--out-dir", default=None)
    parser.add_argument("--n-stacks", type=int, default=None)
    parser.add_argument("--features", type=int, default=None)
    parser.add_argument("--depth", type=int, default=None)
    parser.add_argument("--device", default=None,
                        help="torch device; default the GPU (no CPU "
                             "fallback)")
    args = parser.parse_args(argv)

    model_kw = dict(n_stacks=args.n_stacks, features=args.features,
                    depth=args.depth,
                    fused=detector(args.variant).fused_blocks)
    forward, _, epoch = build_forward(
        args.variant, args.save_root, args.comment,
        device=resolve_device(args.device), model_kw=model_kw)
    print(f"End2End forward ready (epoch {epoch})")
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)

    if args.synthetic:
        source = synthetic_frames(args.frames)
        show = False
    else:
        import cv2

        cap = cv2.VideoCapture(args.video if args.video else args.camera)
        if not cap.isOpened():
            raise SystemExit("could not open capture source")

        def gen():
            while True:
                ok, frame = cap.read()
                if not ok:
                    break
                yield cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)

        source = gen()
        show = args.out_dir is None

    from PIL import Image

    for i, frame in enumerate(source):
        img = Image.fromarray(frame).resize((256, 256), Image.BILINEAR)
        arr = np.asarray(img, np.float32) / 255.0
        pose2d, _ = forward(arr)
        overlay = draw_keypoints(np.asarray(img, np.uint8), pose2d)
        if args.out_dir:
            Image.fromarray(overlay).save(
                os.path.join(args.out_dir, f"frame_{i:04d}.png"))
        if show:
            import cv2

            cv2.imshow("bilinear_tpu_torch",
                       cv2.cvtColor(overlay, cv2.COLOR_RGB2BGR))
            if cv2.waitKey(1) & 0xFF == ord("q"):
                break
    print("done")


if __name__ == "__main__":
    main()
