"""Serving (counterpart of ``bilinear_tpu/serving.py``): batched 2D->3D
lifting around the lifting kernels (``LiftingServer``) and batched
frame->3D over the End2End model (``End2EndServer``).

  image-space (N, 16, 2) -> z-score with the TRAIN-split part stats
  -> kernel K1 (bf16 or f32) or K2 (int8 / int8-static), BN folded once
  -> un-normalize with the TRAIN-split S stats -> (N, 16, 3) mm,
     root-centered (pelvis at the origin).

Weights are folded (and quantized, and calibrated) once per checkpoint.
``from_run_dir`` serves the newest ``{run_dir}/parameter/{epoch}.save``,
written by the JAX trainer or by the port, and ``reload`` swaps in a newer
one. ``End2EndServer`` runs frames through the detector (``variant``,
``models/detectors.py``) -> soft-argmax -> lifting at fixed batch sizes;
with ``model_kw={"fused": True}`` the torch7 detector's ResModules run
through kernel K3 (eval), and with ``quantize="int8"`` an hourglass's body
convs run as int8 convolutions (kernels K6/K7, no K3); a detector without
them refuses. HRNet-W48 runs on cuDNN's convolutions, each followed by one
epilogue (its BN, sums, upsamples and ReLU; kernel K8). Both servers run on
the card unless ``device="cpu"`` is passed.

``mesh=`` (a list of local devices or ``parallel/mesh.py::LocalMesh``; a
device may repeat) serves one request over several devices, as JAX's
``shard_map`` / GSPMD programs do: the weights are replicated to every
device (one engine or model per device, republished together in one
assignment on hot reload), a batch is split into equal row blocks (lifting
pads the rows with zeros to a multiple of the devices, as JAX does), each
block runs on its device through that device's kernels (K1/K2; K3 eval or
K6/K7), and the blocks are joined in order.

Spans (``utils/profiling.py::span``, recorded only while a profiler
records), ``SPANS``: ``e2e.predict`` is one ``End2EndServer.predict`` call,
and inside it, per chunk, ``e2e.h2d`` (frames, centres and scales to the
device, the padding, u8 -> f32) and ``e2e.forward`` (the model's host
dispatch of the chunk), then once ``e2e.d2h`` (the answers to the host:
the wait for the device, then the copy); the numpy work before the first
chunk and after the copy is ``e2e.predict``'s own time. ``lift.call`` is
one ``LiftingServer.lift`` or ``lift_normalized`` call.
"""
from __future__ import annotations

import os
import threading
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from bilinear_tpu_torch.data.h36m import H36MSplit
from bilinear_tpu_torch.device import resolve_device
from bilinear_tpu_torch.io.checkpoint import latest_epoch, load_checkpoint
from bilinear_tpu_torch.models.detectors import detector
from bilinear_tpu_torch.ops import int8
from bilinear_tpu_torch.ops.lifting import lifting_forward, prepare_weights
from bilinear_tpu_torch.ops.lifting_int8 import (
    calibrate_scales,
    lifting_forward_int8,
    prepare_weights_int8,
)
from bilinear_tpu_torch.parallel.mesh import as_local_mesh
from bilinear_tpu_torch.utils.profiling import span

QUANTIZE_MODES = (None, "int8", "int8-static")
SPANS = ("e2e.predict", "e2e.h2d", "e2e.forward", "e2e.d2h", "lift.call")


class _LiftingEngine(NamedTuple):
    """Immutable snapshot of everything one forward needs. ``_set_weights``
    builds a complete new engine and publishes it with ONE reference
    assignment, and ``_forward`` reads ``self._engine`` exactly once, so a
    hot reload on another thread can never pair new weights with a previous
    checkpoint's calibration scales."""

    prepared: object
    static_scales: Optional[tuple]
    shards: tuple = ()  # (device, prepared) per device of a mesh


class LiftingServer:
    def __init__(
        self,
        params,
        batch_stats,
        mean_part: np.ndarray,
        std_part: np.ndarray,
        mean_s: np.ndarray,
        std_s: np.ndarray,
        dtype=torch.bfloat16,
        quantize: Optional[str] = None,
        calib_sample: Optional[np.ndarray] = None,
        device=None,
        mesh=None,
    ):
        """``params``/``batch_stats``: the JAX package's parameter tree
        (numpy leaves, as a ``.save`` checkpoint holds them).

        ``quantize="int8"`` runs the hidden layers as int8 products with a
        dynamic scale per 512-row group; ``"int8-static"`` uses four scales
        calibrated on ``calib_sample`` (z-scored training inputs; a
        standard-normal sample from a seeded generator when None). Inputs
        beyond the calibrated range saturate at +-127. Scales are
        re-calibrated on hot reload. Default (None) is the ``dtype`` kernel.

        ``device``: None is the card, and raises when there is none.
        ``mesh``: local devices to split each request's rows over (the
        first holds the statistics and the answers)."""
        if quantize not in QUANTIZE_MODES:
            raise ValueError(f"unsupported quantize mode {quantize!r}")
        if dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"unsupported dtype {dtype!r}")
        self._mesh = None if mesh is None else as_local_mesh(mesh)
        self.device = resolve_device(
            self._mesh.devices[0] if self._mesh is not None else device)
        self._quantize = quantize
        self._dtype = dtype
        self._calib_sample = None if calib_sample is None else np.asarray(
            calib_sample, np.float32
        ).reshape(-1, 32)[:4096]
        self._set_weights(params, batch_stats)
        self.parameter_dir: Optional[str] = None  # set by from_run_dir
        self.epoch = 0

        def stat(a):
            return torch.as_tensor(np.asarray(a, np.float32),
                                   device=self.device)

        self._mean_part = stat(mean_part)
        self._std_part = stat(std_part)
        self._mean_s = stat(mean_s)
        self._std_s = stat(std_s)

    def _set_weights(self, params, batch_stats) -> None:
        """(Re)fold the checkpoint into the kernel's prepared form and
        publish the complete new engine in one assignment."""
        prepared = self._prepare(params, batch_stats, self.device)
        static_scales = None
        if self._quantize == "int8-static":
            if self._calib_sample is not None:
                calib = self._calib_sample
            else:
                gen = torch.Generator().manual_seed(0)
                calib = torch.randn((4096, 32), generator=gen)
            static_scales = calibrate_scales(prepared, calib)
        shards = () if self._mesh is None else tuple(
            (dev, prepared if dev == self.device else
             self._prepare(params, batch_stats, dev))
            for dev in self._mesh.devices)
        self._engine = _LiftingEngine(prepared, static_scales, shards)

    def _prepare(self, params, batch_stats, device):
        """The checkpoint folded (and quantized) for the kernel, on
        ``device``."""
        if self._quantize in ("int8", "int8-static"):
            return prepare_weights_int8(params, batch_stats, device)
        return prepare_weights(params, batch_stats, self._dtype, device)

    @classmethod
    def from_run_dir(cls, run_dir: str, split: H36MSplit, **kw):
        """Serve the newest ``{run_dir}/parameter/{epoch}.save`` with
        normalization stats from the train split ``split``. Raises
        FileNotFoundError when the dir holds no checkpoint: a serving
        process never serves random weights. Returns (server, epoch)."""
        parameter_dir = os.path.join(run_dir, "parameter")
        epoch = latest_epoch(parameter_dir)
        if epoch == 0:
            raise FileNotFoundError(
                f"no checkpoint under {parameter_dir!r} — refusing to serve "
                "uninitialized weights"
            )
        state = load_checkpoint(parameter_dir, epoch)["state"]
        kw.setdefault("calib_sample", split.part)  # z-scored train inputs
        server = cls(
            state["params"], state["batch_stats"],
            split.mean_part, split.std_part, split.mean_s, split.std_s, **kw,
        )
        server.parameter_dir = parameter_dir
        server.epoch = epoch
        return server, epoch

    def reload(self) -> bool:
        """Swap in the newest checkpoint if one landed since construction.
        Returns True when the weights changed."""
        if self.parameter_dir is None:
            return False
        newest = latest_epoch(self.parameter_dir)
        if newest <= self.epoch:
            return False
        try:
            payload = load_checkpoint(self.parameter_dir, newest)
        except FileNotFoundError:
            # Scan/load race with a trainer pruning old checkpoints; the
            # next poll sees the newer one.
            return False
        state = payload["state"]
        self._set_weights(state["params"], state["batch_stats"])
        self.epoch = newest
        return True

    def _kernel(self, x: torch.Tensor, prepared, static_scales):
        if self._quantize in ("int8", "int8-static"):
            return lifting_forward_int8(
                x=x, prepared=prepared, static_scales=static_scales,
            )
        return lifting_forward(None, None, x, dtype=self._dtype,
                               prepared=prepared)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        eng = self._engine  # ONE read: a consistent snapshot
        if not eng.shards:
            return self._kernel(x, eng.prepared, eng.static_scales)
        # JAX's sharded forward: zero rows up to a multiple of the devices,
        # one equal block per device, the answers' first n rows.
        n = x.shape[0]
        k = len(eng.shards)
        pad = (-n) % k
        if pad:
            x = torch.cat([x, x.new_zeros((pad, x.shape[1]))])
        outs = [self._kernel(block.to(dev), prepared, eng.static_scales)
                for block, (dev, prepared) in zip(x.chunk(k), eng.shards)]
        return torch.cat([o.to(self.device) for o in outs])[:n]

    def _rows(self, a, width: int) -> torch.Tensor:
        t = torch.as_tensor(np.asarray(a, np.float32)) \
            if not isinstance(a, torch.Tensor) else a.float()
        return t.to(self.device).reshape(-1, width)

    def lift(self, keypoints_2d) -> torch.Tensor:
        """(N, 16, 2) image-space keypoints (H36M 16-joint order, nose
        dropped) -> (N, 16, 3) root-centered 3D mm, f32 on the server's
        device."""
        with span("lift.call"):
            kp = self._rows(keypoints_2d, 32)
            x = (kp - self._mean_part) / self._std_part
            mm = self._forward(x) * self._std_s + self._mean_s
            return mm.reshape(-1, 16, 3)

    def lift_normalized(self, x_norm) -> torch.Tensor:
        """(N, 32) pre-normalized inputs -> (N, 48) normalized outputs."""
        with span("lift.call"):
            return self._forward(self._rows(x_norm, 32))

    def warm(self, row_counts) -> list:
        """Run the forward once for each row count, so the kernels are
        built and loaded before the first request. Returns the counts."""
        warmed = []
        for n in sorted(set(int(n) for n in row_counts)):
            self._forward(torch.zeros((n, 32), device=self.device))
            warmed.append(n)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return warmed


FRAME_DTYPES = {"uint8": np.uint8, "u8": np.uint8, "float32": np.float32}


def memory_order(a: np.ndarray) -> Tuple[int, ...]:
    """The axes of ``a`` by descending absolute byte stride, so that
    ``a.transpose(order)`` read in C order walks ``a``'s memory in runs as
    long as its layout allows (a negative-stride axis backwards).
    The identity for C-contiguous ``a``, and for a layout whose strides
    repeat or overlap memory (``np.broadcast_to``), which no order places."""
    identity = tuple(range(a.ndim))
    if a.flags.c_contiguous:
        return identity
    order = sorted(identity, key=lambda i: -abs(a.strides[i]))
    inner = a.itemsize  # bytes one step of the next axis out must clear
    for i in reversed(order):
        if a.shape[i] > 1:
            if abs(a.strides[i]) < inner:
                return identity
            inner = abs(a.strides[i]) * a.shape[i]
    return tuple(order)


def check_frames(frames: np.ndarray, input_size: Tuple[int, int]) -> None:
    """Raise for frames that are not (N, H, W, 3), (H, W) = ``input_size``
    (a served detector's)."""
    want = tuple(input_size) + (3,)
    if frames.ndim != 4 or frames.shape[1:] != want:
        raise ValueError(f"frames must be (N, {want[0]}, {want[1]}, 3), got "
                         f"{frames.shape}")


def default_box(input_size: Tuple[int, int], n: int
                ) -> Tuple[np.ndarray, np.ndarray]:
    """(centres (n, 2), scales (n,)) of the full-frame box of (H, W) =
    ``input_size`` frames: centred on the frame, (W/2, H/2), its scale
    H/200 (the box H px tall)."""
    h, w = input_size
    return (np.tile(np.float32([w / 2.0, h / 2.0]), (n, 1)),
            np.full((n,), h / 200.0, np.float32))


class End2EndServer:
    """Batched frame->3D serving over the End2End model.

    - ``predict(frames)`` takes any number of frames and runs them as
      greedy largest-first chunks of ``batch_sizes``, the remainder
      zero-padded up to the smallest size that fits, so the card only ever
      sees those batch sizes.
    - Each chunk's frames reach the device in one copy from one staging
      buffer (pinned on the card), in the caller's own memory order (a
      strided view is read in runs, not gathered), restored to (batch, H,
      W, 3) by the u8 -> f32 kernel, (H, W) the detector's ``input_size``
      (256 x 256; ViTPose's 256 x 192); frames of another shape raise.
      ``frames_reordered`` counts the frames staged in another order than
      C order, and ``frames_padded`` the zero frames added.
    - ``reload()`` loads a newer epoch of ``parameter_dir`` into a NEW
      model built off to the side and publishes it with one assignment;
      ``predict`` reads the model once per call, so one response never
      mixes two epochs and no request runs on a module being loaded.
    """

    def __init__(self, variables, mean_part, std_part, mean_s, std_s,
                 variant: str = "torch7", dtype=torch.bfloat16,
                 batch_sizes: Sequence[int] = (1, 8, 16),
                 model_kw: Optional[dict] = None,
                 parameter_dir: Optional[str] = None, epoch: int = 0,
                 quantize: Optional[str] = None, device=None, mesh=None):
        """``variables``: ``{"params", "batch_stats"}``, End2End's trees
        (numpy leaves, as a ``.save`` holds them): the JAX package's for
        the hourglasses, HRNet's and ViTPose's published names for
        ``variant="hrnet"`` and ``"vitpose"`` (``utils/weights.py``).
        ``model_kw`` goes to ``End2End`` (``{"fused": True}`` serves the
        torch7 detector through K3). ``quantize="int8"`` serves the
        detector's body convs as dynamic int8 convolutions (the same
        checkpoints; weights quantized once per loaded model, again at each
        reload). ``device``: None is the card, and raises when there is
        none. ``mesh``: local devices to split each chunk's frames over;
        every entry of ``batch_sizes`` must divide over them."""
        if dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"unsupported dtype {dtype!r}")
        if quantize not in int8.MODES:
            raise ValueError(f"unsupported quantize mode {quantize!r}")
        self._mesh = None if mesh is None else as_local_mesh(mesh)
        if self._mesh is not None:
            n_data = len(self._mesh)
            bad = [b for b in batch_sizes if b % n_data]
            if bad:
                raise ValueError(
                    f"batch_sizes {bad} do not divide the mesh's data axis "
                    f"({n_data}); pick multiples of it"
                )
            device = self._mesh.devices[0]
        self.device = resolve_device(device)
        self.variant = variant
        self.dtype = dtype
        self.quantize = quantize
        self.model_kw = dict(model_kw or {})
        self.batch_sizes = tuple(sorted(set(int(b) for b in batch_sizes)))
        self.parameter_dir = parameter_dir
        self.epoch = epoch
        self.frames_padded = 0  # zero frames added to fill a batch size
        self.frames_reordered = 0  # frames staged in another order than C
        # One staging buffer (pinned on the card); the event marks the end
        # of the copy that last read it.
        self._stage_lock = threading.Lock()
        self._staging = None
        self._copied = (torch.cuda.Event() if self.device.type == "cuda"
                        else None)
        self._model = self._build(variables)
        first = self._model if self._mesh is None else self._model[0]
        self.input_size = tuple(first.input_size)

        def stat(a, dev=self.device):
            return torch.as_tensor(np.asarray(a, np.float32).reshape(-1),
                                   device=dev)

        self._mean_part, self._std_part = stat(mean_part), stat(std_part)
        self._part_stats = None if self._mesh is None else tuple(
            (stat(mean_part, d), stat(std_part, d))
            for d in self._mesh.devices)
        self._mean_s = np.asarray(mean_s, np.float32).reshape(-1)
        self._std_s = np.asarray(std_s, np.float32).reshape(-1)
        self._255 = torch.tensor(255.0, device=self.device)

    def _build(self, variables):
        """A new eval-mode End2End holding ``variables``, on the device;
        under a mesh a tuple of them, one per device. A detector with an
        eval plan (its class's ``eval_plan``: HRNet's, ViTPose's) builds it
        here, so each reload brings its own."""
        from bilinear_tpu_torch.models.end2end import End2End

        def one(dev):
            model = End2End(variant=self.variant, dtype=self.dtype,
                            quantize=self.quantize, **self.model_kw)
            model = model.load_jax(variables).to(dev).eval()
            if detector(self.variant).eval_plan:
                model.hourglass.build_eval_plan()
            return model

        if self._mesh is None:
            return one(self.device)
        return tuple(one(d) for d in self._mesh.devices)

    @classmethod
    def from_run_dir(cls, run_dir: str, split: H36MSplit,
                     variant: str = "torch7",
                     model_kw: Optional[dict] = None, **kw):
        """Serve the newest ``{run_dir}/parameter/{epoch}.save`` (either
        package's) with the statistics of the train split ``split``, with
        hot reload. Raises FileNotFoundError when the dir holds no
        checkpoint: a serving process never serves random weights."""
        parameter_dir = os.path.join(run_dir, "parameter")
        epoch = latest_epoch(parameter_dir)
        if epoch <= 0:
            raise FileNotFoundError(
                f"no checkpoint under {parameter_dir!r} — refusing to serve "
                "uninitialized weights")
        state = load_checkpoint(parameter_dir, epoch)["state"]
        return cls(state, split.mean_part, split.std_part, split.mean_s,
                   split.std_s, variant=variant, model_kw=model_kw,
                   parameter_dir=parameter_dir, epoch=epoch, **kw)

    def reload(self) -> bool:
        """Swap in the newest checkpoint if one landed since construction.
        Returns True when the weights changed."""
        if self.parameter_dir is None:
            return False
        newest = latest_epoch(self.parameter_dir)
        if newest <= self.epoch:
            return False
        try:
            payload = load_checkpoint(self.parameter_dir, newest)
        except FileNotFoundError:
            # Scan/load race with a trainer pruning old checkpoints.
            return False
        self._model = self._build(payload["state"])  # ONE assignment
        self.epoch = newest
        return True

    def _chunks(self, n: int):
        """Greedy largest-first split of n into (take, batch) pairs; the
        remainder is padded up to the smallest size that fits."""
        sizes = self.batch_sizes
        out = []
        remaining = n
        while remaining > 0:
            fit = [b for b in sizes if b <= remaining]
            if fit:
                out.append((fit[-1], fit[-1]))
                remaining -= fit[-1]
            else:
                padded = next(b for b in sizes if b >= remaining)
                out.append((remaining, padded))
                remaining = 0
        return out

    def predict(self, frames, centers=None, scales=None
                ) -> Tuple[np.ndarray, np.ndarray]:
        """frames (N, H, W, 3), u8 or f32 in [0, 1], (H, W) the detector's
        ``input_size`` -> (pose2d (N, 16, 2) in frame pixels, pose3d (N, 16,
        3) mm, root-centred). Frames of another shape raise. Defaults: the
        full-frame box (``default_box``: centre 128, scale 256/200 at 256 x
        256, webcam.py:13-25).

        u8 frames stay u8 until they reach the device and are divided by
        255 there (a quarter of the f32 bytes over the bus)."""
        with span("e2e.predict"):
            frames = np.asarray(frames)
            if frames.dtype != np.uint8:
                frames = np.asarray(frames, np.float32)
            check_frames(frames, self.input_size)
            n = frames.shape[0]
            box = default_box(self.input_size, n)
            centers = box[0] if centers is None else centers
            scales = box[1] if scales is None else scales
            centers = np.asarray(centers, np.float32)
            scales = np.asarray(scales, np.float32)
            model = self._model  # ONE read: every chunk on the same weights
            outs = []
            done = 0
            with torch.no_grad():
                for take, batch in self._chunks(n):
                    with span("e2e.h2d"):
                        f, c, s = self._stage(frames[done:done + take],
                                              centers[done:done + take],
                                              scales[done:done + take], batch)
                    with span("e2e.forward"):
                        _, p2, p3 = self._run(model, f, c, s)
                    outs.append((take, p2[:take], p3[:take]))
                    done += take
                # Every chunk is queued before the first copy back waits.
                with span("e2e.d2h"):
                    pose2d, pose3d = (
                        torch.cat([o[i] for o in outs]).float().cpu().numpy()
                        for i in (1, 2))
            mm = pose3d * self._std_s + self._mean_s
            return pose2d, mm.reshape(n, 16, 3)

    def _stage(self, frames, centers, scales, batch: int):
        """One chunk to the device. ``frames`` (take of them) are copied in
        their own memory order (``memory_order``, negative-stride axes
        flipped) into the staging buffer and sent in one copy; on the
        device one kernel writes the model's C-contiguous f32 input from a
        view that restores the (take, H, W, 3) layout (u8 divided by
        255; a flipped axis adds a flip), and zero frames fill the batch,
        their centres 128 and scales 1. Returns (frames, centres, scales)
        on the device."""
        dev = self.device
        take = len(frames)
        # Before the frames: a pageable copy waits for the stream.
        c = torch.from_numpy(np.ascontiguousarray(centers)).to(dev)
        s = torch.from_numpy(np.ascontiguousarray(scales)).to(dev)
        if take < batch:
            pad = batch - take
            c = torch.cat([c, c.new_full((pad, 2), 128.0)])
            s = torch.cat([s, s.new_ones(pad)])
        flips = tuple(i for i in range(frames.ndim) if frames.strides[i] < 0)
        frames = np.flip(frames, flips)  # torch takes no negative stride
        order = memory_order(frames)
        src = torch.from_numpy(frames.transpose(order))
        nbytes = src.numel() * src.element_size()
        f = torch.empty((batch,) + frames.shape[1:], dtype=torch.float32,
                        device=dev)
        with self._stage_lock:
            if order != tuple(range(frames.ndim)):
                self.frames_reordered += take
            self.frames_padded += batch - take
            if self._copied is not None:
                self._copied.synchronize()  # the last copy has read it
            if self._staging is None or self._staging.numel() < nbytes:
                self._staging = torch.empty(  # for the largest batch size
                    max(self.batch_sizes) * (nbytes // take),
                    dtype=torch.uint8, pin_memory=dev.type == "cuda")
            x = self._staging[:nbytes].view(src.dtype).view(src.shape)
            x.copy_(src)
            x = x.to(dev, non_blocking=True)  # on the CPU, the buffer itself
            if self._copied is not None:
                self._copied.record(torch.cuda.current_stream(dev))
            x = x.permute([order.index(i) for i in range(len(order))])
            if flips:
                x = x.flip(flips)
            if take < batch:
                f[take:].zero_()
            if x.dtype == torch.uint8:
                torch.div(x, self._255, out=f[:take])
            else:
                f[:take].copy_(x)
        return f, c, s

    def _run(self, model, f, c, s):
        """One chunk through the model, or its equal row blocks through
        each device's model, joined in order on the first device."""
        if self._mesh is None:
            return model(f, c, s, self._mean_part, self._std_part)
        k = len(model)
        parts = [m(fb.to(d), cb.to(d), sb.to(d), mp, sp)
                 for m, d, (mp, sp), fb, cb, sb in zip(
                     model, self._mesh.devices, self._part_stats,
                     f.chunk(k), c.chunk(k), s.chunk(k))]
        return tuple(torch.cat([p[i].to(self.device) for p in parts],
                               dim=1 if i == 0 else 0)
                     for i in range(3))

    def warm(self, dtypes=("uint8",)) -> list:
        """Run every batch size once per frame dtype, so the kernels are
        built and loaded before the first request. ``dtypes``: "uint8"
        (or "u8") and "float32"; any other string raises. Returns the
        (batch, dtype) pairs run."""
        bad = [d for d in dtypes if d not in FRAME_DTYPES]
        if bad:
            raise ValueError(f"unknown frame dtype(s) {bad}; use one of "
                             f"{sorted(FRAME_DTYPES)}")
        warmed = []
        for dt in dtypes:
            np_dt = FRAME_DTYPES[dt]
            for b in self.batch_sizes:
                self.predict(np.zeros((b,) + self.input_size + (3,),
                                      np_dt))
                warmed.append((b, np.dtype(np_dt).name))
        return warmed
