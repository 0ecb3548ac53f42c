"""AOT serving artifacts: ``torch.export`` programs in one file (counterpart
of ``bilinear_tpu/io/aot.py``).

A serving program is captured ONCE into a single versioned artifact:
weights as the program's constants, the normalisation inside the program,
a manifest beside it. A box with torch and numpy (no checkpoints, no
normalisation data, not even this package: the loader half of this file
imports only torch, numpy and the standard library) runs it:

    pose = load_artifact("lifting.aot")
    mm = pose(keypoints)            # (N, 16, 2) px -> (N, 16, 3) mm

- lifting: ONE program with a symbolic batch (``torch.export.Dim``) serves
  every request size, with no padding;
- end2end: the frame -> 2D + 3D program at fixed batch sizes; the loader
  runs a request as greedy largest-first chunks with the tail zero-padded
  up to the smallest size that fits (End2EndServer's dispatch);
- the manifest records the torch version, the device, the checkpoint epoch
  and each program's input and output shapes.

As in JAX, the exported program is the plain path: the lifting
``BilinearUnit`` in ``dtype`` (eval, BN from its running statistics), or
with ``quantize="int8-static"`` the plain static int8 chain
(``ops/lifting_int8.forward_chain`` with four calibrated scales); End2End
on the standard (unfused) detector. No kernel of this repository is in an
artifact: its programs hold only PyTorch's own operators. A program is
exported for one device and runs there (JAX exports for ``platforms``).

Artifact format (zip): ``manifest.json`` + one ``program_{tag}.pt2``
(``torch.export.save``) per entry, tag ``sym`` (symbolic batch) or ``b{N}``
(fixed batch N).
"""
from __future__ import annotations

import io
import json
import os
import zipfile
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

FORMAT = "bilinear-tpu-torch-aot-v1"
KINDS = ("lifting", "end2end")


# ---------------------------------------------------------------------------
# Export side (needs the package's models)
# ---------------------------------------------------------------------------

def _stats(module: torch.nn.Module, device, **arrays) -> None:
    for name, a in arrays.items():
        module.register_buffer(name, torch.as_tensor(
            np.asarray(a, np.float32).reshape(-1), device=device))


class _Lift(torch.nn.Module):
    """Image-space (b, 16, 2) keypoints -> z-score -> ``net`` -> un-normalize
    -> (b, 16, 3) mm (``LiftingServer.lift``)."""

    def __init__(self, net, mean_part, std_part, mean_s, std_s, device):
        super().__init__()
        self.net = net
        _stats(self, device, mean_part=mean_part, std_part=std_part,
               mean_s=mean_s, std_s=std_s)

    def forward(self, kp: torch.Tensor) -> torch.Tensor:
        n = kp.shape[0]
        x = (kp.reshape(n, 32) - self.mean_part) / self.std_part
        mm = self.net(x).float() * self.std_s + self.mean_s
        return mm.reshape(n, 16, 3)


class _StaticInt8(torch.nn.Module):
    """The plain static int8 lifting chain with its prepared weights as
    buffers and the four calibrated scales as constants."""

    def __init__(self, prepared, scales):
        super().__init__()
        self.scales = tuple(float(s) for s in scales)
        self.register_buffer("enc_w", prepared["encode"][0])
        self.register_buffer("enc_b", prepared["encode"][1])
        self.register_buffer("dec_w", prepared["decode"][0])
        self.register_buffer("dec_b", prepared["decode"][1])
        for i, (wq, ws, b) in enumerate(prepared["hidden"]):
            self.register_buffer(f"wq{i}", wq)
            self.register_buffer(f"ws{i}", ws)
            self.register_buffer(f"b{i}", b)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        from bilinear_tpu_torch.ops.lifting_int8 import forward_chain

        prepared = {
            "encode": (self.enc_w, self.enc_b),
            "hidden": [(getattr(self, f"wq{i}"), getattr(self, f"ws{i}"),
                        getattr(self, f"b{i}")) for i in range(4)],
            "decode": (self.dec_w, self.dec_b)}
        return forward_chain(prepared, self.scales, x[None])[0]


class _Pose(torch.nn.Module):
    """(b, 256, 256, 3) frames in [0, 1], centers, scales -> (pose2d px,
    pose3d mm) through an eval-mode End2End."""

    def __init__(self, model, mean_part, std_part, mean_s, std_s, device):
        super().__init__()
        self.model = model
        _stats(self, device, mean_part=mean_part, std_part=std_part,
               mean_s=mean_s, std_s=std_s)

    def forward(self, frames, centers, scales):
        _, pose2d, pose3d = self.model(frames, centers, scales,
                                       self.mean_part, self.std_part)
        mm = pose3d.float() * self.std_s + self.mean_s
        return pose2d, mm.reshape(mm.shape[0], 16, 3)


def export_lifting(params, batch_stats, mean_part, std_part, mean_s, std_s,
                   *, dtype=torch.bfloat16, device=None,
                   batch_sizes: Optional[Sequence[int]] = None,
                   quantize: Optional[str] = None, calib_sample=None
                   ) -> Dict[str, "torch.export.ExportedProgram"]:
    """Export the lifting serving computation (``LiftingServer.lift``
    semantics) from a JAX-layout checkpoint tree. ``batch_sizes=None``
    exports ONE program with a symbolic batch; otherwise one per size.
    ``quantize="int8-static"`` exports the plain static int8 chain with
    scales calibrated on ``calib_sample`` (z-scored training rows; a
    seeded standard-normal sample when None), the only quantized mode
    without data-dependent scale math. ``device`` defaults to the card."""
    from bilinear_tpu_torch.device import resolve_device

    device = resolve_device(device)
    if quantize == "int8-static":
        from bilinear_tpu_torch.ops.lifting_int8 import (calibrate_scales,
                                                         prepare_weights_int8)

        prepared = prepare_weights_int8(params, batch_stats, device)
        if calib_sample is not None:
            calib = np.asarray(calib_sample, np.float32).reshape(-1, 32)[:4096]
        else:
            calib = torch.randn((4096, 32),
                                generator=torch.Generator().manual_seed(0))
        # The plain calibration on the exported device's copy: the card's
        # kernel K2 would compute the same amaxes, but an artifact holds no
        # kernel of this repository.
        cpu = prepare_weights_int8(params, batch_stats, "cpu")
        net = _StaticInt8(prepared, calibrate_scales(cpu, calib))
    elif quantize is not None:
        raise ValueError(
            f"unsupported AOT quantize mode {quantize!r} (only 'int8-static' "
            "has no data-dependent scale math to export)")
    else:
        from bilinear_tpu_torch.models.bilinear import BilinearUnit
        from bilinear_tpu_torch.utils.weights import bilinear_from_jax

        net = BilinearUnit(dtype=dtype)
        net.load_state_dict(bilinear_from_jax(params, batch_stats))
    program = _Lift(net, mean_part, std_part, mean_s, std_s,
                    device).to(device).eval()
    with torch.no_grad():
        if batch_sizes is None:
            example = torch.zeros((2, 16, 2), device=device)
            batch = torch.export.Dim("b", min=1, max=1 << 24)
            return {"sym": torch.export.export(
                program, (example,), dynamic_shapes=({0: batch},))}
        return {f"b{n}": torch.export.export(
                    program, (torch.zeros((n, 16, 2), device=device),))
                for n in sorted(set(int(n) for n in batch_sizes))}


def export_end2end(variables, mean_part, std_part, mean_s, std_s, *,
                   variant: str = "torch7", dtype=torch.bfloat16,
                   model_kw: Optional[dict] = None,
                   batch_sizes: Sequence[int] = (1, 8, 16), device=None
                   ) -> Dict[str, "torch.export.ExportedProgram"]:
    """Export the frame -> 3D program at each fixed batch size, on the
    standard (unfused) detector. ``variables``: ``{"params",
    "batch_stats"}``, JAX-layout End2End trees. ``device`` defaults to the
    card."""
    from bilinear_tpu_torch.device import resolve_device
    from bilinear_tpu_torch.models.end2end import End2End

    device = resolve_device(device)
    kw = {k: v for k, v in (model_kw or {}).items() if k != "fused"}
    model = End2End(variant=variant, dtype=dtype, **kw).load_jax(variables)
    program = _Pose(model.eval(), mean_part, std_part, mean_s, std_s,
                    device).to(device).eval()
    out = {}
    with torch.no_grad():
        for n in sorted(set(int(n) for n in batch_sizes)):
            out[f"b{n}"] = torch.export.export(program, (
                torch.zeros((n, 256, 256, 3), device=device),
                torch.full((n, 2), 128.0, device=device),
                torch.ones((n,), device=device)))
    return out


def _avals(values) -> list:
    return [f"{tuple(v.shape)} {v.dtype}" for v in values]


def _signature(ep) -> dict:
    """The shapes and types of a program's inputs and outputs (a symbolic
    batch shows as its symbol)."""
    user = set(ep.graph_signature.user_inputs)
    ins = [n.meta["val"] for n in ep.graph.nodes
           if n.op == "placeholder" and n.name in user]
    outs = ep.graph.find_nodes(op="output")[0].args[0]
    return {"in": _avals(ins), "out": _avals(n.meta["val"] for n in outs)}


def save_artifact(path: str, kind: str, programs: Dict[str, object],
                  manifest_extra: Optional[dict] = None) -> dict:
    """Write the artifact zip (to a temporary file, then renamed over
    ``path``, so a server polling it never reads half a file); returns the
    manifest written."""
    if kind not in KINDS:
        raise ValueError(f"unknown artifact kind {kind!r}")
    if not programs:
        raise ValueError("no programs to save")
    first = next(iter(programs.values()))
    consts = list(first.state_dict.values()) + list(first.constants.values())
    device = next((str(t.device) for t in consts
                   if isinstance(t, torch.Tensor)), "cpu")
    manifest = {
        "format": FORMAT,
        "kind": kind,
        "torch_version": torch.__version__,
        "device": device,
        "device_name": (torch.cuda.get_device_name(torch.device(device))
                        if device.startswith("cuda") else "cpu"),
        "programs": {tag: _signature(ep) for tag, ep in programs.items()},
        **(manifest_extra or {}),
    }
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with zipfile.ZipFile(tmp, "w", zipfile.ZIP_DEFLATED) as z:
            z.writestr("manifest.json", json.dumps(manifest, indent=1))
            for tag, ep in programs.items():
                buf = io.BytesIO()
                torch.export.save(ep, buf)
                z.writestr(f"program_{tag}.pt2", buf.getvalue())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return manifest


# ---------------------------------------------------------------------------
# Load side (self-contained: torch + numpy only)
# ---------------------------------------------------------------------------

class AOTPose:
    """A loaded artifact. Call it:

    - kind "lifting":  pose(keypoints (N, 16, 2)) -> (N, 16, 3) mm
    - kind "end2end":  pose(frames (N, 256, 256, 3) [0,1] or uint8,
                            centers=None, scales=None)
                       -> (pose2d (N, 16, 2) px, pose3d (N, 16, 3) mm)

    numpy in, numpy out. Requests of any N are served: a symbolic program
    takes them whole; fixed-batch programs get greedy largest-first chunks
    with the tail padded up to the smallest size that fits."""

    def __init__(self, manifest: dict, programs: Dict[str, object]):
        self.manifest = manifest
        self.kind = manifest["kind"]
        self.device = torch.device(manifest["device"])
        self._sym = programs.get("sym")
        self._fixed = {int(tag[1:]): fn for tag, fn in programs.items()
                       if tag.startswith("b")}

    @property
    def batch_sizes(self) -> Tuple[int, ...]:
        return tuple(sorted(self._fixed))

    def _chunks(self, n: int):
        sizes = self.batch_sizes
        out, remaining = [], n
        while remaining > 0:
            fit = [b for b in sizes if b <= remaining]
            if fit:
                out.append((fit[-1], fit[-1]))
                remaining -= fit[-1]
            else:
                big = [b for b in sizes if b >= remaining]
                if not big:
                    raise ValueError(
                        f"request of {n} rows but artifact has no batch "
                        f"size <= or >= {remaining} (sizes {sizes})")
                out.append((remaining, big[0]))
                remaining = 0
        return out

    def _run(self, fn, arrays):
        with torch.no_grad():
            return fn(*(torch.from_numpy(np.ascontiguousarray(a)).to(
                self.device) for a in arrays))

    def _dispatch(self, arrays, n: int):
        """Run per-row-aligned numpy ``arrays`` through the program(s);
        returns a list of (slice, take, results)."""
        if self._sym is not None:
            return [(slice(0, n), n, self._run(self._sym, arrays))]
        dispatched, done = [], 0
        for take, batch in self._chunks(n):
            idx = slice(done, done + take)
            chunk = []
            for a in arrays:
                part = a[idx]
                if take < batch:
                    pad = np.zeros((batch - take,) + part.shape[1:],
                                   part.dtype)
                    part = np.concatenate([part, pad])
                chunk.append(part)
            dispatched.append((idx, take, self._run(self._fixed[batch],
                                                    chunk)))
            done += take
        return dispatched

    def __call__(self, *args, **kw):
        if self.kind == "lifting":
            return self.lift(*args, **kw)
        return self.predict(*args, **kw)

    def lift(self, keypoints_2d) -> np.ndarray:
        kp = np.ascontiguousarray(keypoints_2d, np.float32).reshape(-1, 16, 2)
        n = kp.shape[0]
        out = np.zeros((n, 16, 3), np.float32)
        for idx, take, res in self._dispatch((kp,), n):
            out[idx] = res[:take].float().cpu().numpy()
        return out

    def predict(self, frames, centers=None, scales=None):
        frames = np.asarray(frames)
        if frames.dtype == np.uint8:
            frames = frames.astype(np.float32) / np.float32(255.0)
        frames = np.ascontiguousarray(frames, np.float32)
        n = frames.shape[0]
        if centers is None:  # the full-frame box (webcam.py:13-25)
            centers = np.full((n, 2), 128.0, np.float32)
        if scales is None:
            scales = np.full((n,), 256.0 / 200.0, np.float32)
        centers = np.ascontiguousarray(centers, np.float32)
        scales = np.ascontiguousarray(scales, np.float32)
        pose2d = np.zeros((n, 16, 2), np.float32)
        pose3d = np.zeros((n, 16, 3), np.float32)
        for idx, take, (p2, p3) in self._dispatch(
                (frames, centers, scales), n):
            pose2d[idx] = p2[:take].float().cpu().numpy()
            pose3d[idx] = p3[:take].float().cpu().numpy()
        return pose2d, pose3d


class AOTServer:
    """An artifact FILE behind the daemon's server contract
    (``serving_http.PoseHTTPServer``: ``lift``/``predict``, ``epoch``,
    ``reload()``, ``warm``): ``python -m bilinear_tpu_torch.cli.serve --aot
    pose.aot`` serves it with no checkpoint and no normalisation data on the
    box. ``reload()`` re-reads the file when its (mtime, size) changes, so
    replacing the artifact atomically (``save_artifact`` does) hot-swaps the
    weights: the swap is one reference assignment, and a request in flight
    finishes on the programs it started with."""

    input_size = (256, 256)  # the (H, W) End2End artifacts are exported at

    def __init__(self, path: str):
        self.path = path
        self._sig = None
        self._pose: Optional[AOTPose] = None
        self.reload()

    @property
    def kind(self) -> str:
        return self._pose.kind

    @property
    def manifest(self) -> dict:
        return self._pose.manifest

    @property
    def epoch(self) -> int:
        return int(self._pose.manifest.get("epoch", -1))

    def reload(self) -> bool:
        # stat BEFORE reading: if the file is replaced mid-load the
        # pre-replace signature is recorded and the next poll reloads.
        st = os.stat(self.path)
        sig = (st.st_mtime_ns, st.st_size)
        if sig == self._sig:
            return False
        pose = load_artifact(self.path)  # parse fully, then swap
        self._pose, self._sig = pose, sig
        return True

    def lift(self, keypoints_2d) -> torch.Tensor:
        return torch.from_numpy(self._pose.lift(keypoints_2d))

    def predict(self, frames, centers=None, scales=None):
        return self._pose.predict(frames, centers, scales)

    def warm(self, arg) -> list:
        """Run each program once before the first request: ``arg`` is the
        row counts for a lifting artifact, the frame dtypes ("uint8"/"u8",
        "float32") for an end2end one. Returns what was run."""
        pose, done = self._pose, []
        if pose.kind == "lifting":
            for n in sorted(set(int(n) for n in arg)):
                pose.lift(np.zeros((n, 16, 2), np.float32))
                done.append(n)
            return done
        for dt in arg:
            np_dt = np.uint8 if dt in ("uint8", "u8") else np.float32
            for b in pose.batch_sizes:
                pose.predict(np.zeros((b, 256, 256, 3), np_dt))
                done.append((b, np.dtype(np_dt).name))
        return done


def load_artifact(path: str) -> AOTPose:
    with zipfile.ZipFile(path) as z:
        manifest = json.loads(z.read("manifest.json"))
        if manifest.get("format") != FORMAT:
            raise ValueError(
                f"{path!r} is not a {FORMAT} artifact "
                f"(format={manifest.get('format')!r})")
        programs = {}
        for tag in manifest["programs"]:
            ep = torch.export.load(io.BytesIO(z.read(f"program_{tag}.pt2")))
            programs[tag] = ep.module()
    return AOTPose(manifest, programs)
