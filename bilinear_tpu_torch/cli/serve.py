"""Pose daemon: HTTP front-end with dynamic batching and checkpoint
hot-reload over the CUDA kernels (counterpart of
``bilinear_tpu/cli/serve.py``).

Usage (on a machine with an NVIDIA GPU):
  # 2D -> 3D lifting (kernel K1; --quantize int8 | int8-static for K2,
  # --dtype float32 for the f32 kernel):
  python -m bilinear_tpu_torch.cli.serve --kind lifting \\
      --run-dir "save/Bilinear GT" --data-dir data/Human3.6M --port 8900

  # frame -> 2D + 3D through End2End, and lifting beside it:
  python -m bilinear_tpu_torch.cli.serve --kind both --run-dir \\
      save/End2End --lifting-run-dir "save/Bilinear GT" \\
      --data-dir data/Human3.6M --variant torch7

  # a deployment box: serve AOT artifacts (cli.export_aot), no checkpoint
  # or normalisation data needed; hot-swap by replacing the file:
  python -m bilinear_tpu_torch.cli.serve --aot lifting.aot end2end.aot \\
      --port 8900 --reload-every 30

Endpoints: GET /healthz, GET /metrics, POST /v1/lift (JSON
{"keypoints": (N,16,2)} or application/x-npy), POST /v1/pose (npz: frames
(N,256,256,3) u8 or f32, (N,256,192,3) for ViTPose [+ centers, scales]),
POST /admin/reload. --warm
runs every lifting row count and each End2End batch size on u8 frames
before the first request. The torch7 detector's ResModules run through
kernel K3; the preact, HRNet and ViTPose detectors have no fused blocks
(``--variant hrnet`` serves HRNet-W48 on cuDNN's convolutions and kernel
K8's epilogues, ``--variant vitpose`` ViTPose-H on cuBLAS's products,
fused attention and K8's head epilogues; both refuse ``--quantize``). ``--quantize int8``
(or int8-static, which maps to int8 for End2End as in JAX) with --kind
end2end|both serves the detector's body convs as int8 convolutions
(kernels K6/K7; no K3). ``--aot`` serves artifacts instead: each one's
kind picks its route, and they run PyTorch's own operators on the device
they were exported for. The server runs on the card; ``--device cpu`` runs
the plain PyTorch path and is meant for tests only.
"""
from __future__ import annotations

import argparse
import logging
import time

import torch

from bilinear_tpu_torch.data.h36m import Protocol, Task, load_h36m
from bilinear_tpu_torch.device import disable_tf32
from bilinear_tpu_torch.models.detectors import detector
from bilinear_tpu_torch.serving import End2EndServer, LiftingServer
from bilinear_tpu_torch.serving_http import PoseHTTPServer

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def build_server(args, logger=None) -> PoseHTTPServer:
    if args.aot:
        return _build_aot_server(args, logger)
    train = load_h36m(args.data_dir, args.protocol)[Task.Train]
    quantize = args.quantize or None
    lifting = end2end = None
    if args.kind in ("lifting", "both"):
        lifting, epoch = LiftingServer.from_run_dir(
            args.lifting_run_dir or args.run_dir, train,
            dtype=DTYPES[args.dtype], quantize=quantize, device=args.device,
        )
        if logger:
            logger.info("lifting model: epoch %d on %s", epoch,
                        lifting.device)
    if args.kind in ("end2end", "both"):
        model_kw = {"fused": detector(args.variant).fused_blocks}
        if args.n_stacks:
            model_kw.update(n_stacks=args.n_stacks, features=args.features,
                            depth=args.depth)
        end2end = End2EndServer.from_run_dir(
            args.run_dir, train, variant=args.variant, model_kw=model_kw,
            dtype=DTYPES[args.dtype], batch_sizes=tuple(args.batch_sizes),
            # static scales are the lifting MLP's; End2End's detector
            # takes the dynamic int8 convolutions
            quantize="int8" if quantize == "int8-static" else quantize,
            device=args.device,
        )
        if logger:
            logger.info("end2end model: epoch %d on %s", end2end.epoch,
                        end2end.device)
    return PoseHTTPServer(
        lifting=lifting,
        end2end=end2end,
        host=args.host,
        port=args.port,
        max_delay_ms=args.max_delay_ms,
        max_rows=args.max_rows,
        max_pending_rows=args.max_pending_rows,
        reload_every=args.reload_every,
        logger=logger,
    )


def _build_aot_server(args, logger=None) -> PoseHTTPServer:
    """Serve AOT artifacts: each artifact's manifest kind assigns it to the
    /v1/lift or /v1/pose route; a second artifact of one kind is refused."""
    from bilinear_tpu_torch.io.aot import AOTServer

    servers = {}
    for path in args.aot:
        srv = AOTServer(path)
        if srv.kind in servers:
            raise ValueError(f"two {srv.kind!r} artifacts given: "
                             f"{servers[srv.kind].path!r} and {path!r}")
        servers[srv.kind] = srv
        if logger:
            logger.info("aot %s: %s (epoch %d, torch %s, device %s, "
                        "programs %s)", srv.kind, path, srv.epoch,
                        srv.manifest.get("torch_version"),
                        srv.manifest.get("device"),
                        ",".join(srv.manifest.get("programs", {})))
    return PoseHTTPServer(
        lifting=servers.get("lifting"),
        end2end=servers.get("end2end"),
        host=args.host,
        port=args.port,
        max_delay_ms=args.max_delay_ms,
        max_rows=args.max_rows,
        max_pending_rows=args.max_pending_rows,
        reload_every=args.reload_every,
        logger=logger,
    )


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--kind", choices=["lifting", "end2end", "both"],
                   default="lifting",
                   help="lifting (/v1/lift), end2end (/v1/pose) or both")
    p.add_argument("--aot", nargs="+", default=[], metavar="ARTIFACT",
                   help="serve AOT artifact(s) (cli.export_aot output) "
                        "instead of checkpoints, routed by manifest kind; "
                        "--run-dir/--data-dir are then not needed and "
                        "--reload-every polls the artifact files")
    p.add_argument("--run-dir", default="",
                   help="run dir holding parameter/{epoch}.save (the "
                        "End2End one for --kind end2end|both; required "
                        "unless --aot)")
    p.add_argument("--lifting-run-dir", default="",
                   help="separate run dir for the lifting model "
                        "(--kind both)")
    p.add_argument("--data-dir", default="",
                   help="H36M dir (normalization stats come from its train "
                        "split; required unless --aot)")
    p.add_argument("--protocol", default=Protocol.GT)
    p.add_argument("--variant", default="torch7",
                   help="End2End's detector: torch7, preact, hrnet or "
                        "vitpose")
    p.add_argument("--dtype", default="bfloat16", choices=list(DTYPES))
    p.add_argument("--quantize", default="",
                   choices=["", "int8", "int8-static"])
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8900)
    p.add_argument("--batch-sizes", type=int, nargs="+", default=[1, 8, 16],
                   help="End2End batch sizes; a request runs as greedy "
                        "largest-first chunks of them")
    p.add_argument("--max-delay-ms", type=float, default=2.0)
    p.add_argument("--max-rows", type=int, default=256)
    p.add_argument("--max-pending-rows", type=int, default=8192,
                   help="admission-control bound; beyond it requests get 503")
    p.add_argument("--reload-every", type=float, default=30.0)
    p.add_argument("--warm", action="store_true",
                   help="build the kernels and run every dispatchable row "
                        "count and End2End batch size (u8 frames) before "
                        "accepting requests")
    p.add_argument("--n-stacks", type=int, default=0,
                   help="End2End detector size override (0 = the "
                        "reference's 8/256/4)")
    p.add_argument("--features", type=int, default=256)
    p.add_argument("--depth", type=int, default=4)
    p.add_argument("--device", default=None,
                   help="torch device; default the GPU (no CPU fallback)")
    return p


def main(argv=None) -> None:
    disable_tf32()
    parser = build_parser()
    args = parser.parse_args(argv)
    if not args.aot and not (args.run_dir and args.data_dir):
        parser.error("--run-dir and --data-dir are required unless --aot "
                     "artifacts are given")
    logging.basicConfig(
        level=logging.INFO, format="[%(levelname)s|serve] %(message)s"
    )
    logger = logging.getLogger("serve")
    server = build_server(args, logger)
    if args.warm:
        t0 = time.monotonic()
        warmed = server.warm()
        logger.info("warmed %s in %.1f s", warmed, time.monotonic() - t0)
    logger.info("listening on http://%s:%d", server.host, server.port)
    server.serve_forever()


if __name__ == "__main__":
    main()
