"""Lifting daemon: HTTP front-end with dynamic batching and checkpoint
hot-reload over the CUDA lifting kernels (counterpart of
``bilinear_tpu/cli/serve.py``, ``--kind lifting``).

Usage (on a machine with an NVIDIA GPU):
  python -m bilinear_tpu_torch.cli.serve --kind lifting \\
      --run-dir "save/Bilinear GT" --data-dir data/Human3.6M --port 8900
  # --quantize int8 | int8-static for the int8 kernel, --dtype float32 for
  # the f32 kernel, --warm to build the kernels before the first request.

Endpoints: GET /healthz, GET /metrics, POST /v1/lift (JSON
{"keypoints": (N,16,2)} or application/x-npy), POST /admin/reload.
The server runs on the card; ``--device cpu`` runs the plain PyTorch path
and is meant for tests only.
"""
from __future__ import annotations

import argparse
import logging
import time

import torch

from bilinear_tpu_torch.data.h36m import Protocol, Task, load_h36m
from bilinear_tpu_torch.device import disable_tf32
from bilinear_tpu_torch.serving import LiftingServer
from bilinear_tpu_torch.serving_http import PoseHTTPServer

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def build_server(args, logger=None) -> PoseHTTPServer:
    if args.aot:
        raise NotImplementedError("--aot is not ported yet; see ROADMAP.md")
    if args.kind != "lifting":
        raise NotImplementedError(
            f"--kind {args.kind} is not ported yet; see ROADMAP.md"
        )
    train = load_h36m(args.data_dir, args.protocol)[Task.Train]
    lifting, epoch = LiftingServer.from_run_dir(
        args.run_dir, train, dtype=DTYPES[args.dtype],
        quantize=args.quantize or None, device=args.device,
    )
    if logger:
        logger.info("lifting model: epoch %d on %s", epoch, lifting.device)
    return PoseHTTPServer(
        lifting=lifting,
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
                   help="only lifting is ported; the others raise")
    p.add_argument("--aot", nargs="+", default=[], metavar="ARTIFACT",
                   help="not ported yet (raises)")
    p.add_argument("--run-dir", required=True,
                   help="run dir holding parameter/{epoch}.save")
    p.add_argument("--data-dir", required=True,
                   help="H36M dir (normalization stats come from its train "
                        "split)")
    p.add_argument("--protocol", default=Protocol.GT)
    p.add_argument("--dtype", default="bfloat16", choices=list(DTYPES))
    p.add_argument("--quantize", default="",
                   choices=["", "int8", "int8-static"])
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8900)
    p.add_argument("--max-delay-ms", type=float, default=2.0)
    p.add_argument("--max-rows", type=int, default=256)
    p.add_argument("--max-pending-rows", type=int, default=8192,
                   help="admission-control bound; beyond it requests get 503")
    p.add_argument("--reload-every", type=float, default=30.0)
    p.add_argument("--warm", action="store_true",
                   help="build the kernels and run every dispatchable row "
                        "count before accepting requests")
    p.add_argument("--device", default=None,
                   help="torch device; default the GPU (no CPU fallback)")
    return p


def main(argv=None) -> None:
    disable_tf32()
    args = build_parser().parse_args(argv)
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
