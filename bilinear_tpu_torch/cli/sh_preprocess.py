"""Write the SH-protocol bins from a trained detector (counterpart of
``bilinear_tpu/cli/sh_preprocess.py``; the working replacement for the
reference's 'SH preprocess.ipynb'), on the GPU.

Usage: python -m bilinear_tpu_torch.cli.sh_preprocess --h36m-dir
       data/Human3.6M [--comment Hourglass --variant torch7 --protocol-out SH
       --fused-blocks true]
       python -m bilinear_tpu_torch.cli.sh_preprocess --h36m-dir
       data/Human3.6M --comment "Hourglass FT" --variant preact
       --protocol-out SH+FT

Then: python -m bilinear_tpu_torch.cli.train_bilinear --protocol SH ...

Loads the newest checkpoint of ``{save_root}/{comment}/parameter`` and
writes ``{train,valid}_{protocol_out}.bin`` into ``--h36m-dir``
(``data/sh_convert.py``). The detector runs in f32, as the JAX CLI's does;
``--fused-blocks true`` (torch7 only) sends every ResModule of the export
forwards through kernel K3, and a shape K3 refuses raises. ``--device cpu``
runs the plain PyTorch path and is meant for tests only.
"""
from __future__ import annotations

import argparse
import os

from bilinear_tpu_torch.cli.valid_hourglass import eval_trainer
from bilinear_tpu_torch.config import HourglassConfig, parse_config
from bilinear_tpu_torch.data.sh_convert import convert_gt_to_sh
from bilinear_tpu_torch.device import disable_tf32, resolve_device
from bilinear_tpu_torch.io.checkpoint import resume_or_init
from bilinear_tpu_torch.io.logger import get_logger


def main(argv=None) -> None:
    disable_tf32()
    cfg = parse_config(HourglassConfig(), argv)
    extra = argparse.ArgumentParser()
    extra.add_argument("--h36m-dir", default="data/Human3.6M")
    extra.add_argument("--protocol-out", default="SH")
    args, _ = extra.parse_known_args(argv)
    if cfg.cache_canvases:
        raise NotImplementedError("--cache-canvases is not ported yet")
    device = resolve_device(cfg.device or None)
    logger, log_dir, _ = get_logger(cfg.comment, cfg.save_root)
    parameter_dir = os.path.join(log_dir, "parameter")

    state, epoch = resume_or_init(eval_trainer(cfg, device)
                                  .init_state(cfg.seed), parameter_dir)
    logger.info("Converting GT->%s with hourglass[%s] epoch %d (fused "
                "blocks %s)", args.protocol_out, cfg.variant, epoch,
                cfg.fused_blocks)
    written = convert_gt_to_sh(state.model, args.h36m_dir,
                               protocol_out=args.protocol_out,
                               batch_size=cfg.batch_size, canvas=cfg.canvas,
                               transport=cfg.transport)
    for task, path in written.items():
        logger.info("%s -> %s", task, path)


if __name__ == "__main__":
    main()
