"""Configuration of the detector's trainer (counterpart of
``HourglassConfig`` and ``parse_config`` in ``bilinear_tpu/config.py``):
the reference's static config as a dataclass, with every field a CLI flag
(``--batch-size 8``, booleans as ``--fused-blocks true``).

The XLA compile cache and the platform override have no counterpart here,
and the JAX config's unused fields (prefetch, total_runs, profile) and
process_id are left out; unknown flags are ignored, as in the JAX package.
``device`` is the port's own: empty for the GPU (no CPU fallback), ``cpu``
for the plain-PyTorch path the tests take.
"""
from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass


@dataclass
class HourglassConfig:
    comment: str = "Hourglass"
    batch_size: int = 8
    data_dir: str = "data/MPII"
    save_root: str = "save"
    learning_rate: float = 2.5e-4
    epochs_per_run: int = 10
    variant: str = "torch7"  # 'preact' is not ported yet
    seed: int = 0
    dtype: str = "float32"
    steps_per_dispatch: int = 4  # steps per group (run in order)
    transport: str = "u8"  # host canvas format: 'u8' or 'f32'
    canvas: int = 512
    cache_canvases: bool = False  # not ported yet
    n_stacks: int = 8
    features: int = 256
    depth: int = 4
    n_modules: int = 1
    fused_blocks: bool = False  # ResModules through kernels K3/K4
    keep_checkpoints: int = 0
    keep_every: int = 0
    debug_nans: bool = False  # not ported yet
    coordinator: str = ""  # multi-process DP: not ported yet
    num_processes: int = 1
    device: str = ""  # '' = the GPU; 'cpu' = the plain path (tests)


def _add_dataclass_args(parser: argparse.ArgumentParser, cfg) -> None:
    for f in dataclasses.fields(cfg):
        arg = "--" + f.name.replace("_", "-")
        val = getattr(cfg, f.name)
        if isinstance(val, bool):
            parser.add_argument(
                arg, default=val,
                type=lambda s: s.lower() in ("1", "true", "yes"))
        else:
            parser.add_argument(arg, type=type(val), default=val)


def parse_config(cfg, argv=None):
    """Overlay CLI flags onto a config dataclass instance (unknown flags
    are ignored, as in the JAX package)."""
    parser = argparse.ArgumentParser()
    _add_dataclass_args(parser, cfg)
    args, _ = parser.parse_known_args(argv)
    for f in dataclasses.fields(cfg):
        setattr(cfg, f.name, getattr(args, f.name))
    return cfg
