"""Configuration of the trainers (counterpart of ``LRDecayConfig``,
``BilinearConfig``, ``HourglassConfig``, ``HourglassFTConfig`` and
``parse_config`` in
``bilinear_tpu/config.py``): the reference's static configs as dataclasses,
with every field a CLI flag (``--batch-size 8``, booleans as
``--fused-blocks true``) except a nested config, which is no flag in the
JAX package either (``lr_decay``: its trainer ignores it, and so does the
port's).

The XLA compile cache and the platform override have no counterpart here,
and the JAX configs' unused fields (prefetch, total_runs, the detector's
profile) are left out; unknown flags are ignored, as in the JAX package.
``coordinator``/``num_processes``/``process_id`` start a
multi-process run (``parallel/mesh.py::start_run``). ``device``,
``local_processes`` and ``model_parallel`` are the port's own: ``device``
empty for the GPU (no CPU fallback; rank i of a multi-process run takes
``cuda:{(i % local_processes) % cards}``, ranks numbered host by host),
``cpu`` for the plain-PyTorch path the tests take; ``local_processes`` the
ranks each host runs (0: all of them, on one host); ``model_parallel`` the
size of the lifter's tensor-parallel groups (the JAX CLI's mesh has a
model axis of 1, and its TP is an API only).
"""
from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass, field

from bilinear_tpu_torch.data.h36m import Protocol


@dataclass
class LRDecayConfig:
    """util/config.py:19-23: lr = base * rate^(step/period), re-set when
    step == 1 or step % period == 0."""

    activate: bool = True
    base_lr: float = 1.0e-3
    rate: float = 0.96
    period: int = 100_000


@dataclass
class BilinearConfig:
    comment: str = "Bilinear GT"
    batch_size: int = 64
    data_dir: str = "data/Human3.6M"
    save_root: str = "save"
    protocol: str = Protocol.GT
    lr_decay: LRDecayConfig = field(default_factory=LRDecayConfig)
    epochs_per_run: int = 10  # train_bilinear.py:56
    seed: int = 0
    dtype: str = "float32"  # "bfloat16": bf16 Linears, f32 BN and loss
    profile: bool = False  # a torch.profiler trace under the run dir
    keep_checkpoints: int = 0
    keep_every: int = 0
    debug_nans: bool = False  # non-finite checks (utils/debug.py)
    coordinator: str = ""  # host:port of rank 0 (multi-process)
    num_processes: int = 1
    process_id: int = 0
    local_processes: int = 0  # ranks on each host; 0 = all (one host)
    model_parallel: int = 1  # ranks per tensor-parallel group
    device: str = ""  # '' = the GPU; 'cpu' = the plain path (tests)


@dataclass
class HourglassConfig:
    comment: str = "Hourglass"
    batch_size: int = 8
    data_dir: str = "data/MPII"
    save_root: str = "save"
    learning_rate: float = 2.5e-4
    epochs_per_run: int = 10
    variant: str = "torch7"  # or 'preact' (the fine-tuned variant)
    seed: int = 0
    dtype: str = "float32"
    steps_per_dispatch: int = 4  # steps per group (run in order)
    transport: str = "u8"  # host canvas format: 'u8' or 'f32'
    canvas: int = 512
    cache_canvases: bool = False  # decode each JPEG once into a u8 memmap
    n_stacks: int = 8
    features: int = 256
    depth: int = 4
    n_modules: int = 1
    fused_blocks: bool = False  # ResModules through kernels K3/K4 (torch7)
    keep_checkpoints: int = 0
    keep_every: int = 0
    debug_nans: bool = False  # non-finite checks (utils/debug.py)
    coordinator: str = ""  # host:port of rank 0 (multi-process)
    num_processes: int = 1
    process_id: int = 0
    local_processes: int = 0  # ranks on each host; 0 = all (one host)
    device: str = ""  # '' = the GPU; 'cpu' = the plain path (tests)


@dataclass
class HourglassFTConfig(HourglassConfig):
    """The H36M fine-tuning of the pre-activation hourglass
    (train_hourglass_FT.py)."""

    comment: str = "Hourglass FT"
    data_dir: str = "data/Human3.6M"
    epochs_per_run: int = 100  # train_hourglass_FT.py:67
    variant: str = "preact"  # train_hourglass_FT.py:47


def _flag_fields(cfg):
    """The fields that are CLI flags: all but nested configs."""
    return [f for f in dataclasses.fields(cfg)
            if not dataclasses.is_dataclass(getattr(cfg, f.name))]


def _add_dataclass_args(parser: argparse.ArgumentParser, cfg) -> None:
    for f in _flag_fields(cfg):
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
    for f in _flag_fields(cfg):
        setattr(cfg, f.name, getattr(args, f.name))
    return cfg
