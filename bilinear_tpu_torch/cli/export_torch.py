"""Export a run's newest checkpoint to the reference's torch format
(counterpart of ``bilinear_tpu/cli/export_torch.py``).

Writes a ``{epoch}.save`` torch checkpoint (``{'epoch', 'step', 'state',
'optimizer'}``, reference train_bilinear.py:96-104) that the reference's
own ``model.*.load()`` resumes from: the weights under the reference's
state_dict names (the port's models keep them), the BN running statistics,
and the optimizer's moments (Adam's ``exp_avg``/``exp_avg_sq`` for lifting,
RMSprop's ``square_avg`` for the detectors) under the integer parameter ids
of ``model.parameters()`` order. The run's checkpoint may come from either
package (both write the JAX layout). The torch7 detector's identity
ResModules carry a zero ``conv_skip`` with no optimizer state, as the
reference registers it and never trains it.

The detector's sizes are read from the checkpoint; ``--n-stacks``,
``--features`` and ``--depth`` (the JAX CLI's flags) are checked against
them, and a size that disagrees stops the export.

Usage:
  python -m bilinear_tpu_torch.cli.export_torch --family bilinear \\
      --save-root save --out-dir /path/to/torch/parameter
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from bilinear_tpu_torch.io.checkpoint import latest_epoch, load_checkpoint
from bilinear_tpu_torch.io.logger import get_logger
from bilinear_tpu_torch.utils import weights as wt

_DEFAULT_COMMENT = {
    "bilinear": "Bilinear GT",
    "hourglass": "Hourglass",
    "hourglass_ft": "Hourglass FT",
}
_DEFAULT_LR = {"bilinear": 1e-3, "hourglass": 2.5e-4, "hourglass_ft": 2.5e-4}


def _param_group(optimizer_cls, lr: float) -> dict:
    """This torch build's default param_group of ``optimizer_cls`` (every
    hyperparameter key its ``load_state_dict`` and ``step`` expect)."""
    dummy = torch.nn.Parameter(torch.zeros(1))
    return dict(optimizer_cls([dummy], lr=lr).state_dict()["param_groups"][0])


SIZE_FLAGS = ("n_stacks", "features", "depth")


def _variant(family: str) -> str:
    return "torch7" if family == "hourglass" else "preact"


def check_sizes(payload: dict, family: str, given: dict) -> None:
    """Raise ``SystemExit`` when a size in ``given`` (``SIZE_FLAGS``; None
    for a flag not given) differs from the one the checkpoint holds. The
    lifting MLP has none of these sizes."""
    given = {k: v for k, v in given.items() if v is not None}
    if not given:
        return
    if family == "bilinear":
        raise SystemExit("--n-stacks/--features/--depth size a detector; "
                         "the bilinear family has none of them")
    cfg = wt.HOURGLASS[_variant(family)].config_of_jax(
        payload["state"]["params"])
    for key, value in given.items():
        if cfg[key] != value:
            flag = "--" + key.replace("_", "-")
            raise SystemExit(f"{flag} {value} disagrees with the "
                             f"checkpoint's {key} {cfg[key]}")


def reference_checkpoint(payload: dict, family: str, epoch: int,
                         learning_rate: float) -> dict:
    """A port/JAX ``.save`` payload of ``epoch`` -> the reference's torch
    checkpoint dict."""
    params = payload["state"]["params"]
    stats = payload["state"]["batch_stats"]
    opt = payload["optimizer"]["1"]
    if family == "bilinear":
        from bilinear_tpu_torch.models.bilinear import BilinearUnit

        model = BilinearUnit()
        sd = wt.bilinear_from_jax(params, stats)
        paths = wt.bilinear_param_paths()
        moments = {"exp_avg": opt["mu"], "exp_avg_sq": opt["nu"]}
        optimizer_cls = torch.optim.Adam
    else:
        from bilinear_tpu_torch.models.detectors import make_model

        variant = _variant(family)
        conv = wt.HOURGLASS[variant]
        cfg = conv.config_of_jax(params)
        model = make_model(variant, n_stacks=cfg["n_stacks"],
                           features=cfg["features"], depth=cfg["depth"],
                           n_modules=cfg["n_modules"])
        sd = conv.from_jax(params, stats)
        paths = conv.param_paths(cfg)
        moments = {"square_avg": opt["square_avg"]}
        optimizer_cls = torch.optim.RMSprop
    names = model.state_dict().keys()
    if set(sd) != set(names):
        raise ValueError("the checkpoint's tree does not fit the "
                         f"{family!r} model")
    state = {k: sd[k].to(torch.int64 if k.endswith("num_batches_tracked")
                         else torch.float32) for k in names}
    where = {key: (path, kind) for key, path, kind in paths}
    count = float(np.asarray(opt["count"]))
    params_order = [k for k, _ in model.named_parameters()]
    opt_state = {}
    for pid, key in enumerate(params_order):
        if key not in where:  # an identity ResModule's unused conv_skip
            continue
        path, kind = where[key]
        entry = {"step": torch.tensor(count)}
        for name, tree in moments.items():
            entry[name] = wt.leaf_from_jax(wt.get_leaf(tree, path),
                                           kind).float()
        opt_state[pid] = entry
    group = _param_group(optimizer_cls, learning_rate)
    group["params"] = list(range(len(params_order)))
    return {"epoch": int(epoch), "step": int(payload["step"]),
            "state": state,
            "optimizer": {"state": opt_state, "param_groups": [group]}}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--family", choices=sorted(_DEFAULT_COMMENT),
                   required=True)
    p.add_argument("--save-root", default="save")
    p.add_argument("--comment", default=None,
                   help="run dir name; defaults to the family's usual comment")
    p.add_argument("--out-dir", default=None,
                   help="where to write {epoch}.save (default: "
                        "<run dir>/torch_export)")
    p.add_argument("--learning-rate", type=float, default=None,
                   help="lr recorded in the exported optimizer param_group "
                        "(default: the family's reference lr)")
    for flag in SIZE_FLAGS:
        p.add_argument("--" + flag.replace("_", "-"), type=int, default=None,
                       help="checked against the checkpoint's detector")
    args = p.parse_args(argv)

    comment = args.comment or _DEFAULT_COMMENT[args.family]
    logger, log_dir, _ = get_logger(comment, args.save_root)
    parameter_dir = os.path.join(log_dir, "parameter")
    out_dir = args.out_dir or os.path.join(log_dir, "torch_export")
    epoch = latest_epoch(parameter_dir)
    if epoch <= 0:
        raise SystemExit(f"no checkpoint found under {parameter_dir}")
    payload = load_checkpoint(parameter_dir, epoch)
    check_sizes(payload, args.family,
                {k: getattr(args, k) for k in SIZE_FLAGS})
    ckpt = reference_checkpoint(
        payload, args.family, epoch,
        args.learning_rate or _DEFAULT_LR[args.family])
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, f"{epoch}.save")
    torch.save(ckpt, out_path)
    logger.info("Exported epoch %d -> %s", epoch, out_path)
    print(out_path)


if __name__ == "__main__":
    main()
