"""One rank of the port's multi-process tests (tests/test_torch_port_
parallel.py). It imports torch and the port only, never JAX: the test
process computes the JAX side once.

    python torch_port_dist_worker.py SCENARIO RANK WORLD PORT DIR

reads ``DIR/inputs.pkl`` (initial states in the JAX ``.save`` layout and
the data, written by the test), joins a gloo group of WORLD CPU ranks at
localhost:PORT, runs SCENARIO and writes ``DIR/{SCENARIO}_{RANK}.pkl``:

- ``dp``: data 2. A full-width ``BilinearTrainer`` step at dropout 0 and
  0.5, an epoch of 29 rows in batches of 16 (the tail, 13 rows, splits 7 /
  6), and a standard torch7 ``HourglassTrainer`` step (2 stacks, 16
  features, depth 2, batch 8) in f32 and in float64, and an
  ``End2EndTrainer`` step of that detector and the lifter in float64; the
  same two steps with fused blocks (K3/K4's plain versions over the data
  group), the whole model in float64, on the batch's first FUSED_ROWS rows
  (the detector, split 1 / 2) and E2E_FUSED_ROWS rows (End2End, split
  2 / 2), and the fused detector's step on its first row alone (rank 0
  holds none).
- ``tp``: data 2 x model 2. The same full-width bilinear step, tensor
  parallel (dropout 0 and 0.5).
"""
import os
import pickle
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from bilinear_tpu_torch.parallel import mesh as ml  # noqa: E402
from bilinear_tpu_torch.train import end2end as te  # noqa: E402
from bilinear_tpu_torch.train import hourglass as th  # noqa: E402
from bilinear_tpu_torch.train.bilinear import BilinearTrainer  # noqa: E402

HG_SIZE = dict(n_stacks=2, features=16, depth=2)
FUSED_ROWS = 3
E2E_FUSED_ROWS = 4


def first_rows(tree, n):
    """The first ``n`` rows of every tensor leaf of a (Named)tuple tree
    (a per-batch int passes through)."""
    if isinstance(tree, tuple):
        return type(tree)(*(first_rows(v, n) for v in tree))
    return tree[:n] if isinstance(tree, torch.Tensor) else tree


def grads_of(model):
    return {k: p.grad.detach().clone() for k, p in model.named_parameters()
            if p.grad is not None}


def bilinear_step(mesh, inputs, dropout):
    t = BilinearTrainer(batch_size=16, learning_rate=1e-3, dropout=dropout,
                        device="cpu", mesh=mesh)
    st = t.init_state(0)
    st.restore(inputs["bilinear_payload"])
    seen = []
    if st.optimizer.grad_norm is not None:  # the pre-clip global norm
        norm_of = st.optimizer.grad_norm

        def recorded():
            v = norm_of()
            seen.append(float(v))
            return v

        st.optimizer.grad_norm = recorded
    gen = t.dropout_generator(3, 1)
    loss = t.train_step(st, torch.from_numpy(inputs["bx"]),
                        torch.from_numpy(inputs["by"]), gen)
    return dict(loss=float(loss), trees=st.trees(), norm=seen)


def bilinear_epoch(mesh, inputs):
    t = BilinearTrainer(batch_size=16, learning_rate=1e-3, dropout=0.5,
                        device="cpu", mesh=mesh)
    st = t.init_state(0)
    st.restore(inputs["bilinear_payload"])
    losses = t.train_epoch(st, torch.from_numpy(inputs["ex"]),
                           torch.from_numpy(inputs["ey"]), epoch=1, seed=3)
    return dict(losses=losses.numpy(), trees=st.trees())


def hourglass_step(mesh, inputs, dtype=torch.float32, fused=False, rows=8):
    """The detector's step on the batch's first ``rows`` rows; fused, the
    whole model in float64. ``mesh=None`` is one process."""
    t = th.HourglassTrainer(device="cpu", mesh=mesh, dtype=dtype,
                            fused_blocks=fused, **HG_SIZE)
    st = t.init_state(0)
    if fused:
        st.model.double()
    st.restore(inputs["hourglass_payload"])
    batch = {k: torch.from_numpy(v[:rows])
             for k, v in inputs["hg_batch"].items()}
    loss = t.train_step(st, batch, first_rows(inputs["hg_draws"], rows))
    return dict(loss=float(loss), trees=st.trees(), grads=grads_of(st.model))


def end2end_step(mesh, inputs, fused=False, rows=8):
    """End2End's step in float64 on the batch's first ``rows`` rows (the
    lifter's dropout masks drawn for the global batch), from its seeded
    initialisation. ``mesh=None`` is one process."""
    t = te.End2EndTrainer(device="cpu", mesh=mesh, dtype=torch.float64,
                          model_kw=dict(HG_SIZE, fused=fused))
    st = t.init_state(0)
    st.model.double()
    batch = {k: torch.from_numpy(v[:rows])
             for k, v in inputs["e2e_batch"].items()}
    stats = tuple(torch.from_numpy(v) for v in inputs["e2e_stats"])
    losses = t.train_step(st, batch, stats,
                          te.sample_augment(0, 1, 1, rows))
    return dict(losses=[float(v) for v in losses], trees=st.trees(),
                grads=grads_of(st.model))


def main():
    scenario, rank, world, port, out_dir = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    with open(os.path.join(out_dir, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    ml.init_distributed(f"localhost:{port}", world, rank, "cpu")
    if scenario == "dp":
        mesh = ml.make_mesh()
        out = dict(step0=bilinear_step(mesh, inputs, 0.0),
                   step5=bilinear_step(mesh, inputs, 0.5),
                   epoch=bilinear_epoch(mesh, inputs),
                   hourglass=hourglass_step(mesh, inputs),
                   hourglass64=hourglass_step(mesh, inputs, torch.float64),
                   end2end=end2end_step(mesh, inputs),
                   hourglass_fused=hourglass_step(
                       mesh, inputs, torch.float64, True, FUSED_ROWS),
                   hourglass_fused_one_row=hourglass_step(
                       mesh, inputs, torch.float64, True, 1),
                   end2end_fused=end2end_step(mesh, inputs, True,
                                              E2E_FUSED_ROWS))
    elif scenario == "tp":
        mesh = ml.make_mesh(model=2)
        out = dict(step0=bilinear_step(mesh, inputs, 0.0),
                   step5=bilinear_step(mesh, inputs, 0.5))
    else:
        raise SystemExit(f"unknown scenario {scenario!r}")
    ml.shutdown_distributed()
    with open(os.path.join(out_dir, f"{scenario}_{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main()
