"""Port vs JAX package on the CPU: the BilinearUnit module, weight carrying,
H36M data, checkpoints and MPJPE (bilinear_tpu_torch, plain paths)."""
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bilinear_tpu.data import h36m as jh36m
from bilinear_tpu.data import synthetic as jsyn
from bilinear_tpu.eval.mpjpe import evaluate_mpjpe as jax_evaluate_mpjpe
from bilinear_tpu.models.bilinear import BilinearUnit as JaxBilinearUnit
from bilinear_tpu.utils.torch_compat import bilinear_to_torch_state
from bilinear_tpu_torch.data import h36m as ph36m
from bilinear_tpu_torch.data import synthetic as psyn
from bilinear_tpu_torch.eval.mpjpe import evaluate_mpjpe
from bilinear_tpu_torch.io import checkpoint as pckpt
from bilinear_tpu_torch.models.bilinear import BilinearUnit
from bilinear_tpu_torch.utils.weights import bilinear_from_jax, bilinear_to_jax
from torch_port_fixtures import one_torch_thread, rows, scrambled_variables


@pytest.fixture(scope="module")
def variables():
    return scrambled_variables(0)


def _port_model(params, stats) -> BilinearUnit:
    m = BilinearUnit()
    m.load_state_dict(bilinear_from_jax(params, stats))
    return m.eval()


def test_eval_matches_flax(variables):
    params, stats = variables
    x = rows(512, 2)
    ref = JaxBilinearUnit().apply({"params": params, "batch_stats": stats},
                                  jnp.asarray(x), train=False)
    with torch.no_grad():
        out = _port_model(params, stats)(torch.from_numpy(x)).numpy()
    # measured max |diff| 1.4e-5 on outputs of mean magnitude ~4
    np.testing.assert_allclose(out, np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_weights_round_trip_is_exact(variables):
    params, stats = variables
    p2, s2 = bilinear_to_jax(bilinear_from_jax(params, stats))
    flat = jax.tree_util.tree_leaves_with_path((params, stats))
    flat2 = jax.tree_util.tree_leaves_with_path((p2, s2))
    assert [k for k, _ in flat] == [k for k, _ in flat2]
    for (_, a), (_, b) in zip(flat, flat2):
        assert np.asarray(a).dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), b)


def test_state_dict_keys_match_torch_compat(variables):
    params, stats = variables
    ours = list(BilinearUnit().state_dict().keys())
    theirs = list(bilinear_to_torch_state(params, stats).sd.keys())
    assert ours == theirs
    assert list(bilinear_from_jax(params, stats).keys()) == ours
    for key, value in bilinear_to_torch_state(params, stats).sd.items():
        np.testing.assert_array_equal(
            bilinear_from_jax(params, stats)[key].numpy(), value
        )


def test_init_distribution_matches_reference(variables):
    """kaiming-normal weights (std sqrt(2 / fan_in)), torch-default biases
    (U(+-1/sqrt(fan_in))): the reference's init, in distribution, and the
    same parameter count as the flax model."""
    m = BilinearUnit(generator=torch.Generator().manual_seed(0))
    w = m.bilinear[0][0][0].weight.detach()
    assert abs(float(w.std()) - math.sqrt(2.0 / 1024)) < 0.02 * math.sqrt(2.0 / 1024)
    b = m.decode.bias.detach()
    assert float(b.abs().max()) <= 1.0 / math.sqrt(1024)
    n_flax = sum(np.asarray(a).size for a in jax.tree.leaves(variables[0]))
    assert sum(p.numel() for p in m.parameters()) == n_flax


def test_make_h36m_bin_matches_jax():
    a = jsyn.make_h36m_bin(37, seed=5)
    b = psyn.make_h36m_bin(37, seed=5)
    assert a["image"] == b["image"] and a["scale"] == b["scale"]
    for key in ("S", "part", "center"):
        np.testing.assert_array_equal(np.stack(a[key]), np.stack(b[key]))


def test_load_h36m_matches_jax(tmp_path):
    d = str(tmp_path / "h36m")
    jsyn.write_h36m_dataset(d, n_train=64, n_valid=16)
    js = jh36m.load_h36m(d, jh36m.Protocol.GT)
    ps = ph36m.load_h36m(d, ph36m.Protocol.GT)
    for task in (ph36m.Task.Train, ph36m.Task.Valid):
        a, b = js[task], ps[task]
        for field in ("part", "s", "raw_part", "raw_s", "mean_part",
                      "std_part", "mean_s", "std_s", "actions", "centers",
                      "scales"):
            np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
        assert a.images == b.images and a.action_names == b.action_names
    # The port's writer gives byte-equal bins.
    d2 = str(tmp_path / "h36m_port")
    psyn.write_h36m_dataset(d2, n_train=64, n_valid=16)
    for name in ("train_GT.bin", "valid_GT.bin"):
        with open(os.path.join(d, name), "rb") as f1, \
                open(os.path.join(d2, name), "rb") as f2:
            assert f1.read() == f2.read()


def test_checkpoint_round_trip_and_scan(tmp_path, variables):
    params, stats = variables
    pdir = str(tmp_path / "parameter")
    assert pckpt.latest_epoch(pdir) == 0
    trees = bilinear_to_jax(bilinear_from_jax(params, stats))
    pckpt.save_checkpoint(pdir, 2, *trees, step=7)
    pckpt.save_checkpoint(pdir, -1, *trees)  # finalized sentinel never wins
    assert pckpt.latest_epoch(pdir) == 2
    payload = pckpt.load_checkpoint(pdir, 2)
    assert payload["epoch"] == 2 and payload["step"] == 7
    assert payload["optimizer"] == {}
    p2, s2 = payload["state"]["params"], payload["state"]["batch_stats"]
    for (_, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path((params, stats)),
                              jax.tree_util.tree_leaves_with_path((p2, s2))):
        np.testing.assert_array_equal(np.asarray(a), b)
    with pytest.raises(FileNotFoundError):
        pckpt.load_checkpoint(pdir, 9)
    os.makedirs(os.path.join(pdir, "5.orbax"))
    assert pckpt.latest_epoch(pdir) == 5
    with pytest.raises(NotImplementedError):
        pckpt.load_checkpoint(pdir, 5)


def test_mpjpe_matches_jax(tmp_path, variables):
    params, stats = variables
    d = str(tmp_path / "h36m")
    psyn.write_h36m_dataset(d, n_train=64, n_valid=40)
    valid = ph36m.load_h36m(d)[ph36m.Task.Valid]
    jvalid = jh36m.load_h36m(d)[jh36m.Task.Valid]
    model = _port_model(params, stats)

    def forward(x):
        with torch.no_grad():
            return model(torch.from_numpy(x))

    per_action, overall = evaluate_mpjpe(forward, valid, chunk=16)
    jper, jall = jax_evaluate_mpjpe(
        JaxBilinearUnit(), {"params": params, "batch_stats": stats}, jvalid,
        chunk=16,
    )
    assert set(per_action) == set(jper) == {"Directions", "Eating", "Posing",
                                            "Walking"}
    for k in jper:
        assert per_action[k] == pytest.approx(jper[k], rel=1e-4)
    assert overall == pytest.approx(jall, rel=1e-4)
