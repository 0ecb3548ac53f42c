"""Port kernel K1's plain version (bilinear_tpu_torch/ops/lifting.py) vs the
JAX package: flax eval and the Pallas lifting kernel in interpret mode.
The CUDA kernel itself is held against this plain version on the card by
chip_smoke.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bilinear_tpu.models.bilinear import BilinearUnit as JaxBilinearUnit
from bilinear_tpu.ops.pallas import lifting as jl
from bilinear_tpu_torch.ops import lifting as pl
from torch_port_fixtures import rows, scrambled_variables


@pytest.fixture(scope="module")
def variables():
    return scrambled_variables(0)


def test_fold_bn_math(variables):
    """Folded Linear+BN == Linear then eval BN."""
    params, stats = variables
    k, b = pl.folded_layer(params, stats, "encode", "cpu")
    p, s = params["encode"], stats["encode"]["bn"]
    x = torch.from_numpy(rows(8, 1))
    t = {k: torch.tensor(np.asarray(v)) for k, v in (
        ("kernel", p["linear"]["kernel"]), ("bias", p["linear"]["bias"]),
        ("mean", s["mean"]), ("var", s["var"]),
        ("scale", p["bn"]["scale"]), ("beta", p["bn"]["bias"]))}
    lin = x @ t["kernel"] + t["bias"]
    ref = (lin - t["mean"]) / torch.sqrt(t["var"] + 1e-5) * t["scale"] + t["beta"]
    np.testing.assert_allclose((x @ k + b).numpy(), ref.numpy(),
                               rtol=1e-4, atol=1e-5)


def test_plain_f32_matches_flax(variables):
    params, stats = variables
    x = rows(512, 2)
    ref = JaxBilinearUnit().apply({"params": params, "batch_stats": stats},
                                  jnp.asarray(x), train=False)
    out = pl.lifting_forward(params, stats, torch.from_numpy(x),
                             dtype=torch.float32)
    assert out.dtype == torch.float32 and out.shape == (512, 48)
    # The tolerance of tests/test_pallas_lifting.py (measured 1.7e-5).
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-3,
                               atol=2e-3)


def test_plain_bf16_matches_jax_kernel(variables):
    """bf16 rounding points as the TPU kernel's. Sums run in another order
    than XLA's, so a value near a bf16 rounding boundary can land one bf16
    step apart and carry through the next layers: gate on the mean |diff|
    and a loose max (measured mean 3.3e-4, max 0.037 on outputs of mean
    magnitude 3.9)."""
    params, stats = variables
    x = rows(512, 2)
    ref = np.asarray(jl.lifting_forward(params, stats, jnp.asarray(x),
                                        dtype=jnp.bfloat16, interpret=True))
    out = pl.lifting_forward(params, stats, torch.from_numpy(x),
                             dtype=torch.bfloat16).numpy()
    d = np.abs(out - ref)
    assert d.mean() < 2e-3
    assert d.max() < 0.25
    # The bf16 path really rounds: it is not the f32 network.
    f32 = pl.lifting_forward(params, stats, torch.from_numpy(x),
                             dtype=torch.float32).numpy()
    assert np.abs(out - f32).mean() > 10 * d.mean()


def test_odd_batch(variables):
    """100 rows: shape (100, 48) and the first 100 rows of a 512-row run.
    CPU BLAS blocks the sum differently for another row count, so f32
    agrees to its rounding and bf16 under the mean gate; on the card the
    kernel's rows are bit-identical (chip_smoke.py checks it)."""
    params, stats = variables
    x = rows(512, 3)
    ref = np.asarray(JaxBilinearUnit().apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x[:100]),
        train=False))
    for dtype in (torch.float32, torch.bfloat16):
        w = pl.prepare_weights(params, stats, dtype, device="cpu")
        full = pl.lifting_forward(None, None, torch.from_numpy(x), prepared=w)
        part = pl.lifting_forward(None, None, torch.from_numpy(x[:100]),
                                  prepared=w)
        assert part.shape == (100, 48)
        d = np.abs(part.numpy() - full[:100].numpy())
        if dtype == torch.float32:
            np.testing.assert_allclose(part.numpy(), ref, rtol=2e-3, atol=2e-3)
            assert d.max() < 1e-4
        else:
            assert d.mean() < 2e-3


def test_prepared_weights_reuse(variables):
    params, stats = variables
    x = torch.from_numpy(rows(64, 4))
    w = pl.prepare_weights(params, stats, torch.float32, device="cpu")
    assert [t.shape for t, _ in w] == [(32, 1024)] + [(1024, 1024)] * 4 + [
        (1024, 48)]
    a = pl.lifting_forward(params, stats, x, dtype=torch.float32)
    b = pl.lifting_forward(None, None, x, prepared=w)
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_kernel_wrapper_refuses_cpu_tensors(variables):
    """The CUDA wrapper never runs the plain version: a CPU tensor raises,
    and weights default to the card, which is absent here."""
    params, stats = variables
    w = pl.prepare_weights(params, stats, torch.bfloat16, device="cpu")
    x = torch.zeros((4, 32), dtype=torch.bfloat16)
    before = pl.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        pl.lifting_forward_cuda(w, x)
    assert pl.LAUNCHES == before
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            pl.prepare_weights(params, stats)
