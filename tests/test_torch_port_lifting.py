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
from torch_port_fixtures import one_torch_thread, rows, scrambled_variables


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


# ---- the kernel's prepared form and its choice of path ----


def test_kmajor_copies_are_exact_transposes(variables):
    """The bf16 wgmma kernels read a K-contiguous (out, in) copy of every
    weight; f32 weights have none (the SIMT kernel reads (in, out))."""
    params, stats = variables
    w = pl.prepare_weights(params, stats, torch.bfloat16, device="cpu")
    assert len(w.kmajor) == 6
    for (k, _), kt in zip(w, w.kmajor):
        assert kt.is_contiguous() and kt.dtype == torch.bfloat16
        assert kt.shape == (k.shape[1], k.shape[0])
        assert torch.equal(kt, k.t())
    assert pl.prepare_weights(params, stats, torch.float32,
                              device="cpu").kmajor is None


def _server(params, stats, **kw):
    from bilinear_tpu_torch.serving import LiftingServer

    one, zero = np.ones(32, np.float32), np.zeros(32, np.float32)
    return LiftingServer(params, stats, zero, one, np.zeros(48, np.float32),
                         np.ones(48, np.float32), device="cpu", **kw)


def test_reload_rebuilds_kmajor_copies(variables, tmp_path):
    from bilinear_tpu_torch.io.checkpoint import save_checkpoint

    params, stats = variables
    server = _server(params, stats)
    before = server._engine.prepared
    pdir = str(tmp_path / "parameter")
    save_checkpoint(pdir, 2, *scrambled_variables(1))
    server.parameter_dir, server.epoch = pdir, 1
    assert server.reload() is True
    after = server._engine.prepared
    assert after is not before
    assert not torch.equal(after[1][0], before[1][0])
    for (k, _), kt in zip(after, after.kmajor):
        assert torch.equal(kt, k.t())


PATH_NS = [0, 1, 256, 257, pl.FUSED_MAX_ROWS, pl.FUSED_MAX_ROWS + 1, 65536]


@pytest.mark.parametrize("n", PATH_NS)
def test_choose_path_names_an_existing_path(n):
    path = pl.choose_path(n)
    assert path in pl.PATHS
    assert (path == "empty") == (n == 0)
    assert (path == "fused") == (0 < n <= pl.FUSED_MAX_ROWS)
    # the f32 mode has no one-launch kernel
    assert pl.choose_path(n, fused_ok=False) in ("empty", "layers")


def test_choose_path_is_monotone_in_n():
    """empty, then one launch, then one launch per layer: never back."""
    order = [pl.PATHS.index(pl.choose_path(n)) for n in range(0, 70000, 7)]
    assert order == sorted(order)
    assert set(order) == {0, 1, 2}
    assert pl.FUSED_MAX_ROWS >= 256  # the daemon's max_rows is one launch


def test_cuda_wrapper_checks_before_it_launches(variables):
    """Shape and type are refused by name on the CPU side, before any
    library is built."""
    params, stats = variables
    w = pl.prepare_weights(params, stats, torch.bfloat16, device="cpu")
    before = pl.LAUNCHES
    for bad in (torch.zeros((4, 31), dtype=torch.bfloat16),
                torch.zeros((4, 32), dtype=torch.float16)):
        with pytest.raises(ValueError):
            pl.lifting_forward_cuda(w, bad)
    assert pl.LAUNCHES == before


def test_weights_are_checked_again_when_a_tensor_is_replaced(variables):
    """The wrapper validates a prepared form once and then only compares
    identities and addresses; a replaced tensor is validated anew, and a
    wrong one refused, before any address reaches a kernel."""
    params, stats = variables
    w = pl.prepare_weights(params, stats, torch.bfloat16, device="cpu")
    x = torch.zeros((4, 32), dtype=torch.bfloat16)
    runs = []
    real = pl._check_weights
    try:
        pl._check_weights = lambda *a: (runs.append(1), real(*a))
        first = pl._weight_pointers(w, x)
        assert pl._weight_pointers(w, x) == first and len(runs) == 1
        w[2] = (w[2][0].clone(), w[2][1])  # same values, another tensor
        again = pl._weight_pointers(w, x)
        assert len(runs) == 2 and again[5] == first[5]  # bias 2 unchanged
        w.kmajor[3] = w.kmajor[3][:, :512].contiguous()
        with pytest.raises(ValueError, match="K-contiguous"):
            pl._weight_pointers(w, x)
        # a plain list of pairs is validated at every call
        w32 = list(pl.prepare_weights(params, stats, torch.float32,
                                      device="cpu"))
        runs.clear()
        pl._weight_pointers(w32, x.float())
        pl._weight_pointers(w32, x.float())
        assert len(runs) == 2
    finally:
        pl._check_weights = real


ROUTE_NS = sorted({*PATH_NS, pl.PERSISTENT_MIN_ROWS - 1,
                   pl.PERSISTENT_MIN_ROWS, 65573})


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n", ROUTE_NS)
def test_choose_route_takes_the_persistent_kernel_for_bulk_bf16_only(n, dtype):
    """The persistent TMA kernel takes bf16 rows from PERSISTENT_MIN_ROWS
    up and nothing else; every other count keeps its path."""
    route = pl.choose_route(n, dtype)
    assert route in pl.ROUTES
    persistent = dtype == torch.bfloat16 and n >= pl.PERSISTENT_MIN_ROWS
    assert (route == "persistent") == persistent
    if not persistent:
        assert route == pl.choose_path(n, fused_ok=dtype == torch.bfloat16)
    assert pl.PERSISTENT_MIN_ROWS > pl.FUSED_MAX_ROWS


def test_route_counter_starts_at_zero():
    """One count per kernel route, none of them moved by a CPU process."""
    assert pl.ROUTE_CALLS == {"fused": 0, "layers": 0, "persistent": 0}
    assert set(pl.ROUTE_CALLS) == set(pl.ROUTES) - {"empty"}
    assert set(pl._ROUTE_ARG) == set(pl.ROUTE_CALLS)


def test_refused_calls_count_no_route(variables):
    """A call refused before its launch moves neither counter; a route
    that does not exist for the type is refused by name."""
    params, stats = variables
    w32 = pl.prepare_weights(params, stats, torch.float32, device="cpu")
    before = dict(pl.ROUTE_CALLS)
    with pytest.raises(ValueError):
        pl.lifting_forward_cuda(w32, torch.zeros((4, 32)), path="persistent")
    assert pl.ROUTE_CALLS == before


def _global_kernels(path):
    import re

    with open(path) as f:
        src = f.read()
    bounds = r"__launch_bounds__\((?:[^()]|\([^()]*\))*\)\s*"
    return re.findall(r"__global__\s+void\s+(?:" + bounds + r")?(\w+)\s*\(",
                      src)


@pytest.mark.parametrize("source", ["lifting.cu", "lifting_common.cuh"])
def test_k1_kernels_are_named_as_k1_roofline_counts_them(source):
    """k1_roofline sums the trace time of the kernels whose names hold one
    of its KERNELS: a K1 kernel under any other name would leave its time
    out and read an impossible share."""
    import importlib.util
    import os

    import bilinear_tpu_torch

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "k1_roofline", os.path.join(root, "portbench", "metrics",
                                    "k1_roofline.py"))
    metric = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(metric)
    csrc = os.path.join(os.path.dirname(bilinear_tpu_torch.__file__), "csrc")
    names = _global_kernels(os.path.join(csrc, source))
    assert names, f"no __global__ kernel found in {source}"
    if source == "lifting.cu":
        assert "gemm_wgmma_persistent" in names
    for name in names:
        assert any(k in name for k in metric.KERNELS), name
