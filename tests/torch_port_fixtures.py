"""Shared inputs of the ``test_torch_port_*`` files: the JAX package's
``BilinearUnit`` at full width with non-trivial BN statistics, as numpy
trees that both packages take; a BN scrambler; the JAX End2End without
dropout; and the fixture that runs each port test module on one torch
thread."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bilinear_tpu.models.bilinear import BilinearUnit
from bilinear_tpu.models.end2end import End2End as _JaxEnd2End
from bilinear_tpu.models.hourglass import StackedHourglass as _JaxPreact
from bilinear_tpu.models.hourglass_torch7 import MainModel as _JaxTorch7


def scrambled_variables(seed: int = 0):
    """(params, batch_stats) numpy trees: flax init, BN means ~N(0, 0.3^2)
    and variances ~U(0.5, 1.5) (as tests/test_pallas_lifting.py does)."""
    v = BilinearUnit().init(jax.random.PRNGKey(seed), jnp.zeros((2, 32)),
                            train=False)
    rng = np.random.RandomState(seed)

    def scramble(path, leaf):
        name = str(path[-1].key)
        if name == "mean":
            return rng.randn(*leaf.shape).astype(np.float32) * 0.3
        if name == "var":
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return np.asarray(leaf)

    params = jax.tree.map(np.asarray, v["params"])
    stats = jax.tree_util.tree_map_with_path(scramble, v["batch_stats"])
    return params, stats


def rows(n: int, seed: int) -> np.ndarray:
    return np.random.RandomState(seed).randn(n, 32).astype(np.float32)


def ulp_gap(a, b) -> int:
    """Largest distance in units of the last place between two f32 arrays
    of one sign."""
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max())


def scramble_bn(rng):
    """A tree_map_with_path function giving every BN non-trivial gamma,
    beta and running statistics from the numpy RandomState ``rng``."""
    def scramble(path, leaf):
        name = str(path[-1].key)
        leaf = np.asarray(leaf)
        if name == "mean":
            return (0.1 * rng.randn(*leaf.shape)).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if name == "scale":
            return (1 + 0.2 * rng.randn(*leaf.shape)).astype(np.float32)
        if name == "bias" and str(path[-2].key).startswith("bn"):
            return (0.1 * rng.randn(*leaf.shape)).astype(np.float32)
        return leaf
    return scramble


class NoDropoutEnd2End(_JaxEnd2End):
    """The JAX End2End with ``BilinearUnit(dropout=0.0)``: JAX's PRNG and
    torch's draw different masks, so train-mode parity runs without
    dropout (as tests/test_m4_composition.py subclasses End2End)."""

    def setup(self):
        size = {k: v for k, v in dict(n_stacks=self.n_stacks,
                                      features=self.features,
                                      depth=self.depth).items()
                if v is not None}
        if self.variant == "torch7":
            self.hourglass = _JaxTorch7(dtype=self.dtype, fused=self.fused,
                                        name="hourglass", **size)
        else:
            names = dict(n_stacks="stacks", features="out_channels",
                         depth="compression_time")
            self.hourglass = _JaxPreact(
                dtype=self.dtype, name="hourglass",
                **{names[k]: v for k, v in size.items()})
        self.bilinear = BilinearUnit(dtype=self.dtype, dropout=0.0,
                                     name="bilinear")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The module's tests run torch on one intra-op thread (imported by name
    into each port test module, which makes it autouse there). The suite
    runs in several worker processes on one machine, where each process's
    pool of OpenMP threads waits at the barrier of every small op for
    threads the other processes keep descheduled: on an 8-core CPU the SH
    protocol chain of test_torch_port_sh.py took 261 s with torch's default
    pool beside five busy processes, 63 s with one thread, and 13 s
    alone."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
