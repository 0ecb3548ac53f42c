"""Shared inputs of the ``test_torch_port_*`` files: the JAX package's
``BilinearUnit`` at full width with non-trivial BN statistics, as numpy
trees that both packages take."""
import jax
import jax.numpy as jnp
import numpy as np

from bilinear_tpu.models.bilinear import BilinearUnit


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
