"""Exactness of the ops helpers against their plain NumPy / jnp forms."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from eryn_tpu.ops.perm import invert_permutation
from eryn_tpu.ops.select_kernels import mask_cumsum


@pytest.mark.parametrize("width", [1, 127, 128, 129, 255, 256, 257, 800, 4000])
def test_mask_cumsum_matches_cumsum_bitwise(width):
    rng = np.random.default_rng(width)
    m = (rng.random((10, width)) < 0.4).astype(np.float32)
    m[3] = 0.0  # an all-inactive row
    m[4] = 1.0  # an all-active row
    got = jax.jit(mask_cumsum)(jnp.asarray(m))
    np.testing.assert_array_equal(np.asarray(got), np.cumsum(m, axis=-1))


@pytest.mark.parametrize(
    "shape", [(1,), (2,), (100,), (9, 2, 100), (19, 2, 1000)]
)
def test_invert_permutation_matches_argsort(shape):
    key = jax.random.PRNGKey(shape[-1])
    perm = jnp.argsort(jax.random.uniform(key, shape), axis=-1)
    got = jax.jit(invert_permutation)(perm)
    np.testing.assert_array_equal(
        np.asarray(got), np.argsort(np.asarray(perm), axis=-1)
    )
