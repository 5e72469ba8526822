"""Matmuls whose values enter a density or a proposal ask for full f32
precision: a DEFAULT f32 matmul may run in TF32 (10-bit mantissa) on a GPU.
The CPU computes DEFAULT in full f32, so the check reads the precision each
site requests from its jaxpr."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from eryn_tpu.moves import GaussianMove, KDEMove, WalkMove
from eryn_tpu.prior import MultivariateNormalDistribution

_MVN = MultivariateNormalDistribution(
    np.zeros(3), np.array([[2.0, 0.5, 0.0], [0.5, 1.0, 0.2], [0.0, 0.2, 1.5]])
)
_KEY = jax.random.PRNGKey(0)
_ONES = {"model_0": jnp.ones((2, 8, 1), bool)}


def _sites():
    x = jnp.ones((4, 3))
    c = {"model_0": jnp.ones((2, 8, 1, 3))}
    return {
        "mvn_logpdf": lambda: _MVN.logpdf(x),
        "mvn_sample": lambda: _MVN.sample(_KEY, (4,)),
        "kde_logpdf": lambda: KDEMove()._kde_logpdf(
            jnp.ones((2, 4, 3)), jnp.ones((2, 6, 3)), jnp.ones((2, 3, 3)),
            jnp.zeros(2), 3,
        ),
        "gaussian_proposal": lambda: GaussianMove(
            {"model_0": np.eye(3) + 0.1}
        ).get_proposal_kernel(_KEY, c, _ONES, {}),
        "walk_proposal": lambda: WalkMove().get_proposal_kernel(
            _KEY, c, c, _ONES
        ),
    }


def _dot_precisions(fn):
    found = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                found.append(eqn.params["precision"])
            for sub in jax.core.jaxprs_in_params(eqn.params):
                walk(sub)

    walk(jax.make_jaxpr(fn)().jaxpr)
    return found


@pytest.mark.parametrize("site", sorted(_sites()))
def test_site_matmuls_ask_for_highest(site):
    precisions = _dot_precisions(_sites()[site])
    assert precisions, "no matmul found at this site"
    highest = jax.lax.Precision.HIGHEST
    for p in precisions:
        assert p is not None and all(q == highest for q in p), precisions
