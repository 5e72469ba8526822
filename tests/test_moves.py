"""MH-family moves: Gaussian (all modes), DistributionGenerate, CombineMove,
weighted move schedules."""

import numpy as np
import pytest

import jax.numpy as jnp

from eryn_tpu import EnsembleSampler, ProbDistContainer, uniform_dist
from eryn_tpu.moves import (
    CombineMove,
    DistributionGenerate,
    GaussianMove,
    StretchMove,
)

NDIM = 3
NWALKERS = 40


def log_like(x):
    return -0.5 * jnp.sum(x**2)


@pytest.fixture
def priors():
    return ProbDistContainer({i: uniform_dist(-10, 10) for i in range(NDIM)})


def _run(moves, priors, nsteps=400, burn=200, ntemps=1, seed=5):
    kwargs = {}
    if ntemps > 1:
        kwargs["tempering_kwargs"] = dict(ntemps=ntemps)
    ens = EnsembleSampler(
        NWALKERS, NDIM, log_like, priors, moves=moves, seed=seed, **kwargs
    )
    size = (ntemps, NWALKERS) if ntemps > 1 else (NWALKERS,)
    coords = 0.1 * np.random.randn(*size, NDIM)
    ens.run_mcmc(coords, nsteps, burn=burn)
    return ens


def _check_posterior(ens, tol_mean=0.25, tol_std=0.25):
    chain = ens.get_chain()["model_0"]
    flat = chain[:, 0].reshape(-1, NDIM)
    assert np.abs(flat.mean(axis=0)).max() < tol_mean
    assert np.abs(flat.std(axis=0) - 1.0).max() < tol_std


@pytest.mark.parametrize("mode", ["vector", "random", "sequential"])
def test_gaussian_move_modes(priors, mode):
    move = GaussianMove({"model_0": 1.2 * np.ones(NDIM)}, mode=mode)
    ens = _run([move], priors)
    _check_posterior(ens)
    acc = ens.acceptance_fraction.mean()
    assert 0.05 < acc < 0.95


def test_gaussian_full_cov_with_factor(priors):
    cov = 0.5 * np.eye(NDIM) + 0.1
    move = GaussianMove({"model_0": cov}, factor=3.0)
    ens = _run([move], priors)
    _check_posterior(ens)


def test_distribution_generate(priors):
    gen = ProbDistContainer({i: uniform_dist(-3, 3) for i in range(NDIM)})
    move = DistributionGenerate({"model_0": gen})
    ens = _run([move], priors, nsteps=800)
    _check_posterior(ens, tol_mean=0.3, tol_std=0.3)


def test_combine_move(priors):
    move = CombineMove(
        [StretchMove(), GaussianMove({"model_0": np.ones(NDIM)})]
    )
    ens = _run([move], priors)
    _check_posterior(ens)
    # per-child acceptance fractions (ref combine.py:59-62) accumulate in the
    # traced kernel state and surface on the host after the run
    afs = move.acceptance_fraction_separate
    assert afs is not None and len(afs) == 2
    for af in afs:
        assert af.shape == (1, NWALKERS)
        assert 0.0 < af.mean() < 1.0
    assert move.moves is move.moves_list


def test_weighted_schedule(priors):
    moves = [
        (StretchMove(), 0.7),
        (GaussianMove({"model_0": np.ones(NDIM)}), 0.3),
    ]
    ens = _run(moves, priors, ntemps=4)
    chain = ens.get_chain()["model_0"]
    assert chain.shape[1] == 4
    _check_posterior(ens)
    # both moves were actually exercised
    fracs = {k: v for k, v in ens.backend.moves_accepted_fraction.items()}
    assert set(fracs) == {"StretchMove_0", "GaussianMove_0"}
    assert all(np.all(np.isfinite(v)) for v in fracs.values())


def test_distgen_gibbs_mask_factors_unbiased(priors):
    """Regression: with parameter-level Gibbs masks, DistributionGenerate
    must compute Hastings factors for the MASKED proposal — factors for
    discarded draw components (the reference's post-hoc cleanup ordering)
    bias the chain when the generator is non-uniform."""
    from eryn_tpu.prior import normal_dist

    gen = ProbDistContainer(
        {i: normal_dist(1.0, 1.5) for i in range(NDIM)}
    )
    m1 = np.zeros((1, NDIM), dtype=bool)
    m1[:, : NDIM // 2] = True
    m2 = ~m1
    move = DistributionGenerate(
        {"model_0": gen},
        gibbs_sampling_setup=[("model_0", m1), ("model_0", m2)],
    )
    ens = EnsembleSampler(
        NWALKERS, NDIM, log_like, priors, moves=[move], seed=51
    )
    ens.run_mcmc(0.1 * np.random.randn(NWALKERS, NDIM), 1200, burn=300)
    chain = ens.get_chain()["model_0"].reshape(-1, NDIM)
    assert np.abs(chain.mean(axis=0)).max() < 0.1
    assert np.abs(chain.std(axis=0) - 1.0).max() < 0.15


def test_gaussian_move_rejects_bad_covariance():
    with pytest.raises(ValueError, match="positive"):
        GaussianMove({"model_0": -1.0})
    with pytest.raises(ValueError, match="positive"):
        GaussianMove({"model_0": np.array([1.0, -0.5, 2.0])})


def test_delayed_rejection_requires_symmetric_proposal(priors):
    """DelayedRejection's recursive acceptance drops proposal densities —
    asymmetric wrapped proposals must be refused, not silently biased."""
    from eryn_tpu.moves import DelayedRejection

    gen = ProbDistContainer({i: uniform_dist(-5, 5) for i in range(NDIM)})
    with pytest.raises(ValueError, match="symmetric"):
        DelayedRejection(DistributionGenerate({"model_0": gen}))


def test_distgen_mask_splitting_mvn_group_raises(priors):
    """Regression: a Gibbs mask selecting part of a correlated multivariate
    prior group must raise (the joint-logpdf factors would be conditional,
    not marginal — a silently biased chain)."""
    from eryn_tpu.prior import MultivariateNormalDistribution

    mvn = MultivariateNormalDistribution(
        np.zeros(2), np.array([[1.0, 0.8], [0.8, 1.0]])
    )
    gen = ProbDistContainer({(0, 1): mvn, 2: uniform_dist(-5, 5)})
    m1 = np.zeros((1, NDIM), dtype=bool)
    m1[:, 0] = True  # splits the (0, 1) group
    move = DistributionGenerate(
        {"model_0": gen},
        gibbs_sampling_setup=[("model_0", m1), ("model_0", ~m1)],
    )
    ens = EnsembleSampler(
        NWALKERS, NDIM, log_like, priors, moves=[move], seed=52
    )
    with pytest.raises(ValueError, match="splits the"):
        ens.run_mcmc(0.1 * np.random.randn(NWALKERS, NDIM), 2)


def test_stretch_log_proposal(priors):
    """Reference roadmap item (ref docs/source/general/todos.rst): the
    ptemcee log-uniform scaling density, with a measured comparison against
    the Goodman-Weare default."""
    ens_log = _run([StretchMove(use_log_proposal=True)], priors, nsteps=800)
    _check_posterior(ens_log)
    acc_log = ens_log.acceptance_fraction.mean()

    ens_gw = _run([StretchMove()], priors, nsteps=800)
    acc_gw = ens_gw.acceptance_fraction.mean()

    # both proposals mix on this target; g(z) ∝ 1/z concentrates less
    # density at extreme stretches, so its acceptance sits at or above the
    # GW default (ptemcee's observed behavior)
    assert 0.1 < acc_log < 0.95
    assert acc_log > acc_gw - 0.05


def test_stretch_log_proposal_factor_exponent():
    """The detailed-balance exponent must be N (not N-1) for g(z) ∝ 1/z."""
    import jax

    move_log = StretchMove(use_log_proposal=True)
    move_gw = StretchMove()
    key = jax.random.PRNGKey(0)
    s = {"model_0": jnp.zeros((1, 4, 1, NDIM))}
    c = {"model_0": jnp.ones((1, 6, 1, NDIM))}
    inds = {"model_0": jnp.ones((1, 4, 1), dtype=bool)}
    _, fac_log = move_log.get_proposal_kernel(key, s, c, inds)
    _, fac_gw = move_gw.get_proposal_kernel(key, s, c, inds)
    # same key -> different z draws per density, so compare via the implied
    # z: factors / exponent must recover a z inside the allowed support
    z_log = np.exp(np.asarray(fac_log) / NDIM)
    z_gw = np.exp(np.asarray(fac_gw) / (NDIM - 1))
    a = move_log.a
    assert np.all((z_log >= 1 / a - 1e-6) & (z_log <= a + 1e-6))
    assert np.all((z_gw >= 1 / a - 1e-6) & (z_gw <= a + 1e-6))
