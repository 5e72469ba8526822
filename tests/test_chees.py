"""ChEES-HMC (self-tuning trajectory lengths, the NUTS
alternative designed for SIMD ensembles)."""

import numpy as np
import pytest

import jax.numpy as jnp

from eryn_tpu import EnsembleSampler, ProbDistContainer, uniform_dist
from eryn_tpu.moves import ChEESHMCMove, HMCMove

NDIM = 5
NWALKERS = 32


@pytest.fixture
def priors():
    return ProbDistContainer({i: uniform_dist(-8, 8) for i in range(NDIM)})


def _correlated(rho=0.9):
    cov = rho * np.ones((NDIM, NDIM)) + (1 - rho) * np.eye(NDIM)
    inv = jnp.asarray(np.linalg.inv(cov))

    def ll(x):
        return -0.5 * x @ (inv @ x)

    return cov, ll


def test_chees_correlated_gaussian(priors):
    """ChEES-HMC self-tunes both eps and the trajectory length into an
    exact, efficient sampler on a strongly correlated Gaussian — no
    hand-set eps or num_leapfrog anywhere."""
    cov, ll = _correlated()
    ens = EnsembleSampler(
        NWALKERS, NDIM, ll, priors, moves=[ChEESHMCMove(tune_steps=300)],
        seed=81,
    )
    coords = np.random.default_rng(1).standard_normal(
        (NWALKERS, NDIM)
    ) @ np.linalg.cholesky(cov).T
    ens.run_mcmc(coords, 600, burn=300)
    chain = ens.get_chain()["model_0"].reshape(-1, NDIM)
    assert np.abs(chain.mean(axis=0)).max() < 0.25
    assert np.abs(np.cov(chain.T) - cov).max() < 0.35
    acc = float(ens.acceptance_fraction.mean())
    assert 0.4 < acc <= 1.0, acc

    ks = ens._kernel_states[0]
    # the trajectory length adapted away from its initialization and the
    # Adam state is live
    assert np.isfinite(float(ks["log_T"]))
    assert float(ks["adam_v"]) > 0.0


def test_chees_adaptation_freezes(priors):
    """log_T and the dual-averaged eps scale stop moving after
    tune_steps (exactness requires a frozen kernel post-burn-in)."""
    cov, ll = _correlated()
    mv = ChEESHMCMove(tune_steps=50)
    ens = EnsembleSampler(NWALKERS, NDIM, ll, priors, moves=[mv], seed=82)
    coords = np.random.default_rng(2).standard_normal(
        (NWALKERS, NDIM)
    ) @ np.linalg.cholesky(cov).T
    ens.run_mcmc(coords, 80)
    frozen_T = float(ens._kernel_states[0]["log_T"])
    frozen_s = float(ens._kernel_states[0]["log_scale_avg"])
    ens.run_mcmc(None, 50)
    assert float(ens._kernel_states[0]["log_T"]) == frozen_T
    assert float(ens._kernel_states[0]["log_scale_avg"]) == frozen_s
    assert int(ens._kernel_states[0]["t"]) == 130


def test_chees_beats_short_hmc_on_correlated(priors):
    """On a 0.95-correlated Gaussian (condition number ~96 — correlation,
    which the diagonal eps heuristic CANNOT precondition away, unlike
    axis-aligned anisotropy) the adapted trajectory decorrelates the slow
    mode far faster than a deliberately short fixed-length HMC
    (measured: tau ~3 vs ~36)."""
    cov, ll = _correlated(rho=0.95)
    coords = np.random.default_rng(3).standard_normal(
        (NWALKERS, NDIM)
    ) @ np.linalg.cholesky(cov).T

    chees = EnsembleSampler(
        NWALKERS, NDIM, ll, priors,
        moves=[ChEESHMCMove(tune_steps=300, max_leapfrog=48)], seed=83,
    )
    chees.run_mcmc(coords, 700, burn=300)
    short = EnsembleSampler(
        NWALKERS, NDIM, ll, priors,
        moves=[HMCMove(num_leapfrog=2, tune_steps=300)], seed=83,
    )
    short.run_mcmc(coords, 700, burn=300)

    tau_c = np.nanmax(chees.get_autocorr_time()["model_0"])
    tau_s = np.nanmax(short.get_autocorr_time()["model_0"])
    assert tau_c < tau_s / 3.0, (tau_c, tau_s)
    # and the posterior is still right
    chain = chees.get_chain()["model_0"].reshape(-1, NDIM)
    np.testing.assert_allclose(chain.std(axis=0), 1.0, rtol=0.15)


def test_chees_tempered_and_rj(priors):
    """ChEES under parallel tempering and RJ leaf masks: cold chain
    correct, leaf machinery intact (momenta only on active leaves)."""
    from eryn_tpu import State

    def ll(c, m):
        contrib = -0.5 * jnp.sum(c**2, axis=-1)
        return jnp.sum(jnp.where(m, contrib, 0.0))

    nlmax = 2
    ens = EnsembleSampler(
        NWALKERS, NDIM, ll, priors,
        nleaves_max=nlmax, nleaves_min=1,
        moves=[ChEESHMCMove(tune_steps=100, max_leapfrog=16)],
        rj_moves=True,
        tempering_kwargs=dict(ntemps=3),
        fill_zero_leaves_val=-1e4,
        seed=84,
    )
    coords = priors.rvs(size=(3, NWALKERS, nlmax))
    inds = np.zeros((3, NWALKERS, nlmax), dtype=bool)
    inds[..., 0] = True
    inds[:, ::2, 1] = True
    ens.run_mcmc(
        State({"model_0": coords}, inds={"model_0": inds}), 250, burn=120
    )
    k = ens.get_nleaves()["model_0"]
    assert k.min() >= 1 and k.max() <= nlmax
    active = ens.get_chain()["model_0"][:, 0][ens.get_inds()["model_0"][:, 0]]
    assert np.abs(active.std(axis=0) - 1.0).max() < 0.25
    assert np.isfinite(ens.get_log_like()).all()


def test_chees_validates_args():
    with pytest.raises(ValueError, match="init_num_leapfrog"):
        ChEESHMCMove(init_num_leapfrog=64, max_leapfrog=32)


def test_chees_jitter_advances_without_tuning(priors):
    """With tune_steps=0 the dual-averaging path never runs, but the
    proposal counter (which drives the Halton jitter) must still advance
    — a frozen counter would repeat u=0.5 forever, silently removing the
    trajectory-length jitter."""
    cov, ll = _correlated()
    ens = EnsembleSampler(
        NWALKERS, NDIM, ll, priors, moves=[ChEESHMCMove(tune_steps=0)],
        seed=85,
    )
    coords = np.random.default_rng(4).standard_normal(
        (NWALKERS, NDIM)
    ) @ np.linalg.cholesky(cov).T
    ens.run_mcmc(coords, 20)
    assert int(ens._kernel_states[0]["t"]) == 20
