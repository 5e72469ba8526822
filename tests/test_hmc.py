"""HMC move (extension: leapfrog via lax.scan over jax.grad)."""

import numpy as np
import pytest

import jax.numpy as jnp

from eryn_tpu import EnsembleSampler, ProbDistContainer, uniform_dist
from eryn_tpu.moves import HMCMove, StretchMove

NDIM = 5
NWALKERS = 32


@pytest.fixture
def priors():
    return ProbDistContainer({i: uniform_dist(-8, 8) for i in range(NDIM)})


def test_hmc_correlated_gaussian(priors):
    """HMC samples a strongly correlated Gaussian correctly and decorrelates
    much faster than the stretch move per stored step."""
    rho = 0.9
    cov = rho * np.ones((NDIM, NDIM)) + (1 - rho) * np.eye(NDIM)
    invcov = jnp.asarray(np.linalg.inv(cov))
    cov_j = jnp.asarray(cov)

    def ll(x):
        return -0.5 * x @ (invcov @ x)

    nsteps, burn = 500, 200
    ens = EnsembleSampler(
        NWALKERS,
        NDIM,
        ll,
        priors,
        moves=[HMCMove(eps=0.25, num_leapfrog=8)],
        seed=71,
    )
    coords = np.random.randn(NWALKERS, NDIM) @ np.linalg.cholesky(cov).T
    ens.run_mcmc(coords, nsteps, burn=burn)
    chain = ens.get_chain()["model_0"].reshape(-1, NDIM)
    assert np.abs(chain.mean(axis=0)).max() < 0.2
    emp_cov = np.cov(chain.T)
    assert np.abs(emp_cov - cov).max() < 0.3
    acc = float(ens.acceptance_fraction.mean())
    assert acc > 0.5, acc

    base = EnsembleSampler(
        NWALKERS, NDIM, ll, priors, moves=[StretchMove()], seed=71
    )
    base.run_mcmc(coords, nsteps, burn=burn)
    tau_hmc = np.nanmax(ens.get_autocorr_time()["model_0"])
    tau_stretch = np.nanmax(base.get_autocorr_time()["model_0"])
    assert tau_hmc < tau_stretch, (tau_hmc, tau_stretch)


def test_hmc_jittered_length(priors):
    """num_leapfrog=(lo, hi) jitters the per-walker trajectory length
    (Neal 2011 resonance breaking) and stays exact on a correlated
    Gaussian."""
    rho = 0.9
    cov = rho * np.ones((NDIM, NDIM)) + (1 - rho) * np.eye(NDIM)
    invcov = jnp.asarray(np.linalg.inv(cov))

    def ll(x):
        return -0.5 * x @ (invcov @ x)

    ens = EnsembleSampler(
        NWALKERS,
        NDIM,
        ll,
        priors,
        moves=[HMCMove(eps=0.25, num_leapfrog=(2, 10))],
        seed=72,
    )
    coords = np.random.randn(NWALKERS, NDIM) @ np.linalg.cholesky(cov).T
    ens.run_mcmc(coords, 500, burn=200)
    chain = ens.get_chain()["model_0"].reshape(-1, NDIM)
    assert np.abs(chain.mean(axis=0)).max() < 0.2
    assert np.abs(np.cov(chain.T) - cov).max() < 0.3
    acc = float(ens.acceptance_fraction.mean())
    assert acc > 0.5, acc
    with pytest.raises(ValueError, match="num_leapfrog"):
        HMCMove(num_leapfrog=(5, 2))


def test_hmc_ensemble_precondition(priors):
    """Red/blue ensemble-preconditioned HMC: on an axis-anisotropic
    Gaussian (sigmas spanning 50x) the complement-half mass matrix makes
    a single scalar eps work across all scales — correct posterior, sane
    acceptance, and mixing no worse than the plain heuristic."""
    sig = np.array([0.05, 0.2, 1.0, 2.5, 0.5])
    sig_j = jnp.asarray(sig)

    def ll(x):
        return -0.5 * jnp.sum((x / sig_j) ** 2)

    rng = np.random.default_rng(7)
    coords = rng.standard_normal((NWALKERS, NDIM)) * sig

    ens = EnsembleSampler(
        NWALKERS, NDIM, ll, priors,
        moves=[HMCMove(eps=0.4, num_leapfrog=5,
                       ensemble_precondition=True, tune_steps=200)],
        seed=76,
    )
    ens.run_mcmc(coords, 500, burn=250)
    chain = ens.get_chain()["model_0"].reshape(-1, NDIM)
    np.testing.assert_allclose(chain.std(axis=0), sig, rtol=0.2)
    assert np.abs(chain.mean(axis=0) / sig).max() < 0.2
    acc = float(ens.acceptance_fraction.mean())
    assert 0.4 < acc <= 1.0, acc
    tau = np.nanmax(ens.get_autocorr_time()["model_0"])
    assert tau < 20.0, tau

    # jittered lengths compose with preconditioning
    ens2 = EnsembleSampler(
        NWALKERS, NDIM, ll, priors,
        moves=[HMCMove(eps=0.4, num_leapfrog=(2, 8),
                       ensemble_precondition=True, tune_steps=200)],
        seed=77,
    )
    ens2.run_mcmc(coords, 300, burn=150)
    chain2 = ens2.get_chain()["model_0"].reshape(-1, NDIM)
    np.testing.assert_allclose(chain2.std(axis=0), sig, rtol=0.25)

    # the fully hands-off configuration the docs advertise: eps=None.
    # The heuristic base collapses to its geometric mean here (the
    # complement sigma supplies the anisotropy) — the naive vector base
    # would scale per-axis steps as sigma^2 and stall the narrow axes.
    ens3 = EnsembleSampler(
        NWALKERS, NDIM, ll, priors,
        moves=[HMCMove(ensemble_precondition=True, tune_steps=250)],
        seed=78,
    )
    ens3.run_mcmc(coords, 500, burn=250)
    chain3 = ens3.get_chain()["model_0"].reshape(-1, NDIM)
    np.testing.assert_allclose(chain3.std(axis=0), sig, rtol=0.2)
    acc3 = float(ens3.acceptance_fraction.mean())
    assert 0.4 < acc3 <= 1.0, acc3
    # mixing must be healthy on EVERY axis (sigma^2 scaling would blow
    # the narrow-axis taus up by ~an order of magnitude)
    tau3 = np.nanmax(ens3.get_autocorr_time()["model_0"])
    assert tau3 < 20.0, tau3

    # ChEES rejects the flag with a descriptive error
    from eryn_tpu.moves import ChEESHMCMove

    with pytest.raises(NotImplementedError, match="ensemble_precondition"):
        ChEESHMCMove(ensemble_precondition=True)


def test_hmc_tempered(priors):
    def ll(x):
        return -0.5 * jnp.sum(x**2)

    ens = EnsembleSampler(
        NWALKERS,
        NDIM,
        ll,
        priors,
        moves=[HMCMove(eps=0.3, num_leapfrog=5)],
        tempering_kwargs=dict(ntemps=4),
        seed=72,
    )
    coords = priors.rvs(size=(4, NWALKERS))
    ens.run_mcmc(coords, 250, burn=150)
    llv = ens.get_log_like()
    assert llv[:, 0].mean() > llv[:, -1].mean()
    chain = ens.get_chain()["model_0"][:, 0].reshape(-1, NDIM)
    assert np.abs(chain.std(axis=0) - 1.0).max() < 0.2


def test_hmc_rj_masked_updates(priors):
    """HMC under RJ leaf masks: momenta/kicks/drifts exist only on active
    leaves; inactive leaves stay frozen and the k-machinery keeps working."""
    from eryn_tpu import State

    def ll(c, m):
        contrib = -0.5 * jnp.sum(c**2, axis=-1)
        return jnp.sum(jnp.where(m, contrib, 0.0))

    nlmax = 2
    ens = EnsembleSampler(
        NWALKERS,
        NDIM,
        ll,
        priors,
        nleaves_max=nlmax,
        nleaves_min=1,
        moves=[HMCMove(eps=0.3, num_leapfrog=4)],
        rj_moves=True,
        fill_zero_leaves_val=-1e4,
        seed=73,
    )
    coords = priors.rvs(size=(1, NWALKERS, nlmax))
    inds = np.zeros((1, NWALKERS, nlmax), dtype=bool)
    inds[..., 0] = True
    inds[:, ::2, 1] = True
    ens.run_mcmc(State({"model_0": coords}, inds={"model_0": inds}), 200, burn=100)
    k = ens.get_nleaves()["model_0"]
    assert k.min() >= 1 and k.max() <= nlmax
    chain = ens.get_chain()["model_0"]
    active = chain[ens.get_inds()["model_0"]]
    assert np.abs(active.std(axis=0) - 1.0).max() < 0.25
    assert np.isfinite(ens.get_log_like()).all()


def test_gradient_moves_carry_blobs(priors):
    """Accepted MALA/HMC proposals update the blobs alongside the coords
    (blob = first coordinate, so they must stay equal)."""
    from eryn_tpu.moves import MALAMove

    def ll(x):
        return -0.5 * jnp.sum(x**2), x[0]

    for move in (MALAMove(eps=0.6), HMCMove(eps=0.3, num_leapfrog=3)):
        ens = EnsembleSampler(
            NWALKERS, NDIM, ll, priors, moves=[move], seed=74
        )
        coords = 0.5 * np.random.randn(NWALKERS, NDIM)
        ens.run_mcmc(coords, 50)
        blobs = np.asarray(ens.get_blobs())
        chain = np.asarray(ens.get_chain()["model_0"][:, :, :, 0, 0])
        # the blob is recomputed inside the value_and_grad aux path; XLA may
        # fuse it differently from the stored coordinate (1-ulp f32 noise)
        np.testing.assert_allclose(
            blobs, chain.reshape(blobs.shape), rtol=1e-5, atol=1e-6
        )


def test_gradient_moves_periodic_wrap(priors):
    """Proposals on a periodic parameter stay wrapped and mix across the
    boundary (a von-Mises-like target centered at the seam)."""
    from eryn_tpu.moves import MALAMove

    two_pi = 2 * np.pi

    def ll(x):
        # concentration at angle 0 == 2pi (the seam)
        return 4.0 * jnp.cos(x[0]) - 0.5 * x[1] ** 2

    pr = ProbDistContainer(
        {0: uniform_dist(0.0, two_pi), 1: uniform_dist(-8.0, 8.0)}
    )
    for move in (MALAMove(eps=0.3), HMCMove(eps=0.25, num_leapfrog=4)):
        ens = EnsembleSampler(
            NWALKERS,
            2,
            ll,
            pr,
            moves=[move],
            periodic={"model_0": {0: two_pi}},
            seed=75,
        )
        start = np.column_stack(
            [
                np.random.uniform(0, two_pi, NWALKERS),
                np.random.randn(NWALKERS),
            ]
        )
        ens.run_mcmc(start, 400, burn=200)
        chain = np.asarray(ens.get_chain()["model_0"][..., 0]).reshape(-1)
        assert chain.min() >= 0.0 and chain.max() <= two_pi
        # posterior mass concentrates at the seam: both edges populated
        assert (chain < 0.5).mean() > 0.1
        assert (chain > two_pi - 0.5).mean() > 0.1
        acc = float(ens.acceptance_fraction.mean())
        assert acc > 0.3, (type(move).__name__, acc)
