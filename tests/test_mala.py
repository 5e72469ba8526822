"""MALA move (extension: jax.grad through the traced model)."""

import numpy as np
import pytest

import jax.numpy as jnp

from eryn_tpu import EnsembleSampler, ProbDistContainer, State, uniform_dist
from eryn_tpu.moves import MALAMove, StretchMove

NDIM = 5
NWALKERS = 32


def log_like(x):
    return -0.5 * jnp.sum(x**2)


@pytest.fixture
def priors():
    return ProbDistContainer({i: uniform_dist(-6, 6) for i in range(NDIM)})


def test_mala_posterior_and_efficiency(priors):
    """MALA samples the correct posterior and decorrelates faster per stored
    step than the stretch move on a smooth unit Gaussian."""
    nsteps, burn = 600, 200
    ens = EnsembleSampler(
        NWALKERS, NDIM, log_like, priors, moves=[MALAMove(eps=0.6)], seed=61
    )
    coords = 0.5 * np.random.randn(NWALKERS, NDIM)
    ens.run_mcmc(coords, nsteps, burn=burn)
    chain = ens.get_chain()["model_0"].reshape(-1, NDIM)
    assert np.abs(chain.mean(axis=0)).max() < 0.15
    assert np.abs(chain.std(axis=0) - 1.0).max() < 0.15
    acc = float(ens.acceptance_fraction.mean())
    assert 0.3 < acc <= 1.0, acc  # near-exact AR(1) kernel on a Gaussian target

    base = EnsembleSampler(
        NWALKERS, NDIM, log_like, priors, moves=[StretchMove()], seed=61
    )
    base.run_mcmc(0.5 * np.random.randn(NWALKERS, NDIM), nsteps, burn=burn)
    tau_mala = np.nanmax(ens.get_autocorr_time()["model_0"])
    tau_stretch = np.nanmax(base.get_autocorr_time()["model_0"])
    assert tau_mala < tau_stretch, (tau_mala, tau_stretch)


def test_mala_tempered(priors):
    """Under PT the drift follows the tempered target per rung."""
    ens = EnsembleSampler(
        NWALKERS,
        NDIM,
        log_like,
        priors,
        moves=[MALAMove(eps=0.6)],
        tempering_kwargs=dict(ntemps=4),
        seed=62,
    )
    coords = priors.rvs(size=(4, NWALKERS))
    ens.run_mcmc(coords, 300, burn=150)
    ll = ens.get_log_like()
    assert ll[:, 0].mean() > ll[:, -1].mean()
    chain = ens.get_chain()["model_0"][:, 0].reshape(-1, NDIM)
    assert np.abs(chain.std(axis=0) - 1.0).max() < 0.2


def test_mala_rj_masked_updates(priors):
    """Under RJ leaf masks, MALA only moves active leaves; the k-posterior
    machinery (driven by a separate RJ move) keeps working."""

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
        moves=[MALAMove(eps=0.5)],
        rj_moves=True,
        fill_zero_leaves_val=-1e4,
        seed=63,
    )
    coords = priors.rvs(size=(1, NWALKERS, nlmax))
    inds = np.zeros((1, NWALKERS, nlmax), dtype=bool)
    inds[..., 0] = True
    inds[:, ::2, 1] = True
    ens.run_mcmc(State({"model_0": coords}, inds={"model_0": inds}), 200, burn=100)
    k = ens.get_nleaves()["model_0"]
    assert k.min() >= 1 and k.max() <= nlmax
    chain = ens.get_chain()["model_0"]
    m = ens.get_inds()["model_0"]
    active = chain[m]
    assert np.abs(active.std(axis=0) - 1.0).max() < 0.25
    assert np.isfinite(ens.get_log_like()).all()


def test_mala_step_size_adaptation(priors):
    """Dual averaging drives a badly initialized step size to the target
    acceptance during the tuning window, then freezes."""
    move = MALAMove(eps=5.0, tune_steps=400, target_acceptance=0.574)
    ens = EnsembleSampler(
        NWALKERS, NDIM, log_like, priors, moves=[move], seed=64
    )
    coords = 0.5 * np.random.randn(NWALKERS, NDIM)
    ens.run_mcmc(coords, 800, burn=400)  # tuning happens inside the burn
    # post-tuning acceptance near the target (eps=5.0 alone would be ~0)
    acc = float(ens.acceptance_fraction.mean())
    assert 0.35 < acc < 0.8, acc
    chain = ens.get_chain()["model_0"].reshape(-1, NDIM)
    assert np.abs(chain.mean(axis=0)).max() < 0.2
    assert np.abs(chain.std(axis=0) - 1.0).max() < 0.2
    # the adapted multiplier shrank the absurd step size
    ks = ens._kernel_states[0]
    assert float(ks["log_scale_avg"]) < -1.0
    assert int(ks["t"]) >= 400


def test_gradient_moves_reject_gibbs_setup(priors):
    """Gradient moves update selected branches jointly; a Gibbs setup would
    be silently ignored, so it raises."""
    move = MALAMove(eps=0.3, gibbs_sampling_setup=["model_0"])
    ens = EnsembleSampler(NWALKERS, NDIM, log_like, priors, moves=[move], seed=65)
    with pytest.raises(ValueError, match="gibbs_sampling_setup"):
        ens.run_mcmc(0.1 * np.random.randn(NWALKERS, NDIM), 2)


def test_mala_ensemble_preconditioning():
    """On a Gaussian with scales spanning 50x, complement-half
    preconditioning samples every marginal correctly and decorrelates far
    faster than isotropic MALA tuned to the smallest scale."""
    ndim = 4
    sigmas = np.array([1.0, 5.0, 15.0, 50.0])
    inv_var = jnp.asarray(1.0 / sigmas**2)

    def ll(x):
        return -0.5 * jnp.sum(x**2 * inv_var)

    pr = ProbDistContainer(
        {i: uniform_dist(-6 * sigmas[i], 6 * sigmas[i]) for i in range(ndim)}
    )
    start = np.random.randn(NWALKERS, ndim) * sigmas
    nsteps, burn = 600, 300

    pre = EnsembleSampler(
        NWALKERS,
        ndim,
        ll,
        pr,
        moves=[MALAMove(eps=0.9, ensemble_precondition=True)],
        seed=66,
    )
    pre.run_mcmc(start, nsteps, burn=burn)
    chain = pre.get_chain()["model_0"].reshape(-1, ndim)
    # every marginal correct despite the 50x scale spread
    assert np.abs(chain.std(axis=0) / sigmas - 1.0).max() < 0.2
    assert np.abs(chain.mean(axis=0) / sigmas).max() < 0.2

    plain = EnsembleSampler(
        NWALKERS,
        ndim,
        ll,
        pr,
        moves=[MALAMove(eps=0.9)],  # isotropic: limited by the sigma=1 axis
        seed=66,
    )
    plain.run_mcmc(start, nsteps, burn=burn)
    tau_pre = np.nanmax(pre.get_autocorr_time()["model_0"])
    tau_plain = np.nanmax(plain.get_autocorr_time()["model_0"])
    assert tau_pre * 2 < tau_plain, (tau_pre, tau_plain)


def test_mala_escapes_nan_gradient_region(priors):
    """Regression: a walker in a -inf-log-like region whose gradient is NaN
    (log(0) with 0/0 derivative, e.g. a truncated density) must degenerate
    to a pure noise step and ESCAPE rather than freeze forever."""
    from eryn_tpu.moves import MALAMove

    def trunc_ll(x):
        # log of a truncated paraboloid: -inf outside |x|^2 < 4 with a NaN
        # gradient there (d log(relu)/dx = 0/0)
        return jnp.log(jnp.maximum(4.0 - jnp.sum(x**2), 0.0))

    ens = EnsembleSampler(
        NWALKERS,
        NDIM,
        trunc_ll,
        priors,
        moves=[MALAMove()],
        seed=63,
    )
    coords = 0.3 * np.random.randn(NWALKERS, NDIM)
    coords[0] = 2.1 / np.sqrt(NDIM)  # just outside the support sphere
    ens.run_mcmc(coords, 300)
    ll_last = np.asarray(ens.get_log_like())[-1]
    assert np.isfinite(ll_last).all(), "stuck walker never escaped"
