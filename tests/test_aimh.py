"""AIMH adaptive independence proposal (the DIME component, Boehl 2022)."""

import numpy as np
import pytest

import jax.numpy as jnp

from eryn_tpu import EnsembleSampler, ProbDistContainer, uniform_dist
from eryn_tpu.moves import AIMHMove, DEMove, StretchMove

NDIM = 3
NWALKERS = 32


@pytest.fixture
def priors():
    return ProbDistContainer({i: uniform_dist(-8, 8) for i in range(NDIM)})


def test_aimh_standard_normal(priors):
    """After adaptation the fitted t-proposal approximates the target: high
    independence-sampler acceptance, near-iid samples, exact moments."""
    def ll(x):
        return -0.5 * jnp.sum(x**2)

    ens = EnsembleSampler(
        NWALKERS, NDIM, ll, priors, moves=[AIMHMove(tune_steps=150)], seed=4
    )
    ens.run_mcmc(priors.rvs(size=(1, NWALKERS)), 500, burn=250)
    chain = ens.get_chain()["model_0"].reshape(-1, NDIM)
    assert np.abs(chain.mean(axis=0)).max() < 0.1
    assert np.abs(chain.std(axis=0) - 1.0).max() < 0.1
    acc = float(ens.acceptance_fraction.mean())
    assert acc > 0.5, acc  # a well-fitted independence sampler
    # near-iid: far shorter autocorrelation than the stretch move
    tau = np.nanmax(ens.get_autocorr_time()["model_0"])
    assert tau < 5.0, tau


def test_aimh_dime_schedule_bimodal(priors):
    """The DIME recipe — (DEMove, 0.9) + (AIMHMove, 0.1) — hops between
    well-separated modes (the fitted t covers both) where a local-move
    chain mixes modes orders of magnitude slower."""
    sep = 4.0

    def ll(x):
        return jnp.logaddexp(
            -0.5 * jnp.sum((x - sep) ** 2) / 0.2,
            -0.5 * jnp.sum((x + sep) ** 2) / 0.2,
        )

    # initialize across both modes so the fit sees them
    rng = np.random.default_rng(0)
    start = rng.standard_normal((NWALKERS, NDIM)) * 0.5
    start[::2] += sep
    start[1::2] -= sep

    ens = EnsembleSampler(
        NWALKERS, NDIM, ll, priors,
        # tune_steps counts AIMH SELECTIONS: weight 0.1 over burn 300
        # steps -> ~30 selections, so 25 freezes inside burn-in
        moves=[(DEMove(), 0.9), (AIMHMove(tune_steps=25), 0.1)],
        seed=5,
    )
    ens.run_mcmc(start, 1000, burn=300)
    chain = np.asarray(ens.get_chain()["model_0"][..., 0]).reshape(1000, -1)
    frac_up = (chain > 0).mean()
    # both modes hold ~half the mass
    assert 0.35 < frac_up < 0.65, frac_up
    # individual walkers actually cross between modes (mode-hopping, not
    # just frozen half-half occupancy)
    signs = chain > 0
    crossings = (signs[1:] != signs[:-1]).sum()
    assert crossings > 50, crossings


def test_aimh_tempered(priors):
    def ll(x):
        return -0.5 * jnp.sum(x**2)

    ens = EnsembleSampler(
        NWALKERS, NDIM, ll, priors,
        moves=[AIMHMove(tune_steps=100)],
        tempering_kwargs=dict(ntemps=4),
        seed=6,
    )
    ens.run_mcmc(priors.rvs(size=(4, NWALKERS)), 400, burn=200)
    llv = ens.get_log_like()
    assert llv[:, 0].mean() > llv[:, -1].mean()
    chain = ens.get_chain()["model_0"][:, 0].reshape(-1, NDIM)
    assert np.abs(chain.std(axis=0) - 1.0).max() < 0.12


def test_aimh_guards(priors):
    with pytest.raises(ValueError, match="df"):
        AIMHMove(df=2.0)

    # RJ configurations are rejected AT CONSTRUCTION (an all-active start
    # would pass a mask check and silently bias once leaves deactivate)
    def ll(c, m):
        return jnp.sum(jnp.where(m, -0.5 * jnp.sum(c**2, axis=-1), 0.0))

    with pytest.raises(ValueError, match="fixed-dimension"):
        EnsembleSampler(
            NWALKERS, NDIM, ll, priors,
            nleaves_max=2, nleaves_min=1,
            moves=[AIMHMove()], rj_moves=True,
            fill_zero_leaves_val=-1e4, seed=7,
        )

    # periodic parameters are rejected like KDEMove (single-image t
    # factors on a wrapped draw bias the seam)
    def ll2(x):
        return -0.5 * jnp.sum(x**2)

    ens = EnsembleSampler(
        NWALKERS, NDIM, ll2, priors,
        moves=[AIMHMove()],
        periodic={"model_0": {0: 2 * np.pi}},
        seed=8,
    )
    with pytest.raises(ValueError, match="periodic"):
        ens.run_mcmc(priors.rvs(size=(1, NWALKERS)), 2)


def test_aimh_offset_narrow_posterior():
    """Centered moment accumulation: a posterior far from the origin with
    tiny width must not lose its variance to float32 cancellation (the
    raw-second-moment form produced a NaN Cholesky and a silently dead
    move here)."""
    center = 500.0
    width = 0.05
    pr = ProbDistContainer(
        {i: uniform_dist(center - 5.0, center + 5.0) for i in range(NDIM)}
    )

    def ll(x):
        return -0.5 * jnp.sum((x - center) ** 2) / width**2

    rng = np.random.default_rng(1)
    start = center + width * rng.standard_normal((NWALKERS, NDIM))
    ens = EnsembleSampler(
        NWALKERS, NDIM, ll, pr, moves=[AIMHMove(tune_steps=150)], seed=9
    )
    ens.run_mcmc(start, 400, burn=200)
    chain = ens.get_chain()["model_0"].reshape(-1, NDIM)
    acc = float(ens.acceptance_fraction.mean())
    assert acc > 0.3, acc  # a dead move would sit at ~0
    np.testing.assert_allclose(chain.mean(axis=0), center, rtol=1e-4)
    np.testing.assert_allclose(chain.std(axis=0), width, rtol=0.25)


def test_aimh_dime_trimodal():
    """Three well-separated modes: the fitted t covers all discovered
    modes and the DIME schedule equilibrates their (equal) weights."""
    import jax as _jax

    ndim, nw = 2, 48
    centers = jnp.asarray([[-4.0, -4.0], [0.0, 4.0], [4.0, -2.0]])

    def ll(x):
        logs = -0.5 * jnp.sum((x[None] - centers) ** 2, axis=-1) / 0.15
        return _jax.scipy.special.logsumexp(logs)

    pr = ProbDistContainer({i: uniform_dist(-8, 8) for i in range(ndim)})
    rng = np.random.default_rng(2)
    start = rng.uniform(-7, 7, size=(nw, ndim))

    ens = EnsembleSampler(
        nw, ndim, ll, pr,
        # ~0.15 * 500 burn = ~75 selections: 60 freezes inside burn-in
        moves=[(DEMove(), 0.85), (AIMHMove(tune_steps=60), 0.15)],
        seed=12,
    )
    ens.run_mcmc(start, 1500, burn=500)
    chain = np.asarray(ens.get_chain(discard=300)["model_0"]).reshape(-1, ndim)
    d = np.linalg.norm(chain[:, None, :] - np.asarray(centers)[None], axis=-1)
    assign = d.argmin(axis=1)
    fr = np.bincount(assign, minlength=3) / len(assign)
    assert fr.min() > 0.2 and fr.max() < 0.5, fr
    for m in range(3):
        sel = chain[assign == m]
        np.testing.assert_allclose(sel.std(axis=0), np.sqrt(0.15), rtol=0.25)


def test_aimh_rj_guard_branch_aware(priors):
    """The sampler-level guard is branch-aware: AIMH restricted to a
    fixed-dimension branch coexists with RJ on another branch; proposing
    on the RJ branch (directly or nested in CombineMove) is rejected."""
    from eryn_tpu.moves import CombineMove

    def ll(c, m):
        tot = 0.0
        for n in c:
            tot = tot + jnp.sum(
                jnp.where(m[n], -0.5 * jnp.sum(c[n] ** 2, axis=-1), 0.0)
            )
        return tot

    two_priors = {"fixed": priors, "var": priors}
    common = dict(
        branch_names=["fixed", "var"],
        nleaves_max={"fixed": 1, "var": 2},
        nleaves_min={"fixed": 1, "var": 0},
        rj_moves=True,
        fill_zero_leaves_val=-1e4,
        seed=13,
    )
    # allowed: AIMH proposes only on the fixed branch
    EnsembleSampler(
        NWALKERS, {"fixed": NDIM, "var": NDIM}, ll, two_priors,
        moves=[AIMHMove(proposal_branch_names=["fixed"])], **common,
    )
    # rejected: proposes (by default) on the RJ branch
    with pytest.raises(ValueError, match="var"):
        EnsembleSampler(
            NWALKERS, {"fixed": NDIM, "var": NDIM}, ll, two_priors,
            moves=[AIMHMove()], **common,
        )
    # rejected even nested inside CombineMove
    with pytest.raises(ValueError, match="fixed-dimension"):
        EnsembleSampler(
            NWALKERS, {"fixed": NDIM, "var": NDIM}, ll, two_priors,
            moves=[CombineMove([StretchMove(), AIMHMove()])], **common,
        )


def test_chisquare_decomposition():
    """The integer-df chi-square sampler (-2 sum log U + Z^2 for odd df;
    replaces jax.random.chisquare, whose gamma sampler is a rejection loop)
    must be distributionally exact for odd, even, and small df."""
    import jax
    import jax.numpy as jnp
    from scipy import stats

    from eryn_tpu.moves import AIMHMove

    for i, df in enumerate([3, 4, 10, 11]):
        mv = AIMHMove(df=df)
        u = np.asarray(
            mv._chisquare(jax.random.key(100 + i), (120000,), jnp.float32)
        )
        assert np.all(u > 0)
        ks = stats.kstest(u, "chi2", args=(df,))
        assert ks.pvalue > 1e-3, (df, ks)
    # non-integer df falls back to the library sampler
    mv = AIMHMove(df=4.5)
    u = np.asarray(mv._chisquare(jax.random.key(7), (20000,), jnp.float32))
    ks = stats.kstest(u, "chi2", args=(4.5,))
    assert ks.pvalue > 1e-3, ks
