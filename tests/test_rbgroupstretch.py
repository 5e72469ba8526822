"""RedBlueGroupStretchMove: the reference's roadmap item "combine group
with red-blue" (ref ``docs/source/general/todos.rst``) — a stretch move
whose complement is the other half's CURRENT active leaves (exact detailed
balance, RJ-correct complement selection).  Pinned against analytic truth:
posterior exactness in-model, a flat-likelihood RJ run whose active-leaf
marginals must reproduce the prior, and a mixed-activation Gaussian whose
per-leaf marginals must be exact."""

import numpy as np
import pytest

import jax.numpy as jnp

from eryn_tpu import EnsembleSampler, ProbDistContainer, State, uniform_dist
from eryn_tpu.moves import RedBlueGroupStretchMove, StretchMove

NDIM = 3
NWALKERS = 64

_rho = 0.7
_COV = np.eye(NDIM) + _rho * (np.ones((NDIM, NDIM)) - np.eye(NDIM))
_ICOV_J = jnp.asarray(np.linalg.inv(_COV))


def log_like(x):
    return -0.5 * x @ (_ICOV_J @ x)


@pytest.fixture
def priors():
    return ProbDistContainer({i: uniform_dist(-10, 10) for i in range(NDIM)})


def test_posterior_exactness(priors):
    """Non-RJ: every leaf active — must sample the correlated Gaussian
    exactly, like the plain stretch move."""
    ens = EnsembleSampler(
        NWALKERS, NDIM, log_like, priors,
        moves=RedBlueGroupStretchMove(), seed=5,
    )
    coords = 0.5 * np.random.default_rng(5).standard_normal((NWALKERS, NDIM))
    ens.run_mcmc(coords, 600, burn=400)
    chain = ens.get_chain()["model_0"][:, 0].reshape(-1, NDIM)
    assert np.abs(chain.mean(axis=0)).max() < 0.25
    assert np.abs(np.cov(chain.T) - _COV).max() < 0.5
    af = ens.moves[0].acceptance_fraction.mean()
    assert 0.05 < af < 0.95, af


def test_pt(priors):
    ens = EnsembleSampler(
        NWALKERS, NDIM, log_like, priors,
        moves=RedBlueGroupStretchMove(),
        tempering_kwargs=dict(ntemps=4), seed=6,
    )
    coords = 0.5 * np.random.default_rng(6).standard_normal(
        (4, NWALKERS, NDIM)
    )
    ens.run_mcmc(coords, 500, burn=300)
    ll = ens.get_log_like()
    assert ll[:, 0].mean() > ll[:, -1].mean()


def test_rj_flat_likelihood_preserves_prior():
    """Flat likelihood + RJ birth/death: leaf-count posterior must be
    uniform and ACTIVE-leaf coordinates must reproduce the (uniform)
    prior — a sharp detailed-balance check of the active-complement
    selection under heavily mixed activation patterns."""
    nlmax, ndim = 3, 2
    pr = ProbDistContainer({i: uniform_dist(-1.0, 1.0) for i in range(ndim)})

    def ll(coords, inds):
        return jnp.zeros(())

    ens = EnsembleSampler(
        NWALKERS, ndim, ll, pr,
        nleaves_max=nlmax, nleaves_min=0,
        moves=RedBlueGroupStretchMove(live_dangerously=True),
        rj_moves=True,
        # k=0 must be as "flat" as every other k for a uniform posterior
        fill_zero_leaves_val=0.0,
        seed=7,
    )
    rng = np.random.default_rng(7)
    coords = pr.rvs(size=(1, NWALKERS, nlmax))
    inds = rng.random((1, NWALKERS, nlmax)) < 0.5
    # keep at least one structure valid (all-inactive rows are allowed)
    state = State({"model_0": coords}, inds={"model_0": inds})
    ens.run_mcmc(state, 1500, burn=300)

    chain = ens.get_chain()["model_0"][:, 0]  # (nsteps, nw, nlmax, ndim)
    inds_c = ens.get_inds()["model_0"][:, 0]
    # k-posterior uniform over 0..nlmax
    k = inds_c.sum(axis=-1).ravel()
    freqs = np.bincount(k, minlength=nlmax + 1) / k.size
    assert np.abs(freqs - 1.0 / (nlmax + 1)).max() < 0.08, freqs
    # active coords ~ U(-1, 1): mean 0, var 1/3
    act = chain[inds_c]
    assert abs(act.mean()) < 0.03
    assert abs(act.var() - 1.0 / 3.0) < 0.02


def test_rj_gaussian_leaf_marginals():
    """Each active leaf contributes an independent N(0, 0.25) factor; the
    active-leaf marginal must match regardless of activation pattern."""
    nlmax, ndim = 2, 2
    pr = ProbDistContainer({i: uniform_dist(-5.0, 5.0) for i in range(ndim)})
    sig2 = 0.25
    # per-leaf offset making the per-leaf Bayes factor ~1 (otherwise the
    # k-posterior collapses to k=0 and active-leaf samples starve)
    off = ndim * np.log(10.0) - 0.5 * ndim * np.log(2 * np.pi * sig2)

    def ll(coords, inds):
        contrib = -0.5 * jnp.sum(coords**2, axis=-1) / sig2 + off
        return jnp.sum(jnp.where(inds, contrib, 0.0))

    ens = EnsembleSampler(
        NWALKERS, ndim, ll, pr,
        nleaves_max=nlmax, nleaves_min=0,
        moves=RedBlueGroupStretchMove(live_dangerously=True),
        rj_moves=True,
        fill_zero_leaves_val=0.0,
        seed=8,
    )
    rng = np.random.default_rng(8)
    coords = 0.3 * rng.standard_normal((1, NWALKERS, nlmax, ndim))
    inds = rng.random((1, NWALKERS, nlmax)) < 0.5
    state = State({"model_0": coords}, inds={"model_0": inds})
    ens.run_mcmc(state, 1500, burn=400)

    chain = ens.get_chain()["model_0"][:, 0]
    inds_c = ens.get_inds()["model_0"][:, 0]
    act = chain[inds_c].reshape(-1, ndim)
    assert np.abs(act.mean(axis=0)).max() < 0.05
    assert np.abs(act.var(axis=0) - sig2).max() < 0.05


def test_mixture_with_plain_stretch(priors):
    ens = EnsembleSampler(
        NWALKERS, NDIM, log_like, priors,
        moves=[(RedBlueGroupStretchMove(), 0.5), (StretchMove(), 0.5)],
        seed=9,
    )
    coords = 0.5 * np.random.default_rng(9).standard_normal((NWALKERS, NDIM))
    ens.run_mcmc(coords, 600, burn=400)
    chain = ens.get_chain()["model_0"][:, 0].reshape(-1, NDIM)
    assert np.abs(np.cov(chain.T) - _COV).max() < 0.5


def test_periodic_wrap():
    """Periodic parameters stay in range through the wrap path."""
    pr = ProbDistContainer({0: uniform_dist(0.0, 2 * np.pi), 1: uniform_dist(-5, 5)})

    def ll_per(x):
        return -0.5 * ((jnp.cos(x[0]) - 1.0) ** 2 / 0.1 + x[1] ** 2)

    ens = EnsembleSampler(
        32, 2, ll_per, pr,
        moves=RedBlueGroupStretchMove(),
        periodic={"model_0": {0: 2 * np.pi}},
        seed=10,
    )
    rng = np.random.default_rng(10)
    coords = np.column_stack(
        [rng.uniform(0, 2 * np.pi, 32), 0.3 * rng.standard_normal(32)]
    )
    ens.run_mcmc(coords, 300, burn=100)
    chain = ens.get_chain()["model_0"][:, 0, :, :, 0]
    assert (chain >= 0).all() and (chain <= 2 * np.pi).all()


def test_plain_stretch_under_rj_warns():
    """The reference warns that its stretch uses the wrong complementary
    parameters under RJ (ref ensemble.py:505-514); ours points at the fix.
    RedBlueGroupStretchMove itself must NOT trigger the warning."""
    import warnings

    pr = ProbDistContainer({0: uniform_dist(-1.0, 1.0)})

    def ll(coords, inds):
        return jnp.zeros(())

    with pytest.warns(UserWarning, match="RedBlueGroupStretchMove"):
        EnsembleSampler(
            8, 1, ll, pr, nleaves_max=2, nleaves_min=0, rj_moves=True,
            moves=StretchMove(live_dangerously=True),
            fill_zero_leaves_val=0.0,
        )
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        EnsembleSampler(
            8, 1, ll, pr, nleaves_max=2, nleaves_min=0, rj_moves=True,
            moves=RedBlueGroupStretchMove(live_dangerously=True),
            fill_zero_leaves_val=0.0,
        )


def test_gibbs_param_masks(priors):
    """Parameter-level Gibbs runs: masked factors stay consistent with the
    masked proposal, posterior stays exact."""
    m1 = np.zeros((1, NDIM), dtype=bool)
    m1[:, :2] = True
    m2 = np.zeros((1, NDIM), dtype=bool)
    m2[:, 2:] = True
    move = RedBlueGroupStretchMove(
        gibbs_sampling_setup=[("model_0", m1), ("model_0", m2)]
    )
    ens = EnsembleSampler(NWALKERS, NDIM, log_like, priors, moves=[move], seed=12)
    coords = 0.5 * np.random.default_rng(12).standard_normal((NWALKERS, NDIM))
    ens.run_mcmc(coords, 600, burn=400)
    chain = ens.get_chain()["model_0"][:, 0].reshape(-1, NDIM)
    assert np.abs(chain.mean(axis=0)).max() < 0.25
    assert np.abs(np.cov(chain.T) - _COV).max() < 0.5


def test_onehot_selection_matches_gather_fallback():
    """The one-hot complement selection and the memory-lean
    searchsorted+gather fallback must produce identical proposals for the
    same key (the selected complement entry is the same (k+1)-th active
    leaf either way), including under partially-empty complements and
    NaN-filled dormant slots (which the one-hot matmul must zero out, not
    propagate)."""
    import jax

    from eryn_tpu.moves import rbgroupstretch

    rng = np.random.default_rng(3)
    nt, ns, nc, nl, nd = 3, 5, 6, 4, 2
    s_coords = {"m": jnp.asarray(rng.normal(size=(nt, ns, nl, nd)), jnp.float32)}
    c = rng.normal(size=(nt, nc, nl, nd)).astype(np.float32)
    ci = rng.random((nt, nc, nl)) < 0.4
    ci[1] = False  # one temp with an EMPTY active complement
    c[~ci] = np.nan  # dormant slots hold NaN (worst-case user state)
    c_coords = {"m": jnp.asarray(c)}
    c_inds = {"m": jnp.asarray(ci)}
    s_inds = {"m": jnp.asarray(rng.random((nt, ns, nl)) < 0.7)}

    mv = RedBlueGroupStretchMove()
    key = jax.random.key(11)
    q1, f1 = mv.get_proposal_kernel(
        key, s_coords, c_coords, s_inds, None, c_inds=c_inds
    )
    old_limit = rbgroupstretch._ONEHOT_BYTES_LIMIT
    try:
        rbgroupstretch._ONEHOT_BYTES_LIMIT = 0  # force the gather fallback
        q2, f2 = mv.get_proposal_kernel(
            key, s_coords, c_coords, s_inds, None, c_inds=c_inds
        )
    finally:
        rbgroupstretch._ONEHOT_BYTES_LIMIT = old_limit

    np.testing.assert_array_equal(np.asarray(f1), np.asarray(f2))
    np.testing.assert_array_equal(np.asarray(q1["m"]), np.asarray(q2["m"]))
    # active proposals moved and are finite where the complement is nonempty
    moved = np.asarray(s_inds["m"])[0]
    assert np.isfinite(np.asarray(q1["m"])[0][moved]).all()


def test_segment_plan_taper():
    """Tapered plans preserve the step total, keep every size a power of
    two when the tapered segment is one, and shrink the tail segment (the
    only flush with no compute to hide behind) to <= 2*min_seg."""
    from eryn_tpu.ensemble import _segment_plan

    plan = _segment_plan(8192, 2048, taper=True)
    assert sum(plan) == 8192
    assert plan[-1] <= 128 and all(v & (v - 1) == 0 for v in plan)
    # non-pow2 segments don't taper (each new length is a fresh compile)
    assert _segment_plan(500, 500, taper=True) == [500]
    rng = np.random.default_rng(0)
    for _ in range(300):
        n = int(rng.integers(1, 10000))
        seg = int(rng.integers(1, 4096))
        for t in (False, True):
            p = _segment_plan(n, seg, taper=t)
            assert sum(p) == n and all(x > 0 for x in p)
