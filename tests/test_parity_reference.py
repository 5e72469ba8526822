"""Statistical parity against the reference implementation (mikekatz04/Eryn,
mounted read-only at /root/reference) on the BASELINE configs.

The reference uses NumPy's Mersenne RNG and eryn_tpu uses JAX threefry keys,
so chains match statistically, not bitwise: we compare acceptance fractions,
posterior moments, swap-acceptance profiles, and adapted ladders.
"""

import sys
import types

import numpy as np
import pytest

import jax.numpy as jnp

from eryn_tpu import EnsembleSampler, ProbDistContainer, uniform_dist


def _import_reference():
    from _refpath import REFERENCE_SRC

    sys.path.insert(0, REFERENCE_SRC)
    sys.modules.setdefault("corner", types.ModuleType("corner"))
    try:
        from eryn.ensemble import EnsembleSampler as RefSampler
        from eryn.prior import ProbDistContainer as RefContainer
        from eryn.prior import uniform_dist as ref_uniform
    except Exception:  # pragma: no cover
        pytest.skip("reference Eryn not importable")
    return RefSampler, RefContainer, ref_uniform


NDIM = 5
NWALKERS = 100
LIMS = 5.0
NSTEPS = 600
BURN = 200


def _run_reference(ntemps=1):
    RefSampler, RefContainer, ref_uniform = _import_reference()
    np.random.seed(42)
    invcov = np.eye(NDIM)

    def ll(x, icov):
        return -0.5 * (x * np.dot(icov, x.T).T).sum()

    priors = RefContainer({i: ref_uniform(-LIMS, LIMS) for i in range(NDIM)})
    kwargs = {}
    if ntemps > 1:
        kwargs["tempering_kwargs"] = dict(ntemps=ntemps)
    ens = RefSampler(NWALKERS, NDIM, ll, priors, args=[invcov], **kwargs)
    size = (ntemps, NWALKERS) if ntemps > 1 else (NWALKERS,)
    coords = priors.rvs(size=size)
    ens.run_mcmc(coords, NSTEPS, burn=BURN, progress=False)
    return ens


def _run_ours(ntemps=1):
    invcov = jnp.eye(NDIM)

    def ll(x):
        return -0.5 * jnp.sum(x * (invcov @ x))

    priors = ProbDistContainer({i: uniform_dist(-LIMS, LIMS) for i in range(NDIM)})
    kwargs = {}
    if ntemps > 1:
        kwargs["tempering_kwargs"] = dict(ntemps=ntemps)
    ens = EnsembleSampler(NWALKERS, NDIM, ll, priors, seed=1234, **kwargs)
    size = (ntemps, NWALKERS) if ntemps > 1 else (NWALKERS,)
    coords = priors.rvs(size=size)
    ens.run_mcmc(coords, NSTEPS, burn=BURN)
    return ens


def test_config_a_parity():
    """Config A (BASELINE configs[0]): 5-D Gaussian, 1 temp, stretch."""
    ref = _run_reference(ntemps=1)
    ours = _run_ours(ntemps=1)

    acc_ref = float(np.mean(ref.acceptance_fraction))
    acc_ours = float(np.mean(ours.acceptance_fraction))
    # same proposal, same target: acceptance fractions agree closely
    assert abs(acc_ref - acc_ours) < 0.05, (acc_ref, acc_ours)

    chain_ref = ref.get_chain()["model_0"].reshape(-1, NDIM)
    chain_ours = ours.get_chain()["model_0"].reshape(-1, NDIM)
    assert np.abs(chain_ref.mean(0) - chain_ours.mean(0)).max() < 0.15
    assert np.abs(chain_ref.std(0) - chain_ours.std(0)).max() < 0.1


def test_config_b_parity():
    """Config B (BASELINE configs[1]): PT with ntemps=10 adaptive ladder."""
    ntemps = 10
    ref = _run_reference(ntemps=ntemps)
    ours = _run_ours(ntemps=ntemps)

    # in-model acceptance per temperature rung tracks the reference
    acc_ref = np.mean(np.asarray(ref.acceptance_fraction), axis=-1)
    acc_ours = np.mean(np.asarray(ours.acceptance_fraction), axis=-1)
    assert np.abs(acc_ref - acc_ours).max() < 0.08, (acc_ref, acc_ours)

    # cold-chain posterior matches
    chain_ref = ref.get_chain()["model_0"][:, 0].reshape(-1, NDIM)
    chain_ours = ours.get_chain()["model_0"][:, 0].reshape(-1, NDIM)
    assert np.abs(chain_ref.mean(0) - chain_ours.mean(0)).max() < 0.15
    assert np.abs(chain_ref.std(0) - chain_ours.std(0)).max() < 0.1

    # adapted ladders agree (log-scale, ignoring the fixed endpoints)
    betas_ref = np.asarray(ref.get_betas()[-1])
    betas_ours = np.asarray(ours.get_betas()[-1])
    log_ratio = np.log(betas_ref[1:-1]) - np.log(betas_ours[1:-1])
    assert np.abs(log_ratio).max() < 0.75, (betas_ref, betas_ours)

    # swap acceptance profiles comparable on the cold rungs
    swap_ref = np.asarray(ref.backend.swaps_accepted) / (
        ref.backend.iteration * NWALKERS
    )
    swap_ours = np.asarray(ours.swap_acceptance_fraction)
    assert np.abs(swap_ref[:4] - swap_ours[:4]).max() < 0.12, (
        swap_ref,
        swap_ours,
    )


def test_config_c_rj_parity():
    """Config C (BASELINE configs[2]): RJ pulse-count posterior matches the
    reference's on identical data."""
    RefSampler, RefContainer, ref_uniform = _import_reference()
    import jax.numpy as jnp_

    from eryn_tpu import State

    rng = np.random.default_rng(7)
    t_np = np.linspace(0, 10, 96)
    sigma = 0.35
    data_np = 2.8 * np.exp(-((t_np - 5.0) ** 2) / (2 * 0.7**2))
    data_np = data_np + sigma * rng.standard_normal(len(t_np))
    noise_ll = float(-0.5 * np.sum((data_np / sigma) ** 2))
    nlmax, nwalkers, ntemps, nsteps, burn = 2, 40, 6, 500, 400

    bounds = {0: (0.5, 5.0), 1: (0.0, 10.0), 2: (0.2, 2.0)}

    # ---- reference ----------------------------------------------------
    np.random.seed(42)

    def ref_ll(params, t, data, sig):
        template = np.zeros_like(t)
        for p in params:
            template = template + p[0] * np.exp(
                -((t - p[1]) ** 2) / (2 * p[2] ** 2)
            )
        return -0.5 * np.sum(((template - data) / sig) ** 2)

    ref_priors = RefContainer({k: ref_uniform(*v) for k, v in bounds.items()})
    from eryn.moves import StretchMove as RefStretchMove

    ref = RefSampler(
        nwalkers,
        3,
        ref_ll,
        ref_priors,
        args=(t_np, data_np, sigma),
        nleaves_max=nlmax,
        nleaves_min=0,
        moves=RefStretchMove(),
        rj_moves=True,
        tempering_kwargs=dict(ntemps=ntemps),
        fill_zero_leaves_val=noise_ll,
    )
    coords = ref_priors.rvs(size=(ntemps, nwalkers, nlmax))
    inds0 = np.random.rand(ntemps, nwalkers, nlmax) < 0.5
    from eryn.state import State as RefState

    ref.run_mcmc(
        RefState({"model_0": coords}, inds={"model_0": inds0}),
        nsteps,
        burn=burn,
        progress=False,
    )
    ref_nleaves = ref.get_inds()["model_0"][:, 0].sum(axis=-1)

    # ---- ours -----------------------------------------------------------
    t_j, data_j = jnp_.asarray(t_np), jnp_.asarray(data_np)

    def our_ll(c, m):
        a, b, w = c[:, 0], c[:, 1], c[:, 2]
        p = a[:, None] * jnp_.exp(
            -((t_j[None] - b[:, None]) ** 2) / (2 * w[:, None] ** 2)
        )
        tmpl = jnp_.sum(jnp_.where(m[:, None], p, 0.0), axis=0)
        return -0.5 * jnp_.sum(((tmpl - data_j) / sigma) ** 2)

    priors = ProbDistContainer({k: uniform_dist(*v) for k, v in bounds.items()})
    ours = EnsembleSampler(
        nwalkers,
        3,
        our_ll,
        priors,
        nleaves_max=nlmax,
        nleaves_min=0,
        rj_moves=True,
        tempering_kwargs=dict(ntemps=ntemps),
        fill_zero_leaves_val=noise_ll,
        seed=77,
    )
    ours.run_mcmc(
        State({"model_0": coords}, inds={"model_0": inds0}),
        nsteps,
        burn=burn,
    )
    our_nleaves = ours.get_nleaves()["model_0"][:, 0]

    # the pulse-count posteriors broadly agree; RJ chains mix slowly so the
    # k-mean tolerance is loose — the *absolute* correctness of our
    # trans-dimensional posterior is pinned by the quadrature ground-truth
    # test below (test_rj_matches_quadrature_truth), which the reference
    # cannot run (it crashes on single-temperature RJ configurations)
    ref_mean = ref_nleaves.mean()
    our_mean = our_nleaves.mean()
    assert abs(ref_mean - our_mean) < 0.45, (ref_mean, our_mean)
    ref_p1 = (ref_nleaves >= 1).mean()
    our_p1 = (our_nleaves >= 1).mean()
    assert abs(ref_p1 - our_p1) < 0.1, (ref_p1, our_p1)

    # recovered pulse centers agree
    ref_chain = ref.get_chain()["model_0"][:, 0]
    ref_inds = ref.get_inds()["model_0"][:, 0]
    our_chain = ours.get_chain()["model_0"][:, 0]
    our_inds = ours.get_inds()["model_0"][:, 0]
    ref_centers = ref_chain[..., 1][ref_inds]
    our_centers = our_chain[..., 1][our_inds]
    assert abs(np.median(ref_centers) - np.median(our_centers)) < 0.3


def test_rj_matches_quadrature_truth():
    """Absolute RJ correctness: on a contested 0-vs-1-pulse problem the
    trans-dimensional posterior P(k=1) matches a brute-force quadrature
    Bayes factor."""
    import jax.numpy as jnp_
    from scipy.special import logsumexp

    from eryn_tpu import State

    rng = np.random.default_rng(3)
    t_np = np.linspace(0, 10, 64)
    sigma = 0.5
    data_np = 0.32 * np.exp(-((t_np - 5.0) ** 2) / (2 * 0.7**2))
    data_np = data_np + sigma * rng.standard_normal(len(t_np))
    noise_ll = float(-0.5 * np.sum((data_np / sigma) ** 2))
    bounds = [(0.2, 3.0), (0.0, 10.0), (0.3, 1.5)]

    # ground truth by quadrature
    A = np.linspace(*bounds[0], 60)
    B = np.linspace(*bounds[1], 120)
    C = np.linspace(*bounds[2], 60)
    AA, BB, CC = np.meshgrid(A, B, C, indexing="ij")
    tmpl = AA[..., None] * np.exp(
        -((t_np[None, None, None, :] - BB[..., None]) ** 2)
        / (2 * CC[..., None] ** 2)
    )
    ll_rel = (
        -0.5 * np.sum(((tmpl - data_np[None, None, None, :]) / sigma) ** 2, axis=-1)
        - noise_ll
    )
    bf = np.exp(logsumexp(ll_rel) - np.log(ll_rel.size))
    p1_true = bf / (1 + bf)

    priors = ProbDistContainer(
        {i: uniform_dist(*bounds[i]) for i in range(3)}
    )
    t_j, d_j = jnp_.asarray(t_np), jnp_.asarray(data_np)

    def our_ll(c, m):
        a, b, w = c[:, 0], c[:, 1], c[:, 2]
        p = a[:, None] * jnp_.exp(
            -((t_j[None] - b[:, None]) ** 2) / (2 * w[:, None] ** 2)
        )
        tm = jnp_.sum(jnp_.where(m[:, None], p, 0.0), axis=0)
        return -0.5 * jnp_.sum(((tm - d_j) / sigma) ** 2)

    ens = EnsembleSampler(
        64,
        3,
        our_ll,
        priors,
        nleaves_max=1,
        nleaves_min=0,
        rj_moves=True,
        fill_zero_leaves_val=noise_ll,
        seed=123,
    )
    coords = priors.rvs(size=(1, 64, 1))
    inds0 = np.random.rand(1, 64, 1) < 0.5
    ens.run_mcmc(
        State({"model_0": coords}, inds={"model_0": inds0}), 5000, burn=1000
    )
    p1 = ens.get_nleaves()["model_0"][:, 0].mean()
    assert abs(p1 - p1_true) < 0.04, (p1, p1_true)


def test_make_ladder_parity():
    """Temperature ladders match the reference's exactly."""
    _import_reference()  # skips where the reference is not importable
    from eryn.moves.tempering import make_ladder as ref_make_ladder

    from eryn_tpu.moves import make_ladder

    for ndim, ntemps, tmax in [
        (5, 10, None),
        (3, 4, None),
        (150, 8, None),
        (5, 10, np.inf),
        (2, None, 100.0),
    ]:
        ours = make_ladder(ndim, ntemps=ntemps, Tmax=tmax)
        ref = ref_make_ladder(ndim, ntemps=ntemps, Tmax=tmax)
        np.testing.assert_allclose(ours, ref, rtol=1e-10)


def test_integrated_act_matches_reference():
    """Per-parameter IACT matches the reference estimator exactly on an
    identical chain array (ref utils/utility.py:79-144) in its supported
    domain (single temperature, nleaves_max=1)."""
    _import_reference()
    from eryn.utils.utility import get_integrated_act as ref_act

    from eryn_tpu.utils.utility import get_integrated_act as our_act

    rng = np.random.default_rng(11)
    nsteps, nwalkers, ndim = 2000, 16, 4
    # AR(1) chains with per-parameter correlation
    rho = np.array([0.2, 0.5, 0.7, 0.9])
    x = np.zeros((nsteps, 1, nwalkers, 1, ndim))
    e = rng.standard_normal((nsteps, 1, nwalkers, 1, ndim))
    for t in range(1, nsteps):
        x[t] = rho * x[t - 1] + e[t]

    ours = our_act({"model_0": x})["model_0"]
    ref = ref_act({"model_0": x})["model_0"]
    assert ours.shape == (1, 1, ndim)
    np.testing.assert_allclose(
        ours.reshape(ref.shape), ref, rtol=1e-10, atol=1e-12
    )
    # and the per-walker (average=False) variant
    ours_w = our_act({"model_0": x}, average=False)["model_0"]
    ref_w = ref_act({"model_0": x}, average=False)["model_0"]
    np.testing.assert_allclose(
        ours_w.reshape(ref_w.shape), ref_w, rtol=1e-10, atol=1e-12
    )


def test_gaussian_move_parity():
    """GaussianMove parity in all three update modes (ref gaussian.py:134-181):
    acceptance fractions and posterior moments match the reference."""
    RefSampler, RefContainer, ref_uniform = _import_reference()
    from eryn.moves import GaussianMove as RefGaussianMove

    from eryn_tpu.moves import GaussianMove

    # random/sequential modes update one dim per step -> tau is ~ndim times
    # larger than vector mode; the run must be long enough that the MC error
    # on the posterior mean (sigma/sqrt(ESS) per sampler) is well under tol
    nwalkers, nsteps, burn = 32, 1600, 400
    # scalar (isotropic) covariance: the reference's 1-D diag path crashes
    # on np.linalg.cholesky of a 1-D array (ref gaussian.py:137-144), so the
    # shared working surface is scalar + full-matrix covariances
    cov_scalar = 0.25
    invcov_np = np.eye(NDIM)
    invcov_j = jnp.eye(NDIM)

    def ref_ll(x, icov):
        return -0.5 * (x * np.dot(icov, x.T).T).sum()

    def our_ll(x):
        return -0.5 * jnp.sum(x * (invcov_j @ x))

    for mode in ("vector", "random", "sequential"):
        np.random.seed(42)
        ref_priors = RefContainer(
            {i: ref_uniform(-LIMS, LIMS) for i in range(NDIM)}
        )
        ref = RefSampler(
            nwalkers,
            NDIM,
            ref_ll,
            ref_priors,
            args=[invcov_np],
            moves=RefGaussianMove({"model_0": cov_scalar}, mode=mode),
        )
        coords = ref_priors.rvs(size=(nwalkers,))
        ref.run_mcmc(coords, nsteps, burn=burn, progress=False)

        priors = ProbDistContainer(
            {i: uniform_dist(-LIMS, LIMS) for i in range(NDIM)}
        )
        ours = EnsembleSampler(
            nwalkers,
            NDIM,
            our_ll,
            priors,
            moves=[GaussianMove({"model_0": cov_scalar}, mode=mode)],
            seed=321,
        )
        ours.run_mcmc(coords, nsteps, burn=burn)

        acc_ref = float(np.mean(ref.acceptance_fraction))
        acc_ours = float(np.mean(ours.acceptance_fraction))
        assert abs(acc_ref - acc_ours) < 0.05, (mode, acc_ref, acc_ours)

        c_ref = ref.get_chain()["model_0"].reshape(-1, NDIM)
        c_ours = ours.get_chain()["model_0"].reshape(-1, NDIM)
        assert np.abs(c_ref.mean(0) - c_ours.mean(0)).max() < 0.2, (
            mode,
            c_ref.mean(0),
            c_ours.mean(0),
        )
        assert np.abs(c_ref.std(0) - c_ours.std(0)).max() < 0.15, mode


def test_mtdistgen_parity():
    """MTDistGenMove parity (ref tests/test_eryn.py:1047-1101): multiple-try
    prior draws under PT match the reference's posterior."""
    RefSampler, RefContainer, ref_uniform = _import_reference()
    from eryn.moves import MTDistGenMove as RefMT

    from eryn_tpu.moves import MTDistGenMove

    nwalkers, ntemps, nsteps, burn, num_try = 20, 10, 400, 100, 25
    invcov_np = np.eye(NDIM)
    invcov_j = jnp.eye(NDIM)

    def ref_ll(x, mu, icov):
        diff = x - mu
        return -0.5 * (diff * np.dot(icov, diff.T).T).sum()

    def our_ll(x):
        return -0.5 * jnp.sum(x * (invcov_j @ x))

    np.random.seed(42)
    means = np.zeros(NDIM)
    ref_priors = RefContainer({i: ref_uniform(-LIMS, LIMS) for i in range(NDIM)})
    ref = RefSampler(
        nwalkers,
        NDIM,
        ref_ll,
        ref_priors,
        args=[means, invcov_np],
        moves=RefMT(ref_priors, num_try=num_try, independent=True),
        tempering_kwargs={"ntemps": ntemps},
    )
    coords = ref_priors.rvs(size=(ntemps, nwalkers, 1))
    ref.run_mcmc(coords, nsteps, burn=burn, progress=False)

    priors = ProbDistContainer({i: uniform_dist(-LIMS, LIMS) for i in range(NDIM)})
    ours = EnsembleSampler(
        nwalkers,
        NDIM,
        our_ll,
        priors,
        moves=[MTDistGenMove(priors, num_try=num_try, independent=True)],
        tempering_kwargs={"ntemps": ntemps},
        seed=654,
    )
    ours.run_mcmc(coords[:, :, 0], nsteps, burn=burn)

    # cold-chain acceptance (hot rungs accept broad prior draws trivially)
    acc_ref = np.mean(np.asarray(ref.acceptance_fraction), axis=-1)
    acc_ours = np.mean(np.asarray(ours.acceptance_fraction), axis=-1)
    assert np.abs(acc_ref - acc_ours).max() < 0.1, (acc_ref, acc_ours)

    c_ref = ref.get_chain()["model_0"][:, 0].reshape(-1, NDIM)
    c_ours = ours.get_chain()["model_0"][:, 0].reshape(-1, NDIM)
    assert np.abs(c_ref.mean(0) - c_ours.mean(0)).max() < 0.2
    assert np.abs(c_ref.std(0) - c_ours.std(0)).max() < 0.15


def test_config_d_group_stretch_parity():
    """Config D (BASELINE configs[3]): multi-pulse RJ with a group-stretch
    in-model move (ref tests/test_eryn.py:809-1045 at reduced scale).  The
    reference requires a user-implemented friends subclass; ours ships a
    default friends table — the comparison is statistical: leaf-count
    posterior, recovered pulse centers, acceptance."""
    RefSampler, RefContainer, ref_uniform = _import_reference()
    from eryn.moves import GroupStretchMove as RefGroupStretchMove
    from eryn.state import BranchSupplemental as RefBranchSupplemental
    from eryn.state import State as RefState

    from eryn_tpu import State
    from eryn_tpu.moves import GroupStretchMove

    nwalkers, ntemps, ndim = 20, 4, 3
    nleaves_max, nleaves_min = 4, 0
    num = 128
    t_np = np.linspace(-1, 1, num)
    gauss_inj_params = np.asarray(
        [[3.3, -0.5, 0.1], [2.9, 0.0, 0.1], [3.1, 0.5, 0.1]]
    )
    sigma = 1.0
    rng = np.random.default_rng(42)
    injection = np.zeros(num)
    for a, b, c in gauss_inj_params:
        injection += a * np.exp(-((t_np - b) ** 2) / (2 * c**2))
    y = injection + sigma * rng.standard_normal(num)

    bounds = {0: (2.5, 3.5), 1: (-1.0, 1.0), 2: (0.05, 0.21)}

    class MeanGaussianGroupMove(RefGroupStretchMove):
        """Reference-style friends: nearest stored cold-chain pulses by mean
        (ref tests/test_eryn.py:813-907)."""

        def setup_friends(self, branches):
            friends = branches["gauss"].coords[0, branches["gauss"].inds[0]]
            means = friends[:, 1].copy()
            self.means, uni = np.unique(means, return_index=True)
            self.friends = friends[uni]
            srt = np.argsort(self.means)
            self.friends[:] = self.friends[srt]
            self.means[:] = self.means[srt]
            current = branches["gauss"].coords[branches["gauss"].inds, 1]
            dist = np.abs(current[:, None] - self.means[None, :])
            closest = np.argsort(dist, axis=1)[:, : self.nfriends]
            branches["gauss"].branch_supplemental[branches["gauss"].inds] = {
                "inds_closest": closest
            }
            branches["gauss"].branch_supplemental[~branches["gauss"].inds] = {
                "inds_closest": -np.ones(
                    (ntemps, nwalkers, nleaves_max, self.nfriends), dtype=int
                )[~branches["gauss"].inds]
            }

        def fix_friends(self, branches):
            fix = branches["gauss"].inds & (
                np.all(
                    branches["gauss"].branch_supplemental[:]["inds_closest"]
                    == -1,
                    axis=-1,
                )
            )
            if not np.any(fix):
                return
            current = branches["gauss"].coords[fix, 1]
            dist = np.abs(current[:, None] - self.means[None, :])
            closest = np.argsort(dist, axis=1)[:, : self.nfriends]
            branches["gauss"].branch_supplemental[fix] = {
                "inds_closest": closest
            }

        def find_friends(self, name, s, s_inds=None, branch_supps=None):
            friends = np.zeros_like(s)
            closest = branch_supps[name][s_inds]["inds_closest"]
            pick = closest[
                np.arange(closest.shape[0]),
                np.random.randint(self.nfriends, size=(closest.shape[0],)),
            ]
            friends[s_inds] = self.friends[pick]
            return friends

    # starting state: walkers at the injections (post-search phase)
    coords0 = np.zeros((ntemps, nwalkers, nleaves_max, ndim))
    for nn, pars in enumerate(gauss_inj_params):
        coords0[:, :, nn] = np.random.default_rng(nn).multivariate_normal(
            pars, np.diag(np.ones(3) * 1e-4), size=(ntemps, nwalkers)
        )
    inds0 = np.zeros((ntemps, nwalkers, nleaves_max), dtype=bool)
    inds0[:, :, : len(gauss_inj_params)] = True
    nsteps, burn = 400, 50

    # ---- reference ------------------------------------------------------
    np.random.seed(42)

    def ref_ll(params, t, data, sig):
        template = np.zeros_like(t)
        for p in params:
            template = template + p[0] * np.exp(
                -((t - p[1]) ** 2) / (2 * p[2] ** 2)
            )
        return -0.5 * np.sum(((template - data) / sig) ** 2)

    ref_priors = {
        "gauss": {k: ref_uniform(*v) for k, v in bounds.items()}
    }
    ref = RefSampler(
        nwalkers,
        ndim,
        ref_ll,
        ref_priors,
        args=[t_np, y, sigma],
        tempering_kwargs=dict(ntemps=ntemps),
        branch_names=["gauss"],
        nleaves_max=nleaves_max,
        nleaves_min=nleaves_min,
        moves=MeanGaussianGroupMove(nfriends=nwalkers),
        rj_moves=True,
    )
    lp = ref.compute_log_prior(
        {"gauss": coords0}, inds={"gauss": inds0}
    )
    ll0 = ref.compute_log_like(
        {"gauss": coords0}, inds={"gauss": inds0}, logp=lp
    )[0]
    branch_supps = {
        "gauss": RefBranchSupplemental(
            {"inds_closest": np.zeros(inds0.shape + (nwalkers,), dtype=int)},
            base_shape=(ntemps, nwalkers, nleaves_max),
        )
    }
    ref.run_mcmc(
        RefState(
            {"gauss": coords0},
            log_like=ll0,
            log_prior=lp,
            inds={"gauss": inds0},
            branch_supplemental=branch_supps,
        ),
        nsteps,
        burn=burn,
        progress=False,
    )

    # ---- ours -------------------------------------------------------------
    t_j, y_j = jnp.asarray(t_np), jnp.asarray(y)

    def our_ll(c, m):
        a, b, w = c[:, 0], c[:, 1], c[:, 2]
        p = a[:, None] * jnp.exp(
            -((t_j[None] - b[:, None]) ** 2) / (2 * w[:, None] ** 2)
        )
        tmpl = jnp.sum(jnp.where(m[:, None], p, 0.0), axis=0)
        return -0.5 * jnp.sum(((tmpl - y_j) / sigma) ** 2)

    priors = ProbDistContainer({k: uniform_dist(*v) for k, v in bounds.items()})
    ours = EnsembleSampler(
        nwalkers,
        ndim,
        our_ll,
        priors,
        branch_names=["gauss"],
        nleaves_max=nleaves_max,
        nleaves_min=nleaves_min,
        moves=[GroupStretchMove(n_iter_update=25)],
        rj_moves=True,
        tempering_kwargs=dict(ntemps=ntemps),
        seed=17,
    )
    ours.run_mcmc(
        State({"gauss": coords0}, inds={"gauss": inds0}), nsteps, burn=burn
    )

    # the three injected pulses stay found in both
    ref_k = ref.get_nleaves()["gauss"][:, 0]
    our_k = ours.get_nleaves()["gauss"][:, 0]
    assert abs(ref_k.mean() - our_k.mean()) < 0.5, (ref_k.mean(), our_k.mean())
    assert ref_k.mean() >= 2.5 and our_k.mean() >= 2.5

    # recovered pulse centers cluster at the same injections
    ref_b = ref.get_chain()["gauss"][:, 0][..., 1][
        ref.get_inds()["gauss"][:, 0]
    ]
    our_b = ours.get_chain()["gauss"][:, 0][..., 1][
        ours.get_inds()["gauss"][:, 0]
    ]
    for b_true in gauss_inj_params[:, 1]:
        frac_ref = float(np.mean(np.abs(ref_b - b_true) < 0.15))
        frac_our = float(np.mean(np.abs(our_b - b_true) < 0.15))
        assert frac_our > 0.1, (b_true, frac_our)
        assert abs(frac_ref - frac_our) < 0.25, (b_true, frac_ref, frac_our)


def test_config_a_marginals_ks():
    """Distribution-level parity: two-sample Kolmogorov-Smirnov comparison of
    every cold-chain marginal between ours and the reference on config A.
    Walkers are thinned to roughly independent samples so the KS statistic
    has its nominal scale."""
    from scipy.stats import ks_2samp

    ref = _run_reference(ntemps=1)
    ours = _run_ours(ntemps=1)

    # thin aggressively: stretch tau ~ 30 on this config
    thin = 30
    c_ref = ref.get_chain(thin=thin)["model_0"].reshape(-1, NDIM)
    c_ours = np.asarray(ours.get_chain(thin=thin)["model_0"]).reshape(-1, NDIM)
    for d in range(NDIM):
        stat, p = ks_2samp(c_ref[:, d], c_ours[:, d])
        # with ~1300 samples/side, a true distribution difference of a few
        # percent would drive p to ~0; demand no strong evidence of mismatch
        assert p > 1e-3, (d, stat, p)


def test_estimator_parity_on_identical_inputs():
    """Estimator-level numerical parity: feed the SAME arrays to the
    reference's diagnostics and ours — ACF, thermodynamic-integration
    evidence, and the pooled-split Gelman-Rubin must agree to float
    precision (the stepping-stone bootstrap differs only through RNG, so
    its point estimate is compared via a zero-error path)."""
    _import_reference()
    from eryn.utils.utility import get_acf as ref_acf
    from eryn.utils.utility import psrf as ref_psrf
    from eryn.utils.utility import (
        thermodynamic_integration_log_evidence as ref_ti,
    )

    from eryn_tpu.utils.utility import (
        get_acf,
        psrf,
        thermodynamic_integration_log_evidence,
    )

    rng = np.random.default_rng(42)

    # ACF of an AR(1) series
    x = np.zeros(4096)
    for i in range(1, len(x)):
        x[i] = 0.9 * x[i - 1] + rng.standard_normal()
    ours = np.asarray(get_acf(x))
    ref = np.asarray(ref_acf(x))
    np.testing.assert_allclose(ours.reshape(ref.shape), ref, rtol=1e-8)

    # thermodynamic-integration evidence on identical ladder + mean logls
    betas = np.logspace(0, -3, 12)
    logls = -50.0 + 40.0 * betas + rng.standard_normal(12) * 0.1
    z_ours, dz_ours = thermodynamic_integration_log_evidence(betas, logls)
    z_ref, dz_ref = ref_ti(betas, logls)
    np.testing.assert_allclose(z_ours, z_ref, rtol=1e-10)
    np.testing.assert_allclose(dz_ours, dz_ref, rtol=1e-10)

    # Gelman-Rubin: our per_walker=False reproduces the reference's default
    # pooled first/last-third split on the same flattened chains
    chains = rng.standard_normal((900, 8, 3)) + np.linspace(
        0, 1, 900
    )[:, None, None]
    ours_r = psrf(chains, 3, per_walker=False)
    ref_r = ref_psrf(chains.reshape(-1, 3), 3, per_walker=False)
    np.testing.assert_allclose(ours_r, np.asarray(ref_r), rtol=1e-8)
