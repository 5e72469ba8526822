"""Reference host-API surface: ``TemperatureControl.temper_comps`` /
``temperature_swaps`` (`/root/reference/src/eryn/moves/tempering.py:484-649`),
``get_mt_computations`` (ref ``multipletry.py:36-59``), and the fail-fast
for callback-unsupported backends."""

import numpy as np
import pytest

import jax.numpy as jnp

from eryn_tpu import EnsembleSampler, ProbDistContainer, State, uniform_dist
from eryn_tpu.moves import TemperatureControl
from eryn_tpu.moves.multipletry import get_mt_computations

NDIM, NWALKERS, NTEMPS = 3, 64, 5


def _tc():
    return TemperatureControl(
        effective_ndim=NDIM, nwalkers=NWALKERS, ntemps=NTEMPS
    )


def _state():
    coords = {"model_0": np.random.randn(NTEMPS, NWALKERS, 1, NDIM)}
    logl = -0.5 * (coords["model_0"] ** 2).sum(axis=(-1, -2))
    logp = np.zeros_like(logl)
    return State(coords, log_like=logl, log_prior=logp)


def test_temper_comps_swaps_and_adapts():
    tc = _tc()
    state = _state()
    state.betas = np.asarray(tc.betas)
    betas0 = tc.betas.copy()
    out = tc.temper_comps(state)
    # state type + shapes preserved
    assert out.log_like.shape == (NTEMPS, NWALKERS)
    # swaps move log-likelihood values between rungs but preserve the
    # multiset of (value, walker-coord) pairs globally
    all_old = np.sort(np.asarray(state.log_like).ravel())
    all_new = np.sort(np.asarray(out.log_like).ravel())
    np.testing.assert_allclose(all_old, all_new, rtol=1e-6)
    # coords follow their log-likelihoods
    ll_from_coords = -0.5 * (
        np.asarray(out.branches_coords["model_0"]) ** 2
    ).sum(axis=(-1, -2))
    np.testing.assert_allclose(
        ll_from_coords, np.asarray(out.log_like), rtol=1e-5
    )
    # adaptation advanced the clock and moved interior betas
    assert tc.time == 1
    assert not np.allclose(tc.betas[1:-1], betas0[1:-1])
    assert np.asarray(tc.swaps_accepted).shape == (NTEMPS - 1,)
    # adapt=False leaves the clock alone
    t_before = tc.time
    tc.temper_comps(out, adapt=False)
    assert tc.time == t_before


def test_temperature_swaps_reference_signature():
    tc = _tc()
    state = _state()
    x = {n: np.asarray(v) for n, v in state.branches_coords.items()}
    inds = {n: np.asarray(v) for n, v in state.branches_inds.items()}
    logl = np.asarray(state.log_like)
    logp = np.asarray(state.log_prior)
    logP = np.asarray(tc.compute_log_posterior_tempered(logl, logp))
    out = tc.temperature_swaps(x, logP.copy(), logl.copy(), logp.copy(), inds=inds)
    x2, logP2, logl2, logp2, inds2, blobs2, supps2, bs2 = out
    assert blobs2 is None and supps2 is None and bs2 is None
    np.testing.assert_allclose(
        np.sort(logl.ravel()), np.sort(logl2.ravel()), rtol=1e-6
    )
    # returned logP is re-tempered from the swapped parts
    np.testing.assert_allclose(
        logP2,
        np.asarray(tc.compute_log_posterior_tempered(logl2, logp2)),
        rtol=1e-6,
    )
    # coords followed their walkers
    ll_from_coords = -0.5 * (x2["model_0"] ** 2).sum(axis=(-1, -2))
    np.testing.assert_allclose(ll_from_coords, logl2, rtol=1e-5)
    assert np.asarray(tc.swaps_accepted).shape == (NTEMPS - 1,)


def test_get_mt_computations_matches_reference_semantics():
    np.random.seed(3)
    nbatch, ntry = 200, 8
    logP = np.random.randn(nbatch, ntry)
    logq = np.random.randn(nbatch, ntry)
    liw, lsw, keep = get_mt_computations(logP, logq, symmetric=False)
    np.testing.assert_allclose(liw, logP - logq, rtol=1e-12)
    from scipy.special import logsumexp as sp_lse

    np.testing.assert_allclose(lsw, sp_lse(liw, axis=-1), rtol=1e-10)
    assert keep.shape == (nbatch,)
    assert np.all((keep >= 0) & (keep < ntry))
    # symmetric mode ignores the proposal density
    liw_s, _, _ = get_mt_computations(logP, logq, symmetric=True)
    np.testing.assert_allclose(liw_s, logP, rtol=1e-12)
    # selection frequencies track the importance weights (chi^2-ish check
    # on the most-weighted try over many rows)
    best = liw.argmax(axis=-1)
    frac_best = (keep == best).mean()
    expected = np.exp(liw - lsw[:, None])[np.arange(nbatch), best].mean()
    assert abs(frac_best - expected) < 0.12


def test_temperature_control_evidence_methods():
    """Roadmap item (ref docs/source/general/todos.rst): evidence
    estimation on the tempering module, delegating to the utils
    estimators over the control's own ladder."""
    import numpy as np

    from eryn_tpu.moves.tempering import TemperatureControl
    from eryn_tpu.utils.utility import (
        stepping_stone_log_evidence,
        thermodynamic_integration_log_evidence,
    )

    tc = TemperatureControl(5, 32, ntemps=8)
    rng = np.random.default_rng(0)
    logls = rng.standard_normal((200, tc.ntemps, 32)) - 3.0

    mean_logls = logls.mean(axis=(0, 2))
    logz_ti, err_ti = tc.thermodynamic_integration_log_evidence(mean_logls)
    expect_ti = thermodynamic_integration_log_evidence(tc.betas, mean_logls)
    assert np.allclose((logz_ti, err_ti), expect_ti)

    logz_ss, err_ss = tc.stepping_stone_log_evidence(logls, seed=1)
    expect_ss = stepping_stone_log_evidence(tc.betas, logls, seed=1)
    assert np.allclose((logz_ss, err_ss), expect_ss)
    assert np.isfinite(logz_ss) and err_ss >= 0


def test_move_host_protocol_helpers():
    """The reference's Move helper methods (move.py:223-402,443-457) exist
    under their public names and operate on host arrays."""
    from eryn_tpu.moves import StretchMove

    mv = StretchMove()
    ntemps, nw, nl, nd = 2, 8, 3, 2
    rng = np.random.default_rng(0)
    coords = {"a": rng.standard_normal((ntemps, nw, nl, nd))}
    inds = {"a": rng.random((ntemps, nw, nl)) < 0.7}

    # gibbs iterator with no setup yields the all-branches split
    splits = list(mv.gibbs_sampling_setup_iterator(["a"]))
    assert splits == [(["a"], [None])]

    c_go, i_go, at_least_one = mv.setup_proposals(["a"], [None], coords, inds)
    assert at_least_one
    np.testing.assert_array_equal(i_go["a"], inds["a"])

    # per-leaf gibbs mask restricts the proposal inds
    leaf_mask = np.zeros((nl, nd), dtype=bool)
    leaf_mask[0] = True
    _, i_go2, _ = mv.setup_proposals(["a"], [leaf_mask], coords, inds)
    assert not i_go2["a"][:, :, 1:].any()

    # cleanup restores non-gibbs params and back-fills missing branches
    q = {"a": np.array(coords["a"]) + 1.0}
    coords2 = dict(coords)
    coords2["b"] = rng.standard_normal((ntemps, nw, 1, nd))
    inds2 = dict(inds)
    inds2["b"] = np.ones((ntemps, nw, 1), dtype=bool)
    new_inds = {"a": np.array(inds["a"])}
    mv.cleanup_proposals_gibbs(
        ["a"], [leaf_mask], q, coords2, new_inds=new_inds, branches_inds=inds2
    )
    np.testing.assert_array_equal(
        q["a"][:, :, ~leaf_mask.any(-1)], coords["a"][:, :, ~leaf_mask.any(-1)]
    )
    assert "b" in q and "b" in new_inds

    # ensure_ordering returns reordered dicts
    qo, io, so = mv.ensure_ordering(["b", "a"], q, new_inds, None)
    assert list(qo) == ["b", "a"] and list(io) == ["b", "a"] and so is None

    # fix_logp_gibbs: a walker with leaves in a NON-run branch but no
    # selected leaves in the run branch gets -inf; a walker with no
    # leaves anywhere gets 0 (ref move.py:368-402)
    logp = np.zeros((ntemps, nw))
    inds_fix = {
        "a": np.zeros((ntemps, nw, nl), dtype=bool),
        "b": np.zeros((ntemps, nw, 1), dtype=bool),
    }
    inds_fix["b"][0, 0, 0] = True  # walker (0,0): leaves only in "b"
    split = np.zeros((nl, nd), dtype=bool)
    split[2] = True
    mv.fix_logp_gibbs(["a"], [split], logp, inds_fix)
    assert logp[0, 0] == -np.inf  # active elsewhere, nothing in this split
    assert logp[1, 1] == 0.0  # empty model everywhere -> 0

    assert mv.compute_log_posterior_basic(1.5, 2.5) == 4.0


def test_move_update_merges_accepted():
    """Move.update (ref move.py:472-703): accepted walkers from new_state
    land in old_state, honoring a red/blue subset index array."""
    from eryn_tpu.moves import StretchMove
    from eryn_tpu.state import State

    mv = StretchMove()
    ntemps, nw, nl, nd = 2, 6, 1, 2
    rng = np.random.default_rng(1)
    mk = lambda: State(
        {"a": rng.standard_normal((ntemps, nw, nl, nd))},
        log_like=rng.standard_normal((ntemps, nw)),
        log_prior=rng.standard_normal((ntemps, nw)),
    )
    old, new = mk(), mk()
    old_ll = np.array(old.log_like)
    accepted = np.zeros((ntemps, nw), dtype=bool)
    accepted[:, 0] = True
    out = mv.update(old, new, accepted)
    np.testing.assert_array_equal(out.log_like[:, 0], new.log_like[:, 0])
    np.testing.assert_array_equal(out.log_like[:, 1:], old_ll[:, 1:])

    # subset form: new_state covers walkers [3, 4, 5] only
    old2 = mk()
    old2_ll = np.array(old2.log_like)
    sub_coords = {"a": rng.standard_normal((ntemps, 3, nl, nd))}
    sub = State(
        sub_coords,
        log_like=rng.standard_normal((ntemps, 3)),
        log_prior=rng.standard_normal((ntemps, 3)),
    )
    subset = np.tile(np.array([3, 4, 5]), (ntemps, 1))
    acc = np.zeros((ntemps, nw), dtype=bool)
    acc[:, 4] = True
    out2 = mv.update(old2, sub, acc, subset=subset)
    np.testing.assert_array_equal(out2.log_like[:, 4], sub.log_like[:, 1])
    np.testing.assert_array_equal(out2.log_like[:, 3], old2_ll[:, 3])
    np.testing.assert_allclose(
        np.asarray(out2.branches["a"].coords)[:, 4],
        sub_coords["a"][:, 1],
        rtol=1e-6,
    )


def test_stretch_stock_get_proposal_not_host_move():
    """The framework-provided StretchMove.get_proposal must NOT flip the
    move into legacy host mode (only USER overrides do), and it must
    reproduce the stretch formula."""
    from eryn_tpu.moves import StretchMove

    mv = StretchMove()
    assert not mv.host_move  # stock methods are marker-exempt

    class UserStretch(StretchMove):
        def get_proposal(self, s_all, c_all, random, gibbs_ndim=None):
            return super().get_proposal(s_all, c_all, random, gibbs_ndim)

    user = UserStretch()
    assert user.host_move  # a user override still routes through the bridge

    rng = np.random.RandomState(2)
    ntemps, Ns, Nc, nl, nd = 2, 4, 5, 1, 3
    s_all = {"a": rng.randn(ntemps, Ns, nl, nd)}
    c_all = {"a": [rng.randn(ntemps, Nc, nl, nd)]}
    q, factors = mv.get_proposal(s_all, c_all, np.random.RandomState(3))
    assert q["a"].shape == (ntemps, Ns, nl, nd)
    # recover z from the factors and check support
    z = np.exp(np.asarray(factors) / (nl * nd - 1))
    assert np.all((z >= 1 / mv.a - 1e-9) & (z <= mv.a + 1e-9))

    # get_new_points: ray formula with the shared z
    s = s_all["a"]
    c_t = c_all["a"][0][:, :Ns]
    pts = mv.get_new_points(
        "a", s, c_t, Ns, (ntemps, Ns, nl, nd), 0, np.random.RandomState(4)
    )
    expect = c_t - (c_t - s) * mv.zz[:, :, None, None]
    np.testing.assert_allclose(pts, expect, rtol=1e-12)


def test_do_swaps_indexing_reference_semantics():
    """TemperatureControl.do_swaps_indexing (ref tempering.py:351-482):
    in-place pairwise walker swaps between rungs i and i-1, with logP
    re-thermalized by dbeta."""
    from eryn_tpu.moves.tempering import TemperatureControl

    tc = TemperatureControl(2, 8, ntemps=3)
    rng = np.random.default_rng(5)
    ntemps, nw, nl, nd = 3, 8, 1, 2
    x = {"a": rng.standard_normal((ntemps, nw, nl, nd))}
    logl = rng.standard_normal((ntemps, nw))
    logp = rng.standard_normal((ntemps, nw))
    betas = np.asarray(tc.betas)
    i = 1
    dbeta = betas[i - 1] - betas[i]  # ref convention (tempering.py:522)
    logP = logl * betas[:, None] + logp
    x0 = {"a": np.array(x["a"])}
    logl0, logp0, logP0 = map(np.array, (logl, logp, logP))

    iperm = np.array([0, 2])
    i1perm = np.array([5, 1])
    tc.do_swaps_indexing(i, iperm, i1perm, dbeta, x, logP, logl, logp)

    # swapped pairs moved both ways
    np.testing.assert_array_equal(x["a"][i, iperm], x0["a"][i - 1, i1perm])
    np.testing.assert_array_equal(x["a"][i - 1, i1perm], x0["a"][i, iperm])
    np.testing.assert_array_equal(logl[i, iperm], logl0[i - 1, i1perm])
    np.testing.assert_array_equal(logl[i - 1, i1perm], logl0[i, iperm])
    # untouched walkers unchanged
    np.testing.assert_array_equal(logl[i, 1], logl0[i, 1])
    # logP re-thermalized: new logP at rung i equals beta_i * logl + logp
    np.testing.assert_allclose(
        logP[i, iperm], betas[i] * logl[i, iperm] + logp[i, iperm], rtol=1e-12
    )
    np.testing.assert_allclose(
        logP[i - 1, i1perm],
        betas[i - 1] * logl[i - 1, i1perm] + logp[i - 1, i1perm],
        rtol=1e-12,
    )


def _gauss_log_like(x):
    return -0.5 * jnp.sum(x**2, axis=-1)


def _tiny_sampler(seed=10):
    # module-level likelihood: pickling requires it, exactly as for the
    # reference/emcee with process pools
    pr = ProbDistContainer({i: uniform_dist(-5, 5) for i in range(2)})
    return EnsembleSampler(16, 2, _gauss_log_like, pr, seed=seed)


def test_delayed_rejection_host_protocol_shims():
    """DelayedRejection.get_new_state / dr_scheme and the container's
    append (ref delayedrejection.py:13-148) operate on host state."""
    from eryn_tpu.moves import DelayedRejection, GaussianMove
    from eryn_tpu.moves.delayedrejection import DelayedRejectionContainer
    from eryn_tpu.state import BranchSupplemental, State

    sampler = _tiny_sampler()
    model = sampler.get_model()
    move = DelayedRejection(GaussianMove({"model_0": 0.05}), max_iter=2)

    ntemps, nw = 1, 16
    rng = np.random.default_rng(0)
    coords = {"model_0": rng.standard_normal((ntemps, nw, 1, 2))}
    logl = -0.5 * (coords["model_0"] ** 2).sum(axis=(-1, -2))
    logp = np.zeros_like(logl)
    state = State(coords, log_like=logl, log_prior=logp)

    # get_new_state: priors masked to -inf off the keep set
    keep = np.zeros((ntemps, nw), dtype=bool)
    keep[0, :8] = True
    new_state, factors = move.get_new_state(model, state, keep)
    assert np.all(np.isneginf(np.asarray(new_state.log_prior)[~keep]))
    assert np.all(np.isfinite(np.asarray(new_state.log_prior)[keep]))
    assert np.asarray(factors).shape == (ntemps, nw)

    # dr_scheme: one DR stage with the past_alpha correction
    past_alpha = np.full((ntemps, nw), 0.3)
    new_state.supplemental = BranchSupplemental(
        {"past_alpha": past_alpha}, base_shape=(ntemps, nw)
    )
    cur = State(state, copy=True)
    out_state, new_accepted, out_new_state = move.dr_scheme(
        cur, new_state, keep, model, ntemps, nw, {}
    )
    assert new_accepted.shape == (ntemps, nw)
    alpha = np.asarray(out_new_state.supplemental[:]["alpha"])
    assert np.all((alpha >= 0) & (alpha <= 1))
    # accepted walkers carry the new log-likelihood
    if new_accepted.any():
        np.testing.assert_allclose(
            np.asarray(out_state.log_like)[new_accepted],
            np.asarray(out_new_state.log_like)[new_accepted],
            rtol=1e-6,
        )

    # container records stages
    c = DelayedRejectionContainer(max_iter=4, foo="bar")
    assert c.foo == "bar"
    c.append(coords, logl, logp, past_alpha)
    assert len(c.coords) == len(c.alpha) == 1


def test_sampler_pickles_and_resumes():
    """EnsembleSampler pickles for process pools (ref ensemble.py:773-778),
    dropping the pool and compiled caches; the clone keeps sampling."""
    import pickle

    sampler = _tiny_sampler(seed=11)
    start = np.random.default_rng(4).standard_normal((16, 2)) * 0.5
    state = sampler.run_mcmc(start, 20, burn=5, progress=False)
    sampler.pool = object()  # stand-in for an unpicklable pool

    blob = pickle.dumps(sampler)
    clone = pickle.loads(blob)
    assert clone.pool is None
    assert clone._step_cache == {}
    assert clone.backend.iteration == sampler.backend.iteration

    out = clone.run_mcmc(state, 10, progress=False)
    assert clone.backend.iteration == sampler.backend.iteration + 10
    assert np.all(np.isfinite(np.asarray(out.log_like)))
