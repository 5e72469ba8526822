"""Batched independent sub-ensembles (ParaEnsembleSampler / ParaState)."""

import numpy as np
import pytest

import jax.numpy as jnp

from eryn_tpu import ParaState, ProbDistContainer, uniform_dist
from eryn_tpu.parallel.para import ParaEnsembleSampler

NDIM = 2
NWALKERS = 24
NGROUPS = 4


def test_para_ensemble_independent_groups():
    # each group targets a Gaussian with a different mean
    mus = jnp.asarray([-2.0, -0.5, 0.5, 2.0])

    def log_like(x, mu):
        return -0.5 * jnp.sum((x - mu) ** 2)

    # group-dependent likelihood via kwargs is not batched; instead encode
    # the group mean in the first coordinate's prior window... simplest:
    # identical likelihood, verify groups decorrelate.
    priors = ProbDistContainer({i: uniform_dist(-6, 6) for i in range(NDIM)})
    para = ParaEnsembleSampler(
        NGROUPS,
        NWALKERS,
        NDIM,
        lambda x: -0.5 * jnp.sum(x**2),
        priors,
        tempering_kwargs=dict(ntemps=3),
        seed=60,
    )
    coords = priors.rvs(size=(NGROUPS, 3, NWALKERS))
    state = para.run_mcmc(coords, 200, burn=100)
    assert isinstance(state, ParaState)
    assert state.groups_running.shape == (NGROUPS,)

    chain = para.get_chain()["model_0"]
    assert chain.shape == (200, NGROUPS, 3, NWALKERS, 1, NDIM)
    flat = chain[:, :, 0].reshape(200, NGROUPS, -1)

    # every group converged to the same posterior...
    for g in range(NGROUPS):
        vals = chain[:, g, 0].reshape(-1, NDIM)
        assert np.abs(vals.mean(axis=0)).max() < 0.3
        assert np.abs(vals.std(axis=0) - 1.0).max() < 0.3

    # ...but with independent chains (different random streams)
    g0 = chain[:, 0, 0, 0, 0, 0]
    g1 = chain[:, 1, 0, 0, 0, 0]
    assert not np.allclose(g0, g1)

    ll = para.get_log_like()
    assert ll.shape == (200, NGROUPS, 3, NWALKERS)
    assert np.isfinite(ll).all()

    # continuing advances all groups
    para.run_mcmc(None, 50)
    assert para.get_log_like().shape[0] == 250


def test_para_state_accepts_prefolded_arrays():
    """Regression: ParaState must not re-fold log_like/log_prior (or inds)
    that are already in folded 2D/3D form — previously fold() mangled them
    to 1D and State coerced that to (1, N) silently."""
    import jax.numpy as jnp
    from eryn_tpu.state import ParaState

    ngroups, ntemps, nw, nl, nd = 3, 2, 8, 1, 2
    coords5 = jnp.zeros((ngroups, ntemps, nw, nl, nd))
    folded_ll = jnp.arange(ngroups * ntemps * nw, dtype=jnp.float32).reshape(
        ngroups * ntemps, nw
    )
    st = ParaState(
        {"m": coords5},
        log_like=folded_ll,
        log_prior=jnp.zeros((ngroups * ntemps, nw)),
        inds={"m": jnp.ones((ngroups * ntemps, nw, nl), bool)},
    )
    assert st.log_like.shape == (ngroups * ntemps, nw)
    assert st.branches["m"].coords.shape == (ngroups * ntemps, nw, nl, nd)
    # group-batched input still folds
    st2 = ParaState(
        {"m": coords5},
        log_like=jnp.zeros((ngroups, ntemps, nw)),
        inds={"m": jnp.ones((ngroups, ntemps, nw, nl), bool)},
    )
    assert st2.log_like.shape == (ngroups * ntemps, nw)


def test_para_burn_ignores_thin_by_and_rejects_backend():
    """burn counts raw proposal steps (thin_by ignored, same contract as
    EnsembleSampler.run_mcmc); a user backend is refused rather than
    silently discarded."""
    import jax.numpy as jnp

    from eryn_tpu import Backend, ProbDistContainer, uniform_dist
    from eryn_tpu.parallel.para import ParaEnsembleSampler

    pr = ProbDistContainer({i: uniform_dist(-5, 5) for i in range(2)})

    def ll(x):
        return -0.5 * jnp.sum(x**2)

    with pytest.raises(ValueError, match="backend"):
        ParaEnsembleSampler(2, 16, 2, ll, pr, backend=Backend())

    para = ParaEnsembleSampler(2, 16, 2, ll, pr, seed=3)
    para.run_mcmc(np.random.randn(2, 16, 2) * 0.1, 4, burn=6, thin_by=5)
    # the burn bulk was compiled for 6 raw steps, not 6 * thin_by
    assert (1, 6, False) in para._fn_cache
    assert (1, 30, False) not in para._fn_cache


def test_para_groups_sharded_over_mesh():
    """The ngroups axis distributes over a 1-D group
    mesh (the multi-slice/DCN analog — independent ensembles on separate
    devices) and per-group results match the unsharded vmap runner."""
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    from eryn_tpu.parallel.mesh import make_group_mesh

    priors = ProbDistContainer({i: uniform_dist(-6, 6) for i in range(NDIM)})

    def build(mesh):
        return ParaEnsembleSampler(
            8,
            NWALKERS,
            NDIM,
            lambda x: -0.5 * jnp.sum(x**2),
            priors,
            tempering_kwargs=dict(ntemps=2),
            seed=61,
            mesh=mesh,
        )

    mesh = make_group_mesh(8)
    coords = priors.rvs(size=(8, 2, NWALKERS))

    para_s = build(mesh)
    state_s = para_s.run_mcmc(coords, 50, burn=20)
    # groups actually distributed: one group per device
    assert len(state_s.log_like.sharding.device_set) == 8

    para_u = build(None)
    state_u = para_u.run_mcmc(coords, 50, burn=20)

    # identical seeds -> identical streams; per-group results match the
    # unsharded runner (vmap over groups is embarrassingly parallel, so
    # sharding must not change the computation)
    np.testing.assert_allclose(
        np.asarray(state_s.log_like), np.asarray(state_u.log_like),
        rtol=1e-5, atol=1e-6,
    )
    np.testing.assert_allclose(
        para_s.get_chain()["model_0"], para_u.get_chain()["model_0"],
        rtol=1e-5, atol=1e-6,
    )

    # misuse guards
    with pytest.raises(ValueError, match="divisible"):
        ParaEnsembleSampler(
            3, NWALKERS, NDIM, lambda x: -0.5 * jnp.sum(x**2), priors,
            seed=62, mesh=mesh,
        )


def test_para_groups_running_gating():
    """ParaState.groups_running honored by the runner (the reference ships
    the field with no runner): stopped groups freeze — state and stored
    chain repeat the frozen snapshot; running groups are unaffected."""
    priors = ProbDistContainer({i: uniform_dist(-6, 6) for i in range(NDIM)})
    para = ParaEnsembleSampler(
        3, NWALKERS, NDIM,
        lambda x: -0.5 * jnp.sum(x**2),
        priors, tempering_kwargs=dict(ntemps=2), seed=63,
    )
    coords = priors.rvs(size=(3, 2, NWALKERS))
    def per_group_ll(st):
        # ParaState folds (ngroups, ntemps) together; unfold for indexing
        return np.asarray(st.group_view({"ll": st.log_like})["ll"])

    st1 = para.run_mcmc(coords, 20)
    frozen_ll = per_group_ll(st1)

    running = np.array([True, False, True])
    st2 = para.run_mcmc(None, 30, groups_running=running)
    np.testing.assert_array_equal(np.asarray(st2.groups_running), running)
    # stopped group's state identical; running groups advanced
    ll2 = per_group_ll(st2)
    np.testing.assert_array_equal(ll2[1], frozen_ll[1])
    assert not np.allclose(ll2[0], frozen_ll[0])
    assert not np.allclose(ll2[2], frozen_ll[2])
    # stored chain: stopped group repeats its frozen sample
    ll = para.get_log_like()  # (50, ngroups, ntemps, nwalkers)
    assert ll.shape[0] == 50
    for step in range(20, 50):
        np.testing.assert_array_equal(ll[step, 1], frozen_ll[1])
    assert not np.allclose(ll[49, 0], ll[19, 0])
    # restarting all groups resumes the stopped one
    st3 = para.run_mcmc(None, 10, groups_running=np.ones(3, bool))
    assert not np.allclose(per_group_ll(st3)[1], frozen_ll[1])


def test_para_groups_running_resets_when_omitted():
    """The mask is per-call: omitting groups_running advances EVERY group
    (a stale mask from an earlier call must not keep freezing groups)."""
    priors = ProbDistContainer({i: uniform_dist(-6, 6) for i in range(NDIM)})
    para = ParaEnsembleSampler(
        3, NWALKERS, NDIM,
        lambda x: -0.5 * jnp.sum(x**2),
        priors, tempering_kwargs=dict(ntemps=2), seed=64,
    )
    coords = priors.rvs(size=(3, 2, NWALKERS))
    st1 = para.run_mcmc(coords, 10, groups_running=np.array([True, False, True]))
    ll1 = np.asarray(st1.group_view({"ll": st1.log_like})["ll"])
    st2 = para.run_mcmc(None, 10)  # omitted -> all groups advance
    assert bool(np.asarray(st2.groups_running).all())
    ll2 = np.asarray(st2.group_view({"ll": st2.log_like})["ll"])
    assert not np.allclose(ll2[1], ll1[1])


def test_para_new_move_families_under_vmap():
    """ChEES (lax.while_loop kernels), SliceMove (lockstep while loops),
    and DEO swap phases all compose with the vmapped group axis."""
    from eryn_tpu.moves import ChEESHMCMove, SliceMove

    priors = ProbDistContainer({i: uniform_dist(-6, 6) for i in range(NDIM)})
    for label, moves, tk in [
        ("chees", [ChEESHMCMove(tune_steps=50, max_leapfrog=8)], None),
        ("slice", [SliceMove(tune_steps=50)], None),
        ("deo", None, dict(ntemps=3, swap_scheme="deo")),
    ]:
        kwargs = {}
        if moves is not None:
            kwargs["moves"] = moves
        if tk is not None:
            kwargs["tempering_kwargs"] = tk
        para = ParaEnsembleSampler(
            NGROUPS, NWALKERS, NDIM,
            lambda x: -0.5 * jnp.sum(x**2),
            priors, seed=61, **kwargs,
        )
        nt = 1 if tk is None else tk["ntemps"]
        coords = priors.rvs(size=(NGROUPS, nt, NWALKERS))
        para.run_mcmc(coords, 150, burn=80)
        chain = para.get_chain()["model_0"]
        for g in range(NGROUPS):
            vals = np.asarray(chain[:, g, 0]).reshape(-1, NDIM)
            assert np.abs(vals.mean(axis=0)).max() < 0.35, (label, g)
            assert np.abs(vals.std(axis=0) - 1.0).max() < 0.35, (label, g)
