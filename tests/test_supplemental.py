"""BranchSupplemental: storage, indexing, and consistency through
temperature swaps."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from eryn_tpu import BranchSupplemental, State
from eryn_tpu.moves.tempering import TemperatureControl


def test_branch_supplemental_container():
    supp = BranchSupplemental(
        {"walker_id": np.arange(12).reshape(3, 4)}, base_shape=(3, 4)
    )
    assert "walker_id" in supp
    assert supp["walker_id"].shape == (3, 4)
    assert supp.flat["walker_id"].shape == (12,)
    with pytest.raises(ValueError):
        BranchSupplemental({"bad": np.zeros((2, 2))}, base_shape=(3, 4))


def test_branch_supplemental_object_management():
    """add/remove/take/put along-axis surface (ref state.py:63-310)."""
    base = np.arange(24, dtype=float).reshape(2, 3, 4)
    supp = BranchSupplemental({"a": base.copy()}, base_shape=(2, 3))
    supp.add_objects({"b": np.ones((2, 3))})
    assert supp.contained_objects == ["a", "b"]
    with pytest.raises(ValueError):
        supp.add_objects({"bad": np.zeros((5, 5))})

    idx = np.array([[1, 0, 2], [2, 1, 0]])
    out = supp.take_along_axis(idx, axis=1, skip_names=("b",))
    assert list(out) == ["a"]
    np.testing.assert_array_equal(
        np.asarray(out["a"]),
        np.take_along_axis(base, idx[..., None], axis=1),
    )

    # put(take(x)) along a permutation is the identity
    vals = supp.take_along_axis(idx, axis=1)
    supp.put_along_axis(idx, vals, axis=1)
    np.testing.assert_array_equal(np.asarray(supp["a"]), base)

    supp.remove_objects("b")
    assert supp.contained_objects == ["a"]
    with pytest.raises(ValueError):
        supp.remove_objects(3.14)


def test_host_object_supplementals_follow_swaps():
    """Object-dtype supplemental entries (ref state.py:84-96) live host-side
    and are reordered by the composed temperature-swap permutation at
    segment boundaries: after a PT run, each walker's host object must agree
    with a traced int tag that rode the compiled swap cascade."""
    from eryn_tpu import EnsembleSampler, ProbDistContainer, uniform_dist

    ntemps, nw, ndim = 6, 32, 2

    def ll(x):
        return -0.5 * jnp.sum(x**2)

    pr = ProbDistContainer({i: uniform_dist(-5, 5) for i in range(ndim)})
    ens = EnsembleSampler(
        nw, ndim, ll, pr, tempering_kwargs=dict(ntemps=ntemps), seed=3
    )
    coords = pr.rvs(size=(ntemps, nw))

    flat_ids = np.arange(ntemps * nw).reshape(ntemps, nw)
    objs = np.empty((ntemps, nw), dtype=object)
    bobjs = np.empty((ntemps, nw), dtype=object)
    for t in range(ntemps):
        for w in range(nw):
            objs[t, w] = ("state", t * nw + w)
            bobjs[t, w] = {"branch_id": t * nw + w}

    state = State(
        {"model_0": coords},
        supplemental=BranchSupplemental(
            {"tag": flat_ids.copy(), "obj": objs},
            base_shape=(ntemps, nw),
        ),
        branch_supplemental={
            "model_0": BranchSupplemental(
                {"btag": flat_ids.copy(), "bobj": bobjs},
                base_shape=(ntemps, nw),
            )
        },
    )
    ens.run_mcmc(state, 60, burn=40)
    final = ens._previous_state

    tag = np.asarray(final.supplemental["tag"])
    # swaps actually happened
    assert not np.array_equal(tag, flat_ids)
    obj = final.supplemental["obj"]
    for t in range(ntemps):
        for w in range(nw):
            assert obj[t, w] == ("state", int(tag[t, w])), (t, w)

    btag = np.asarray(final.branches["model_0"].supplemental["btag"])
    bobj = final.branches["model_0"].supplemental["bobj"]
    assert np.array_equal(btag, tag)  # one common swap permutation
    for t in range(ntemps):
        for w in range(nw):
            assert bobj[t, w]["branch_id"] == int(btag[t, w])

    # a second run continues tracking from the permuted registry
    ens.run_mcmc(None, 40)
    final2 = ens._previous_state
    tag2 = np.asarray(final2.supplemental["tag"])
    obj2 = final2.supplemental["obj"]
    for t in range(ntemps):
        for w in range(nw):
            assert obj2[t, w] == ("state", int(tag2[t, w]))


def test_host_object_registry_cleared_between_runs():
    """A later run with a clean state must not inherit a previous run's
    host objects (the registry is rebuilt per _setup_state)."""
    from eryn_tpu import EnsembleSampler, ProbDistContainer, uniform_dist

    ntemps, nw, ndim = 3, 16, 2

    def ll(x):
        return -0.5 * jnp.sum(x**2)

    pr = ProbDistContainer({i: uniform_dist(-5, 5) for i in range(ndim)})
    ens = EnsembleSampler(
        nw, ndim, ll, pr, tempering_kwargs=dict(ntemps=ntemps), seed=5
    )
    objs = np.empty((ntemps, nw), dtype=object)
    objs[...] = [[("run1", i) for i in range(nw)] for _ in range(ntemps)]
    state = State(
        {"model_0": pr.rvs(size=(ntemps, nw))},
        supplemental=BranchSupplemental({"obj": objs}, base_shape=(ntemps, nw)),
    )
    ens.run_mcmc(state, 10)
    clean = State({"model_0": pr.rvs(size=(ntemps, nw))})
    ens.run_mcmc(clean, 10)
    final = ens._previous_state
    assert final.supplemental is None or "obj" not in final.supplemental


def test_branch_supplemental_setitem_host_entries():
    objs = np.empty((2, 3), dtype=object)
    objs[...] = [[("a", i) for i in range(3)] for _ in range(2)]
    supp = BranchSupplemental({"obj": objs}, base_shape=(2, 3))
    new_objs = np.empty((2, 3), dtype=object)
    new_objs[...] = [[("b", i) for i in range(3)] for _ in range(2)]
    supp["obj"] = new_objs
    assert supp["obj"][0, 0] == ("b", 0)
    supp[(0, 1)] = {"obj": ("c", 9)}
    assert supp["obj"][0, 1] == ("c", 9)


def test_state_copy_into_self():
    s1 = State({"m": np.zeros((1, 4, 1, 2))}, log_like=np.zeros((1, 4)))
    s2 = State({"m": np.ones((1, 4, 1, 2))}, log_like=np.ones((1, 4)))
    s1.copy_into_self(s2)
    assert float(np.asarray(s1.log_like).sum()) == 4.0
    assert float(np.asarray(s1.branches["m"].coords).sum()) == 8.0


def test_supplemental_swaps_with_coords():
    """After the swap cascade, per-branch supplemental entries must have
    moved together with their coordinates."""
    ntemps, nw, ndim = 5, 16, 2
    rng = np.random.default_rng(0)
    coords = rng.standard_normal((ntemps, nw, 1, ndim))
    # supplemental tag == first coordinate, so they must stay equal
    tag = coords[:, :, 0, 0].copy()

    state = State(
        {"model_0": coords},
        branch_supplemental={
            "model_0": BranchSupplemental(
                {"tag": tag}, base_shape=(ntemps, nw)
            )
        },
        log_like=rng.standard_normal((ntemps, nw)) * 5,
        log_prior=np.zeros((ntemps, nw)),
        betas=np.logspace(0, -2, ntemps),
    )
    tc = TemperatureControl(ndim, nw, ntemps=ntemps, adaptive=False)

    new_state, swaps, _ = tc.temper_kernel(
        jax.random.PRNGKey(0), state, jnp.zeros((), jnp.int32), adapt=False
    )
    assert np.asarray(swaps).sum() > 0  # swaps actually happened
    new_tag = np.asarray(new_state.branches_supplemental["model_0"]["tag"])
    new_c0 = np.asarray(new_state.branches["model_0"].coords[:, :, 0, 0])
    np.testing.assert_allclose(new_tag, new_c0)
    # and it is a permutation of the original tags
    np.testing.assert_allclose(
        np.sort(new_tag.ravel()), np.sort(tag.ravel())
    )


def test_provide_supplemental_traced_likelihood():
    """provide_supplemental=True: the traced likelihood receives per-walker
    supplemental data (here: per-walker noise scales)."""
    import jax.numpy as jnp

    from eryn_tpu import EnsembleSampler, ProbDistContainer, uniform_dist

    nwalkers, ndim = 24, 2
    rng = np.random.default_rng(1)
    noise_scale = np.full((1, nwalkers), 2.0)

    def log_like(x, supps):
        # supps: {"sigma": scalar per walker}
        return -0.5 * jnp.sum((x / supps["sigma"]) ** 2)

    priors = ProbDistContainer({i: uniform_dist(-10, 10) for i in range(ndim)})
    ens = EnsembleSampler(
        nwalkers,
        ndim,
        log_like,
        priors,
        provide_supplemental=True,
        seed=70,
    )
    coords = priors.rvs(size=(nwalkers,))
    state = State(
        {"model_0": coords},
        branch_supplemental={
            "model_0": BranchSupplemental(
                {"sigma": noise_scale}, base_shape=(1, nwalkers)
            )
        },
    )
    ens.run_mcmc(state, 300, burn=200)
    chain = ens.get_chain()["model_0"].reshape(-1, ndim)
    # with sigma=2 the posterior std should be ~2, not ~1
    assert abs(chain.std(axis=0).mean() - 2.0) < 0.3


def test_state_copy_true_is_independent():
    """Regression: State(state, copy=True) must not alias mutable holders —
    mutating the copy's supplemental cannot corrupt the original (the
    reference deep-copies, ref state.py:428-447)."""
    import numpy as np
    import jax.numpy as jnp
    from eryn_tpu.state import BranchSupplemental, State

    coords = jnp.zeros((1, 4, 1, 2))
    supp = BranchSupplemental(
        {"tag": np.arange(4.0).reshape(1, 4)}, base_shape=(1, 4)
    )
    objs = np.empty((1, 4), dtype=object)
    objs[:] = [[{"id": i} for i in range(4)]]
    supp["objs"] = objs
    st = State(
        {"m": coords},
        log_like=jnp.zeros((1, 4)),
        log_prior=jnp.zeros((1, 4)),
        branch_supplemental={"m": supp},
    )

    snap = State(st, copy=True)
    # mutate the copy's host objects and array entries
    snap.branches["m"].supplemental["objs"][0, 0]["id"] = 99
    snap.branches["m"].supplemental["tag"] = np.full((1, 4), -1.0)
    assert st.branches["m"].supplemental["objs"][0, 0]["id"] == 0
    np.testing.assert_array_equal(
        np.asarray(st.branches["m"].supplemental["tag"]),
        np.arange(4.0).reshape(1, 4),
    )
    # copy=False shares (reference semantics)
    alias = State(st)
    assert alias.branches["m"] is st.branches["m"]
