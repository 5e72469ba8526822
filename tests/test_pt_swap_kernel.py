"""The stochastic PT swap cascade — the XLA rung loop and the
single-launch Pallas kernel (interpret mode here) — against a NumPy
implementation of the reference's two-permutation cascade
(ref ``tempering.py:484-561``), given the same per-rung permutations and
acceptance draws; and the kernel's wrapper: CUDA lowering, shape guard and
the choice between the two."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from eryn_tpu.moves import tempering
from eryn_tpu.moves.tempering import (
    TemperatureControl,
    cascade_draws,
    cascade_provenance,
)
from eryn_tpu.ops.swap_cascade import MAX_WALKERS, swap_cascade

SHAPES = [(2, 8), (3, 17), (5, 64), (10, 100), (8, 203), (20, 50)]


def _numpy_cascade(logl, tree, betas, perms, raccept):
    """The reference's in-place cascade: rung ``i`` pairs ``perms[i-1, 0]``
    with ``perms[i-1, 1]`` of rung ``i - 1`` and scatter-swaps the accepted
    pairs of every array."""
    logl = logl.copy()
    tree = {k: v.copy() for k, v in tree.items()}
    ntemps = logl.shape[0]
    accepted = np.zeros(ntemps - 1)
    for i in range(ntemps - 1, 0, -1):
        iperm, i1perm = perms[i - 1]
        dbeta = betas[i - 1] - betas[i]
        paccept = dbeta * (logl[i, iperm] - logl[i - 1, i1perm])
        sel = paccept > raccept[i - 1]
        accepted[i - 1] = sel.sum()
        a, b = iperm[sel], i1perm[sel]
        for arr in [logl, *tree.values()]:
            hi = arr[i, a].copy()
            arr[i, a] = arr[i - 1, b]
            arr[i - 1, b] = hi
    return logl, tree, accepted


@pytest.mark.parametrize("ntemps,nwalkers", SHAPES)
def test_cascade_matches_numpy_reference(ntemps, nwalkers):
    rng = np.random.default_rng(ntemps * 1000 + nwalkers)
    tc = TemperatureControl(5, nwalkers, ntemps=ntemps, adaptive=False)
    betas = np.asarray(tc.betas, np.float32)
    logl = (rng.standard_normal((ntemps, nwalkers)) * 3.0).astype(np.float32)
    tree = {
        "coords": rng.standard_normal((ntemps, nwalkers, 2, 3)).astype(
            np.float32
        ),
        "inds": rng.random((ntemps, nwalkers, 2)) < 0.5,
    }
    key = jax.random.PRNGKey(ntemps + nwalkers)

    perms, _, raccept = cascade_draws(key, ntemps, nwalkers, jnp.float32)
    exp_logl, exp_tree, exp_acc = _numpy_cascade(
        logl, tree, betas, np.asarray(perms), np.asarray(raccept)
    )
    # the swap phase must actually exchange something at these temperatures
    assert exp_acc.sum() > 0

    out_tree, out_logl, acc, prop = tc.swap_kernel(
        key,
        {k: jnp.asarray(v) for k, v in tree.items()},
        jnp.asarray(logl),
        jnp.asarray(betas),
    )
    np.testing.assert_array_equal(np.asarray(out_logl), exp_logl)
    np.testing.assert_array_equal(np.asarray(acc), exp_acc)
    np.testing.assert_array_equal(np.asarray(prop), nwalkers)
    for k in tree:
        np.testing.assert_array_equal(np.asarray(out_tree[k]), exp_tree[k])


def test_temper_kernel_rescales_partial_proposal_counts():
    """Regression: every consumer outside temper_kernel (backend counters,
    swap_acceptance_fraction, plots, host adapt_temps) divides the returned
    swap counts by nwalkers.  When a swap kernel proposes fewer pairings per
    rung (a subclass override), the returned counts must be rescaled so
    those ratios stay unbiased."""
    from eryn_tpu.moves.tempering import TemperatureControl
    from eryn_tpu.state import State

    ntemps, nw = 3, 64
    tc = TemperatureControl(5, nw, ntemps=ntemps, adaptive=False)
    state = State(
        {"m": jnp.zeros((ntemps, nw, 1, 2))},
        log_like=jnp.zeros((ntemps, nw)),
        log_prior=jnp.zeros((ntemps, nw)),
        betas=jnp.asarray(tc.betas),
    )

    # stub cascade: 20 accepts out of only 50 proposed pairings per rung
    def fake_swap_kernel(key, swap_tree, logl, betas, time=None):
        acc = jnp.full((ntemps - 1,), 20.0, dtype=logl.dtype)
        prop = jnp.full((ntemps - 1,), 50.0, dtype=logl.dtype)
        return swap_tree, logl, acc, prop

    tc.swap_kernel = fake_swap_kernel
    _, swaps_accepted, _ = tc.temper_kernel(
        jax.random.PRNGKey(0), state, jnp.zeros((), jnp.int32), adapt=False
    )
    # 20/50 acceptance rate reported on the nwalkers scale
    np.testing.assert_allclose(
        np.asarray(swaps_accepted), 20.0 / 50.0 * nw, rtol=1e-6
    )


def test_make_ladder_validation():
    from eryn_tpu.moves.tempering import make_ladder

    # ntemps=None with infinite Tmax must raise the intended ValueError,
    # not the reference's TypeError(None - 1)
    with pytest.raises(ValueError, match="ntemps and finite Tmax"):
        make_ladder(5, ntemps=None, Tmax=np.inf)
    # the valid inf-Tmax path still appends a beta=0 rung
    betas = make_ladder(5, ntemps=4, Tmax=np.inf)
    assert len(betas) == 4 and betas[-1] == 0.0


def test_provenance_capacity_guard():
    nt, nw = 2**15, 2**10
    perms = jax.ShapeDtypeStruct((nt - 1, 2, nw), jnp.int32)
    with pytest.raises(ValueError, match="2\\*\\*24"):
        jax.eval_shape(
            cascade_provenance,
            jax.ShapeDtypeStruct((nt, nw), jnp.float32),
            jax.ShapeDtypeStruct((nt,), jnp.float32),
            perms,
            perms,
            jax.ShapeDtypeStruct((nt - 1, nw), jnp.float32),
        )


def _inputs(ntemps, nwalkers, seed):
    rng = np.random.default_rng(seed)
    betas = np.asarray(
        TemperatureControl(5, nwalkers, ntemps=ntemps).betas, np.float32
    )
    logl = (rng.standard_normal((ntemps, nwalkers)) * 3.0).astype(np.float32)
    perms, inv_perms, raccept = cascade_draws(
        jax.random.PRNGKey(seed), ntemps, nwalkers, jnp.float32
    )
    return logl, betas, perms, inv_perms, raccept


@pytest.mark.parametrize("ntemps,nwalkers", SHAPES)
def test_cascade_kernel_matches_numpy_reference(ntemps, nwalkers):
    logl, betas, perms, inv_perms, raccept = _inputs(ntemps, nwalkers, 3)
    origin = np.arange(ntemps * nwalkers, dtype=np.int32).reshape(ntemps, nwalkers)
    exp_logl, exp_tree, exp_acc = _numpy_cascade(
        logl, {"origin": origin}, betas, np.asarray(perms), np.asarray(raccept)
    )
    got_logl, flat, acc = swap_cascade(
        jnp.asarray(logl),
        jnp.asarray(betas[:-1] - betas[1:]),
        perms,
        raccept,
        interpret=True,
    )
    np.testing.assert_array_equal(np.asarray(got_logl), exp_logl)
    np.testing.assert_array_equal(np.asarray(flat), exp_tree["origin"].ravel())
    np.testing.assert_array_equal(np.asarray(acc), exp_acc)
    # and bit for bit the XLA rung loop it replaces on the GPU
    want = cascade_provenance(jnp.asarray(logl), jnp.asarray(betas), perms, inv_perms, raccept)
    for a, b in zip(want, (got_logl, flat, acc)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("ntemps,nwalkers", [(10, 100), (20, 1000), (7, 333)])
def test_cascade_kernel_lowers_for_cuda(ntemps, nwalkers):
    logl, betas, perms, _, raccept = _inputs(ntemps, nwalkers, 4)
    lowered = (
        jax.jit(swap_cascade)
        .trace(jnp.asarray(logl), jnp.asarray(betas[:-1] - betas[1:]), perms, raccept)
        .lower(lowering_platforms=("cuda",))
    )
    assert "pt_swap_cascade" in lowered.as_text()


def test_cascade_kernel_vmaps():
    nt, nw, ng = 4, 33, 3
    logl = jnp.asarray(
        np.random.default_rng(0).standard_normal((ng, nt, nw)), jnp.float32
    )
    betas = jnp.asarray(TemperatureControl(5, nw, ntemps=nt).betas, jnp.float32)
    perms, inv, racc = jax.vmap(
        lambda k: cascade_draws(k, nt, nw, jnp.float32)
    )(jax.random.split(jax.random.PRNGKey(1), ng))
    want = jax.vmap(lambda l, p, i, r: cascade_provenance(l, betas, p, i, r))(
        logl, perms, inv, racc
    )
    got = jax.vmap(
        lambda l, p, r: swap_cascade(l, betas[:-1] - betas[1:], p, r, interpret=True)
    )(logl, perms, racc)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize(
    "backend,dtype,nwalkers,expect",
    [
        ("gpu", jnp.float32, 100, True),
        ("gpu", jnp.float32, tempering.CASCADE_KERNEL_MAX_WALKERS, True),
        ("gpu", jnp.float32, tempering.CASCADE_KERNEL_MAX_WALKERS + 1, False),
        ("gpu", jnp.bfloat16, 100, False),
        ("cpu", jnp.float32, 100, False),
    ],
)
def test_cascade_kernel_choice(monkeypatch, backend, dtype, nwalkers, expect):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    logl = jax.ShapeDtypeStruct((4, nwalkers), dtype)
    assert tempering._use_cascade_kernel(logl) is expect


@pytest.mark.parametrize("shape", [(1, 16), (3, MAX_WALKERS + 1)])
def test_cascade_kernel_rejects_unsupported_shapes(shape):
    nt, nw = shape
    with pytest.raises(ValueError, match="swap_cascade needs"):
        jax.eval_shape(
            swap_cascade,
            jax.ShapeDtypeStruct((nt, nw), jnp.float32),
            jax.ShapeDtypeStruct((max(nt - 1, 0),), jnp.float32),
            jax.ShapeDtypeStruct((max(nt - 1, 0), 2, nw), jnp.int32),
            jax.ShapeDtypeStruct((max(nt - 1, 0), nw), jnp.float32),
        )


@pytest.mark.parametrize("cell", ["north_star", "config_e"])
def test_sampler_with_cascade_kernel_is_bitwise_the_xla_loop(cell, monkeypatch):
    """A whole compiled segment with the kernel (interpreted) in place of
    the XLA rung loop gives the same chain state bit for bit."""
    import functools

    import chip_smoke as cs
    from eryn_tpu.ops import swap_cascade as sc

    def build():
        np.random.seed(cs.SEED)
        if cell == "config_e":
            return cs._config_e_sampler(cs.TINY, 5)
        s, pr = cs._gaussian_sampler(4, 32, 5)
        return s, s._setup_state(pr.rvs(size=(4, 32)))

    s, st = build()
    want, _ = s._run_bulk(st, 1, 12, store=False)
    monkeypatch.setattr(tempering, "_use_cascade_kernel", lambda logl: True)
    monkeypatch.setattr(
        tempering, "swap_cascade", functools.partial(sc.swap_cascade, interpret=True)
    )
    s, st = build()
    got, _ = s._run_bulk(st, 1, 12, store=False)
    for a, b in zip(jax.tree_util.tree_leaves(want), jax.tree_util.tree_leaves(got)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
