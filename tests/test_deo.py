"""Non-reversible (deterministic even-odd) parallel tempering.

Syed et al. 2021: alternating disjoint parity classes of rung pairs give
replicas ballistic ladder traversal — and a fully parallel swap phase
(no sequential cascade), the natural lockstep formulation.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from eryn_tpu import EnsembleSampler, ProbDistContainer, uniform_dist
from eryn_tpu.moves.tempering import TemperatureControl

NDIM = 3
NWALKERS = 32
NTEMPS = 6


@pytest.fixture
def priors():
    return ProbDistContainer({i: uniform_dist(-7, 7) for i in range(NDIM)})


def log_like(x):
    return -0.5 * jnp.sum(x**2)


def test_deo_parity_alternation():
    """Phase t attempts exactly the boundaries with b % 2 == t % 2, pairing
    each walker with itself; a guaranteed-accept logl pattern makes the
    expected row exchanges deterministic."""
    betas = np.array([1.0, 0.5, 0.25, 0.125])
    tc = TemperatureControl(
        betas=betas, nwalkers=4, adaptive=False, swap_scheme="deo"
    )
    # hotter rows have HIGHER logl -> paccept = dbeta*(logl[b+1]-logl[b]) > 0
    # with margin >> log(u) never below ~-20 at these shapes
    logl = jnp.asarray(
        np.arange(4, dtype=np.float32)[:, None] * 100.0
        + np.arange(4, dtype=np.float32)[None, :]
    )
    tree = {"tag": logl * 10.0}

    key = jax.random.PRNGKey(0)
    for t, expected_swapped in [(0, {0, 2}), (1, {1}), (2, {0, 2})]:
        out_tree, logl_new, acc, prop = tc.swap_kernel(
            key, tree, logl, jnp.asarray(betas), time=jnp.asarray(t)
        )
        prop = np.asarray(prop)
        acc = np.asarray(acc)
        for b in range(3):
            if b in expected_swapped:
                assert prop[b] == 4 and acc[b] == 4, (t, b, prop, acc)
                # rows b and b+1 exchanged per-walker
                np.testing.assert_array_equal(
                    np.asarray(logl_new[b]), np.asarray(logl[b + 1])
                )
            else:
                assert prop[b] == 0 and acc[b] == 0, (t, b, prop, acc)
        # the payload tree rides the same exchange
        np.testing.assert_array_equal(
            np.asarray(out_tree["tag"]), np.asarray(logl_new) * 10.0
        )


def test_deo_host_parity_clock():
    """The host temperature_swaps API ticks the parity clock so repeated
    calls alternate phases even with adaptation off — and reports swap
    counts at the PER-ATTEMPT scale, like the compiled path."""
    betas = np.array([1.0, 0.25])
    tc = TemperatureControl(
        betas=betas, nwalkers=8, adaptive=False, swap_scheme="deo"
    )
    # equal logl: every attempted pair accepts with probability 1
    logl = np.zeros((2, 8))
    logp = np.zeros((2, 8))
    x = {"model_0": np.random.randn(2, 8, 1, NDIM)}
    assert tc.time == 0
    tc.temperature_swaps(x, None, logl, logp)
    assert tc.time == 1
    # the single boundary was attempted (parity 0) and accepted all 8
    # pairs; the 2x per-attempt rescale reports 16 = 2 * 8
    np.testing.assert_allclose(tc.swaps_accepted, [16.0])
    tc.temperature_swaps(x, None, logl, logp)
    assert tc.time == 2
    # parity 1 attempts no boundary on a 2-rung ladder
    np.testing.assert_allclose(tc.swaps_accepted, [0.0])


def test_deo_reference_composition_single_tick(priors):
    """The reference's documented pattern temperature_swaps() +
    adapt_temps() must advance the parity clock exactly once per phase —
    a double tick would freeze the parity and permanently disconnect one
    boundary class."""
    betas = np.array([1.0, 0.5, 0.25])
    tc = TemperatureControl(
        betas=betas, nwalkers=8, adaptive=True, swap_scheme="deo"
    )
    logl = np.random.randn(3, 8)
    logp = np.zeros((3, 8))
    x = {"model_0": np.random.randn(3, 8, 1, NDIM)}
    for expected in (1, 2, 3):
        tc.temperature_swaps(x, None, logl, logp)
        tc.adapt_temps()
        assert tc.time == expected
    # and adapt_temps alone (no preceding swap call) still ticks
    tc.adapt_temps()
    assert tc.time == 4


def test_deo_host_propose_ticks_parity(priors):
    """Move.propose (the host-step path) must tick the parity clock even
    with adaptation off — otherwise only one boundary class is ever
    attempted in host-step mode."""
    from eryn_tpu.moves import StretchMove

    ens = EnsembleSampler(
        NWALKERS, NDIM, log_like, priors,
        tempering_kwargs=dict(
            ntemps=4, adaptive=False, swap_scheme="deo"
        ),
        seed=7,
    )
    state = ens._setup_state(priors.rvs(size=(4, NWALKERS)))
    model = ens.get_model()
    move = StretchMove(temperature_control=ens.temperature_control)
    assert ens.temperature_control.time == 0
    state, _ = move.propose(model, state)
    assert ens.temperature_control.time == 1
    state, _ = move.propose(model, state)
    assert ens.temperature_control.time == 2

    # a prevent_swaps move runs NO phase: the clock must not tick (a
    # phantom tick would scramble the deterministic parity alternation)
    noswap = StretchMove(
        temperature_control=ens.temperature_control, prevent_swaps=True
    )
    state, _ = noswap.propose(model, state)
    assert ens.temperature_control.time == 2


def test_deo_invalid_scheme():
    with pytest.raises(ValueError, match="swap_scheme"):
        TemperatureControl(betas=np.array([1.0, 0.5]), swap_scheme="seo")


def test_deo_end_to_end(priors):
    """A DEO-tempered run matches the cascade statistically: correct cold
    chain, adapted ladder, live swap traffic, parity clock advancing every
    step."""
    coords = priors.rvs(size=(NTEMPS, NWALKERS))
    runs = {}
    for scheme in ("cascade", "deo"):
        ens = EnsembleSampler(
            NWALKERS, NDIM, log_like, priors,
            tempering_kwargs=dict(ntemps=NTEMPS, swap_scheme=scheme),
            seed=31,
        )
        ens.run_mcmc(coords, 800, burn=300)
        runs[scheme] = ens

    for scheme, ens in runs.items():
        chain = ens.get_chain()["model_0"][:, 0].reshape(-1, NDIM)
        assert np.abs(chain.mean(axis=0)).max() < 0.15, scheme
        assert np.abs(chain.std(axis=0) - 1.0).max() < 0.1, scheme
        betas = ens.get_betas()
        assert not np.allclose(betas[0], betas[-1]), scheme
        # swap traffic on every boundary (DEO reports the per-phase
        # average: attempted phases alternate with skipped ones)
        frac = np.asarray(ens.backend.swaps_accepted, dtype=float) / max(
            ens.backend.iteration * NWALKERS, 1
        )
        assert frac.min() > 0.02, (scheme, frac)

    # cold-chain moments agree between the schemes
    c_c = runs["cascade"].get_chain()["model_0"][:, 0].reshape(-1, NDIM)
    c_d = runs["deo"].get_chain()["model_0"][:, 0].reshape(-1, NDIM)
    np.testing.assert_allclose(c_c.mean(0), c_d.mean(0), atol=0.12)
    np.testing.assert_allclose(c_c.std(0), c_d.std(0), atol=0.08)

    # DEO ticks the traced parity clock once per sampler step
    assert runs["deo"].temperature_control.time == 1100