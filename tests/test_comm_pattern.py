"""Multi-chip COMMUNICATION PATTERN proof (not just the answer).

``test_sharding.py`` proves a sharded run is statistically equivalent to an
unsharded one — but GSPMD could satisfy that by all-gathering the whole
``(ntemps, nwalkers, nleaves, ndim)`` ensemble every step.  These tests
compile the sharded bulk step on the 8-virtual-device mesh and assert on
the collective ops in the per-device HLO itself:

* the temperature-swap phase crosses devices as collective-permutes of
  adjacent rung payload rows (the traffic that maps the reference's swap
  loop, ref ``tempering.py:515-559``), bounded by a small multiple of one
  swap-phase payload;
* NO all-gather / all-reduce of the full coords tensor exists anywhere in
  the compiled module — the silent-regression mode this suite exists to
  catch.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from eryn_tpu import EnsembleSampler, ProbDistContainer, uniform_dist
from eryn_tpu.parallel.comm_audit import audit_sampler_comm
from eryn_tpu.parallel.mesh import make_mesh, shard_state

NDIM = 8
NWALKERS = 64


def _sampler(ntemps, **tk_extra):
    priors = ProbDistContainer(
        {i: uniform_dist(-5, 5) for i in range(NDIM)}
    )
    ens = EnsembleSampler(
        NWALKERS,
        NDIM,
        lambda x: -0.5 * jnp.sum(x**2),
        priors,
        tempering_kwargs=dict(ntemps=ntemps, **tk_extra),
        seed=7,
    )
    return ens, priors


def _audit(ntemps, mesh, **tk_extra):
    ens, priors = _sampler(ntemps, **tk_extra)
    state = ens._setup_state(priors.rvs(size=(ntemps, NWALKERS)))
    state = shard_state(state, mesh)
    return audit_sampler_comm(ens, state)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
def test_cascade_swap_traffic_is_boundary_local():
    """Fully temp-sharded mesh (one rung per device): within-rung moves are
    device-local, so ALL cross-device traffic is the swap phase.  The
    stochastic cascade must ride permutation collectives, never a
    data-dependent gather that all-gathers the ensemble."""
    audit = _audit(8, make_mesh(8, temp_parallel=8))
    assert audit["big_gathers"] == [], audit
    # boundary-local rung exchanges: permutes dominate, and the per-device
    # step traffic stays within a small multiple of ONE swap-phase payload
    # (coords + log_like + log_prior; measured ~1.8x — rows cross in both
    # directions plus walker-permutation index traffic)
    assert "collective-permute" in audit["per_op"], audit
    assert audit["total_bytes"] <= 2.5 * audit["payload_bytes"], audit


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
def test_deo_swap_traffic_is_one_parity_phase():
    """DEO's disjoint parity pairs are three shifted selects — O(1) phases
    whose lowering is pure adjacent-rung collective-permutes, cheaper than
    one full swap payload per step."""
    audit = _audit(8, make_mesh(8, temp_parallel=8), swap_scheme="deo")
    assert audit["big_gathers"] == [], audit
    assert "collective-permute" in audit["per_op"], audit
    assert audit["total_bytes"] <= 1.0 * audit["payload_bytes"], audit
    # a parity phase reduces nothing globally: no all-reduce traffic beyond
    # scalar diagnostics
    ar = audit["per_op"].get("all-reduce", {"bytes": 0})
    assert ar["bytes"] <= 0.05 * audit["payload_bytes"], audit


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
def test_standard_mesh_never_allgathers_full_ensemble():
    """The default (temp=2, walker=4) mesh: red/blue complement selection
    legitimately crosses walker shards (half-ensemble gathers are the
    algorithm's real data dependence), but nothing may move the FULL
    coords tensor through one all-gather/all-reduce."""
    audit = _audit(4, make_mesh(8))
    assert audit["big_gathers"] == [], audit
    # with the walker axis sharded 4-ways, each device must see the
    # complement half (~1x coords) plus boundary exchanges and walker
    # permutation traffic (measured ~2.5x payload); 4x still fails the
    # all-gather-everything regression (~n_devices x shard per step)
    assert audit["total_bytes"] <= 4.0 * audit["payload_bytes"], audit


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
def test_rj_deo_mesh_traffic_bounded():
    """RJ (leaf-mask flips ride the swap tree) + DEO over the mesh: masks
    add u8/pred channels to the swap payload; the traffic bound holds."""
    ndim, nlmax, ntemps = 3, 2, 8
    pr = ProbDistContainer({i: uniform_dist(-5, 5) for i in range(ndim)})

    def ll(coords, inds):
        contrib = -0.5 * jnp.sum(coords**2, axis=-1)
        return jnp.sum(jnp.where(inds, contrib, 0.0))

    ens = EnsembleSampler(
        NWALKERS,
        ndim,
        ll,
        pr,
        nleaves_max=nlmax,
        nleaves_min=0,
        rj_moves=True,
        tempering_kwargs=dict(ntemps=ntemps, swap_scheme="deo"),
        fill_zero_leaves_val=-1e4,
        seed=9,
    )
    from eryn_tpu import State

    coords = pr.rvs(size=(ntemps, NWALKERS, nlmax))
    inds = np.random.default_rng(2).random((ntemps, NWALKERS, nlmax)) < 0.5
    state = ens._setup_state(State({"model_0": coords}, inds={"model_0": inds}))
    state = shard_state(state, make_mesh(8, temp_parallel=8))
    audit = audit_sampler_comm(ens, state)
    assert audit["big_gathers"] == [], audit
    # masks + two proposal phases (in-model + RJ) double the phase count
    assert audit["total_bytes"] <= 3.0 * audit["payload_bytes"], audit


def test_boundary_cascade_bitwise_matches_provenance_cascade():
    """The sharded boundary-local cascade consumes the same PRNG stream and
    applies the same exchanges as the provenance+gather formulation — the
    results must match BITWISE, so every statistical test of the cascade
    covers both."""
    from eryn_tpu.moves.tempering import TemperatureControl

    nt, nw, nd = 6, 32, 4
    rng = np.random.default_rng(0)
    betas0 = np.geomspace(1, 1e-2, nt)
    tc = TemperatureControl(betas=betas0, nwalkers=nw)
    key = jax.random.key(5)
    logl = jnp.asarray(rng.standard_normal((nt, nw)).astype(np.float32))
    tree = {
        "c": jnp.asarray(
            rng.standard_normal((nt, nw, 2, nd)).astype(np.float32)
        ),
        "lp": jnp.asarray(rng.standard_normal((nt, nw)).astype(np.float32)),
        "m": jnp.asarray(rng.random((nt, nw, 2)) < 0.5),
    }
    betas = jnp.asarray(betas0.astype(np.float32))

    tc.sharding_active = False
    t1, l1, a1, p1 = tc.swap_kernel(key, tree, logl, betas)
    tc.sharding_active = True
    t2, l2, a2, p2 = tc.swap_kernel(key, tree, logl, betas)
    for k in tree:
        assert np.array_equal(np.asarray(t1[k]), np.asarray(t2[k])), k
    assert np.array_equal(np.asarray(l1), np.asarray(l2))
    assert np.array_equal(np.asarray(a1), np.asarray(a2))
    assert np.array_equal(np.asarray(p1), np.asarray(p2))
    # something actually swapped (the comparison is not vacuous)
    assert float(np.asarray(a1).sum()) > 0
