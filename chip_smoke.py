#!/usr/bin/env python
"""Smoke run of the sampler's main path on NVIDIA GPUs.

Drives ``EnsembleSampler(...).run_mcmc`` through the public API at the
ensemble sizes Eryn users run, and checks every phase against analytic
truths or a plain reference:

1. ``north_star``: parallel tempering, 10 temperatures x 100 walkers on a
   5-D Gaussian, StretchMove, adaptive ladder, default backend.
2. ``rj_full_width``: reversible jump over 8 leaves with 8192-point pulse
   templates, 10 x 200, RedBlueGroupStretchMove.
3. ``config_e``: one compiled step and a short stored run at
   20 x 1000 x 8 leaves with RJ and group moves.
4. ``host_paths``: the host ``Backend``, a NumPy likelihood through the
   ``jax.pure_callback`` bridge, and a run split over two ``run_mcmc``
   calls against one uninterrupted run (bitwise).
5. ``kernels``: ``mask_cumsum`` against ``cumsum`` and the swap-cascade
   kernel against the XLA rung loop (both bitwise), and the full-precision
   density matmuls against float64 NumPy, at real widths.

With ``--four`` it runs only the sharded path on a (2, 2) (temp, walker)
mesh over four GPUs and its comparison with the unsharded step.

Usage::

    python chip_smoke.py            # one GPU
    python chip_smoke.py --four     # four GPUs

It exits non-zero, printing no result line, when JAX finds no GPU or any
check fails.  The last line of standard output is one JSON object::

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": 1}}

Rates printed on the way are smoke information, not a benchmark.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import warnings
from dataclasses import dataclass

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))


class SmokeFailure(RuntimeError):
    """A phase's check failed."""


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


@dataclass(frozen=True)
class Size:
    """Shapes and tolerances of one smoke configuration."""

    # phase 1: north star
    ns_ntemps: int
    ns_nwalkers: int
    ns_steps: int
    ns_burn: int
    ns_mean_tol: float
    ns_var_tol: float
    # phase 2: reversible jump
    rj_ntemps: int
    rj_nwalkers: int
    rj_nleaves: int
    rj_npts: int
    rj_steps: int
    rj_burn: int
    # phase 3: config E
    e_ntemps: int
    e_nwalkers: int
    e_nleaves: int
    e_steps: int
    # phase 4: host paths
    host_steps: int


#: the sizes Eryn users run (BASELINE.json configs; benchmarks/lisa_style.py)
#: (step counts are powers of two: each distinct segment length compiles)
FULL = Size(
    ns_ntemps=10, ns_nwalkers=100, ns_steps=4096, ns_burn=1024,
    ns_mean_tol=0.1, ns_var_tol=0.15,
    rj_ntemps=10, rj_nwalkers=200, rj_nleaves=8, rj_npts=8192,
    rj_steps=512, rj_burn=4096,
    e_ntemps=20, e_nwalkers=1000, e_nleaves=8, e_steps=64,
    host_steps=256,
)

#: the same phases at a size the CPU test suite runs in seconds
TINY = Size(
    ns_ntemps=4, ns_nwalkers=32, ns_steps=512, ns_burn=256,
    ns_mean_tol=0.35, ns_var_tol=0.45,
    rj_ntemps=4, rj_nwalkers=32, rj_nleaves=4, rj_npts=256,
    rj_steps=256, rj_burn=512,
    e_ntemps=4, e_nwalkers=40, e_nleaves=4, e_steps=4,
    host_steps=32,
)

NDIM = 5
SEED = 20260


# ----------------------------------------------------------------------
# phase 1: north star
# ----------------------------------------------------------------------
def _gaussian_sampler(ntemps, nwalkers, seed, backend=None):
    import jax.numpy as jnp

    from eryn_tpu import EnsembleSampler, ProbDistContainer, uniform_dist

    def log_like(x):
        return -0.5 * jnp.sum(x * x)

    priors = ProbDistContainer({i: uniform_dist(-5.0, 5.0) for i in range(NDIM)})
    sampler = EnsembleSampler(
        nwalkers,
        NDIM,
        log_like,
        priors,
        tempering_kwargs=dict(ntemps=ntemps),
        backend=backend,
        seed=seed,
    )
    return sampler, priors


def _check_north_star(sampler, betas0, size):
    """Cold-chain moments against N(0, I), acceptance, swaps, ladder."""
    chain = np.asarray(sampler.get_chain(temp_index=0)["model_0"])
    x = chain.reshape(-1, NDIM)
    check(np.isfinite(x).all(), "north_star: non-finite cold chain")
    mean = x.mean(axis=0)
    var = x.var(axis=0)
    check(
        np.abs(mean).max() < size.ns_mean_tol,
        f"north_star: cold mean {mean} not within {size.ns_mean_tol} of 0",
    )
    check(
        np.abs(var - 1.0).max() < size.ns_var_tol,
        f"north_star: cold variance {var} not within {size.ns_var_tol} of 1",
    )
    acc = float(np.mean(np.asarray(sampler.acceptance_fraction)[0]))
    check(0.2 < acc < 0.8, f"north_star: cold acceptance {acc}")
    swap = float(np.asarray(sampler.swap_acceptance_fraction)[0])
    check(0.05 < swap < 0.95, f"north_star: cold-rung swap acceptance {swap}")
    betas = np.asarray(sampler.get_betas())[-1]
    check(
        not np.allclose(betas, betas0),
        "north_star: the adaptive ladder did not move",
    )
    tau = np.asarray(sampler.get_autocorr_time()["model_0"])
    check(np.isfinite(tau).all(), f"north_star: autocorrelation time {tau}")
    return {
        "cold_mean_max_abs": float(np.abs(mean).max()),
        "cold_var_max_dev": float(np.abs(var - 1.0).max()),
        "cold_acceptance": acc,
        "cold_swap_acceptance": swap,
        "tau_max": float(np.max(tau)),
    }


def phase_north_star(size):
    import jax

    from eryn_tpu import DeviceBackend

    sampler, priors = _gaussian_sampler(size.ns_ntemps, size.ns_nwalkers, SEED)
    if jax.devices()[0].platform == "gpu":
        check(
            isinstance(sampler.backend, DeviceBackend),
            f"north_star: default backend is {type(sampler.backend).__name__}",
        )
    betas0 = np.array(sampler.temperature_control.betas, dtype=float)
    coords = priors.rvs(size=(size.ns_ntemps, size.ns_nwalkers))
    sampler.run_mcmc(coords, size.ns_steps, burn=size.ns_burn)
    info = _check_north_star(sampler, betas0, size)
    info["backend"] = type(sampler.backend).__name__
    return info, size.ns_steps + size.ns_burn


# ----------------------------------------------------------------------
# phase 2: reversible jump at full width
# ----------------------------------------------------------------------
#: injected pulses (amplitude, centre, width)
PULSES = ((3.0, 3.0, 0.5), (2.0, 7.0, 0.4))
RJ_SIGMA = 1.0


def _pulse_data(npts, seed):
    t = np.linspace(0.0, 10.0, npts)
    signal = sum(a * np.exp(-((t - b) ** 2) / (2 * c**2)) for a, b, c in PULSES)
    noise = RJ_SIGMA * np.random.default_rng(seed).standard_normal(npts)
    return t, signal + noise


def _pulse_fisher_sigma(t, a, b, c):
    """Cramer-Rao standard deviations of one isolated pulse's
    ``(a, b, c)`` in white noise of ``RJ_SIGMA`` on the grid ``t``."""
    g = np.exp(-((t - b) ** 2) / (2 * c**2))
    jac = np.stack([g, a * g * (t - b) / c**2, a * g * (t - b) ** 2 / c**3], 1)
    fisher = jac.T @ jac / RJ_SIGMA**2
    return np.sqrt(np.diag(np.linalg.inv(fisher)))


def phase_rj_full_width(size):
    import jax.numpy as jnp

    from eryn_tpu import EnsembleSampler, ProbDistContainer, State, uniform_dist
    from eryn_tpu.moves import RedBlueGroupStretchMove

    t_np, data_np = _pulse_data(size.rj_npts, SEED)
    t = jnp.asarray(t_np, jnp.float32)
    data = jnp.asarray(data_np, jnp.float32)

    def log_like(coords, inds):
        a, b, c = coords[:, 0], coords[:, 1], coords[:, 2]
        p = a[:, None] * jnp.exp(-((t[None] - b[:, None]) ** 2) / (2 * c[:, None] ** 2))
        tmpl = jnp.sum(jnp.where(inds[:, None], p, 0.0), axis=0)
        return -0.5 * jnp.sum(((tmpl - data) / RJ_SIGMA) ** 2)

    priors = ProbDistContainer(
        {0: uniform_dist(0.5, 5.0), 1: uniform_dist(0.0, 10.0), 2: uniform_dist(0.1, 2.0)}
    )
    nt, nw, nl = size.rj_ntemps, size.rj_nwalkers, size.rj_nleaves
    sampler = EnsembleSampler(
        nw,
        3,
        log_like,
        priors,
        nleaves_max=nl,
        nleaves_min=0,
        moves=RedBlueGroupStretchMove(),
        rj_moves=True,
        tempering_kwargs=dict(ntemps=nt),
        fill_zero_leaves_val=float(-0.5 * np.sum((data_np / RJ_SIGMA) ** 2)),
        seed=SEED + 1,
    )
    coords = priors.rvs(size=(nt, nw, nl))
    inds = np.random.default_rng(SEED + 2).random((nt, nw, nl)) < 0.4
    sampler.run_mcmc(
        State({"model_0": coords}, inds={"model_0": inds}),
        size.rj_steps,
        burn=size.rj_burn,
    )

    log_like_chain = np.asarray(sampler.get_log_like())
    check(np.isfinite(log_like_chain).all(), "rj: non-finite log-likelihoods")
    nleaves = np.asarray(sampler.get_nleaves()["model_0"])[:, 0].ravel()
    counts = np.bincount(nleaves, minlength=nl + 1)
    mode = int(np.argmax(counts))
    check(
        mode == len(PULSES),
        f"rj: leaf-count mode {mode} != injected {len(PULSES)} ({counts})",
    )
    # active leaves of the cold walkers holding the injected count, sorted
    # by centre (leaves are exchangeable)
    chain = np.asarray(sampler.get_chain(temp_index=0)["model_0"])
    cold_inds = np.asarray(sampler.get_inds(temp_index=0)["model_0"])
    sel = cold_inds.sum(axis=-1) == len(PULSES)
    leaves = chain[sel][cold_inds[sel]].reshape(-1, len(PULSES), 3)
    leaves = np.take_along_axis(
        leaves, np.argsort(leaves[..., 1], axis=1)[..., None], axis=1
    )
    medians = np.median(leaves, axis=0)
    truth = np.array(sorted(PULSES, key=lambda p: p[1]))
    sigmas = np.array([_pulse_fisher_sigma(t_np, *p) for p in truth])
    z = np.abs(medians - truth) / sigmas
    check(
        (z < 5.0).all(),
        f"rj: active-leaf medians {medians.tolist()} more than 5 Fisher "
        f"sigmas {sigmas.tolist()} from {truth.tolist()}",
    )
    info = {
        "leaf_count_posterior": (counts / counts.sum()).round(4).tolist(),
        "median_leaf_params": medians.round(4).tolist(),
        "median_offset_in_fisher_sigmas": z.round(2).tolist(),
        "rj_acceptance": float(np.mean(np.asarray(sampler.rj_acceptance_fraction)[0])),
    }
    return info, size.rj_steps + size.rj_burn


# ----------------------------------------------------------------------
# phase 3: config E
# ----------------------------------------------------------------------
def _config_e_sampler(size, seed, backend=None):
    import jax.numpy as jnp

    from eryn_tpu import EnsembleSampler, ProbDistContainer, State, uniform_dist
    from eryn_tpu.moves import GroupStretchMove

    t = jnp.linspace(0.0, 10.0, 128)
    data = jnp.zeros(128)

    def log_like(coords, inds):
        a, b, c = coords[:, 0], coords[:, 1], coords[:, 2]
        p = a[:, None] * jnp.exp(-((t[None] - b[:, None]) ** 2) / (2 * c[:, None] ** 2))
        tmpl = jnp.sum(jnp.where(inds[:, None], p, 0.0), axis=0)
        return -0.5 * jnp.sum((tmpl - data) ** 2)

    priors = ProbDistContainer(
        {0: uniform_dist(0.5, 5.0), 1: uniform_dist(0.0, 10.0), 2: uniform_dist(0.1, 2.0)}
    )
    nt, nw, nl = size.e_ntemps, size.e_nwalkers, size.e_nleaves
    sampler = EnsembleSampler(
        nw,
        3,
        log_like,
        priors,
        nleaves_max=nl,
        nleaves_min=0,
        moves=[GroupStretchMove(n_iter_update=3)],
        rj_moves=True,
        tempering_kwargs=dict(ntemps=nt),
        fill_zero_leaves_val=-1e4,
        backend=backend,
        seed=seed,
    )
    coords = priors.rvs(size=(nt, nw, nl))
    inds = np.random.default_rng(seed).random((nt, nw, nl)) < 0.4
    state = sampler._setup_state(State({"model_0": coords}, inds={"model_0": inds}))
    return sampler, state


def _compiled_step(sampler, state):
    """One jitted sampler step (proposal, accept, RJ, swaps), compiled."""
    import jax
    import jax.numpy as jnp

    one_step = sampler._make_one_step()

    def step(key, state, t):
        carry = sampler.initial_step_carry(key, state, t)
        carry, _ = one_step(carry, None)
        return carry[1]

    args = (sampler._key, state, jnp.zeros((), jnp.int32))
    return jax.jit(step).lower(*args).compile(), args


def phase_config_e(size):
    import jax

    sampler, state = _config_e_sampler(size, SEED + 3)
    compiled, args = _compiled_step(sampler, state)
    mem = compiled.memory_analysis()
    new_state = compiled(*args)
    check(
        bool(np.isfinite(np.asarray(new_state.log_like)).all()),
        "config_e: non-finite log-likelihood after one step",
    )
    sampler.run_mcmc(state, size.e_steps)
    ll = np.asarray(sampler.get_log_like())
    shape = (size.e_steps, size.e_ntemps, size.e_nwalkers)
    check(ll.shape == shape, f"config_e: stored log_like {ll.shape} != {shape}")
    check(np.isfinite(ll).all(), "config_e: non-finite stored log-likelihoods")
    info = {
        "memory_analysis": {
            k: getattr(mem, k, None)
            for k in (
                "argument_size_in_bytes",
                "output_size_in_bytes",
                "temp_size_in_bytes",
                "generated_code_size_in_bytes",
            )
        }
        if mem is not None
        else None,
        "state_bytes": int(
            sum(x.size * x.dtype.itemsize for x in jax.tree_util.tree_leaves(state))
        ),
    }
    return info, size.e_steps + 1


# ----------------------------------------------------------------------
# phase 4: host paths
# ----------------------------------------------------------------------
def phase_host_paths(size):
    from eryn_tpu import Backend, EnsembleSampler, ProbDistContainer, uniform_dist

    nt, nw, n = size.ns_ntemps, size.ns_nwalkers, size.host_steps
    info = {}

    # the host Backend: the chain is flushed to NumPy per segment
    sampler, priors = _gaussian_sampler(nt, nw, SEED + 4, backend=Backend())
    sampler.run_mcmc(priors.rvs(size=(nt, nw)), n, burn=n)
    chain = np.asarray(sampler.get_chain()["model_0"])
    check(chain.shape == (n, nt, nw, 1, NDIM), f"host_paths: chain {chain.shape}")
    check(np.isfinite(chain).all(), "host_paths: non-finite host-backend chain")
    acc = float(np.mean(np.asarray(sampler.acceptance_fraction)[0]))
    check(0.2 < acc < 0.8, f"host_paths: host-backend cold acceptance {acc}")
    info["host_backend_acceptance"] = acc

    # a NumPy likelihood the user cannot port: the pure_callback bridge
    def np_like(x):
        return -0.5 * float(np.sum(np.asarray(x, dtype=np.float64) ** 2))

    pr2 = ProbDistContainer({i: uniform_dist(-5.0, 5.0) for i in range(2)})
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        cb = EnsembleSampler(
            16, 2, np_like, pr2, tempering_kwargs=dict(ntemps=2), seed=SEED + 5
        )
    check(cb._like_eval.mode == "callback", f"host_paths: mode {cb._like_eval.mode}")
    check(
        any("not JAX-traceable" in str(w.message) for w in caught),
        "host_paths: no callback-bridge warning",
    )
    cb.run_mcmc(pr2.rvs(size=(2, 16)), 64)
    cb_chain = np.asarray(cb.get_chain()["model_0"])
    cb_ll = np.asarray(cb.get_log_like())
    check(np.isfinite(cb_chain).all(), "host_paths: non-finite callback chain")
    expect = -0.5 * np.sum(cb_chain.astype(np.float64) ** 2, axis=(-2, -1))
    check(
        np.allclose(cb_ll, expect, rtol=1e-5, atol=1e-5),
        "host_paths: callback log-likelihoods disagree with the NumPy function",
    )
    info["callback_acceptance"] = float(np.mean(np.asarray(cb.acceptance_fraction)))

    # resume contract: two run_mcmc calls continue one uninterrupted run
    # bit for bit (default backend: DeviceBackend on an accelerator)
    coords = priors.rvs(size=(nt, nw))
    one, _ = _gaussian_sampler(nt, nw, SEED + 6)
    one.run_mcmc(coords, 2 * n)
    two, _ = _gaussian_sampler(nt, nw, SEED + 6)
    two.run_mcmc(coords, n)
    two.run_mcmc(None, n)
    for getter in ("get_chain", "get_inds"):
        a = getattr(one, getter)()["model_0"]
        b = getattr(two, getter)()["model_0"]
        check(np.array_equal(a, b), f"host_paths: split run differs in {getter}")
    for getter in ("get_log_like", "get_log_prior", "get_betas"):
        a, b = getattr(one, getter)(), getattr(two, getter)()
        check(np.array_equal(a, b), f"host_paths: split run differs in {getter}")
    info["split_run_bitwise"] = True
    info["split_run_backend"] = type(one.backend).__name__
    return info, 3 * n + 64 + 2 * n


# ----------------------------------------------------------------------
# phase 5: kernels and precision at real widths
# ----------------------------------------------------------------------
def _max_rel(got, want):
    got = np.asarray(got, dtype=np.float64)
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1.0)))


def precision_sites(size, seed=SEED):
    """Each full-precision density matmul on the device against float64
    NumPy; returns ``{site: max relative error}``."""
    import jax
    import jax.numpy as jnp

    from eryn_tpu.moves import GaussianMove, KDEMove, WalkMove
    from eryn_tpu.prior import MultivariateNormalDistribution

    rng = np.random.default_rng(seed)
    nt, nw = size.rj_ntemps, size.rj_nwalkers
    out = {}

    # multivariate-normal prior logpdf
    d = 6
    a = rng.standard_normal((d, d))
    cov = a @ a.T + d * np.eye(d)
    mean = rng.standard_normal(d)
    mvn = MultivariateNormalDistribution(mean, cov)
    x = mean + 3.0 * rng.standard_normal((nt * nw, d))
    diff = x - mean
    maha = np.einsum("ni,ij,nj->n", diff, np.linalg.inv(cov), diff)
    want = -0.5 * (maha + d * np.log(2 * np.pi) + np.linalg.slogdet(cov)[1])
    got = jax.jit(mvn.logpdf)(jnp.asarray(x, jnp.float32))
    out["prior_mvn_logpdf"] = _max_rel(got, want)

    # KDE log density (enters the KDE move's Hastings factors)
    ns, nc = nw // 2, nw - nw // 2
    xk = rng.standard_normal((nt, ns, d))
    ker = rng.standard_normal((nt, nc, d))
    w = rng.standard_normal((nt, d, d)) * 0.3 + np.eye(d)
    logdet = rng.standard_normal(nt)
    xw, kw = np.einsum("tmd,tde->tme", xk, w), np.einsum("tnd,tde->tne", ker, w)
    maha = ((xw[:, :, None, :] - kw[:, None, :, :]) ** 2).sum(-1)
    logk = -0.5 * maha - 0.5 * logdet[:, None, None] - 0.5 * d * np.log(2 * np.pi)
    m = logk.max(-1, keepdims=True)
    want = (m[..., 0] + np.log(np.exp(logk - m).sum(-1))) - np.log(nc)
    f32 = lambda v: jnp.asarray(v, jnp.float32)  # noqa: E731
    got = jax.jit(KDEMove()._kde_logpdf, static_argnums=4)(
        f32(xk), f32(ker), f32(w), f32(logdet), d
    )
    out["kde_logpdf"] = _max_rel(got, want)

    # Gaussian proposal with a full covariance: dx = noise @ chol.T
    cov_g = a @ a.T / d + np.eye(d)
    move = GaussianMove({"model_0": cov_g})
    coords = rng.standard_normal((nt, nw, 1, d))
    key = jax.random.PRNGKey(seed)
    q, _, _ = move.get_proposal_kernel(
        key, {"model_0": f32(coords)}, {"model_0": jnp.ones((nt, nw, 1), bool)}, {}
    )
    noise = np.asarray(
        jax.random.normal(jax.random.split(key, 2)[0], coords.shape, jnp.float32),
        dtype=np.float64,
    )
    want = coords + noise @ np.linalg.cholesky(cov_g).T
    out["gaussian_proposal"] = _max_rel(q["model_0"], want)

    # walk move: q = s + scale * z @ (c - mean(c))
    walk = WalkMove()
    s = rng.standard_normal((nt, ns, 1, d))
    c = rng.standard_normal((nt, nc, 1, d)) * 5.0 + 10.0
    q, _ = walk.get_proposal_kernel(
        key, {"model_0": f32(s)}, {"model_0": f32(c)},
        {"model_0": jnp.ones((nt, ns, 1), bool)},
    )
    kz, _ = jax.random.split(jax.random.split(key, 1)[0])
    z = np.asarray(jax.random.normal(kz, (nt, ns, nc), jnp.float32), np.float64)
    flat = c.reshape(nt, nc, d)
    dev = flat - flat.mean(axis=1, keepdims=True)
    want = s + (np.einsum("tsc,tcd->tsd", z, dev) * nc**-0.5).reshape(s.shape)
    out["walk_proposal"] = _max_rel(q["model_0"], want)
    return out


#: float32 with full-precision matmul passes stays well inside this; a
#: TF32 (10-bit mantissa) pass misses it by two orders of magnitude
PRECISION_RTOL = 1e-5


def phase_kernels(size):
    import jax
    import jax.numpy as jnp

    from eryn_tpu.ops.select_kernels import mask_cumsum

    info = {}
    rng = np.random.default_rng(SEED)
    widths = {
        "rj": (size.rj_ntemps, (size.rj_nwalkers // 2) * size.rj_nleaves),
        "config_e": (size.e_ntemps, (size.e_nwalkers // 2) * size.e_nleaves),
    }
    for name, (nt, width) in widths.items():
        m = (rng.random((nt, width)) < 0.4).astype(np.float32)
        got = np.asarray(jax.jit(mask_cumsum)(jnp.asarray(m)))
        ref = np.asarray(jax.jit(lambda v: jnp.cumsum(v, axis=-1))(jnp.asarray(m)))
        check(
            np.array_equal(got, ref) and np.array_equal(got, np.cumsum(m, -1)),
            f"kernels: mask_cumsum differs from cumsum at {(nt, width)}",
        )
        info[f"mask_cumsum_{name}_shape"] = [nt, width]

    # the single-launch swap cascade against the XLA rung loop: selects
    # only (f32 compare, no matmul), so the two must agree bit for bit
    from eryn_tpu.moves.tempering import cascade_draws, cascade_provenance, make_ladder
    from eryn_tpu.ops.swap_cascade import swap_cascade

    interpret = jax.devices()[0].platform != "gpu"
    shapes = [
        (size.ns_ntemps, size.ns_nwalkers),
        (size.e_ntemps, size.e_nwalkers),
        (7, 333),
    ]
    for k, (nt, nw) in enumerate(shapes):
        betas = jnp.asarray(make_ladder(NDIM, ntemps=nt), jnp.float32)
        logl = jnp.asarray(rng.standard_normal((nt, nw)) * 5.0, jnp.float32)
        perms, inv_perms, raccept = cascade_draws(
            jax.random.PRNGKey(k), nt, nw, jnp.float32
        )
        want = cascade_provenance(logl, betas, perms, inv_perms, raccept)
        got = swap_cascade(
            logl, betas[:-1] - betas[1:], perms, raccept, interpret=interpret
        )
        check(
            all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in zip(want, got)),
            f"kernels: swap cascade kernel differs from the XLA loop at {(nt, nw)}",
        )
        check(float(np.asarray(want[2]).sum()) > 0, f"kernels: no swaps at {(nt, nw)}")
    info["swap_cascade_bitwise_shapes"] = shapes

    errs = precision_sites(size)
    info["precision_max_rel_err"] = errs
    bad = {k: v for k, v in errs.items() if not v < PRECISION_RTOL}
    check(not bad, f"kernels: float32 density sites off float64 by {bad}")
    return info, 0


PHASES = (
    ("north_star", phase_north_star),
    ("rj_full_width", phase_rj_full_width),
    ("config_e", phase_config_e),
    ("host_paths", phase_host_paths),
    ("kernels", phase_kernels),
)


# ----------------------------------------------------------------------
# --four: the sharded path
# ----------------------------------------------------------------------
def _tree_max_diff(a, b):
    """Largest relative difference ``|x - y| / max(|y|, 1)`` over the float
    leaves of two pytrees; a mismatching bool leaf counts its mismatches."""
    import jax

    diffs = [0.0]
    for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
        x, y = np.asarray(x), np.asarray(y)
        check(x.shape == y.shape, f"four: leaf shapes {x.shape} vs {y.shape}")
        if x.dtype == bool:
            diffs.append(float(np.sum(x != y)))
        elif x.size:
            y = y.astype(np.float64)
            diffs.append(float(np.max(np.abs(x - y) / np.maximum(np.abs(y), 1.0))))
    return max(diffs)


#: sharded and unsharded steps compute the same draws and the same math;
#: partitioning may only reorder float32 reductions (a few ulps)
SHARDED_RTOL = 1e-5


def phase_four(size, n_devices=4):
    import jax

    from eryn_tpu import DeviceBackend
    from eryn_tpu.parallel.mesh import make_mesh, shard_state

    mesh = make_mesh(n_devices)
    check(
        dict(mesh.shape) == {"temp": 2, "walker": 2},
        f"four: mesh {dict(mesh.shape)}",
    )
    info = {"mesh": dict(mesh.shape)}

    def ns_setup(seed):
        s, pr = _gaussian_sampler(size.ns_ntemps, size.ns_nwalkers, seed)
        return s, s._setup_state(pr.rvs(size=(size.ns_ntemps, size.ns_nwalkers)))

    for name, setup in (
        ("north_star", ns_setup),
        ("config_e", lambda seed: _config_e_sampler(size, seed)),
    ):
        # prior draws come from NumPy's global stream: same seed, same state
        np.random.seed(SEED + 7)
        plain, st_plain = setup(SEED + 7)
        np.random.seed(SEED + 7)
        sharded, st_sharded = setup(SEED + 7)
        st_sharded = shard_state(st_sharded, mesh)
        out_plain, _ = plain._run_bulk(st_plain, 1, 1, store=False)
        out_sharded, _ = sharded._run_bulk(st_sharded, 1, 1, store=False)
        check(
            len(out_sharded.log_like.sharding.device_set) == n_devices,
            f"four: {name} step left the mesh",
        )
        diff = _tree_max_diff(out_plain, out_sharded)
        check(diff <= SHARDED_RTOL, f"four: {name} sharded step differs by {diff}")
        info[f"{name}_sharded_vs_unsharded_max_rel_diff"] = diff

    # a multi-segment stored run on the mesh passes phase 1's checks, and
    # every stored buffer spans the mesh
    sampler, priors = _gaussian_sampler(
        size.ns_ntemps, size.ns_nwalkers, SEED + 8, backend=DeviceBackend()
    )
    betas0 = np.array(sampler.temperature_control.betas, dtype=float)
    state = shard_state(
        sampler._setup_state(priors.rvs(size=(size.ns_ntemps, size.ns_nwalkers))),
        mesh,
    )
    seg = size.ns_steps // 4
    sampler.run_mcmc(state, size.ns_steps, burn=size.ns_burn, segment_size=seg)
    segs = sampler.backend._segs
    check(len(segs) >= 4, f"four: {len(segs)} stored segments")
    # the packed per-step buffers as the sampler emitted them, then the
    # per-step fields a reader unpacks from them (without reversible jump
    # the leaf mask is one static host constant, not a per-step buffer)
    spans = {
        name: {len(x.sharding.device_set) for x in jax.tree_util.tree_leaves(leaves)}
        for name, leaves in (
            ("packed", [s._packed for s in segs]),
            (
                "unpacked",
                [(s["chain"], s["log_like"], s["log_prior"]) for s in segs],
            ),
        )
    }
    check(
        all(v == {n_devices} for v in spans.values()),
        f"four: stored buffers span {spans} devices",
    )
    info["stored_segments"] = len(segs)
    info["stored_buffers_span_devices"] = {k: sorted(v) for k, v in spans.items()}
    info.update(_check_north_star(sampler, betas0, size))
    return info, size.ns_steps + size.ns_burn + 2


# ----------------------------------------------------------------------
# driver
# ----------------------------------------------------------------------
class _CompileClock:
    """Sums XLA backend compile time reported by JAX's monitoring events."""

    def __init__(self):
        import jax

        self.seconds = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event, duration, **kwargs):
        if event == "/jax/core/compile/backend_compile_duration":
            self.seconds += duration


def run_phase(name, fn, size, clock):
    """Run one phase, print its line, and return its info dict."""
    import jax

    np.random.seed(SEED)
    c0, t0 = clock.seconds, time.perf_counter()
    info, steps = fn(size)
    wall = time.perf_counter() - t0
    compile_s = clock.seconds - c0
    stats = jax.devices()[0].memory_stats() or {}
    line = {
        "wall_s": round(wall, 3),
        "compile_s": round(compile_s, 3),
        # smoke information, not a benchmark: steps over wall minus compile
        "smoke_steps_per_s": round(steps / max(wall - compile_s, 1e-9), 1)
        if steps
        else None,
        "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
        **info,
    }
    print(f"phase {name}: {json.dumps(line, default=str)}", flush=True)
    return line


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument(
        "--four",
        action="store_true",
        help="run only the sharded path on four GPUs and its comparison",
    )
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(
            f"chip_smoke: no GPU (JAX found {devices[0].platform}); nothing run",
            file=sys.stderr,
        )
        return 1
    n_needed = 4 if args.four else 1
    if len(devices) < n_needed:
        print(f"chip_smoke: needs {n_needed} GPUs, found {len(devices)}", file=sys.stderr)
        return 1

    from eryn_tpu.compile_cache import use_compile_cache

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
        check=True,
    )
    for line in smi.stdout.strip().splitlines():
        print(f"nvidia-smi: {line.strip()}", flush=True)
    print(
        f"jax {jax.__version__}, jaxlib {jax.lib.__version__}, "
        f"compile cache {use_compile_cache(ROOT)}",
        flush=True,
    )

    clock = _CompileClock()
    phases = (("four", phase_four),) if args.four else PHASES
    for name, fn in phases:
        run_phase(name, fn, FULL, clock)

    dev = jax.devices()[0]
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": dev.platform,
                    "kind": dev.device_kind,
                    "count": len(jax.devices()),
                },
            }
        ),
        flush=True,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
