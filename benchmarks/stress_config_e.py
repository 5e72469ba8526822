"""Config E stress benchmark (BASELINE configs[4]): LISA-style scale,
ntemps=20 x nwalkers=1000, reversible jump + group moves.

Run: python benchmarks/stress_config_e.py
Prints JSON lines with throughput for the stress configurations.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np
import jax
import jax.numpy as jnp

from eryn_tpu import EnsembleSampler, ProbDistContainer, State, uniform_dist
from eryn_tpu.moves import GroupStretchMove, StretchMove


def bench(label, make_sampler, make_state, nsteps=500):
    ens = make_sampler()
    state = make_state(ens)
    state, _ = ens._run_bulk(state, 1, nsteps, store=False)  # compile + warm
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        state, _ = ens._run_bulk(state, 1, nsteps, store=False)
        jax.block_until_ready(state.log_like)
        times.append(time.perf_counter() - t0)
    sps = nsteps / min(times)
    walkers = ens.ntemps * ens.nwalkers
    print(
        json.dumps(
            {
                "metric": label,
                "value": round(sps, 1),
                "unit": "steps/s",
                "walker_steps_per_sec": round(sps * walkers, 0),
            }
        )
    )
    return sps


NDIM = 5
NT, NW = 20, 1000


def main():
    from eryn_tpu.compile_cache import use_compile_cache

    use_compile_cache(ROOT)
    priors = ProbDistContainer({i: uniform_dist(-5, 5) for i in range(NDIM)})

    def ll_simple(x):
        return -0.5 * jnp.sum(x**2)

    def make_pt():
        return EnsembleSampler(
            NW, NDIM, ll_simple, priors,
            tempering_kwargs=dict(ntemps=NT), seed=0,
        )

    bench(
        "stress_pt_nt20_nw1000_d5",
        make_pt,
        lambda ens: ens._setup_state(priors.rvs(size=(NT, NW))),
    )

    # non-reversible (DEO) swap phase at the same scale: the O(1)-depth
    # parity exchange replaces the 20-rung sequential cascade — measures
    # how much of the PT epilogue the swap scheme buys back
    def make_pt_deo():
        return EnsembleSampler(
            NW, NDIM, ll_simple, priors,
            tempering_kwargs=dict(ntemps=NT, swap_scheme="deo"), seed=0,
        )

    bench(
        "stress_pt_deo_nt20_nw1000_d5",
        make_pt_deo,
        lambda ens: ens._setup_state(priors.rvs(size=(NT, NW))),
    )

    # RJ + group stretch at scale: variable pulse count
    t_np = np.linspace(0, 10, 64)
    sigma = 0.4
    rng = np.random.default_rng(0)
    data_np = 3.0 * np.exp(-((t_np - 5.0) ** 2) / (2 * 0.7**2))
    data_np = data_np + sigma * rng.standard_normal(len(t_np))
    t, data = jnp.asarray(t_np), jnp.asarray(data_np)

    def ll_rj(coords, inds):
        a, b, c = coords[:, 0], coords[:, 1], coords[:, 2]
        p = a[:, None] * jnp.exp(
            -((t[None] - b[:, None]) ** 2) / (2 * c[:, None] ** 2)
        )
        tmpl = jnp.sum(jnp.where(inds[:, None], p, 0.0), axis=0)
        return -0.5 * jnp.sum(((tmpl - data) / sigma) ** 2)

    pr_rj = ProbDistContainer(
        {
            0: uniform_dist(0.5, 5.0),
            1: uniform_dist(0.0, 10.0),
            2: uniform_dist(0.2, 2.0),
        }
    )
    nlmax = 4

    def make_rj():
        return EnsembleSampler(
            NW, 3, ll_rj, pr_rj,
            nleaves_max=nlmax, nleaves_min=0, rj_moves=True,
            moves=[GroupStretchMove(n_iter_update=50, live_dangerously=True)],
            tempering_kwargs=dict(ntemps=NT),
            fill_zero_leaves_val=float(-0.5 * np.sum((data_np / sigma) ** 2)),
            seed=1,
        )

    def make_rj_state(ens):
        coords = pr_rj.rvs(size=(NT, NW, nlmax))
        inds = np.random.default_rng(3).random((NT, NW, nlmax)) < 0.5
        return ens._setup_state(State({"model_0": coords}, inds={"model_0": inds}))

    bench("stress_rj_group_nt20_nw1000", make_rj, make_rj_state, nsteps=200)


if __name__ == "__main__":
    main()
