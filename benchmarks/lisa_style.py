"""Compute-bound likelihood benchmark: the regime LISA-style users run.

The 5-D Gaussian and 128-point template cells are overhead-bound.  This
config makes the LIKELIHOOD dominate, the way a real GW search does (ref
vectorized-likelihood contract this exploits:
`/root/reference/src/eryn/ensemble.py:1371-1406`):

- 8192-sample frequency-grid pulse templates (multi-kHz-sample regime),
- multi-leaf reversible jump (nleaves_max=8) with PT (10 x 200),
- reports: steps/s, achieved FLOP/s (XLA cost analysis of the compiled
  ensemble likelihood x evals/step), its share of the card's published
  bf16 peak (``benchmarks/peaks.py``; this workload is transcendental and
  elementwise like real template likelihoods, so the share is small by
  nature), and the likelihood/sampler-overhead split measured by swapping
  in a trivial likelihood on the identical config.

Usage: ``python benchmarks/lisa_style.py [--nsteps N]`` (needs a GPU;
``--cpu`` is a hermetic rehearsal at reduced shape that reports no share).
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np

from benchmarks.peaks import peak


def build(npts, nlmax, ntemps, nwalkers, heavy=True, seed=3):
    import jax.numpy as jnp

    from eryn_tpu import EnsembleSampler, ProbDistContainer, State, uniform_dist
    from eryn_tpu.moves import RedBlueGroupStretchMove

    rng = np.random.default_rng(10)
    t_np = np.linspace(0.0, 10.0, npts)
    sigma = 0.3
    data_np = 3.0 * np.exp(-((t_np - 4.0) ** 2) / (2 * 0.6**2))
    data_np = data_np + sigma * rng.standard_normal(npts)
    t, data = jnp.asarray(t_np, jnp.float32), jnp.asarray(
        data_np, jnp.float32
    )

    if heavy:

        def ll(coords, inds):
            a, b, c = coords[:, 0], coords[:, 1], coords[:, 2]
            p = a[:, None] * jnp.exp(
                -((t[None] - b[:, None]) ** 2) / (2 * c[:, None] ** 2)
            )
            tmpl = jnp.sum(jnp.where(inds[:, None], p, 0.0), axis=0)
            return -0.5 * jnp.sum(((tmpl - data) / sigma) ** 2)

    else:

        def ll(coords, inds):  # trivial: isolates sampler overhead
            return -0.5 * jnp.sum(
                jnp.where(inds[:, None], coords, 0.0) ** 2
            )

    pr = ProbDistContainer(
        {
            0: uniform_dist(0.5, 5.0),
            1: uniform_dist(0.0, 10.0),
            2: uniform_dist(0.1, 2.0),
        }
    )
    fill = float(-0.5 * np.sum((data_np / sigma) ** 2))
    s = EnsembleSampler(
        nwalkers,
        3,
        ll,
        pr,
        nleaves_max=nlmax,
        nleaves_min=0,
        # the library's own RJ guidance: stretch active leaves toward
        # ACTIVE complement leaves (plain StretchMove warns under RJ)
        moves=RedBlueGroupStretchMove(),
        rj_moves=True,
        tempering_kwargs=dict(ntemps=ntemps),
        fill_zero_leaves_val=fill,
        seed=seed,
    )
    coords = pr.rvs(size=(ntemps, nwalkers, nlmax))
    inds = np.random.default_rng(4).random((ntemps, nwalkers, nlmax)) < 0.4
    state = s._setup_state(
        State({"model_0": coords}, inds={"model_0": inds})
    )
    return s, state, ll


def likelihood_flops(sampler, state):
    """XLA's FLOP estimate for ONE full-ensemble likelihood evaluation of
    this config (lower + compile the evaluator standalone)."""
    import jax
    import jax.numpy as jnp

    nt, nw = sampler.ntemps, sampler.nwalkers
    coords = dict(state.branches_coords)
    inds = dict(state.branches_inds)
    logp = jnp.zeros((nt, nw), dtype=sampler.dtype)

    def full_eval(coords, inds, logp):
        ll, _ = sampler._like_eval(coords, inds, logp)
        return ll

    compiled = jax.jit(full_eval).lower(coords, inds, logp).compile()
    cost = compiled.cost_analysis()
    if isinstance(cost, (list, tuple)):
        cost = cost[0]
    return float(cost.get("flops", float("nan")))


def timed_run(sampler, state, nsteps):
    """Asymptotic per-step rate via two run lengths (slope timing):
    ``(t2 - t1) / (n2 - n1)`` removes the fixed per-dispatch cost that a
    single short window folds into the rate."""
    import jax

    def best_total(n):
        st, _ = sampler._run_bulk(state, 1, n, store=False)
        jax.block_until_ready(st.log_like)  # compile + warm
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            st, _ = sampler._run_bulk(state, 1, n, store=False)
            jax.block_until_ready(st.log_like)
            best = min(best, time.perf_counter() - t0)
        return best, st

    n1, n2 = nsteps, 3 * nsteps
    t1, _ = best_total(n1)
    t2, st = best_total(n2)
    per_step = (t2 - t1) / (n2 - n1)
    return 1.0 / per_step, st


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--nsteps", type=int, default=500)
    ap.add_argument(
        "--npts",
        type=int,
        nargs="*",
        default=None,
        help="template lengths to sweep (default: 8192 16384 32768)",
    )
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
        npts_list = args.npts or [2048]
        nlmax, ntemps, nwalkers = 4, 4, 50
    elif jax.devices()[0].platform != "gpu":
        sys.exit("lisa_style: no GPU (pass --cpu for the CPU rehearsal)")
    else:
        npts_list = args.npts or [8192, 16384, 32768]
        nlmax, ntemps, nwalkers = 8, 10, 200
    from eryn_tpu.compile_cache import use_compile_cache

    use_compile_cache(ROOT)

    null_sps = None
    for npts in npts_list:
        res = run_config(
            args.nsteps, npts, nlmax, ntemps, nwalkers, null_sps=null_sps
        )
        null_sps = res["null_likelihood_steps_per_sec"]
        print(json.dumps(res), flush=True)


def run_config(
    nsteps, npts=8192, nlmax=8, ntemps=10, nwalkers=200, null_sps=None
):
    """Run the benchmark; importable by bench.py (returns the result dict).

    ``null_sps`` (steps/s with the trivial likelihood on the identical
    sampler config) does not depend on ``npts`` — pass a previous config's
    value to skip re-measuring it in a template-length sweep."""
    import jax

    heavy, state_h, _ = build(npts, nlmax, ntemps, nwalkers, heavy=True)
    flops_eval = likelihood_flops(heavy, state_h)
    heavy_sps, _ = timed_run(heavy, state_h, nsteps)

    if null_sps is None:
        null, state_n, _ = build(npts, nlmax, ntemps, nwalkers, heavy=False)
        null_sps, _ = timed_run(null, state_n, nsteps)

    # default schedule: one in-model stretch (two half-ensemble evals = one
    # full) + one RJ proposal (one full) per step
    evals_per_step = 2.0
    flops_per_sec = flops_eval * evals_per_step * heavy_sps
    overhead_frac = heavy_sps / null_sps  # time_null / time_heavy
    dev = jax.devices()[0]
    return {
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "npts": npts,
        "nleaves_max": nlmax,
        "ntemps": ntemps,
        "nwalkers": nwalkers,
        "nsteps": nsteps,
        "steps_per_sec": round(heavy_sps, 2),
        "null_likelihood_steps_per_sec": round(float(null_sps), 2),
        "sampler_overhead_fraction": round(overhead_frac, 4),
        "likelihood_fraction": round(1.0 - overhead_frac, 4),
        "likelihood_flops_per_eval": flops_eval,
        "achieved_flops_per_sec": round(flops_per_sec, 1),
        "bf16_peak_share": None
        if dev.platform == "cpu"
        else round(flops_per_sec / peak(dev.device_kind), 5),
    }


if __name__ == "__main__":
    main()
