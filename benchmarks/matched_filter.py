"""Matmul-bound likelihood benchmark: matched-filter bank projection.

The LISA-style benchmark (`benchmarks/lisa_style.py`) measures the regime
where the likelihood is a transcendental template generator — elementwise
work, far from the tensor cores.  This benchmark measures the OTHER
production regime: a likelihood dominated by large matmuls — here a
matched-filter projection of each walker's template against a bank of
`nbank` reference waveforms (the inner-product primitive of real GW
searches), computed in bf16 with f32 accumulation.

What it measures: when the user's likelihood is matmul-shaped, how close
the sampled step comes to the card's bf16 peak (``benchmarks/peaks.py``).

- ensemble: 10 temps x 200 walkers, 3 parameters, plain PT stretch;
- per eval: templates (2000, npts) f32 built from the walker parameters,
  projected `(2000, npts) @ (npts, nbank)` in bf16;
- reports: steps/s, achieved FLOP/s (XLA cost analysis x evals/step), its
  share of the card's published bf16 peak, and the likelihood/sampler
  split via the trivial-likelihood control.

Usage: ``python benchmarks/matched_filter.py [--nsteps N] [--cpu]``
(``--cpu`` is a hermetic rehearsal at reduced shape; it reports no share).
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


def build(npts, nbank, ntemps, nwalkers, heavy=True, seed=5):
    import jax
    import jax.numpy as jnp

    from eryn_tpu import EnsembleSampler, ProbDistContainer, uniform_dist

    rng = np.random.default_rng(12)
    t_np = np.linspace(0.0, 10.0, npts).astype(np.float32)
    t = jnp.asarray(t_np)
    # fixed reference bank: unit-normalized noisy pulses (bf16 operand)
    bank_np = rng.standard_normal((npts, nbank)).astype(np.float32)
    bank_np /= np.linalg.norm(bank_np, axis=0, keepdims=True)
    bank = jnp.asarray(bank_np, jnp.bfloat16)

    if heavy:

        def ll(x):
            # one walker's template, matched-filtered against the bank:
            # the (npts,) @ (npts, nbank) contraction vmaps into the
            # full-ensemble (B, npts) @ (npts, nbank) matmul
            a, b, c = x[0], x[1], x[2]
            tmpl = a * jnp.exp(-((t - b) ** 2) / (2.0 * c**2))
            snr = jnp.dot(
                tmpl.astype(jnp.bfloat16),
                bank,
                preferred_element_type=jnp.float32,
            )
            # smooth, bounded target over the bank SNRs
            return jax.nn.logsumexp(snr) - 0.5 * jnp.sum(tmpl**2) / npts

    else:

        def ll(x):  # trivial control: isolates sampler overhead
            return -0.5 * jnp.sum(x**2)

    pr = ProbDistContainer(
        {
            0: uniform_dist(0.5, 5.0),
            1: uniform_dist(0.0, 10.0),
            2: uniform_dist(0.1, 2.0),
        }
    )
    s = EnsembleSampler(
        nwalkers,
        3,
        ll,
        pr,
        tempering_kwargs=dict(ntemps=ntemps),
        seed=seed,
    )
    state = s._setup_state(pr.rvs(size=(ntemps, nwalkers)))
    return s, state


def likelihood_flops(sampler, state):
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


def run_config(nsteps, npts=8192, nbank=2048, ntemps=10, nwalkers=200):
    import jax

    heavy, state_h = build(npts, nbank, ntemps, nwalkers, heavy=True)
    flops_eval = likelihood_flops(heavy, state_h)
    heavy_sps, _ = timed_run(heavy, state_h, nsteps)

    null, state_n = build(npts, nbank, ntemps, nwalkers, heavy=False)
    null_sps, _ = timed_run(null, state_n, nsteps)

    # plain stretch schedule: two half-ensemble evals = one full eval/step
    evals_per_step = 1.0
    flops_per_sec = flops_eval * evals_per_step * heavy_sps
    overhead_frac = heavy_sps / null_sps
    dev = jax.devices()[0]
    return {
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "npts": npts,
        "nbank": nbank,
        "ntemps": ntemps,
        "nwalkers": nwalkers,
        "nsteps": nsteps,
        "steps_per_sec": round(heavy_sps, 2),
        "null_likelihood_steps_per_sec": round(null_sps, 2),
        "sampler_overhead_fraction": round(overhead_frac, 4),
        "likelihood_fraction": round(1.0 - overhead_frac, 4),
        "likelihood_flops_per_eval": flops_eval,
        "achieved_flops_per_sec": round(flops_per_sec, 1),
        "bf16_peak_share": None
        if dev.platform == "cpu"
        else round(flops_per_sec / peak(dev.device_kind), 5),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--nsteps", type=int, default=300)
    ap.add_argument("--npts", type=int, default=None)
    ap.add_argument("--nbank", type=int, default=None)
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
        npts, nbank, ntemps, nwalkers = 1024, 128, 4, 50
    elif jax.devices()[0].platform != "gpu":
        sys.exit("matched_filter: no GPU (pass --cpu for the CPU rehearsal)")
    else:
        npts, nbank, ntemps, nwalkers = 8192, 2048, 10, 200
    from eryn_tpu.compile_cache import use_compile_cache

    use_compile_cache(ROOT)
    npts = args.npts or npts
    nbank = args.nbank or nbank

    print(json.dumps(run_config(args.nsteps, npts, nbank, ntemps, nwalkers)))


if __name__ == "__main__":
    main()
