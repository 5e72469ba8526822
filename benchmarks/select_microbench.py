"""Microbenchmark: RBGS complement selection — one-hot contraction vs
searchsorted + gather.

Times the full null-likelihood sampler step at the LISA benchmark shape
(10 temps x 200 walkers x 8 leaves x 3 params, RedBlueGroupStretchMove +
RJ) on each of the move's two selection paths, plus the standalone
selection op.  Run on the GPU after touching the selection path.

Usage: ``python benchmarks/select_microbench.py [--nsteps N]``
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import functools

import numpy as np


def timed_scan(fn, args, nsteps):
    """Slope-timed scan rate (see benchmarks/matched_filter.py)."""
    import jax

    def total(n):
        out = fn(n, *args)
        jax.block_until_ready(out)
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            out = fn(n, *args)
            jax.block_until_ready(out)
            best = min(best, time.perf_counter() - t0)
        return best

    t1, t2 = total(nsteps), total(3 * nsteps)
    return (t2 - t1) / (2 * nsteps)


def op_bench(nsteps):
    """Standalone selection op: one-hot contraction vs searchsorted."""
    import jax
    import jax.numpy as jnp

    nt, Q, M, nd = 10, 800, 800, 3
    rng = np.random.default_rng(0)
    m = (rng.random((nt, M)) < 0.4).astype(np.float32)
    cs = jnp.asarray(np.cumsum(m, axis=-1))
    cnt = jnp.asarray(m.sum(axis=-1))
    c_clean = jnp.asarray(rng.normal(size=(nt, M, nd)).astype(np.float32))

    def xla_step(key):
        kq = jnp.floor(
            jax.random.uniform(key, (nt, Q)) * jnp.maximum(cnt, 1.0)[:, None]
        )
        # count-equality one-hot (what the move's XLA path uses)
        onehot = (cs[:, None, :] == kq[:, :, None] + 1.0).astype(jnp.float32)
        return jnp.einsum(
            "tqm,tmd->tqd",
            onehot,
            c_clean,
            precision=jax.lax.Precision.HIGHEST,
        )

    def searchsorted_step(key):
        kq = jnp.floor(
            jax.random.uniform(key, (nt, Q)) * jnp.maximum(cnt, 1.0)[:, None]
        )
        idx = jax.vmap(functools.partial(jnp.searchsorted, side="right"))(cs, kq)
        return jnp.take_along_axis(
            c_clean, jnp.minimum(idx, M - 1)[..., None], axis=1
        )

    def make_scan(step):
        @functools.partial(jax.jit, static_argnames=("n",))
        def run(key, n):
            def body(k, _):
                k, sub = jax.random.split(k)
                out = step(sub)
                return k, out.sum()

            _, outs = jax.lax.scan(
                body, key, None, length=n
            )
            return outs.sum()

        return lambda n, key: run(key, n)

    key = jax.random.key(0)
    res = {}
    for name, step in [("onehot", xla_step), ("searchsorted", searchsorted_step)]:
        per = timed_scan(make_scan(step), (key,), nsteps)
        res[f"select_{name}_us"] = round(per * 1e6, 2)
    return res


def move_bench(nsteps, searchsorted):
    from eryn_tpu.moves import rbgroupstretch

    limit = rbgroupstretch._ONEHOT_BYTES_LIMIT
    if searchsorted:
        # the one-hot tensor "does not fit" -> the move takes searchsorted
        rbgroupstretch._ONEHOT_BYTES_LIMIT = 0
    try:
        from benchmarks.lisa_style import build

        s, state, _ = build(128, 8, 10, 200, heavy=False)

        def run(n, st):
            out, _ = s._run_bulk(st, 1, n, store=False)
            return out.log_like

        s._step_cache.clear()
        per = timed_scan(run, (state,), nsteps)
    finally:
        rbgroupstretch._ONEHOT_BYTES_LIMIT = limit
    return round(per * 1e6, 2)


def ablation_bench(nsteps, which):
    """Null-likelihood step ablations at the LISA shape: attribute the
    bare-machinery cost across (move, RJ, tempering, scan) components."""
    import jax.numpy as jnp

    from eryn_tpu import EnsembleSampler, ProbDistContainer, State, uniform_dist
    from eryn_tpu.moves import GaussianMove, RedBlueGroupStretchMove

    ntemps, nwalkers, nlmax, ndim = 10, 200, 8, 3

    def ll(coords, inds):
        return -0.5 * jnp.sum(jnp.where(inds[:, None], coords, 0.0) ** 2)

    pr = ProbDistContainer(
        {
            0: uniform_dist(0.5, 5.0),
            1: uniform_dist(0.0, 10.0),
            2: uniform_dist(0.1, 2.0),
        }
    )
    kw = dict(
        nleaves_max=nlmax,
        tempering_kwargs=dict(ntemps=ntemps),
        fill_zero_leaves_val=-1e6,
        seed=7,
    )
    if which == "floor":
        kw["moves"] = GaussianMove(
            {"model_0": 0.01 * np.eye(ndim)}
        )
    elif which == "rbgs":
        kw["moves"] = RedBlueGroupStretchMove()
    elif which == "rbgs_rj":
        kw["moves"] = RedBlueGroupStretchMove()
        kw["rj_moves"] = True
        kw["nleaves_min"] = 0
    s = EnsembleSampler(nwalkers, ndim, ll, pr, **kw)
    coords = pr.rvs(size=(ntemps, nwalkers, nlmax))
    inds = np.random.default_rng(4).random((ntemps, nwalkers, nlmax)) < 0.4
    if which != "rbgs_rj":
        inds[..., 0] = True  # fixed-leaf configs keep masks static
    state = s._setup_state(State({"model_0": coords}, inds={"model_0": inds}))

    def run(n, st):
        out, _ = s._run_bulk(st, 1, n, store=False)
        return out.log_like

    return round(timed_scan(run, (state,), nsteps) * 1e6, 2)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nsteps", type=int, default=400)
    args = ap.parse_args()

    import jax

    from eryn_tpu.compile_cache import use_compile_cache

    if jax.devices()[0].platform != "gpu":
        sys.exit("select_microbench: no GPU; nothing measured")
    use_compile_cache(ROOT)
    res = op_bench(args.nsteps)
    res["null_step_onehot_us"] = move_bench(args.nsteps, searchsorted=False)
    res["null_step_searchsorted_us"] = move_bench(args.nsteps, searchsorted=True)
    res["abl_floor_us"] = ablation_bench(args.nsteps, "floor")
    res["abl_rbgs_us"] = ablation_bench(args.nsteps, "rbgs")
    res["abl_rbgs_rj_us"] = ablation_bench(args.nsteps, "rbgs_rj")
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
