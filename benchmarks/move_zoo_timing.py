"""Per-move step timing on a standard config: the slow-lowering detector.

A single op with a pathological lowering (a vmapped ``searchsorted`` once
serialized a whole step) can slow every run that draws its move.  This
benchmark times every in-model move of the zoo — and the RJ moves — at the
same PT configuration, so a pathological lowering in any one kernel shows
up as an outlier instead of surfacing months later inside a user's run.

Usage: ``python benchmarks/move_zoo_timing.py [--nsteps N] [--cpu]``
Prints one line per move: steps/s and us/step (sorted slowest-first at the
end).  On CPU it is a smoke test; the numbers only mean something on the
GPU.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np

NDIM, NWALKERS, NTEMPS = 5, 100, 10
NLMAX = 4


def build_moves():
    import jax.numpy as jnp

    from eryn_tpu.moves import (
        AIMHMove,
        ChEESHMCMove,
        DEMove,
        DESnookerMove,
        DistributionGenerate,
        GaussianMove,
        GroupStretchMove,
        HMCMove,
        KDEMove,
        MALAMove,
        MTDistGenMove,
        RedBlueGroupStretchMove,
        SliceMove,
        StretchMove,
        WalkMove,
    )
    from eryn_tpu.prior import ProbDistContainer, uniform_dist

    dist = ProbDistContainer(
        {i: uniform_dist(-5.0, 5.0) for i in range(NDIM)}
    )
    cov = {"model_0": np.diag(np.full(NDIM, 0.5**2))}
    return {
        "MTDistGenMove(8 tries)": MTDistGenMove(
            {"model_0": dist}, num_try=8, independent=True
        ),
        "StretchMove": StretchMove(),
        "RedBlueGroupStretchMove": RedBlueGroupStretchMove(),
        "GroupStretchMove": GroupStretchMove(),
        "GaussianMove(diag)": GaussianMove(cov),
        "GaussianMove(full)": GaussianMove(
            {"model_0": 0.25 * np.eye(NDIM) + 0.05}
        ),
        "DistributionGenerate": DistributionGenerate({"model_0": dist}),
        "DEMove": DEMove(),
        "DESnookerMove": DESnookerMove(),
        "WalkMove": WalkMove(),
        "KDEMove": KDEMove(),
        "SliceMove": SliceMove(),
        "MALAMove": MALAMove(),
        "HMCMove": HMCMove(),
        "ChEESHMCMove": ChEESHMCMove(),
        "AIMHMove": AIMHMove(),
    }


def time_move(name, move, nsteps):
    import jax
    import jax.numpy as jnp

    from eryn_tpu import EnsembleSampler, ProbDistContainer, uniform_dist

    invcov = jnp.eye(NDIM)

    def log_like(x):
        return -0.5 * jnp.sum(x * (invcov @ x))

    priors = ProbDistContainer(
        {i: uniform_dist(-5.0, 5.0) for i in range(NDIM)}
    )
    s = EnsembleSampler(
        NWALKERS,
        NDIM,
        log_like,
        priors,
        moves=move,
        tempering_kwargs=dict(ntemps=NTEMPS),
        seed=10,
    )
    state = s._setup_state(priors.rvs(size=(NTEMPS, NWALKERS)))
    state, _ = s._run_bulk(state, 1, nsteps, store=False)
    jax.block_until_ready(state.log_like)
    best = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        state, _ = s._run_bulk(state, 1, nsteps, store=False)
        jax.block_until_ready(state.log_like)
        best = min(best, time.perf_counter() - t0)
    return nsteps / best


def time_rj(nsteps, mt=False):
    """RJ timing: default DistributionGenerateRJ (``rj_moves=True``) or the
    multiple-try RJ kernel, + the RJ-recommended in-model move, on a
    4-leaf branch."""
    import jax
    import jax.numpy as jnp

    from eryn_tpu import EnsembleSampler, ProbDistContainer, State, uniform_dist
    from eryn_tpu.moves import MTDistGenMoveRJ, RedBlueGroupStretchMove

    def ll(coords, inds):
        return -0.5 * jnp.sum(jnp.where(inds[:, None], coords, 0.0) ** 2)

    pr = ProbDistContainer(
        {i: uniform_dist(-5.0, 5.0) for i in range(NDIM)}
    )
    rj = True
    if mt:
        rj = [
            MTDistGenMoveRJ(
                {"model_0": pr},
                nleaves_max={"model_0": NLMAX},
                nleaves_min={"model_0": 0},
                num_try=8,
            )
        ]
    s = EnsembleSampler(
        NWALKERS,
        NDIM,
        ll,
        pr,
        nleaves_max=NLMAX,
        nleaves_min=0,
        moves=RedBlueGroupStretchMove(),
        rj_moves=rj,
        tempering_kwargs=dict(ntemps=NTEMPS),
        seed=11,
    )
    coords = pr.rvs(size=(NTEMPS, NWALKERS, NLMAX))
    inds = np.random.default_rng(4).random((NTEMPS, NWALKERS, NLMAX)) < 0.5
    state = s._setup_state(State({"model_0": coords}, inds={"model_0": inds}))
    state, _ = s._run_bulk(state, 1, nsteps, store=False)
    jax.block_until_ready(state.log_like)
    best = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        state, _ = s._run_bulk(state, 1, nsteps, store=False)
        jax.block_until_ready(state.log_like)
        best = min(best, time.perf_counter() - t0)
    return nsteps / best


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--nsteps", type=int, default=None)
    args = ap.parse_args()

    import jax

    from eryn_tpu.compile_cache import use_compile_cache

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    use_compile_cache(ROOT)
    nsteps = args.nsteps or (2000 if not args.cpu else 50)

    results = {}
    for name, move in build_moves().items():
        try:
            sps = time_move(name, move, nsteps)
            results[name] = sps
            print(
                f"{name:32s} {sps:10.0f} steps/s  ({1e6 / sps:8.1f} us/step)",
                flush=True,
            )
        except Exception as e:  # pragma: no cover - reporting only
            print(f"{name:32s} FAILED: {type(e).__name__}: {e}", flush=True)
    for tag, mt in [
        ("RJ(distgenRJ+RBGS, 4 leaves)", False),
        ("RJ(MT x8 +RBGS, 4 leaves)", True),
    ]:
        try:
            sps = time_rj(nsteps, mt=mt)
            results[tag] = sps
            print(
                f"{tag:32s} {sps:10.0f} steps/s  ({1e6 / sps:8.1f} us/step)",
                flush=True,
            )
        except Exception as e:  # pragma: no cover
            print(f"{tag} FAILED: {type(e).__name__}: {e}", flush=True)

    order = sorted(results.items(), key=lambda kv: kv[1])
    print("\nslowest-first:")
    for name, sps in order:
        print(f"  {name:32s} {1e6 / sps:8.1f} us/step")
    print(json.dumps({k: round(v, 1) for k, v in results.items()}))


if __name__ == "__main__":
    main()
