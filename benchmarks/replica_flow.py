"""Replica-flow comparison: cascade vs non-reversible (DEO) swap schemes.

A replica's "round trip" (cold rung -> hottest rung -> back) is the unit
of tempering work: each trip carries one fresh hot-chain sample to the
cold chain (Syed et al. 2021).  An integer replica tag riding the state
supplemental (it is exchanged by the compiled swap phase alongside the
chain) makes the flow directly observable.

Measured on the 8x16 harness below (CPU, 1200 steps, pinned seeds):

    cascade  10.2 trips / replica / 1k steps, 225 per attempt,  ~520 steps/s
    deo       5.6 trips / replica / 1k steps, 245 per attempt, ~1700 steps/s

Per STEP the cascade wins (it attempts every boundary, sequentially,
every phase; DEO attempts half, all at once).  Per ATTEMPT DEO's
ballistic lifting is more efficient, and per SECOND — the metric that
matters — DEO's O(1)-depth phase makes the whole step ~2-3x faster here,
netting roughly twice the round trips per second.  The cascade stays the
default (per-step-optimal, matches the reference); "deo" is the
throughput-optimal choice when the PT epilogue is a significant share of
the step, i.e. wide ladders or cheap likelihoods.
"""

import os
import sys
import time as _time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np

import jax

# replica-flow statistics are platform-independent and the harness reads
# the (tiny) replica tags every step — run on host CPU, where those reads
# cost no device round trip
jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp

from eryn_tpu import EnsembleSampler, State
from eryn_tpu.prior import ProbDistContainer, uniform_dist
from eryn_tpu.state import BranchSupplemental
from eryn_tpu.utils.utility import replica_round_trips

NTEMPS, NWALKERS, NDIM = 8, 16, 3
NSTEPS = 1200


def log_like(x):
    return -0.5 * jnp.sum(x**2)


def run(scheme, seed=17):
    pr = ProbDistContainer({i: uniform_dist(-7, 7) for i in range(NDIM)})
    # pin the start coords (rvs consumes the GLOBAL NumPy stream, which
    # would make results depend on in-process draw order)
    rng = np.random.default_rng(99)
    coords = rng.uniform(-3, 3, size=(NTEMPS, NWALKERS, 1, NDIM))
    flat = np.arange(NTEMPS * NWALKERS).reshape(NTEMPS, NWALKERS)
    ens = EnsembleSampler(
        NWALKERS, NDIM, log_like, pr,
        tempering_kwargs=dict(
            ntemps=NTEMPS, adaptive=False, swap_scheme=scheme
        ),
        seed=seed,
    )
    st = State(
        {"model_0": coords},
        supplemental=BranchSupplemental(
            {"rid": flat.copy()}, base_shape=(NTEMPS, NWALKERS)
        ),
    )
    rungs = np.empty((NSTEPS, NTEMPS * NWALKERS), dtype=np.int8)
    t0 = _time.perf_counter()
    for i, s in enumerate(ens.sample(st, iterations=NSTEPS, store=False)):
        tag = np.asarray(s.supplemental["rid"]).ravel()
        pos = np.empty(NTEMPS * NWALKERS, dtype=np.int8)
        pos[tag] = np.repeat(np.arange(NTEMPS, dtype=np.int8), NWALKERS)
        rungs[i] = pos
    dt = _time.perf_counter() - t0
    trips = replica_round_trips(rungs, NTEMPS)
    attempts = NTEMPS - 1 if scheme == "cascade" else (NTEMPS - 1) / 2.0
    return trips, attempts, dt


def main():
    from eryn_tpu.compile_cache import use_compile_cache

    use_compile_cache(ROOT)
    for scheme in ("cascade", "deo"):
        trips, attempts, dt = run(scheme)
        rate = 1000.0 * trips / (NTEMPS * NWALKERS * NSTEPS)
        print(
            f"{scheme:8s} round trips {trips:5d}  "
            f"per replica per 1k steps {rate:5.2f}  "
            f"per boundary-attempt {trips / attempts:7.1f}  "
            f"[{NSTEPS / dt:5.0f} steps/s]"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
