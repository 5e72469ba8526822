"""Benchmark hybrid host-move scheduling vs pure-native and pure-host modes.

The migration state this measures: a user ported 9 of 10 moves to the
traced kernel API but still carries ONE reference-style custom move (host
``get_proposal``).  Before round 4 that single move flipped the whole run
into host-step mode; hybrid scheduling keeps every all-native step
compiled.  Prints one JSON line with steps/s for each mode and the ratios
quoted in ``docs/migration.md``.

Run on CPU (hermetic) by default; pass ``--device`` to keep JAX's default
platform (the GPU), where every host-mode step pays a dispatch and a
device->host round trip — the regime hybrid scheduling rescues.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", action="store_true")
    ap.add_argument("--nsteps", type=int, default=300)
    ap.add_argument("--host-weight", type=float, default=0.1)
    args = ap.parse_args()

    import jax

    from eryn_tpu.compile_cache import use_compile_cache

    if not args.device:
        jax.config.update("jax_platforms", "cpu")
    use_compile_cache(ROOT)

    import jax.numpy as jnp

    from eryn_tpu import EnsembleSampler, ProbDistContainer, uniform_dist
    from eryn_tpu.moves import MHMove, StretchMove

    ndim, nwalkers, ntemps = 5, 100, 4

    def log_like(x):
        return -0.5 * jnp.sum(x * x, axis=-1)

    priors = ProbDistContainer({i: uniform_dist(-10, 10) for i in range(ndim)})
    rng = np.random.default_rng(0)
    coords = rng.uniform(-2, 2, size=(ntemps, nwalkers, 1, ndim))

    class CustomHostMH(MHMove):
        """Reference-style custom move (host get_proposal protocol)."""

        def get_proposal(
            self, branches_coords, random, branches_inds=None, **kwargs
        ):
            q = {}
            for name, c in branches_coords.items():
                c = np.asarray(c)
                q[name] = c + 0.3 * random.randn(*c.shape)
            factors = np.zeros(next(iter(q.values())).shape[:2])
            return q, factors

    import warnings

    def timed(moves, label, force_host=False):
        warnings.simplefilter("ignore")
        s = EnsembleSampler(
            nwalkers, ndim, log_like, priors, moves=moves,
            tempering_kwargs=dict(ntemps=ntemps), seed=7,
        )
        if force_host:
            s._hybrid_host = False
        # warmup: cover the segment lengths the timed window will use (the
        # pure-native leg reuses one 32-step program; hybrid chunks native
        # runs on the power-of-two plan, so its lengths self-warm quickly)
        s.run_mcmc(coords, 64, progress=False, segment_size=32)
        t0 = time.perf_counter()
        s.run_mcmc(None, args.nsteps, progress=False, segment_size=32)
        dt = time.perf_counter() - t0
        rate = args.nsteps / dt
        print(f"  {label}: {rate:.1f} steps/s ({dt:.2f}s)", file=sys.stderr)
        return rate

    w = args.host_weight
    native = timed(StretchMove(), "pure native (compiled)")
    hybrid = timed(
        [(StretchMove(), 1 - w), (CustomHostMH(), w)],
        f"hybrid (custom move at w={w})",
    )
    host = timed(
        [(StretchMove(), 1 - w), (CustomHostMH(), w)],
        "host-step mode (pre-round-4 behavior)",
        force_host=True,
    )

    print(json.dumps({
        "platform": jax.default_backend(),
        "nsteps": args.nsteps,
        "host_weight": w,
        "native_steps_per_s": round(native, 2),
        "hybrid_steps_per_s": round(hybrid, 2),
        "host_mode_steps_per_s": round(host, 2),
        "hybrid_vs_host_speedup": round(hybrid / host, 2),
        "native_vs_hybrid_factor": round(native / hybrid, 2),
    }))


if __name__ == "__main__":
    main()
