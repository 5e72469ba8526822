"""Statistical validation sweep: every move family against analytic truths.

Runs each proposal family long enough for tight checks and reports, per
config: posterior mean/std errors in units of the IACT-corrected Monte Carlo
standard error (|z| should be O(1); systematic bias shows up as |z| >> 3),
the Kolmogorov-Smirnov statistic of tau-thinned pooled samples against the
analytic marginal, and the acceptance fraction.

Target: N(0, I) in 3-D inside a wide uniform prior (so every marginal is a
unit normal), plus an RJ amplitude model checked against a brute-force
quadrature Bayes factor.  Exercises in one sweep: the red/blue and group
machinery, all MH-family modes, multiple-try (independent and
state-dependent), delayed rejection, gradient moves, differential evolution,
KDE, walk, parallel tempering (cold chain), and trans-dimensional moves.

Usage: ``python benchmarks/validate_statistics.py`` (runs on whatever
backend jax selects; compile-dominated).
"""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import functools

print = functools.partial(print, flush=True)

import numpy as np

import jax
import jax.numpy as jnp

from eryn_tpu import EnsembleSampler, ProbDistContainer, State, uniform_dist
from eryn_tpu.prior import normal_dist
from eryn_tpu.moves import (
    AIMHMove,
    ChEESHMCMove,
    DelayedRejection,
    ModelSwapRJMove,
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
from eryn_tpu.utils.utility import get_integrated_act

NDIM = 3
NWALKERS = 64
NSTEPS = 3000
BURN = 500


def log_like(x):
    return -0.5 * jnp.sum(x**2)


def _priors():
    return ProbDistContainer({i: uniform_dist(-7, 7) for i in range(NDIM)})


def _ks_stat(samples):
    """KS statistic of sorted samples vs the standard normal CDF."""
    from scipy.stats import norm

    s = np.sort(samples)
    n = len(s)
    cdf = norm.cdf(s)
    d_plus = np.max(np.arange(1, n + 1) / n - cdf)
    d_minus = np.max(cdf - np.arange(n) / n)
    return max(d_plus, d_minus)


def check_move(tag, moves, seed, ntemps=1, nsteps=NSTEPS, tempering_extra=None):
    priors = _priors()
    kwargs = dict(moves=moves, seed=seed)
    if ntemps > 1:
        kwargs["tempering_kwargs"] = dict(ntemps=ntemps, **(tempering_extra or {}))
    ens = EnsembleSampler(NWALKERS, NDIM, log_like, priors, **kwargs)
    coords = 0.5 * np.random.default_rng(seed).standard_normal(
        (ntemps, NWALKERS, NDIM) if ntemps > 1 else (NWALKERS, NDIM)
    )
    t0 = time.perf_counter()
    ens.run_mcmc(coords, nsteps, burn=BURN)
    dt = time.perf_counter() - t0

    chain = ens.get_chain(temp_index=0)["model_0"].reshape(-1, NDIM)
    tau = float(
        np.nanmax(np.atleast_1d(ens.backend.get_autocorr_time()["model_0"]))
    )
    n_eff = chain.shape[0] / max(2 * tau, 1.0)
    # z-scores of the moment errors in MC-standard-error units
    z_mean = np.abs(chain.mean(axis=0)) * np.sqrt(n_eff)
    z_std = np.abs(chain.std(axis=0) - 1.0) * np.sqrt(n_eff / 2.0)
    # KS on a decorrelated stream: one walker per kept time slice
    # (slices >= 2*tau apart, walker rotated per slice), so the samples are
    # independent in BOTH time and walker — pooling all walkers per step
    # would understate the critical value via cross-walker correlation
    chain3 = chain.reshape(-1, NWALKERS, NDIM)
    step_thin = max(int(2 * tau), 1)
    if chain3.shape[0] // step_thin < 200:
        # keep ONE walker per slice always (pooling walkers within a step
        # correlates the stream and understates the critical value); gain
        # slices by relaxing the time-thin to ~tau instead
        step_thin = max(int(tau), 1)
    kept = chain3[::step_thin]
    rot = np.arange(kept.shape[0]) % NWALKERS
    stream = kept[np.arange(kept.shape[0]), rot]
    ks = max(_ks_stat(stream[:, d]) for d in range(NDIM))
    n_ks = stream.shape[0]
    ks_crit = 1.63 / np.sqrt(n_ks)  # ~1% critical value
    acc = float(np.mean(np.asarray(ens.acceptance_fraction)))
    ok = (z_mean.max() < 4.0) and (z_std.max() < 4.0) and (ks < ks_crit)
    print(
        f"{tag:38s} |z_mean|={z_mean.max():5.2f} |z_std|={z_std.max():5.2f} "
        f"KS={ks:.4f} (crit {ks_crit:.4f}) tau={tau:5.1f} acc={acc:.2f} "
        f"[{nsteps/dt:7.0f} steps/s] {'OK' if ok else '** FAIL **'}",
        flush=True,
    )
    _MOVE_STATS[tag] = {"tau": tau, "acc": acc}
    return ok


#: per-config tau/acceptance, for cross-config assertions (gradient moves
#: must BEAT the stretch baseline at default construction, not just be
#: unbiased — unbiasedness alone would hide a mistuned default)
_MOVE_STATS = {}


def check_gradient_efficiency(tag="gradient-move efficiency"):
    """MALA/HMC at DEFAULT construction must self-tune into the optimal
    acceptance band and decorrelate faster than the stretch move on the
    same target."""
    stretch_tau = _MOVE_STATS["StretchMove"]["tau"]
    ok = True
    for name, band in (
        ("MALAMove", (0.40, 0.80)),
        ("HMCMove", (0.45, 0.90)),
        ("ChEESHMCMove", (0.45, 0.90)),
    ):
        st = _MOVE_STATS[name]
        in_band = band[0] <= st["acc"] <= band[1]
        faster = st["tau"] < stretch_tau
        ok = ok and in_band and faster
        print(
            f"{tag + ': ' + name:38s} acc={st['acc']:.2f} in {band}? "
            f"{'yes' if in_band else 'NO'}  tau={st['tau']:.1f} < "
            f"stretch {stretch_tau:.1f}? {'yes' if faster else 'NO'}",
            flush=True,
        )
    print(
        f"{tag:38s} {'OK' if ok else '** FAIL **'}",
        flush=True,
    )
    return ok


def check_rj(tag, seed=99):
    """RJ k-posterior vs a brute-force quadrature Bayes factor."""
    rng = np.random.default_rng(8)
    npts = 64
    t_np = np.linspace(0, 1, npts)
    g = np.exp(-((t_np - 0.5) ** 2) / (2 * 0.1**2))
    a_true, sigma, amax = 1.2, 1.0, 3.0
    data_np = a_true * g + sigma * rng.standard_normal(npts)

    def ll_np(amp_sum):
        resid = data_np[None] - amp_sum[:, None] * g[None]
        return -0.5 * np.sum((resid / sigma) ** 2, axis=-1)

    a = np.linspace(0.0, amax, 400)
    z1 = np.exp(ll_np(a)).mean()
    A1, A2 = np.meshgrid(a, a, indexing="ij")
    z2 = np.exp(ll_np((A1 + A2).ravel())).mean()
    p2_true = z2 / (z1 + z2)

    g_j, d_j = jnp.asarray(g), jnp.asarray(data_np)

    def our_ll(c, m):
        amp = jnp.sum(jnp.where(m, c[:, 0], 0.0))
        return -0.5 * jnp.sum(((amp * g_j - d_j) / sigma) ** 2)

    priors = ProbDistContainer({0: uniform_dist(0.0, amax)})
    ens = EnsembleSampler(
        64, 1, our_ll, priors, nleaves_max=2, nleaves_min=1, rj_moves=True,
        seed=seed,
    )
    coords = priors.rvs(size=(1, 64, 2))
    inds0 = np.zeros((1, 64, 2), dtype=bool)
    inds0[..., 0] = True
    inds0[:, ::2, 1] = True
    t0 = time.perf_counter()
    ens.run_mcmc(
        State({"model_0": coords}, inds={"model_0": inds0}), 6000, burn=1000
    )
    dt = time.perf_counter() - t0
    nleaves = ens.get_nleaves()["model_0"][:, 0]
    p2 = (nleaves == 2).mean()
    ok = abs(p2 - p2_true) < 0.04
    print(
        f"{tag:38s} P(k=2)={p2:.3f} quadrature={p2_true:.3f} "
        f"[{6000/dt:7.0f} steps/s] {'OK' if ok else '** FAIL **'}",
        flush=True,
    )
    return ok


def check_modelswap(tag, seed=47):
    """Product-space model indicator vs quadrature Bayes factor."""
    rng = np.random.default_rng(4)
    npts = 64
    t_np = np.linspace(0, 1, npts)
    g = np.exp(-((t_np - 0.5) ** 2) / (2 * 0.1**2))
    data_np = 1.1 * g + rng.standard_normal(npts)
    amax = 3.0
    a = np.linspace(0.0, amax, 800)
    c = np.linspace(-1.0, 1.0, 800)
    z_p = np.exp(
        -0.5 * ((data_np[None] - a[:, None] * g[None]) ** 2).sum(-1)
    ).mean()
    z_c = np.exp(-0.5 * ((data_np[None] - c[:, None]) ** 2).sum(-1)).mean()
    p_true = z_p / (z_p + z_c)

    g_j, d_j = jnp.asarray(g), jnp.asarray(data_np)

    def ll(coords, inds):
        amp = jnp.sum(jnp.where(inds["pulse"][:, None], coords["pulse"], 0.0))
        off = jnp.sum(jnp.where(inds["const"][:, None], coords["const"], 0.0))
        return -0.5 * jnp.sum((d_j - amp * g_j - off) ** 2)

    from eryn_tpu.moves import GaussianMove

    priors = {
        "pulse": ProbDistContainer({0: uniform_dist(0.0, amax)}),
        "const": ProbDistContainer({0: uniform_dist(-1.0, 1.0)}),
    }
    ens = EnsembleSampler(
        64, {"pulse": 1, "const": 1}, ll, priors,
        branch_names=["pulse", "const"],
        nleaves_max={"pulse": 1, "const": 1},
        nleaves_min={"pulse": 0, "const": 0},
        moves=[GaussianMove({"pulse": 0.05, "const": 0.05})],
        rj_moves=[ModelSwapRJMove({n: priors[n] for n in priors})],
        fill_zero_leaves_val=-1e8,
        seed=seed,
    )
    coords = {
        n: np.asarray(priors[n].rvs(size=(1, 64, 1))) for n in priors
    }
    pick = np.random.default_rng(7).random((1, 64)) < 0.5
    state = State(
        coords, inds={"pulse": pick[..., None], "const": ~pick[..., None]}
    )
    t0 = time.perf_counter()
    ens.run_mcmc(state, 4000, burn=500)
    dt = time.perf_counter() - t0
    p = ens.get_nleaves()["pulse"][:, 0].mean()
    ok = abs(p - p_true) < 0.05
    print(
        f"{tag:38s} P(pulse)={p:.3f} quadrature={p_true:.3f} "
        f"[{4000/dt:7.0f} steps/s] {'OK' if ok else '** FAIL **'}",
        flush=True,
    )
    return ok


def main():
    from eryn_tpu.compile_cache import use_compile_cache

    use_compile_cache(ROOT)
    print(f"backend: {jax.default_backend()}  target: N(0, I) in {NDIM}-D")
    gen = ProbDistContainer(
        {i: normal_dist(0.8, 1.4) for i in range(NDIM)}
    )
    results = [
        check_move("StretchMove", [StretchMove()], 1),
        check_move("StretchMove + PT (cold chain)", [StretchMove()], 2, ntemps=4),
        check_move(
            "StretchMove + non-reversible PT (DEO)",
            [StretchMove()],
            24,
            ntemps=4,
            tempering_extra=dict(swap_scheme="deo"),
        ),
        check_move(
            # the Syed et al. 2021 pairing: non-reversible swaps + the
            # communication-barrier schedule replacing the Vousden drift
            "StretchMove + DEO + Syed schedule",
            [StretchMove()],
            26,
            ntemps=4,
            tempering_extra=dict(
                swap_scheme="deo", adaptation_scheme="syed"
            ),
        ),
        check_move(
            "StretchMove log-proposal",
            [StretchMove(use_log_proposal=True)],
            20,
        ),
        check_move("WalkMove", [WalkMove()], 3),
        check_move("KDEMove", [KDEMove()], 4),
        check_move("DEMove", [DEMove()], 5),
        check_move("DESnookerMove", [DESnookerMove()], 6),
        check_move(
            "GaussianMove vector", [GaussianMove({"model_0": 0.6 * np.ones(NDIM)})], 7
        ),
        check_move(
            "GaussianMove random",
            [GaussianMove({"model_0": 2.0 * np.ones(NDIM)}, mode="random")],
            8,
        ),
        check_move(
            "GaussianMove sequential",
            [GaussianMove({"model_0": 2.0 * np.ones(NDIM)}, mode="sequential")],
            9,
        ),
        check_move(
            "DistributionGenerate (offset gen)",
            [DistributionGenerate({"model_0": gen})],
            10,
        ),
        check_move(
            "MTDistGen independent",
            [MTDistGenMove({"model_0": gen}, num_try=8, independent=True)],
            11,
        ),
        check_move(
            "MTDistGen non-independent",
            [MTDistGenMove({"model_0": gen}, num_try=8, independent=False)],
            12,
        ),
        check_move("GroupStretchMove", [GroupStretchMove(n_iter_update=50)], 13),
        check_move(
            # 6x steps: tau ~35 makes this the highest-autocorrelation
            # config in the sweep, and at shorter runs the KS harness
            # falls back to 1x-tau thinning where single unlucky seeded
            # realizations sit near the 1% critical value (see
            # VALIDATION.md).  18k steps engage the harness's preferred
            # 2x-tau thinning with n=250 independent samples
            "RedBlueGroupStretchMove",
            [RedBlueGroupStretchMove()],
            21,
            nsteps=6 * NSTEPS,
        ),
        check_move("SliceMove", [SliceMove()], 22, nsteps=1500),
        check_move(
            "DelayedRejection(Gaussian)",
            [DelayedRejection(GaussianMove({"model_0": 1.5 * np.ones(NDIM)}), max_iter=2)],
            14,
            nsteps=1500,
        ),
        check_move("MALAMove", [MALAMove()], 15, nsteps=1500),
        check_move("HMCMove", [HMCMove()], 16, nsteps=800),
        check_move("ChEESHMCMove", [ChEESHMCMove()], 23, nsteps=800),
        check_move(
            # tune_steps counts AIMH SELECTIONS (weight 0.1 of BURN=500
            # steps -> ~50 during burn): 40 freezes the fit inside
            # burn-in so the measured chain comes from the exact frozen
            # kernel
            "DIME (DEMove + AIMHMove)",
            [(DEMove(), 0.9), (AIMHMove(tune_steps=40), 0.1)],
            25,
            nsteps=1500,
        ),
        check_gradient_efficiency(),
        check_rj("RJ k-posterior vs quadrature"),
        check_modelswap("Product-space Bayes factor"),
    ]
    n_ok = sum(results)
    print(f"\n{n_ok}/{len(results)} configurations statistically consistent")
    return 0 if n_ok == len(results) else 1


if __name__ == "__main__":
    raise SystemExit(main())
