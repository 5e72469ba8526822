"""Runtime diagnostic plotting, mirroring the reference's
``examples/plotting_example.py`` / ``plotting_rj_example.py`` workflow on
the compiled sampler: a PT run plus an RJ pulse search, with the full
`PlotContainer` family written to ``./plots_out``.

Run: ``python examples/runtime_plots.py``
"""

import os
import sys

import numpy as np

import jax.numpy as jnp

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from eryn_tpu.moves import RedBlueGroupStretchMove
from eryn_tpu import EnsembleSampler, ProbDistContainer, State, uniform_dist
from eryn_tpu.utils.plot import PlotContainer

from _common import example_steps as _steps


# default to the CURRENT directory so smoke runs (cwd=tmp) stay hermetic
OUT = os.environ.get(
    "ERYN_TPU_EXAMPLE_OUTDIR", os.path.join(os.getcwd(), "plots_out")
)


def pt_gaussian():
    """PT run on a 5-D Gaussian -> base + tempering + advanced plots."""
    ndim, nwalkers, ntemps = 5, 64, 10
    invcov = jnp.eye(ndim)

    def log_like(x):
        return -0.5 * jnp.sum(x * (invcov @ x))

    priors = ProbDistContainer({i: uniform_dist(-10, 10) for i in range(ndim)})
    ens = EnsembleSampler(
        nwalkers,
        ndim,
        log_like,
        priors,
        tempering_kwargs=dict(ntemps=ntemps),
        seed=0,
    )
    coords = priors.rvs(size=(ntemps, nwalkers))
    ens.run_mcmc(coords, _steps(1000), burn=_steps(300))

    plots = PlotContainer(
        fp="pt_gaussian",
        backend=ens.backend,
        plot_dir=OUT,
        which_plots=["base", "tempering", "advanced"],
    )
    plots.produce_plots(burn=100)
    print("PT plots written:", sorted(os.listdir(OUT)))


def rj_pulses():
    """RJ pulse search -> leaves histograms / evolution plots."""
    rng = np.random.default_rng(7)
    t_np = np.linspace(0, 10, 96)
    sigma = 0.4
    data_np = 3.0 * np.exp(-((t_np - 3.0) ** 2) / (2 * 0.5**2))
    data_np = data_np + 2.0 * np.exp(-((t_np - 7.0) ** 2) / (2 * 0.4**2))
    data_np = data_np + sigma * rng.standard_normal(len(t_np))
    t, data = jnp.asarray(t_np), jnp.asarray(data_np)

    def log_like(coords, inds):
        a, b, c = coords[:, 0], coords[:, 1], coords[:, 2]
        p = a[:, None] * jnp.exp(
            -((t[None] - b[:, None]) ** 2) / (2 * c[:, None] ** 2)
        )
        tmpl = jnp.sum(jnp.where(inds[:, None], p, 0.0), axis=0)
        return -0.5 * jnp.sum(((tmpl - data) / sigma) ** 2)

    priors = ProbDistContainer(
        {
            0: uniform_dist(0.5, 5.0),
            1: uniform_dist(0.0, 10.0),
            2: uniform_dist(0.1, 2.0),
        }
    )
    ntemps, nwalkers, nmax = 8, 64, 4
    ens = EnsembleSampler(
        nwalkers,
        3,
        log_like,
        priors,
        nleaves_max=nmax,
        nleaves_min=0,
        moves=RedBlueGroupStretchMove(),  # RJ-correct in-model stretch
        rj_moves=True,
        tempering_kwargs=dict(ntemps=ntemps),
        fill_zero_leaves_val=float(-0.5 * np.sum((data_np / sigma) ** 2)),
        seed=1,
    )
    coords = priors.rvs(size=(ntemps, nwalkers, nmax))
    inds = np.random.default_rng(2).random((ntemps, nwalkers, nmax)) < 0.3
    ens.run_mcmc(
        State({"model_0": coords}, inds={"model_0": inds}), _steps(800), burn=_steps(300)
    )

    plots = PlotContainer(
        fp="rj_pulses",
        backend=ens.backend,
        plot_dir=OUT,
        which_plots=["base", "rj"],
    )
    plots.produce_plots(burn=100)
    nleaves = ens.get_nleaves()["model_0"][:, 0]
    print(
        "RJ plots written; mean leaf count (cold chain):",
        float(nleaves.mean()),
    )


if __name__ == "__main__":
    os.makedirs(OUT, exist_ok=True)
    pt_gaussian()
    rj_pulses()
