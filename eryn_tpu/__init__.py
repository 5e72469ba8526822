"""eryn_tpu: a JAX "omni-MCMC" ensemble sampler.

A from-scratch JAX/XLA re-design with the capabilities of the reference Eryn
sampler (mikekatz04/Eryn): affine-invariant ensemble MCMC with parallel
tempering (adaptive ladder), multiple simultaneous model types ("branches"),
reversible-jump moves over static-shape leaf masks, a proposal zoo, HDF5
checkpoint/resume, priors, and diagnostics — with the entire hot loop
(propose → accept → temperature swaps → adaptation) compiled as one jitted
``lax.scan`` step over the ``(ntemps, nwalkers)`` ensemble.
"""

__version__ = "0.1.0"

from .ensemble import EnsembleSampler, walkers_independent
from .model import Model
from .state import Branch, BranchSupplemental, ParaState, State
from .prior import (
    MappedUniformDistribution,
    ProbDistContainer,
    UniformDistribution,
    log_uniform,
    uniform_dist,
)
from .backends import Backend, DeviceBackend, HDFBackend, TempHDFBackend

__all__ = [
    "EnsembleSampler",
    "walkers_independent",
    "Model",
    "Backend",
    "DeviceBackend",
    "HDFBackend",
    "TempHDFBackend",
    "State",
    "Branch",
    "BranchSupplemental",
    "ParaState",
    "ProbDistContainer",
    "UniformDistribution",
    "MappedUniformDistribution",
    "uniform_dist",
    "log_uniform",
    "__version__",
]
