"""Metropolis move with Gaussian proposals.

JAX re-design of ``/root/reference/src/eryn/moves/gaussian.py:38-195``.
Covariance specs (scalar / diagonal / full per branch) are baked into static
proposal parameters; the ``vector``/``random``/``sequential`` update modes are
expressed as fused masked vector ops over the whole ensemble, with the
sequential-dimension counter carried in the move's traced kernel state.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from .mh import MHMove

__all__ = ["GaussianMove"]

_ALLOWED_MODES = ("vector", "random", "sequential")


class _BranchProposal:
    """Static per-branch proposal parameters (ref ``gaussian.py:134-195``)."""

    def __init__(self, cov, factor, mode):
        self.kind = None
        try:
            scale = float(cov)
            if scale <= 0:
                raise ValueError("covariance must be positive.")
            self.kind = "isotropic"
            self.scale = np.sqrt(scale)
        except TypeError:
            cov = np.atleast_1d(np.asarray(cov, dtype=np.float64))
            if cov.ndim == 1:
                if np.any(cov <= 0):
                    # a negative variance would give NaN scales and a chain
                    # that silently never accepts
                    raise ValueError(
                        "diagonal covariance entries must be positive."
                    )
                self.kind = "diagonal"
                self.scale = np.sqrt(cov)
            elif cov.ndim == 2 and cov.shape[0] == cov.shape[1]:
                self.kind = "full"
                self.chol = np.linalg.cholesky(cov)
            else:
                raise ValueError("Invalid proposal scale dimensions")

        if factor is None:
            self.log_factor = None
        else:
            if factor < 1.0:
                raise ValueError("'factor' must be >= 1.0")
            self.log_factor = float(np.log(factor))

        if mode not in _ALLOWED_MODES:
            raise ValueError(
                f"'{mode}' is not a recognized mode. Please select from: "
                f"{_ALLOWED_MODES}"
            )
        if self.kind == "full" and mode != "vector":
            raise ValueError("full covariance requires mode='vector'")
        self.mode = mode


class GaussianMove(MHMove):
    """Gaussian MH proposal per branch (ref ``gaussian.py:38-66``).

    Args:
        cov_all: ``{branch_name: scalar | (ndim,) | (ndim, ndim)}`` covariance.
        mode: ``"vector"`` (all dims), ``"random"`` (one random dim per leaf),
            or ``"sequential"`` (cycle dims).
        factor: optional scale jitter ``exp(U(-log f, log f))``.
    """

    #: every mode's stage kernel is symmetric in (x, y) — the scale jitter
    #: and dim choices are drawn independently of the current point — so
    #: DelayedRejection may wrap this move
    symmetric_proposal = True

    def __init__(self, cov_all, mode="vector", factor=None, **kwargs):
        self.all_proposal = {
            name: _BranchProposal(cov, factor, mode) for name, cov in cov_all.items()
        }
        self.mode = mode
        super().__init__(**kwargs)

    def run_branches(self, state):
        names = super().run_branches(state)
        return [n for n in names if n in self.all_proposal]

    def init_kernel_state(self, state):
        # per-branch sequential-dimension counter
        return {
            name: jnp.zeros((), dtype=jnp.int32)
            for name, p in self.all_proposal.items()
            if p.mode == "sequential"
        }

    def get_proposal_kernel(
        self, key, branch_coords, branch_inds, kernel_state, param_masks=None
    ):
        q = {}
        new_kernel_state = dict(kernel_state) if kernel_state else {}
        names = list(branch_coords.keys())
        keys = jax.random.split(key, 2 * len(names))
        ntemps = nwalkers = None
        for i, name in enumerate(names):
            coords = branch_coords[name]
            inds = branch_inds[name]
            ntemps, nwalkers, nleaves_max, ndim = coords.shape
            prop = self.all_proposal[name]
            k_noise, k_extra = keys[2 * i], keys[2 * i + 1]

            noise = jax.random.normal(k_noise, coords.shape, dtype=coords.dtype)
            if prop.kind == "full":
                dx = jnp.matmul(
                    noise,
                    jnp.asarray(prop.chol, dtype=coords.dtype).T,
                    precision=jax.lax.Precision.HIGHEST,
                )
            else:
                dx = noise * jnp.asarray(prop.scale, dtype=coords.dtype)

            if prop.log_factor is not None:
                k_extra, k_fac = jax.random.split(k_extra)
                fac = jnp.exp(
                    jax.random.uniform(
                        k_fac,
                        (),
                        minval=-prop.log_factor,
                        maxval=prop.log_factor,
                        dtype=coords.dtype,
                    )
                )
                dx = dx * fac

            if prop.mode == "random":
                dim = jax.random.randint(
                    k_extra, (ntemps, nwalkers, nleaves_max), 0, ndim
                )
                dim_mask = (
                    jax.lax.broadcasted_iota(
                        jnp.int32, (ntemps, nwalkers, nleaves_max, ndim), 3
                    )
                    == dim[..., None]
                )
                dx = jnp.where(dim_mask, dx, 0.0)
            elif prop.mode == "sequential":
                idx = kernel_state[name]
                dim_mask = (
                    jax.lax.broadcasted_iota(
                        jnp.int32, (ntemps, nwalkers, nleaves_max, ndim), 3
                    )
                    == idx % ndim
                )
                dx = jnp.where(dim_mask, dx, 0.0)
                new_kernel_state[name] = (idx + 1) % ndim

            mask = None if param_masks is None else param_masks.get(name)
            if mask is not None:
                # gibbs parameter selection zeroes the step in-kernel so the
                # periodic wrap below sees the masked proposal
                dx = jnp.where(jnp.asarray(mask)[None, None, :, :], dx, 0.0)

            # only active leaves move (ref gaussian.py:96-110)
            xnew = jnp.where(inds[..., None], coords + dx, coords)

            if self.periodic is not None:
                xnew = self.periodic.wrap({name: xnew})[name]
            q[name] = xnew

        factors = jnp.zeros(
            (ntemps, nwalkers), dtype=next(iter(q.values())).dtype
        )
        return q, factors, new_kernel_state
