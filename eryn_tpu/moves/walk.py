"""Goodman & Weare "walk" move.

Another classic ensemble proposal the reference only stubs as a
commented-out import (``/root/reference/src/eryn/moves/__init__.py:3-23``).
Goodman & Weare (2010) §3: a walker steps by a random linear combination of
the complement's deviations from their mean,

    ``q = s + sum_j z_j (c_j - c_mean)``,  ``z_j ~ N(0, 1)``,

which is symmetric (factors = 0) and affine-invariant.  The whole
half-ensemble update is one batched matmul ``Z @ (C - C_mean)`` over
``(ntemps, ns, nc) x (ntemps, nc, D)`` — no per-walker loops.

``s0`` restricts each walker's combination to a random subset of the
complement (Bernoulli mask with mean size ``s0``, still symmetric); the
default uses the full complement like emcee's ``WalkMove(s=None)``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .red_blue import RedBlueMove

__all__ = ["WalkMove"]


class WalkMove(RedBlueMove):
    """Goodman-Weare walk proposal (see module docstring).

    Args:
        s0: expected number of complement walkers entering each walker's
            combination (``None`` = all of them).
        scale: overall step scale multiplying the combination (default
            ``1/sqrt(nc_eff)``, which keeps the proposal covariance equal to
            the complement's sample covariance independent of ensemble
            size).
    """

    def __init__(self, s0=None, scale=None, **kwargs):
        super().__init__(**kwargs)
        self.s0 = s0
        self.scale = scale

    def get_proposal_kernel(self, key, s_coords, c_coords, s_inds, param_masks=None):
        names = list(s_coords.keys())
        first = s_coords[names[0]]
        ntemps, ns = first.shape[:2]
        dtype = first.dtype

        branch_keys = jax.random.split(key, len(names))
        newpos = {}
        for name, kb in zip(names, branch_keys):
            s = s_coords[name]
            c = c_coords[name]
            nt, nc, nl, nd = c.shape
            kz, km = jax.random.split(kb)
            z = jax.random.normal(kz, (ntemps, ns, nc), dtype=dtype)
            if self.s0 is not None:
                p = jnp.clip(float(self.s0) / nc, 0.0, 1.0)
                mask = (
                    jax.random.uniform(km, (ntemps, ns, nc), dtype=dtype) < p
                ).astype(dtype)
                z = z * mask
                nc_eff = max(float(self.s0), 1.0)
            else:
                nc_eff = float(nc)
            scale = (
                float(self.scale) if self.scale is not None else nc_eff**-0.5
            )

            if self.periodic is not None:
                # minimum-image deviations: raw differences across a
                # periodic seam would inflate the complement spread
                mean = c.mean(axis=1, keepdims=True)
                dev4 = self.periodic.distance(
                    {name: jnp.broadcast_to(mean, c.shape)}, {name: c}
                )[name]
                dev = dev4.reshape(nt, nc, nl * nd)
            else:
                flat = c.reshape(nt, nc, nl * nd)
                dev = flat - flat.mean(axis=1, keepdims=True)
            # (nt, ns, nc) @ (nt, nc, D) -> (nt, ns, D): the whole
            # half-ensemble update in one batched matmul, at full f32
            # precision (the default may round operands to TF32/bf16)
            step = (
                jnp.einsum(
                    "tsc,tcd->tsd",
                    z,
                    dev,
                    precision=jax.lax.Precision.HIGHEST,
                )
                * scale
            )
            q = s + step.reshape(ntemps, ns, nl, nd)
            if self.periodic is not None:
                q = self.periodic.wrap({name: q})[name]
            newpos[name] = q

        factors = jnp.zeros((ntemps, ns), dtype=dtype)
        return newpos, factors
