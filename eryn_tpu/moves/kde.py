"""Kernel-density-estimate ensemble proposal.

Another classic ensemble proposal the reference only stubs as a
commented-out import (``/root/reference/src/eryn/moves/__init__.py:3-23``):
fit a Gaussian KDE to the complement half and propose *independent* draws
from it.  Because the proposal does not depend on the current point, the
detailed-balance factors are ``log q(s) - log q(q_new)``.

Formulation: the KDE density at ``m`` points against ``nc``
kernels is an ``(m, nc)`` Mahalanobis-distance matrix — two batched
matmuls against the whitening Cholesky factor — followed by a
``logsumexp`` over kernels; sampling is one categorical pick plus a
triangular matmul.  Everything batches over ``(ntemps, nwalkers)``; the
only per-temperature sequential work is a ``D x D`` Cholesky.

Bandwidth: Scott's rule, ``h = nc**(-1/(d+4))``, on the complement's
sample covariance (regularized by ``jitter``).

Intended for fully-active branches (no reversible jump): with leaf masks
the padded inactive columns would enter the covariance.  Formally the move
remains valid on the padded space (uniform-extension argument), but the
bandwidth then reflects junk columns — prefer :class:`DEMove` or
:class:`StretchMove` under RJ.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .red_blue import RedBlueMove

__all__ = ["KDEMove"]


class KDEMove(RedBlueMove):
    """Gaussian-KDE independent proposal from the complement half.

    Args:
        bw_method: bandwidth scale factor; ``None`` uses Scott's rule
            ``nc ** (-1 / (d + 4))``.
        jitter: diagonal regularization added to the complement covariance
            before the Cholesky (default 1e-10 of the mean variance).
    """

    def __init__(self, bw_method=None, jitter=1e-10, **kwargs):
        super().__init__(**kwargs)
        self.bw_method = bw_method
        self.jitter = float(jitter)

    def _kde_logpdf(self, x, kernels, chol_inv, logdet, d):
        """log KDE density of ``x`` ``(nt, m, d)`` against ``kernels``
        ``(nt, nc, d)`` with whitening ``chol_inv`` ``(nt, d, d)``."""
        nc = kernels.shape[1]
        # whiten both sets: mahalanobis^2 = |W x - W mu|^2
        # f32 matmuls default to reduced-precision passes (TF32 on a GPU);
        # these values enter the Hastings factors, so ask for full f32
        hi = jax.lax.Precision.HIGHEST
        xw = jnp.einsum("tmd,tde->tme", x, chol_inv, precision=hi)
        kw = jnp.einsum("tnd,tde->tne", kernels, chol_inv, precision=hi)
        # pairwise squared distances via the matmul expansion
        x2 = jnp.sum(xw**2, axis=-1)[:, :, None]
        k2 = jnp.sum(kw**2, axis=-1)[:, None, :]
        cross = jnp.einsum("tme,tne->tmn", xw, kw, precision=hi)
        maha = x2 + k2 - 2.0 * cross
        logk = -0.5 * maha - 0.5 * logdet[:, None, None]
        logk = logk - 0.5 * d * jnp.log(2.0 * jnp.pi)
        return jax.scipy.special.logsumexp(logk, axis=-1) - jnp.log(
            jnp.asarray(nc, dtype=x.dtype)
        )

    def get_proposal_kernel(self, key, s_coords, c_coords, s_inds, param_masks=None):
        if param_masks is not None and any(
            m is not None for m in param_masks.values()
        ):
            # a post-hoc Gibbs mask would keep the full-draw Hastings factors
            # while realizing only the masked coordinates -> biased chain.
            # The marginal-KDE factors are not implemented; fail loudly.
            raise ValueError(
                "KDEMove does not support Gibbs parameter masks: the "
                "independence factors are computed for the full KDE draw. "
                "Use DEMove/StretchMove for Gibbs-split updates."
            )
        names = list(s_coords.keys())
        if self.periodic is not None and any(
            self.periodic._vector_for(n, s_coords[n].shape[-1]) is not None
            for n in names
        ):
            # exact independence factors on a periodic dimension need
            # wrapped kernels (a sum over periodic images in the density);
            # unwrapped draws with raw factors would bias the chain near
            # the seam — fail loudly instead
            raise ValueError(
                "KDEMove does not support periodic parameters: the KDE "
                "independence factors are computed on the unwrapped space. "
                "Use DEMove/StretchMove for periodic dimensions."
            )
        first = s_coords[names[0]]
        ntemps, ns = first.shape[:2]
        dtype = first.dtype

        branch_keys = jax.random.split(key, len(names))
        newpos = {}
        factors = jnp.zeros((ntemps, ns), dtype=dtype)
        for name, kb in zip(names, branch_keys):
            s = s_coords[name]
            c = c_coords[name]
            nt, nc, nl, nd = c.shape
            d = nl * nd
            if nc <= d:
                raise ValueError(
                    f"KDEMove needs more complement walkers ({nc}) than "
                    f"parameters ({d}) for a non-singular KDE covariance."
                )
            flat_c = c.reshape(nt, nc, d)
            flat_s = s.reshape(nt, ns, d)

            mean = flat_c.mean(axis=1, keepdims=True)
            dev = flat_c - mean
            cov = jnp.einsum("tnd,tne->tde", dev, dev) / (nc - 1)
            var_scale = jnp.trace(cov, axis1=1, axis2=2) / d
            cov = cov + (self.jitter * var_scale)[:, None, None] * jnp.eye(
                d, dtype=dtype
            )
            bw = (
                float(self.bw_method)
                if self.bw_method is not None
                else nc ** (-1.0 / (d + 4))
            )
            cov = cov * bw**2
            chol = jnp.linalg.cholesky(cov)  # (nt, d, d) lower
            # whitening operator: solve L W = I  ->  W = L^{-1}
            eye = jnp.broadcast_to(jnp.eye(d, dtype=dtype), (nt, d, d))
            chol_inv = jax.scipy.linalg.solve_triangular(
                chol, eye, lower=True
            ).transpose(0, 2, 1)  # x @ chol_inv whitens rows
            logdet = 2.0 * jnp.sum(
                jnp.log(jnp.diagonal(chol, axis1=1, axis2=2)), axis=-1
            )

            kpick, kstep = jax.random.split(kb)
            pick = jax.random.randint(kpick, (nt, ns), 0, nc)
            centers = jnp.take_along_axis(flat_c, pick[:, :, None], axis=1)
            eps = jax.random.normal(kstep, (nt, ns, d), dtype=dtype)
            q = centers + jnp.einsum("tsd,ted->tse", eps, chol)
            newpos[name] = q.reshape(ntemps, ns, nl, nd)

            logq_old = self._kde_logpdf(flat_s, flat_c, chol_inv, logdet, d)
            logq_new = self._kde_logpdf(q, flat_c, chol_inv, logdet, d)
            factors = factors + (logq_old - logq_new)

        return newpos, factors
