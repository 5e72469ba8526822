"""Adaptive independence Metropolis-Hastings — the DIME component.

No reference equivalent.  The adaptive-proposal half of the DIME sampler
(Boehl 2022, "DIME MCMC: a simple and robust estimator for Bayesian
inference"): a multivariate Student-t independence proposal whose
location/scale are fitted to an exponentially discounted history of the
ensemble itself.  Because the proposal accumulates EVERY past iteration
(unlike :class:`~eryn_tpu.moves.kde.KDEMove`, which densities only the
current complement half), it learns all discovered posterior modes and
proposes global jumps between them — the robust multimodal workhorse.

DIME itself is the schedule ``moves=[(DEMove(), 1 - p), (AIMHMove(), p)]``
with small ``p`` (component-wise mixture MH: each sampler step picks one
component with fixed probability and accepts with that component's own
Hastings ratio, which is exactly valid).

The independence structure makes the whole ensemble updatable at once
(the proposal does not depend on the walker being moved), and the
discounted-moment fit is three small reductions per rung — everything
stays inside the compiled step.  Adaptation freezes after ``tune_steps``
AIMH proposals; afterwards the kernel is a fixed independence sampler, so
detailed balance is exact.  NOTE: in a weighted schedule ``tune_steps``
counts this move's SELECTIONS, not sampler steps — to freeze inside
burn-in choose roughly ``tune_steps ~ weight * burn``.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from .move import Move, mh_accept, state_branch_supps
from .tempering import tempered_log_likelihood

__all__ = ["AIMHMove"]


class AIMHMove(Move):
    """Adaptive Student-t independence proposal (per temperature rung).

    Args:
        df: Student-t degrees of freedom (heavy tails keep global jumps
            alive; Boehl's default is 10).
        rho: per-proposal discount factor on the accumulated ensemble
            moments (0.999 keeps a long memory; smaller adapts faster).
        tune_steps: number of adapting AIMH proposals, after which the
            fitted proposal freezes (0 disables adaptation: the
            initial-ensemble fit is used forever).  Counts this move's
            selections, not sampler steps.
        jitter: RELATIVE diagonal floor on the fitted covariance — scaled
            by the mean per-rung variance, like
            :class:`~eryn_tpu.moves.kde.KDEMove`'s regularizer.

    Notes:
        Requires fixed-dimension models: reversible-jump leaf masks change
        the meaning of the flattened parameter vector, so the sampler
        rejects the move in RJ configurations (``requires_fixed_dimension``)
        and ``init_kernel_state`` re-checks the masks.  Periodic
        parameters are rejected like :class:`KDEMove` (exact independence
        factors on a torus need image sums).  Tempered runs fit separate
        moments per rung.
    """

    #: checked by the sampler: this move cannot run under reversible jump
    requires_fixed_dimension = True

    def __init__(self, df=10.0, rho=0.999, tune_steps=500, jitter=1e-6, **kwargs):
        super().__init__(**kwargs)
        if df <= 2.0:
            raise ValueError("df must exceed 2 (finite proposal covariance).")
        self.df = float(df)
        self.rho = float(rho)
        self.tune_steps = int(tune_steps)
        self.jitter = float(jitter)

    # ------------------------------------------------------------------
    def _flatten(self, state, names):
        """(ntemps, nwalkers, D) flattened coordinates of the run branches."""
        nt, nw = state.log_like.shape
        return jnp.concatenate(
            [state.branches_coords[n].reshape(nt, nw, -1) for n in names],
            axis=-1,
        )

    def _unflatten(self, state, names, flat):
        out = {}
        off = 0
        for n in names:
            shape = state.branches_coords[n].shape
            k = int(np.prod(shape[2:]))
            out[n] = flat[..., off : off + k].reshape(shape)
            off += k
        return out

    @staticmethod
    def _batch_moments(x):
        """Per-rung mean and CENTERED covariance of one ensemble
        ``x`` (nt, nw, D) — centered accumulation, so a posterior far from
        the origin cannot cancel catastrophically in float32 (the raw
        E[xx^T] - mm^T form loses small variances at means ~sqrt(1/eps))."""
        nw = x.shape[1]
        mean = x.mean(axis=1)  # (nt, D)
        d = x - mean[:, None, :]
        # HIGHEST: the fitted covariance feeds a Cholesky whose density
        # must match the realized draws exactly — reduced-precision (bf16 or
        # TF32) passes would mis-specify the proposal density the Hastings
        # factor uses
        cov = (
            jnp.einsum(
                "twi,twj->tij", d, d, precision=jax.lax.Precision.HIGHEST
            )
            / nw
        )  # (nt, D, D)
        return mean, cov

    def _reject_periodic(self, state, names):
        if self.periodic is not None and any(
            self.periodic._vector_for(
                n, state.branches_coords[n].shape[-1]
            )
            is not None
            for n in names
        ):
            # exact independence factors on a periodic dimension need a
            # sum over periodic images in the density; single-image
            # factors on wrapped draws bias the chain near the seam —
            # fail loudly (same contract as KDEMove)
            raise ValueError(
                "AIMHMove does not support periodic parameters: the "
                "Student-t independence factors are computed on the "
                "unwrapped space. Use DEMove/StretchMove for periodic "
                "dimensions."
            )

    def init_kernel_state(self, state):
        names = self.run_branches(state)
        self._reject_periodic(state, names)
        for n in names:
            m = state.branches_inds[n]
            if isinstance(m, jax.core.Tracer):
                # traced init (external jitted drivers): the sampler path
                # validates eagerly; a tracer cannot be concretized here
                continue
            if not np.asarray(m).all():
                raise ValueError(
                    "AIMHMove requires fixed-dimension models (all leaves "
                    "active): reversible-jump masks change the meaning of "
                    "the flattened parameter vector. Use KDEMove/DEMove "
                    "for trans-dimensional targets."
                )
        x = self._flatten(state, names)
        dtype = state.log_like.dtype
        nt, nw, _D = x.shape
        mean, cov = self._batch_moments(x)
        return {
            "w": jnp.full((nt,), float(nw), dtype),
            "mean": mean,
            "cov": cov,
            "t": jnp.zeros((), jnp.int32),
        }

    def _proposal_params(self, ks, dtype, D):
        """(mean, cholesky of covariance) per rung, with a RELATIVE
        diagonal floor (scaled by the mean per-rung variance)."""
        mean, cov = ks["mean"], ks["cov"]
        var_scale = jnp.trace(cov, axis1=-2, axis2=-1) / D  # (nt,)
        eye = jnp.eye(D, dtype=dtype)[None]
        cov = cov + (
            self.jitter * jnp.maximum(var_scale, 1e-30)[:, None, None] * eye
        )
        chol = jnp.linalg.cholesky(cov)
        return mean, chol

    def _t_logpdf(self, x, mean, chol):
        """Multivariate Student-t log-kernel per (rung, walker) — the
        normalization and determinant terms are shared by the forward and
        reverse densities of the same rung and cancel in the Hastings
        ratio, so only the quadratic form matters."""
        D = x.shape[-1]
        d = x - mean[:, None, :]
        y = jax.vmap(
            lambda L, dd: jax.scipy.linalg.solve_triangular(
                L, dd.T, lower=True
            ).T
        )(chol, d)
        q = jnp.sum(y**2, axis=-1)  # (nt, nw)
        return -0.5 * (self.df + D) * jnp.log1p(q / self.df)

    def _chisquare(self, key, shape, dtype):
        """chi-square(df) draws without ``jax.random.chisquare``.

        JAX's gamma sampler is a rejection loop (a while loop inside the
        step, run until every lane accepts).  For integer ``df`` the exact
        decomposition chi2(df) = -2 sum log U_i (+ Z^2 for odd df) needs
        only ceil(df/2) uniforms and one normal: pure vector ops.
        Non-integer ``df`` keeps the library sampler."""
        df = self.df
        if not float(df).is_integer() or not (0 < df <= 512):
            return jax.random.chisquare(key, df, shape=shape).astype(dtype)
        k = int(df)
        k_u, k_n = jax.random.split(key)
        halves = k // 2
        u = jnp.zeros(shape, dtype)
        if halves:
            uu = jax.random.uniform(
                k_u,
                shape + (halves,),
                dtype,
                minval=jnp.finfo(dtype).tiny,
                maxval=1.0,
            )
            u = -2.0 * jnp.sum(jnp.log(uu), axis=-1)
        if k % 2:
            zz = jax.random.normal(k_n, shape, dtype)
            u = u + zz * zz
        return u

    def _propose_impl(self, key, state, ctx, kernel_state=()):
        if self.gibbs_sampling_setup_input is not None:
            raise ValueError(
                "gibbs_sampling_setup is not supported by AIMHMove (the "
                "fitted proposal is joint over the flattened parameters); "
                "use proposal_branch_names to restrict branches."
            )
        names = self.run_branches(state)
        self._reject_periodic(state, names)
        ks = kernel_state if isinstance(kernel_state, dict) else None
        dtype = state.log_like.dtype
        nt, nw = state.log_like.shape
        x = self._flatten(state, names)
        D = x.shape[-1]

        if ks is None:
            # bare kernel call: fit to the current ensemble, traced (no
            # host-side mask validation — init_kernel_state does that on
            # the sampler path)
            mean0, cov0 = self._batch_moments(x)
            ks = {
                "w": jnp.full((nt,), float(nw), dtype),
                "mean": mean0,
                "cov": cov0,
                "t": jnp.zeros((), jnp.int32),
            }

        mean, chol = self._proposal_params(ks, dtype, D)

        key, k_z, k_u, k_acc = jax.random.split(key, 4)
        z = jax.random.normal(k_z, (nt, nw, D), dtype)
        u = self._chisquare(k_u, (nt, nw), dtype)
        step = jnp.einsum(
            "tij,twj->twi", chol, z, precision=jax.lax.Precision.HIGHEST
        )
        q_flat = mean[:, None, :] + step * jnp.sqrt(
            self.df / jnp.maximum(u, 1e-12)
        )[..., None]
        q_branches = self._unflatten(state, names, q_flat)

        # independence Hastings factor: log q(x_old) - log q(x_new)
        factors = self._t_logpdf(x, mean, chol) - self._t_logpdf(
            q_flat, mean, chol
        )

        # evaluate the proposal
        betas = (
            state.betas
            if state.betas is not None
            else jnp.ones((nt,), dtype=dtype)
        )
        inds = dict(state.branches_inds)
        full = dict(state.branches_coords)
        full.update(q_branches)
        supps = state_branch_supps(state)
        lp1 = ctx.compute_log_prior(full, inds)
        ll1, blobs1 = ctx.compute_log_like(full, inds, lp1, supps)

        logP_new = tempered_log_likelihood(ll1, betas) + lp1
        logP_old = (
            tempered_log_likelihood(state.log_like, betas) + state.log_prior
        )
        acc = mh_accept(k_acc, factors, logP_new, logP_old)

        new_coords = dict(state.branches_coords)
        for n in names:
            new_coords[n] = jnp.where(
                acc[:, :, None, None], q_branches[n], state.branches_coords[n]
            )
        logl = jnp.where(acc, ll1, state.log_like)
        logp = jnp.where(acc, lp1, state.log_prior)
        blobs = state.blobs
        if blobs is not None and blobs1 is not None:
            acc_b = acc.reshape(acc.shape + (1,) * (blobs.ndim - 2))
            blobs = jnp.where(acc_b, blobs1, blobs)

        if self.tune_steps > 0:
            # discounted WEIGHTED MERGE of the post-accept ensemble into
            # the running centered moments (exact for discounted weights;
            # no raw second moments anywhere, so no f32 cancellation).
            # lax.cond skips the O(nt*nw*D^2) reductions once frozen.
            x_new = jnp.where(acc[..., None], q_flat, x)

            def do_update(args):
                w, m, C = args
                mb, Cb = self._batch_moments(x_new)
                w_old = self.rho * w
                w_new = w_old + nw
                delta = mb - m
                frac = (nw / w_new)[:, None]
                m_new = m + frac * delta
                cross = jnp.einsum(
                    "ti,tj->tij",
                    delta,
                    delta,
                    precision=jax.lax.Precision.HIGHEST,
                )
                C_new = (
                    w_old[:, None, None] * C
                    + nw * Cb
                    + (w_old * nw / w_new)[:, None, None] * cross
                ) / w_new[:, None, None]
                return w_new, m_new, C_new

            tuning = ks["t"] < self.tune_steps
            w2, m2, C2 = jax.lax.cond(
                tuning,
                do_update,
                lambda args: args,
                (ks["w"], ks["mean"], ks["cov"]),
            )
            ks = {"w": w2, "mean": m2, "cov": C2, "t": ks["t"] + 1}

        new_state = state.replace(
            coords=new_coords,
            inds=inds,
            log_like=logl,
            log_prior=logp,
            blobs=blobs,
        )
        return new_state, acc, ks
