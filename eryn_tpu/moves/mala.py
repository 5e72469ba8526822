"""Metropolis-adjusted Langevin (MALA) move — a JAX extension.

No reference equivalent: the reference's NumPy likelihoods are opaque, so
gradient-guided proposals are impossible there.  Here the likelihood and the
priors are traced JAX functions, so ``jax.grad`` differentiates the tempered
log-posterior through the *user's own model* for free, and the whole
drift-propose-accept step stays inside the compiled sampler step.

Proposal (per walker, per active leaf):

    q = x + (eps^2 / 2) * M * grad logP(x) + eps * sqrt(M) * xi,  xi ~ N(0, I)

with the exact MH correction using the reverse drift at ``q``.  ``logP`` is
the tempered posterior ``beta * logl + logp``, so hot chains take
proportionally smaller likelihood drifts.  Gradients of inactive RJ leaves
are identically zero (the masked likelihood/prior contract guarantees it),
so the move is reversible-jump compatible: it updates active leaves only.

Requires a traceable likelihood (the host-callback bridge is not
differentiable).  Costs two likelihood+gradient evaluations per step, repaid
by far higher ESS per step on smooth targets.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from ..ops.perm import invert_permutation

from .move import Move, mh_accept, state_branch_supps
from .tempering import tempered_log_likelihood

__all__ = ["MALAMove"]


class MALAMove(Move):
    """Langevin proposal with exact MH correction.

    Args:
        eps: step size — scalar (all branches) or ``{branch: scalar or
            (ndim,) array}`` for per-parameter preconditioning (the diagonal
            mass matrix ``M = eps_vec^2 / eps_scalar^2`` absorbed into eps).
        target_acceptance: when ``tune_steps > 0``, dual-averaging adapts a
            global log-step-size multiplier toward this cold-chain
            acceptance (0.574 is MALA-optimal) for the first ``tune_steps``
            proposals, then freezes (the adaptation state lives in the
            traced kernel state, so it works inside compiled segments).
        tune_steps: number of adapting proposals (0 disables adaptation).
        ensemble_precondition: emcee-style diagonal preconditioning from the
            ensemble itself — walkers update in two halves, each using the
            *complement half's* per-parameter standard deviation as the mass
            matrix. The scale is independent of the walkers being moved, so
            detailed balance holds exactly (the same argument as the stretch
            move), and the proposal adapts to anisotropic targets for free.
    """

    #: dual-averaging constants (Hoffman & Gelman 2014, NUTS sec. 3.2)
    _DA_GAMMA = 0.05
    _DA_T0 = 10.0
    _DA_KAPPA = 0.75
    #: optimal-scaling step-size heuristic for ``eps=None``:
    #: eps = CONST * sigma * d^(-EXP) (Roberts & Rosenthal 1998: MALA
    #: step variance scales as d^(-1/3) at 0.574 acceptance)
    _EPS_DIM_EXP = 1.0 / 6.0
    _EPS_DIM_CONST = 1.65

    def __init__(
        self,
        eps=None,
        target_acceptance=0.574,
        tune_steps=500,
        ensemble_precondition=False,
        **kwargs,
    ):
        super().__init__(**kwargs)
        self.eps = eps
        self.ensemble_precondition = bool(ensemble_precondition)
        self.target_acceptance = float(target_acceptance)
        self.tune_steps = int(tune_steps)

    def _eps_base(self, state):
        """Dimension-aware default step sizes (``eps=None``): per-parameter
        spread of the initial cold-temperature ensemble scaled by the
        optimal-scaling dimension factor.  Frozen at kernel-state init (a
        constant thereafter); dual averaging multiplies it by a global
        scalar that freezes after ``tune_steps``, so run the adaptation
        during burn-in."""
        names = self.run_branches(state)
        d_total = max(
            sum(
                state.branches[n].nleaves_max * state.branches[n].ndim
                for n in names
            ),
            1,
        )
        dim_factor = float(d_total) ** (-self._EPS_DIM_EXP)
        out = {}
        for n in names:
            c = state.branches_coords[n][0]
            m = state.branches_inds[n][0][..., None].astype(c.dtype)
            cnt = m.sum(axis=(0, 1))
            mean = (c * m).sum(axis=(0, 1)) / jnp.maximum(cnt, 1.0)
            var = (((c - mean) ** 2) * m).sum(axis=(0, 1)) / jnp.maximum(
                cnt - 1.0, 1.0
            )
            sig = jnp.sqrt(var)
            sig = jnp.where((cnt > 1.0) & (sig > 0.0), sig, 1.0)
            out[n] = self._EPS_DIM_CONST * dim_factor * sig
        return out

    def _eps_for(self, name, ndim, dtype, kernel_state=None):
        eps = self.eps
        if eps is None:
            base = None
            if isinstance(kernel_state, dict):
                base = kernel_state.get("eps_base", {}).get(name)
            if base is not None:
                return jnp.asarray(base, dtype=dtype)
            eps = 0.1  # no kernel state supplied (bare kernel call)
        if isinstance(eps, dict):
            eps = eps[name]
        eps = jnp.asarray(eps, dtype=dtype)
        return jnp.broadcast_to(eps, (ndim,))

    # -- dual-averaging step-size adaptation --------------------------------
    def init_kernel_state(self, state):
        dtype = state.log_like.dtype
        ks = {
            "log_scale": jnp.zeros((), dtype),      # current log multiplier
            "log_scale_avg": jnp.zeros((), dtype),  # averaged iterate
            "h_avg": jnp.zeros((), dtype),          # averaged error
            "t": jnp.zeros((), jnp.int32),
        }
        if self.eps is None:
            ks["eps_base"] = {
                n: v.astype(dtype) for n, v in self._eps_base(state).items()
            }
        return ks

    def _adapt_scale(self, kernel_state, acc):
        """One dual-averaging update from the cold-chain mean acceptance.
        Frozen (identity) once ``t >= tune_steps``."""
        if self.tune_steps <= 0:
            return kernel_state, jnp.zeros((), acc.dtype)
        ks = kernel_state
        tuning = ks["t"] < self.tune_steps
        t = ks["t"] + 1
        tf = t.astype(acc.dtype)
        a_mean = acc[0].mean()  # cold chain
        err = self.target_acceptance - a_mean
        h_avg = jnp.where(
            tuning,
            (1.0 - 1.0 / (tf + self._DA_T0)) * ks["h_avg"]
            + err / (tf + self._DA_T0),
            ks["h_avg"],
        )
        log_scale = jnp.where(
            tuning,
            -jnp.sqrt(tf) / self._DA_GAMMA * h_avg,
            ks["log_scale"],
        )
        w = tf ** (-self._DA_KAPPA)
        log_scale_avg = jnp.where(
            tuning,
            w * log_scale + (1.0 - w) * ks["log_scale_avg"],
            ks["log_scale_avg"],
        )
        new_ks = {
            **ks,  # preserves eps_base and subclass-added entries
            "log_scale": log_scale,
            "log_scale_avg": log_scale_avg,
            "h_avg": h_avg,
            "t": t,
        }
        use = jnp.where(tuning, ks["log_scale"], ks["log_scale_avg"])
        return new_ks, use

    def _current_scale(self, kernel_state, dtype):
        if self.tune_steps <= 0 or not kernel_state:
            return jnp.ones((), dtype)
        tuning = kernel_state["t"] < self.tune_steps
        ls = jnp.where(
            tuning, kernel_state["log_scale"], kernel_state["log_scale_avg"]
        )
        return jnp.exp(ls).astype(dtype)

    # -- shared setup / epilogue for gradient moves (HMC subclasses) --------
    def _grad_setup(self, state, ctx):
        """Common pieces of a gradient proposal: branch selection, the
        tempered-log-posterior closure (separable over walkers, so the
        gradient of the sum IS the per-walker gradient), and its grad fn."""
        if self.gibbs_sampling_setup_input is not None:
            raise ValueError(
                "gibbs_sampling_setup is not supported by gradient moves "
                "(MALA/HMC update all selected branches jointly); use "
                "proposal_branch_names to restrict branches."
            )
        names = self.run_branches(state)
        coords = {n: state.branches_coords[n] for n in names}
        inds = dict(state.branches_inds)
        other = {
            n: state.branches_coords[n]
            for n in state.branches_coords
            if n not in names
        }
        dtype = state.log_like.dtype
        ntemps = state.log_like.shape[0]
        betas = (
            state.betas
            if state.betas is not None
            else jnp.ones((ntemps,), dtype=dtype)
        )
        supps = state_branch_supps(state)

        def logP_sum(active_coords):
            full = {**other, **active_coords}
            lp = ctx.compute_log_prior(full, inds)
            ll, blobs = ctx.compute_log_like(full, inds, lp, supps)
            logP = tempered_log_likelihood(ll, betas) + lp
            return (
                jnp.sum(jnp.where(jnp.isfinite(logP), logP, 0.0)),
                (ll, lp, blobs),
            )

        raw_grad_fn = jax.value_and_grad(logP_sum, has_aux=True)

        def grad_fn(active_coords):
            (val, aux), g = raw_grad_fn(active_coords)
            # a walker at a -inf-logP point has a NaN gradient (the where
            # zeroes the cotangent but 0 * nan = nan in backprop); zero it
            # so the proposal degenerates to a pure noise step that can
            # ESCAPE instead of freezing the walker forever
            g = jax.tree_util.tree_map(
                lambda a: jnp.where(jnp.isfinite(a), a, 0.0), g
            )
            return (val, aux), g

        return names, coords, inds, betas, dtype, grad_fn

    def _wrap_periodic(self, name, q):
        if self.periodic is not None:
            return self.periodic.wrap({name: q})[name]
        return q

    def _displacement(self, name, a, b):
        """Signed displacement ``b - a`` using the nearest periodic image
        when the branch has periodic parameters (same treatment as the rest
        of the move suite; exact in the small-step limit)."""
        if self.periodic is not None:
            # PeriodicContainer.distance(p1, p2) = p2 - p1, nearest image
            return self.periodic.distance({name: a}, {name: b})[name]
        return b - a

    @staticmethod
    def _acceptance_probability(state, betas, factors, ll1, lp1):
        """Per-walker MH acceptance PROBABILITY alpha = min(1, exp(...)) —
        the single definition shared by the dual-averaging update and the
        ChEES gradient weighting (Hoffman & Gelman 2014 use the
        probability, lower-variance than the 0/1 outcomes)."""
        logP_new = tempered_log_likelihood(ll1, betas) + lp1
        logP_old = (
            tempered_log_likelihood(state.log_like, betas) + state.log_prior
        )
        lnpdiff = factors + logP_new - logP_old
        return jnp.nan_to_num(jnp.exp(jnp.minimum(lnpdiff, 0.0)))

    def _accept_and_merge(
        self, key, state, names, coords, q, factors, ll1, lp1, blobs1,
        betas, dtype, kernel_state,
    ):
        logP_new = tempered_log_likelihood(ll1, betas) + lp1
        logP_old = (
            tempered_log_likelihood(state.log_like, betas) + state.log_prior
        )
        acc = mh_accept(key, factors, logP_new, logP_old)

        new_coords = dict(state.branches_coords)
        for n in names:
            new_coords[n] = jnp.where(acc[:, :, None, None], q[n], coords[n])
        logl = jnp.where(acc, ll1, state.log_like)
        logp = jnp.where(acc, lp1, state.log_prior)
        blobs = state.blobs
        if blobs is not None and blobs1 is not None:
            acc_b = acc.reshape(acc.shape + (1,) * (blobs.ndim - 2))
            blobs = jnp.where(acc_b, blobs1, blobs)

        if self.tune_steps > 0 and kernel_state:
            alpha = self._acceptance_probability(
                state, betas, factors, ll1, lp1
            )
            kernel_state, _ = self._adapt_scale(kernel_state, alpha)

        new_state = state.replace(
            coords=new_coords,
            inds=dict(state.branches_inds),
            log_like=logl,
            log_prior=logp,
            blobs=blobs,
        )
        return new_state, acc, kernel_state

    def _complement_sigma(self, coords_c, inds_c):
        """Per-parameter std of the complement half, masked to active
        leaves: shape ``(ntemps, 1, nleaves_max, ndim)`` (1.0 where fewer
        than two active samples exist)."""
        mm = inds_c[..., None].astype(coords_c.dtype)
        cnt = mm.sum(axis=1, keepdims=True)
        mean = (coords_c * mm).sum(axis=1, keepdims=True) / jnp.maximum(
            cnt, 1.0
        )
        var = ((coords_c - mean) ** 2 * mm).sum(
            axis=1, keepdims=True
        ) / jnp.maximum(cnt - 1.0, 1.0)
        sig = jnp.sqrt(var)
        return jnp.where((cnt > 1.0) & (sig > 0.0), sig, 1.0)

    def _eps_for_precond(self, name, ndim, dtype, kernel_state):
        """Base step size for the preconditioned path.  With ``eps=None``
        the heuristic ``eps_base`` already encodes the per-axis ensemble
        sigmas — but the complement-half sigma supplies the anisotropy in
        this path, so using the vector base would scale per-axis steps as
        sigma SQUARED.  Collapse it to its geometric mean (isotropic,
        right overall magnitude); explicit user eps values pass through."""
        vec = self._eps_for(name, ndim, dtype, kernel_state)
        if self.eps is None:
            return jnp.exp(
                jnp.log(jnp.maximum(jnp.abs(vec), 1e-12)).mean()
            ).astype(dtype)
        return vec

    def _propose_impl_precond(
        self, key, state, ctx, kernel_state=(), propose_block=None
    ):
        """Two sequential permuted halves, each preconditioned by the other
        half's per-parameter scales (red/blue structure, so the mass matrix
        never depends on the walkers being moved).

        ``propose_block(key, x, masks_blk, eps_tree, grad_fn, dtype) ->
        (key, q, ll1, lp1, blobs1, factors)`` supplies the proposal core
        for one walker block; ``None`` uses the MALA drift (HMC passes its
        leapfrog trajectory)."""
        if self.gibbs_sampling_setup_input is not None:
            raise ValueError(
                "gibbs_sampling_setup is not supported by gradient moves."
            )
        if propose_block is None:
            propose_block = self._mala_block
        names = self.run_branches(state)
        all_names = list(state.branches_coords.keys())
        ntemps, nwalkers = state.log_like.shape
        dtype = state.log_like.dtype
        betas = (
            state.betas
            if state.betas is not None
            else jnp.ones((ntemps,), dtype=dtype)
        )
        scale = self._current_scale(kernel_state, dtype)

        key, kperm = jax.random.split(key)
        perm = jax.random.permutation(kperm, nwalkers)
        inv_perm = invert_permutation(perm)
        coords_p = {n: state.branches_coords[n][:, perm] for n in all_names}
        inds_p = {n: state.branches_inds[n][:, perm] for n in all_names}
        logl_p = state.log_like[:, perm]
        logp_p = state.log_prior[:, perm]
        blobs_p = state.blobs[:, perm] if state.blobs is not None else None
        acc_p = jnp.zeros((ntemps, nwalkers), dtype=bool)

        n0 = nwalkers - nwalkers // 2
        alpha_sum = jnp.zeros((), dtype)
        for off, ns in ((0, n0), (n0, nwalkers - n0)):
            key, k_acc = jax.random.split(key)

            def blk(x, off=off, ns=ns):
                return x[:, off : off + ns]

            def comp(x, off=off, ns=ns):
                return jnp.concatenate([x[:, :off], x[:, off + ns :]], axis=1)

            eps_tree = {}
            for n in names:
                sigma = self._complement_sigma(
                    comp(coords_p[n]), comp(inds_p[n])
                )
                base = self._eps_for_precond(
                    n, coords_p[n].shape[-1], dtype, kernel_state
                )
                eps_tree[n] = scale * base * sigma  # (nt, 1, nl, nd)

            inds_blk = {n: blk(inds_p[n]) for n in all_names}
            supps_blk = state_branch_supps(state, perm=perm, block=(off, ns))
            fixed = {
                n: blk(coords_p[n]) for n in all_names if n not in names
            }

            def logP_sum(active, inds_blk=inds_blk, supps_blk=supps_blk, fixed=fixed):
                full = {**fixed, **active}
                lp = ctx.compute_log_prior(full, inds_blk)
                ll, blobs = ctx.compute_log_like(full, inds_blk, lp, supps_blk)
                logP = tempered_log_likelihood(ll, betas) + lp
                return (
                    jnp.sum(jnp.where(jnp.isfinite(logP), logP, 0.0)),
                    (ll, lp, blobs),
                )

            raw_grad_fn = jax.value_and_grad(logP_sum, has_aux=True)

            def grad_fn(active_coords, raw_grad_fn=raw_grad_fn):
                (val, aux), g = raw_grad_fn(active_coords)
                # see _grad_setup: zero NaN gradients from -inf-logP points
                g = jax.tree_util.tree_map(
                    lambda a: jnp.where(jnp.isfinite(a), a, 0.0), g
                )
                return (val, aux), g

            x = {n: blk(coords_p[n]) for n in names}
            masks_blk = {n: inds_blk[n][..., None] for n in names}

            key, q, ll1, lp1, blobs1, factors = propose_block(
                key, names, x, masks_blk, eps_tree, grad_fn, dtype
            )

            prev_logl = blk(logl_p)
            prev_logp = blk(logp_p)
            logP_new = tempered_log_likelihood(ll1, betas) + lp1
            logP_old = tempered_log_likelihood(prev_logl, betas) + prev_logp
            acc = mh_accept(k_acc, factors, logP_new, logP_old)
            lnpdiff = factors + logP_new - logP_old
            alpha_sum = alpha_sum + jnp.nan_to_num(
                jnp.exp(jnp.minimum(lnpdiff[0], 0.0))
            ).mean()

            upd = jax.lax.dynamic_update_slice_in_dim
            for n in names:
                coords_p[n] = upd(
                    coords_p[n],
                    jnp.where(acc[:, :, None, None], q[n], x[n]),
                    off,
                    axis=1,
                )
            logl_p = upd(logl_p, jnp.where(acc, ll1, prev_logl), off, axis=1)
            logp_p = upd(logp_p, jnp.where(acc, lp1, prev_logp), off, axis=1)
            if blobs_p is not None and blobs1 is not None:
                acc_b = acc.reshape(acc.shape + (1,) * (blobs_p.ndim - 2))
                blobs_p = upd(
                    blobs_p,
                    jnp.where(acc_b, blobs1, blk(blobs_p)),
                    off,
                    axis=1,
                )
            acc_p = upd(acc_p, acc, off, axis=1)

        if self.tune_steps > 0 and kernel_state:
            kernel_state, _ = self._adapt_scale(
                kernel_state, (0.5 * alpha_sum)[None, None]
            )

        new_coords = {n: coords_p[n][:, inv_perm] for n in all_names}
        new_state = state.replace(
            coords=new_coords,
            inds=dict(state.branches_inds),
            log_like=logl_p[:, inv_perm],
            log_prior=logp_p[:, inv_perm],
            blobs=blobs_p[:, inv_perm] if blobs_p is not None else state.blobs,
        )
        return new_state, acc_p[:, inv_perm], kernel_state

    def _mala_block(self, key, names, x, masks_blk, eps_tree, grad_fn, dtype):
        """Langevin drift + exact Hastings factors for one walker block
        (the ``propose_block`` core of :meth:`_propose_impl_precond`)."""
        key, k_xi = jax.random.split(key)
        xi_keys = jax.random.split(k_xi, len(names))

        (_, _aux0), grad_x = grad_fn(x)
        q = {}
        for n, kx in zip(names, xi_keys):
            c = x[n]
            eps_vec = eps_tree[n]
            xi = jax.random.normal(kx, c.shape, dtype=dtype)
            step = 0.5 * eps_vec**2 * grad_x[n] + eps_vec * xi
            q[n] = self._wrap_periodic(
                n, c + jnp.where(masks_blk[n], step, 0.0)
            )

        (_, (ll1, lp1, blobs1)), grad_q = grad_fn(q)

        factors = jnp.zeros(masks_blk[names[0]].shape[:2], dtype=dtype)
        for n in names:
            c, qq = x[n], q[n]
            e2 = eps_tree[n] ** 2
            m = masks_blk[n]
            fwd = self._displacement(n, c, qq) - 0.5 * e2 * grad_x[n]
            rev = self._displacement(n, qq, c) - 0.5 * e2 * grad_q[n]
            contrib = (rev**2 - fwd**2) / (2.0 * e2)
            factors = factors - jnp.where(m, contrib, 0.0).sum(axis=(-2, -1))
        return key, q, ll1, lp1, blobs1, factors

    def _propose_impl(self, key, state, ctx, kernel_state=()):
        if self.ensemble_precondition:
            return self._propose_impl_precond(key, state, ctx, kernel_state)
        names, coords, inds, betas, dtype, grad_fn = self._grad_setup(
            state, ctx
        )
        (_, _aux0), grad_x = grad_fn(coords)

        key, k_xi, k_acc = jax.random.split(key, 3)
        xi_keys = jax.random.split(k_xi, len(names))
        scale = self._current_scale(kernel_state, dtype)

        q = {}
        for n, kx in zip(names, xi_keys):
            c = coords[n]
            eps_vec = scale * self._eps_for(n, c.shape[-1], dtype, kernel_state)
            xi = jax.random.normal(kx, c.shape, dtype=dtype)
            step = 0.5 * eps_vec**2 * grad_x[n] + eps_vec * xi
            q[n] = self._wrap_periodic(
                n, c + jnp.where(inds[n][..., None], step, 0.0)
            )

        (_, (ll1, lp1, blobs1)), grad_q = grad_fn(q)

        # log q(a -> b) = -||d(a, b) - (eps^2/2) grad(a)||^2 / (2 eps^2)
        # over active coordinates (d = nearest-image displacement);
        # factors = log q(q -> x) - log q(x -> q)
        factors = jnp.zeros(state.log_like.shape, dtype=dtype)
        for n in names:
            c, qq = coords[n], q[n]
            eps_vec = scale * self._eps_for(n, c.shape[-1], dtype, kernel_state)
            e2 = eps_vec**2
            m = inds[n][..., None]
            fwd = self._displacement(n, c, qq) - 0.5 * e2 * grad_x[n]
            rev = self._displacement(n, qq, c) - 0.5 * e2 * grad_q[n]
            contrib = (rev**2 - fwd**2) / (2.0 * e2)
            factors = factors - jnp.where(m, contrib, 0.0).sum(axis=(-2, -1))

        return self._accept_and_merge(
            k_acc, state, names, coords, q, factors, ll1, lp1, blobs1,
            betas, dtype, kernel_state,
        )
