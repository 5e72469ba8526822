"""Delayed-rejection MH (experimental, as in the reference).

JAX re-design of
``/root/reference/src/eryn/moves/delayedrejection.py:40-229``.  NOTE: the
reference ships this move but keeps it unreachable from the RJ path
(``rj.py:350-353`` raises NotImplementedError); this implementation follows
the *intended* semantics — the iterated DR chain of Trias et al.
(arXiv:0904.2207) with the one-step-back alpha correction
(``delayedrejection.py:100-117``) — as a usable in-model move, and is flagged
experimental to match.

Each DR stage re-proposes from the previously rejected candidate with the
wrapped (symmetric) proposal; the stage-k acceptance is the exact recursive
Mira (2001) formula

    alpha_m(z_0..z_m) = min(1, pi(z_m)/pi(z_0)
        * prod_j (1 - alpha_j(z_m..z_{m-j})) / prod_j (1 - alpha_j(z_0..z_j)))

computed over all contiguous sub-paths of the candidate chain (O(max_iter^3)
elementwise ops, unrolled in the traced kernel).  NOTE: the reference's
in-tree formula uses ``pi(y_k)/pi(y_{k-1})`` in place of ``pi(y_k)/pi(x)``,
which does not leave the target invariant — verified empirically (the
reference also never reaches this code path, ``rj.py:350-353``); this
implementation uses the correct kernel.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .move import Move
from .tempering import tempered_log_likelihood

__all__ = ["DelayedRejection", "DelayedRejectionContainer"]


class DelayedRejectionContainer:
    """Config + trajectory carrier matching the reference's container API
    (ref ``delayedrejection.py:13-29``): arbitrary config attributes via
    kwargs plus per-stage ``coords``/``log_prob``/``log_prior``/``alpha``
    lists populated by :meth:`append`."""

    def __init__(self, proposal=None, max_iter=10, **kwargs):
        self.proposal = proposal
        self.max_iter = max_iter
        for key, item in kwargs.items():
            setattr(self, key, item)
        self.coords = []
        self.log_prob = []
        self.log_prior = []
        self.alpha = []

    def append(self, new_coords, new_log_prob, new_log_prior, new_alpha):
        """Record one DR stage (ref ``delayedrejection.py:24-29``)."""
        self.coords.append(new_coords)
        self.log_prob.append(new_log_prob)
        self.log_prior.append(new_log_prior)
        self.alpha.append(new_alpha)


def _host_log_posterior(move, state):
    """Tempered host log-posterior matching ref ``move.py:435-441``'s
    ``compute_log_posterior`` wiring (basic when no temperature control)."""
    logl = np.asarray(state.log_like)
    logp = np.asarray(state.log_prior)
    tc = move.temperature_control
    if tc is not None:
        return np.asarray(tc.compute_log_posterior_tempered(logl, logp))
    return logl + logp


class DelayedRejection(Move):
    """Delayed-rejection wrapper around an MH-style proposal
    (ref ``delayedrejection.py:40``).

    Args:
        proposal: a move exposing ``get_proposal_kernel(key, coords, inds,
            kernel_state) -> (q, factors, kernel_state)`` whose proposal is
            SYMMETRIC per stage (``q(x -> y) == q(y -> x)``), e.g.
            :class:`~eryn_tpu.moves.gaussian.GaussianMove`.  The recursive
            acceptance below drops all proposal densities, which is exact
            only in the symmetric case — the move refuses asymmetric
            proposals (wrapped ``factors`` are not representable in the
            multi-stage recursion).  Custom moves opt in by setting a class
            attribute ``symmetric_proposal = True``.
        max_iter: number of delayed-rejection stages after the first
            rejection.  COST NOTE: the traced kernel evaluates ALL
            ``max_iter + 1`` candidates unconditionally every proposal (no
            data-dependent early exit under ``jit``), so the move costs
            ``max_iter + 1`` full likelihood evaluations per step; the
            default is kept small for that reason (the reference's lazy
            host loop defaults to 10 but is unreachable, ``rj.py:350-353``).
    """

    def __init__(self, proposal, max_iter=3, **kwargs):
        super().__init__(**kwargs)
        if not getattr(proposal, "symmetric_proposal", False):
            raise ValueError(
                "DelayedRejection requires a symmetric wrapped proposal "
                "(its recursive acceptance drops all proposal densities). "
                f"{type(proposal).__name__} does not declare "
                "symmetric_proposal = True; use GaussianMove, or set the "
                "attribute on a custom move whose kernel is symmetric."
            )
        self.proposal = proposal
        self.max_iter = int(max_iter)

    def propagate_wiring(self):
        if self.proposal.periodic is None:
            self.proposal.periodic = self.periodic
        if self.proposal.temperature_control is None:
            self.proposal.temperature_control = self.temperature_control

    def init_kernel_state(self, state):
        return self.proposal.init_kernel_state(state)

    # ------------------------------------------------------------------
    # Reference host-protocol shims.  The reference keeps DelayedRejection
    # unreachable (``rj.py:350-353`` raises before wiring it) but the
    # methods below are named public API; they mirror the host semantics of
    # ref ``delayedrejection.py:52-148`` over NumPy state so reference user
    # code that drives them directly keeps working.
    # ------------------------------------------------------------------

    def get_new_state(self, model, state, keep):
        """Re-propose from the currently rejected walkers (host protocol,
        ref ``delayedrejection.py:122-148``): draw the wrapped proposal,
        mask priors to ``-inf`` off the ``keep`` set so only those walkers'
        likelihoods are computed, and return ``(new_state, factors)``."""
        from ..state import State as _State

        try:
            qn, factors = self.proposal.get_proposal(
                state.branches_coords, model.random,
                branches_inds=state.branches_inds,
            )
        except NotImplementedError:
            # native moves expose only the traced kernel — drive it with a
            # key derived from the host RNG stream
            seed = int(model.random.randint(0, 2**31 - 1))
            coords = {
                n: jnp.asarray(v) for n, v in state.branches_coords.items()
            }
            inds_j = {
                n: jnp.asarray(v).astype(bool)
                for n, v in state.branches_inds.items()
            }
            qn, factors, _ks = self.proposal.get_proposal_kernel(
                jax.random.key(seed), coords, inds_j,
                self.proposal.init_kernel_state(state),
            )
        qn = {name: np.asarray(q) for name, q in qn.items()}
        logp = np.array(
            model.compute_log_prior_fn(qn, inds=state.branches_inds)
        )
        keep = np.asarray(keep, dtype=bool)
        logp[~keep] = -np.inf
        logl, new_blobs = model.compute_log_like_fn(
            qn, inds=state.branches_inds, logp=logp
        )
        new_state = _State(
            qn,
            log_like=np.asarray(logl),
            log_prior=logp,
            blobs=new_blobs,
            inds=state.branches_inds,
            supplemental=state.supplemental,
        )
        return new_state, np.asarray(factors)

    def dr_scheme(
        self,
        state,
        new_state,
        keep_rejected,
        model,
        ntemps,
        nwalkers,
        inds_for_change,
        inds=None,
        dr_iter=0,
    ):
        """One delayed-rejection stage over the host state (host protocol,
        ref ``delayedrejection.py:52-120``): re-propose from the rejected
        candidates, form the one-step-back corrected alpha against the
        ``past_alpha`` supplemental, and merge freshly accepted walkers.

        Returns ``(state, new_accepted, new_state)`` exactly as the
        reference does."""
        from ..state import State as _State

        randU = model.random.rand(ntemps, nwalkers)
        old_new_state = _State(new_state, copy=True)

        new_state, log_proposal_ratio = self.get_new_state(
            model, new_state, np.asarray(keep_rejected, dtype=bool)
        )

        logP = _host_log_posterior(self, new_state)
        prev_logP = _host_log_posterior(self, old_new_state)

        past_alpha = np.asarray(old_new_state.supplemental[:]["past_alpha"])
        with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
            # -inf - -inf = NaN on walkers outside the keep set; NaNs
            # auto-reject below exactly as in the reference
            lndiff = logP - prev_logP + np.asarray(log_proposal_ratio)
            alpha_1 = np.minimum(np.exp(lndiff), 1.0)
            dr_alpha = np.exp(
                lndiff + np.log(1.0 - alpha_1) - np.log(1.0 - past_alpha)
            )
        dr_alpha = np.minimum(dr_alpha, 1.0)
        dr_alpha = np.nan_to_num(dr_alpha)  # NaNs auto-reject (ref :112)

        # string-key set ADDS the entry (indexed set ignores unknown names,
        # matching ref state.py:196-208 — which makes the reference's own
        # `supplemental[:] = {"alpha": ...}` here a silent no-op)
        new_state.supplemental["alpha"] = dr_alpha
        new_state.supplemental["past_alpha"] = dr_alpha

        new_accepted = np.logical_or(dr_alpha >= 1.0, randU < dr_alpha)
        state = self.update(state, new_state, new_accepted)
        return state, new_accepted, new_state

    def _eval_candidate(self, ctx, state, q, betas):
        inds = dict(state.branches_inds)
        logp = ctx.compute_log_prior(q, inds)
        logl, blobs = ctx.compute_log_like(q, inds, logp)
        logP = tempered_log_likelihood(logl, betas) + logp
        return logl, logp, logP, blobs

    def _propose_impl(self, key, state, ctx, kernel_state=()):
        self.propagate_wiring()
        coords = dict(state.branches_coords)
        inds = dict(state.branches_inds)
        ntemps, nwalkers = state.log_like.shape
        betas = (
            state.betas
            if state.betas is not None
            else jnp.ones((ntemps,), dtype=state.log_like.dtype)
        )
        names = self.proposal.run_branches(state)

        logl = state.log_like
        logp = state.log_prior
        blobs = state.blobs
        logP_x = tempered_log_likelihood(logl, betas) + logp

        def merge(accepted_now, q_cand, ll_cand, lp_cand, blobs_cand):
            nonlocal coords, logl, logp, blobs
            acc4 = accepted_now[:, :, None, None]
            for n in names:
                coords[n] = jnp.where(acc4, q_cand[n], coords[n])
            logl = jnp.where(accepted_now, ll_cand, logl)
            logp = jnp.where(accepted_now, lp_cand, logp)
            if blobs is not None and blobs_cand is not None:
                acc_b = accepted_now.reshape(
                    accepted_now.shape + (1,) * (blobs.ndim - 2)
                )
                blobs = jnp.where(acc_b, blobs_cand, blobs)

        # build the candidate chain x -> y1 -> ... -> yK, evaluating each
        # candidate once; acceptance uses the recursive Mira alphas below
        chain_logP = [logP_x]
        chain_vals = []  # (q_full, ll, lp) per candidate
        prev_q = coords
        for _stage in range(self.max_iter + 1):
            key, kq = jax.random.split(key)
            q, _factors, kernel_state = self.proposal.get_proposal_kernel(
                kq,
                {n: prev_q[n] for n in names},
                {n: inds[n] for n in names},
                kernel_state,
            )
            q_full = {**prev_q, **q}
            ll_c, lp_c, logP_c, blobs_c = self._eval_candidate(
                ctx, state, q_full, betas
            )
            chain_logP.append(logP_c)
            chain_vals.append((q_full, ll_c, lp_c, blobs_c))
            prev_q = q_full

        # alpha[(s, e)] = acceptance of contiguous sub-path z_s -> z_e
        # (symmetric proposal assumed; exact Mira 2001 recursion)
        alpha_cache = {}

        def alpha(s, e):
            if (s, e) in alpha_cache:
                return alpha_cache[(s, e)]
            m = abs(e - s)
            ld = chain_logP[e] - chain_logP[s]
            if m == 1:
                out = jnp.exp(jnp.minimum(ld, 0.0))
            else:
                step_f = 1 if e > s else -1
                log_num = jnp.zeros_like(ld)
                log_den = jnp.zeros_like(ld)
                for j in range(1, m):
                    log_num = log_num + jnp.log1p(-alpha(e, e - step_f * j))
                    log_den = log_den + jnp.log1p(-alpha(s, s + step_f * j))
                out = jnp.exp(jnp.minimum(ld + log_num - log_den, 0.0))
            out = jnp.nan_to_num(out)  # NaNs auto-reject (ref dr.py:112)
            alpha_cache[(s, e)] = out
            return out

        accepted = jnp.zeros(logP_x.shape, dtype=bool)
        for stage in range(1, self.max_iter + 2):
            key, ku = jax.random.split(key)
            a = alpha(0, stage)
            u = jax.random.uniform(ku, a.shape, dtype=a.dtype)
            q_full, ll_c, lp_c, blobs_c = chain_vals[stage - 1]
            acc_now = (~accepted) & (u < a)
            merge(acc_now, q_full, ll_c, lp_c, blobs_c)
            accepted = accepted | acc_now

        new_state = state.replace(
            coords=coords, inds=inds, log_like=logl, log_prior=logp,
            blobs=blobs,
        )
        return new_state, accepted, kernel_state
