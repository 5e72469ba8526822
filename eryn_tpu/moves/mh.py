"""Whole-ensemble Metropolis-Hastings skeleton.

JAX re-design of ``/root/reference/src/eryn/moves/mh.py:16-193``: the
proposal, prior, likelihood, and accept/merge all operate on the full
``(ntemps, nwalkers)`` block in one traced pass.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .move import Move, mh_accept, state_branch_supps
from .tempering import tempered_log_likelihood

__all__ = ["MHMove"]


class MHMove(Move):
    """Base for moves proposing updates for all walkers at once.

    Subclasses implement ``get_proposal_kernel(key, branch_coords,
    branch_inds, kernel_state, param_masks=None) -> (q_dict, factors,
    kernel_state)`` with ``factors`` shaped ``(ntemps, nwalkers)``.

    ``param_masks`` (``{name: (nleaves_max, ndim) bool}``) carries the
    Gibbs parameter selection INTO the kernel: asymmetric proposals must
    restrict both the update and the Hastings factors to the selected
    parameters — masking the proposal after the factors are computed (the
    reference's ``cleanup_proposals_gibbs`` ordering, ``move.py:297-336``)
    would leave factors for discarded draw components in the acceptance
    ratio and break detailed balance.  Kernels with the legacy 4-argument
    signature are still called; the base class re-applies the mask
    afterwards as a safety net (exact only for symmetric proposals).
    """

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        # reference-style subclasses implement a host-NumPy
        # ``get_proposal(branches_coords, random, branches_inds=None, ...)``
        # (ref mh.py:16-60); they run through the legacy host bridge
        from .move import overrides_host_api

        if overrides_host_api(self, "get_proposal"):
            self.host_move = True
            self._legacy_family = "mh"

    def get_proposal(self, branches_coords, random, branches_inds=None, **kwargs):
        """Reference host-protocol hook (ref ``mh.py:16-60``): subclasses
        return ``(q_dict, factors)``.  Abstract here, exactly as in the
        reference — a subclass defining it runs through the legacy host
        bridge."""
        raise NotImplementedError(
            "MHMove subclasses implement get_proposal (legacy host "
            "protocol) or get_proposal_kernel (traced protocol)."
        )

    # abstract in the reference: only a USER definition flags host mode
    get_proposal.__eryn_tpu_stock__ = True

    def get_proposal_kernel(
        self, key, branch_coords, branch_inds, kernel_state, param_masks=None
    ):
        raise NotImplementedError

    def _kernel_takes_masks(self):
        import inspect

        try:
            sig = inspect.signature(self.get_proposal_kernel)
        except (TypeError, ValueError):
            return False
        return "param_masks" in sig.parameters

    def _propose_impl(self, key, state, ctx, kernel_state=()):
        coords = dict(state.branches_coords)
        inds = dict(state.branches_inds)
        ntemps, nwalkers = state.log_like.shape
        betas = (
            state.betas
            if state.betas is not None
            else jnp.ones((ntemps,), dtype=state.log_like.dtype)
        )
        logl = state.log_like
        logp = state.log_prior
        blobs = state.blobs
        accepted = jnp.zeros((ntemps, nwalkers), dtype=bool)

        takes_masks = self._kernel_takes_masks()
        for names, param_masks in self.gibbs_iterations_for(state):
            key, kprop, kacc = jax.random.split(key, 3)
            kernel_args = (
                kprop,
                {n: coords[n] for n in names},
                {n: inds[n] for n in names},
                kernel_state,
            )
            if takes_masks:
                q, factors, kernel_state = self.get_proposal_kernel(
                    *kernel_args, param_masks=param_masks
                )
            else:
                q, factors, kernel_state = self.get_proposal_kernel(
                    *kernel_args
                )

            # gibbs parameter masking safety net (see class docstring;
            # idempotent for kernels that already masked)
            for n in names:
                mask = param_masks.get(n)
                if mask is not None:
                    mask_b = jnp.asarray(mask)[None, None, :, :]
                    q[n] = jnp.where(mask_b, q[n], coords[n])

            q_full = {**coords, **q}
            logp_new = ctx.compute_log_prior(q_full, inds)
            logl_new, blobs_new = ctx.compute_log_like(
                q_full, inds, logp_new, state_branch_supps(state)
            )

            logP_new = tempered_log_likelihood(logl_new, betas) + logp_new
            logP_old = tempered_log_likelihood(logl, betas) + logp
            acc = mh_accept(kacc, factors, logP_new, logP_old)

            acc4 = acc[:, :, None, None]
            for n in names:
                coords[n] = jnp.where(acc4, q_full[n], coords[n])
            logl = jnp.where(acc, logl_new, logl)
            logp = jnp.where(acc, logp_new, logp)
            if blobs is not None and blobs_new is not None:
                acc_b = acc.reshape(acc.shape + (1,) * (blobs.ndim - 2))
                blobs = jnp.where(acc_b, blobs_new, blobs)
            accepted = accepted | acc

        new_state = state.replace(
            coords=coords, inds=inds, log_like=logl, log_prior=logp, blobs=blobs
        )
        return new_state, accepted, kernel_state
