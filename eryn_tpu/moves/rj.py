"""Reversible-jump (trans-dimensional) move skeleton.

JAX re-design of ``/root/reference/src/eryn/moves/rj.py:14-388``.
Births/deaths are pure flips of the static-shape leaf-activation masks; the
reference's per-(temp, walker) Python loops picking leaf slots
(``distgenrj.py:85-121``) become a masked gumbel-argmax, so the whole
trans-dimensional proposal is one fused traced kernel.  Detailed-balance edge
factors at the k-range boundaries (``rj.py:228-271``) are ``where``-masks.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from .move import Move, mh_accept, state_branch_supps
from .tempering import tempered_log_likelihood

__all__ = ["ReversibleJumpMove", "rj_change_kernel"]


def rj_change_kernel(key, inds, nleaves_min, nleaves_max, fix_change=None):
    """Propose +-1 leaf-count changes and pick the affected slot.

    Traced analogue of ``get_model_change_proposal``
    (``distgenrj.py:56-122``): random +-1 per (temp, walker), clamped to +1 at
    ``nleaves_min`` and -1 at ``nleaves_max``; birth slots drawn uniformly
    among inactive leaves, death slots uniformly among active leaves (masked
    gumbel-argmax).

    Returns:
        ``(change (nt, nw) int32 in {-1, 0, +1}, slot (nt, nw) int32,
        new_inds (nt, nw, nleaves_max) bool)``.
    """
    ntemps, nwalkers, nl = inds.shape
    nleaves = inds.sum(axis=-1)

    k_change, k_slot = jax.random.split(key)
    if fix_change is None:
        change = jnp.where(
            jax.random.uniform(k_change, (ntemps, nwalkers)) < 0.5, 1, -1
        )
    else:
        change = jnp.full((ntemps, nwalkers), int(fix_change), dtype=jnp.int32)

    # clamp at the k-range edges (ref distgenrj.py:61-71)
    change = jnp.where(nleaves == nleaves_min, 1, change)
    change = jnp.where(nleaves == nleaves_max, -1, change)
    if nleaves_min == nleaves_max:
        change = jnp.zeros_like(change)
    change = change.astype(jnp.int32)

    # uniform choice over masked slots via gumbel-argmax
    g = jax.random.gumbel(k_slot, inds.shape)
    birth_slot = jnp.argmax(jnp.where(~inds, g, -jnp.inf), axis=-1)
    death_slot = jnp.argmax(jnp.where(inds, g, -jnp.inf), axis=-1)
    slot = jnp.where(change == 1, birth_slot, death_slot).astype(jnp.int32)

    slot_mask = (
        jax.lax.broadcasted_iota(jnp.int32, inds.shape, 2) == slot[:, :, None]
    )
    new_inds = jnp.where(
        (change == 1)[:, :, None],
        inds | slot_mask,
        jnp.where((change == -1)[:, :, None], inds & ~slot_mask, inds),
    )
    return change, slot, new_inds


class ReversibleJumpMove(Move):
    """Base for trans-dimensional moves (ref ``rj.py:14``).

    Subclasses implement ``get_proposal_kernel(key, name, coords, inds) ->
    (q_coords, new_inds, factors)`` for one branch.  Branches are updated
    sequentially (Gibbs-style) within a single propose, as in the reference
    (``rj.py:169-203``); temperature swaps run afterwards *without* ladder
    adaptation (``rj.py:381-382``).
    """

    adapt_temps = False
    is_rj = True

    def __init__(
        self,
        nleaves_max=None,
        nleaves_min=None,
        dr=None,
        dr_max_iter=5,
        fix_change=None,
        **kwargs,
    ):
        super().__init__(**kwargs)
        self.nleaves_max = dict(nleaves_max) if nleaves_max else {}
        self.nleaves_min = dict(nleaves_min) if nleaves_min else {}
        if fix_change not in (None, 1, -1, +1):
            raise ValueError("fix_change must be None, +1, or -1.")
        self.fix_change = fix_change
        self.dr = dr
        self.dr_max_iter = dr_max_iter
        # reference-style custom RJ subclasses implement the host
        # ``get_proposal`` / ``get_model_change_proposal`` protocol
        # (ref rj.py:87-143); they run through the legacy host bridge
        from .move import overrides_host_api

        if overrides_host_api(self, "get_proposal") or overrides_host_api(
            self, "get_model_change_proposal"
        ):
            self.host_move = True
            self._legacy_family = "rj"

    def get_proposal(
        self, all_coords, all_inds, nleaves_min_all, nleaves_max_all, random, **kwargs
    ):
        """Reference host-protocol hook (ref ``rj.py:87-120``): subclasses
        return ``(q, new_inds, factors)``.  Abstract here, exactly as in
        the reference — a subclass defining it runs through the legacy
        host bridge."""
        raise NotImplementedError(
            "ReversibleJumpMove subclasses implement get_proposal (legacy "
            "host protocol) or get_proposal_kernel (traced protocol)."
        )

    get_proposal.__eryn_tpu_stock__ = True

    def get_model_change_proposal(self, inds, random, nleaves_min, nleaves_max):
        """Reference host-protocol helper (ref ``rj.py:122-143``): pick
        birth/death slots per walker.  Abstract here, as in the
        reference."""
        raise NotImplementedError

    get_model_change_proposal.__eryn_tpu_stock__ = True

    def get_proposal_kernel(self, key, name, coords, inds):
        raise NotImplementedError

    def _edge_factors(self, name, old_nleaves, new_nleaves, dtype):
        """Proposal-asymmetry corrections at the k-range boundaries
        (ref ``rj.py:228-271``)."""
        nmin = self.nleaves_min[name]
        nmax = self.nleaves_max[name]
        if nmin > nmax:
            raise ValueError("nleaves_min cannot be greater than nleaves_max.")
        if nmin == nmax or nmin + 1 == nmax:
            return jnp.zeros(old_nleaves.shape, dtype=dtype)
        log_half = float(np.log(0.5))
        ef = jnp.zeros(old_nleaves.shape, dtype=dtype)
        ef = ef + jnp.where(old_nleaves == nmin, log_half, 0.0)
        ef = ef + jnp.where(old_nleaves == nmax, log_half, 0.0)
        ef = ef - jnp.where(new_nleaves == nmin, log_half, 0.0)
        ef = ef - jnp.where(new_nleaves == nmax, log_half, 0.0)
        return ef

    def _propose_impl(self, key, state, ctx, kernel_state=()):
        # branch-level Gibbs splits only (ref rj.py:169-203)
        names = []
        for split_names, _masks in self.gibbs_iterations_for(state):
            names.extend(n for n in split_names if n not in names)
        coords = dict(state.branches_coords)
        inds = dict(state.branches_inds)
        logl = state.log_like
        logp = state.log_prior
        blobs = state.blobs
        ntemps, nwalkers = logl.shape
        betas = (
            state.betas
            if state.betas is not None
            else jnp.ones((ntemps,), dtype=logl.dtype)
        )
        accepted_total = jnp.zeros((ntemps, nwalkers), dtype=logl.dtype)

        for name in names:
            key, kprop, kacc = jax.random.split(key, 3)
            q_branch, new_inds_branch, factors = self.get_proposal_kernel(
                kprop, name, coords[name], inds[name]
            )

            old_nleaves = inds[name].sum(axis=-1)
            new_nleaves = new_inds_branch.sum(axis=-1)
            factors = factors + self._edge_factors(
                name, old_nleaves, new_nleaves, logl.dtype
            )

            q_full = {**coords, name: q_branch}
            inds_full = {**inds, name: new_inds_branch}
            logp_new = ctx.compute_log_prior(q_full, inds_full)
            logl_new, blobs_new = ctx.compute_log_like(
                q_full, inds_full, logp_new, state_branch_supps(state)
            )

            logP_new = tempered_log_likelihood(logl_new, betas) + logp_new
            logP_old = tempered_log_likelihood(logl, betas) + logp
            acc = mh_accept(kacc, factors, logP_new, logP_old)
            # identity proposals (change == 0, e.g. nleaves_min ==
            # nleaves_max branches) accept with probability ~1 and would
            # inflate rj acceptance diagnostics; mask them out like
            # MTDistGenMoveRJ does (chain distribution is unaffected).
            # a proposal only counts as identity when BOTH the leaf count
            # and the coordinates are unchanged, so custom kernels that
            # swap/replace leaves at constant k are not silently discarded.
            # NaN-filled inactive slots (the reference's chain convention)
            # must compare equal to themselves, else every proposal looks
            # "changed" and the masking never engages
            entry_changed = (q_branch != coords[name]) & ~(
                jnp.isnan(q_branch) & jnp.isnan(coords[name])
            )
            coords_changed = jnp.any(entry_changed, axis=(-2, -1))
            acc = acc & ((new_nleaves != old_nleaves) | coords_changed)

            acc4 = acc[:, :, None, None]
            coords[name] = jnp.where(acc4, q_branch, coords[name])
            inds[name] = jnp.where(acc[:, :, None], new_inds_branch, inds[name])
            logl = jnp.where(acc, logl_new, logl)
            logp = jnp.where(acc, logp_new, logp)
            if blobs is not None and blobs_new is not None:
                acc_b = acc.reshape(acc.shape + (1,) * (blobs.ndim - 2))
                blobs = jnp.where(acc_b, blobs_new, blobs)
            accepted_total = accepted_total + acc

        new_state = state.replace(
            coords=coords, inds=inds, log_like=logl, log_prior=logp, blobs=blobs
        )
        return new_state, accepted_total, kernel_state
