"""Red/blue half-ensemble proposal machinery.

JAX re-design of ``/root/reference/src/eryn/moves/red_blue.py:89-333``.
The reference shuffles walker indices on the host and loops over ragged
subsets with ``take_along_axis`` gathers; here one random permutation splits
the walker axis into ``nsplits`` *static-size* contiguous blocks, and each
block update is a fully vectorized gather -> propose -> accept -> scatter
inside the traced kernel.  The sequential dependency between halves (each
half's complement sees the other half's already-updated positions,
``red_blue.py:148-323``) is preserved by carrying the updated coordinate
arrays between block iterations.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..ops.perm import invert_permutation

from .move import Move, mh_accept, state_branch_supps
from .tempering import tempered_log_likelihood

__all__ = ["RedBlueMove"]


class RedBlueMove(Move):
    """Base for ensemble proposals that move one subset using the complement.

    Subclasses implement ``get_proposal_kernel(key, s_coords, c_coords,
    s_inds) -> (q_dict, factors)`` with ``factors`` shaped ``(ntemps, Ns)``.
    """

    def __init__(
        self,
        nsplits=2,
        randomize_split=True,
        live_dangerously=False,
        **kwargs,
    ):
        super().__init__(**kwargs)
        self.nsplits = int(nsplits)
        self.randomize_split = randomize_split
        self.live_dangerously = live_dangerously
        # reference-style subclasses implement a host-NumPy
        # ``get_proposal(s_all, c_all, random, gibbs_ndim=None)``
        # (ref red_blue.py:16-87); they run through the legacy host bridge.
        # Group moves define their own (group-protocol) get_proposal and are
        # classified by GroupMove.__init__ instead.
        from .group import GroupMove
        from .move import overrides_host_api

        if overrides_host_api(self, "get_proposal") and not (
            isinstance(self, GroupMove)
        ):
            self.host_move = True
            self._legacy_family = "redblue"

    def setup(self, branches):
        """Per-proposal setup hook (ref ``red_blue.py:84-87``)."""
        pass

    def get_proposal(self, s_all, c_all, random, gibbs_ndim=None):
        """Reference host-protocol hook (ref ``red_blue.py:60-83``):
        subclasses return ``(q_dict, factors)`` from sample/complement
        sets.  Abstract here, exactly as in the reference — a subclass
        defining it runs through the legacy host bridge."""
        raise NotImplementedError(
            "RedBlueMove subclasses implement get_proposal (legacy host "
            "protocol) or get_proposal_kernel (traced protocol)."
        )

    # abstract in the reference: only a USER definition flags host mode
    get_proposal.__eryn_tpu_stock__ = True

    def get_proposal_kernel(self, key, s_coords, c_coords, s_inds, param_masks=None):
        raise NotImplementedError

    def _propose_impl(self, key, state, ctx, kernel_state=()):
        ntemps, nwalkers = state.log_like.shape

        total_ndim = sum(
            state.branches[n].nleaves_max * state.branches[n].ndim
            for n in self.run_branches(state)
        )
        if nwalkers < 2 * total_ndim and not self.live_dangerously:
            raise RuntimeError(
                "It is unadvisable to use a red-blue move with fewer walkers "
                "than twice the number of dimensions. (set live_dangerously "
                "to override)"  # ref red_blue.py:102-114
            )

        self.setup(state.branches)

        coords = dict(state.branches_coords)
        inds = dict(state.branches_inds)
        logl = state.log_like
        logp = state.log_prior
        blobs = state.blobs
        betas = (
            state.betas
            if state.betas is not None
            else jnp.ones((ntemps,), dtype=logl.dtype)
        )
        accepted = jnp.zeros((ntemps, nwalkers), dtype=bool)

        # static subset sizes: the reference's shuffled `arange % nsplits`
        # (red_blue.py:119-124) yields these same counts.
        sizes = [
            nwalkers // self.nsplits + (1 if i < nwalkers % self.nsplits else 0)
            for i in range(self.nsplits)
        ]
        offsets = [sum(sizes[:i]) for i in range(self.nsplits)]

        all_names = list(coords.keys())
        for names, param_masks in self.gibbs_iterations_for(state):
            key, kperm = jax.random.split(key)
            if self.randomize_split:
                perm = jax.random.permutation(kperm, nwalkers)
                inv_perm = invert_permutation(perm)
            else:
                perm = inv_perm = jnp.arange(nwalkers)

            # permuted layout: splits become STATIC contiguous blocks updated
            # with dynamic_update_slice (no scatter); one inverse gather per
            # gibbs iteration restores walker order
            coords_p = {n: coords[n][:, perm] for n in all_names}
            inds_p = {n: inds[n][:, perm] for n in all_names}
            logl_p = logl[:, perm]
            logp_p = logp[:, perm]
            blobs_p = blobs[:, perm] if blobs is not None else None
            acc_p = accepted[:, perm]

            def blk(x, off, ns):
                return x[:, off : off + ns]

            def comp(x, off, ns):
                return jnp.concatenate(
                    [x[:, :off], x[:, off + ns :]], axis=1
                )

            def unblk(x, v, off):
                return jax.lax.dynamic_update_slice_in_dim(x, v, off, axis=1)

            for split, (off, ns) in enumerate(zip(offsets, sizes)):
                s_coords = {n: blk(coords_p[n], off, ns) for n in names}
                c_coords = {n: comp(coords_p[n], off, ns) for n in names}
                s_inds = {n: blk(inds_p[n], off, ns) for n in names}

                key, kprop, kacc = jax.random.split(key, 3)
                prop_kwargs = {}
                if getattr(self, "_needs_c_inds", False):
                    # RJ-aware kernels (RedBlueGroupStretchMove) select
                    # complements from ACTIVE leaves only
                    prop_kwargs["c_inds"] = {
                        n: comp(inds_p[n], off, ns) for n in names
                    }
                q, factors = self.get_proposal_kernel(
                    kprop, s_coords, c_coords, s_inds, param_masks,
                    **prop_kwargs,
                )

                # gibbs parameter masking: non-selected (leaf, param) entries
                # keep old values (ref move.py:297-336)
                for n in names:
                    mask = param_masks.get(n)
                    if mask is not None:
                        mask_b = jnp.asarray(mask)[None, None, :, :]
                        q[n] = jnp.where(mask_b, q[n], s_coords[n])

                # evaluate over ALL branches: non-proposed branches contribute
                # their (unchanged) subset coords to the posterior
                q_eval = {
                    n: (q[n] if n in q else blk(coords_p[n], off, ns))
                    for n in all_names
                }
                inds_eval = {n: blk(inds_p[n], off, ns) for n in all_names}
                logp_new = ctx.compute_log_prior(q_eval, inds_eval)
                logl_new, blobs_new = ctx.compute_log_like(
                    q_eval,
                    inds_eval,
                    logp_new,
                    state_branch_supps(state, perm=perm, block=(off, ns)),
                )

                prev_logl = blk(logl_p, off, ns)
                prev_logp = blk(logp_p, off, ns)
                logP_new = tempered_log_likelihood(logl_new, betas) + logp_new
                logP_old = tempered_log_likelihood(prev_logl, betas) + prev_logp

                acc = mh_accept(kacc, factors, logP_new, logP_old)

                acc4 = acc[:, :, None, None]
                for n in names:
                    coords_p[n] = unblk(
                        coords_p[n],
                        jnp.where(acc4, q[n], s_coords[n]),
                        off,
                    )
                logl_p = unblk(logl_p, jnp.where(acc, logl_new, prev_logl), off)
                logp_p = unblk(logp_p, jnp.where(acc, logp_new, prev_logp), off)
                if blobs_p is not None and blobs_new is not None:
                    acc_b = acc.reshape(acc.shape + (1,) * (blobs_p.ndim - 2))
                    blobs_p = unblk(
                        blobs_p,
                        jnp.where(acc_b, blobs_new, blk(blobs_p, off, ns)),
                        off,
                    )
                # OR with earlier Gibbs iterations' flags: the reference
                # accumulates accepted across iterations
                # (ref red_blue.py:306-309), so a walker accepted in ANY
                # iteration counts as accepted for this proposal
                acc_p = unblk(acc_p, acc | blk(acc_p, off, ns), off)

            coords = {n: coords_p[n][:, inv_perm] for n in all_names}
            logl = logl_p[:, inv_perm]
            logp = logp_p[:, inv_perm]
            if blobs_p is not None:
                blobs = blobs_p[:, inv_perm]
            accepted = acc_p[:, inv_perm]

        new_state = state.replace(
            coords=coords, inds=inds, log_like=logl, log_prior=logp, blobs=blobs
        )
        return new_state, accepted, kernel_state
