"""Group proposals: stationary-complement ensemble moves.

JAX re-design of ``/root/reference/src/eryn/moves/group.py:14-281``.
The stationary "friends" group (refreshed every ``n_iter_update`` iterations,
using the pre-proposal state at the window boundary to preserve detailed
balance) lives in the move's traced kernel state, so the whole group proposal
— refresh decision included (``lax.cond``-free ``where`` blend) — stays inside
the jitted sampler step.  This is the RJ-compatible alternative to
red/blue: all walkers update at once against the stationary complement.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .move import Move, mh_accept, state_branch_supps
from .tempering import tempered_log_likelihood

__all__ = ["GroupMove"]


class GroupMove(Move):
    """Base class for stationary-complement moves (ref ``group.py:14``).

    Subclasses implement:

    * ``setup_friends_kernel(branches_coords, branches_inds) -> pytree`` —
      build the stationary friends table (traced);
    * ``find_friends_kernel(key, name, s_coords, s_inds, friends) ->
      c_coords`` — per-walker complement draw from the table (traced);
    * ``group_proposal_kernel`` — the proposal math (e.g. stretch).

    Args:
        nfriends: number of friends retained per walker (default: nwalkers).
        n_iter_update: refresh period for the stationary group
            (ref ``group.py:148-157``).
    """

    def __init__(
        self, nfriends=None, n_iter_update=100, live_dangerously=False, **kwargs
    ):
        super().__init__(**kwargs)
        self.nfriends = nfriends
        self.n_iter_update = int(n_iter_update)
        if self.n_iter_update <= 1 and not live_dangerously:
            raise ValueError("n_iter_update must be greater than or equal to 2.")
        # reference-style subclasses override the host hooks below
        # (ref group.py:50-96); they run through the legacy host bridge
        cls = type(self)
        if (
            cls.setup_friends is not GroupMove.setup_friends
            or cls.find_friends is not GroupMove.find_friends
        ):
            self.host_move = True
            self._legacy_family = "group"
            self.iter = 0

    # -- reference host hooks (legacy custom-move protocol) ---------------
    def setup_friends(self, branches):
        """Host hook: build friend bookkeeping from the (NumPy) branches
        dict (ref ``group.py:77-85``).  Overriding this (or
        :meth:`find_friends`) marks the move as a legacy host move —
        correct but slow; port to :meth:`setup_friends_kernel` for the
        compiled path."""
        raise NotImplementedError

    def find_friends(self, name, s, s_inds=None, branch_supps=None):
        """Host hook: return complement coordinates for the points in ``s``
        (ref ``group.py:50-68``)."""
        raise NotImplementedError

    def fix_friends(self, branches):
        """Host hook: repair friends for leaves born through RJ
        (ref ``group.py:88-96``).  Optional."""
        return

    def choose_c_vals(self, name, s, s_inds=None, branch_supps=None):
        """Get the complementary values (ref ``group.py:69-72``):
        delegates to :meth:`find_friends`."""
        return self.find_friends(
            name, s, s_inds=s_inds, branch_supps=branch_supps
        )

    def get_proposal(self, s_all, random, gibbs_ndim=None, s_inds_all=None, **kwargs):
        """Reference host-protocol hook (ref ``group.py:98-120``):
        subclasses return ``(q_dict, factors)`` against the friends
        complement.  Abstract here, exactly as in the reference."""
        raise NotImplementedError(
            "GroupMove subclasses implement get_proposal (legacy host "
            "protocol) or group_proposal_kernel (traced protocol)."
        )

    get_proposal.__eryn_tpu_stock__ = True

    # -- subclass hooks ---------------------------------------------------
    def setup_friends_kernel(self, branches_coords, branches_inds):
        raise NotImplementedError

    def find_friends_kernel(self, key, name, s_coords, s_inds, friends):
        raise NotImplementedError

    def fix_friends_kernel(self, friends, branches_coords, branches_inds):
        """Repair friends for leaves born through RJ (ref ``group.py:88-96``).
        Default: no-op.

        ``branches_coords``/``branches_inds`` are the STATIONARY window
        snapshot (the ensemble at the last refresh boundary), not the live
        pre-proposal state: repairs sourced from walkers that move in the
        same joint step would reintroduce the simultaneous-update
        dependency the stationary table exists to remove."""
        return friends

    def group_proposal_kernel(self, key, s_coords, s_inds, friends, param_masks):
        raise NotImplementedError

    # ----------------------------------------------------------------------
    def init_kernel_state(self, state):
        return {
            "iter": jnp.zeros((), dtype=jnp.int32),
            "friends": self.setup_friends_kernel(
                state.branches_coords, state.branches_inds
            ),
            # stationary snapshot backing mid-window friend repairs
            "snap_coords": dict(state.branches_coords),
            "snap_inds": dict(state.branches_inds),
        }

    def _propose_impl(self, key, state, ctx, kernel_state):
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

        it = kernel_state["iter"]
        friends = kernel_state["friends"]

        # refresh the stationary group at window boundaries using the
        # pre-proposal state (ref group.py:148-157, 275-279)
        refresh = (it % self.n_iter_update) == 0

        def blend(new, old):
            if not hasattr(new, "ndim"):
                return new
            return jnp.where(refresh.reshape((1,) * new.ndim), new, old)

        fresh = self.setup_friends_kernel(coords, inds)
        friends = jax.tree_util.tree_map(blend, fresh, friends)
        # the snapshot freezes with the same cadence; mid-window repairs
        # must draw from it, never from the live ensemble (see
        # fix_friends_kernel docstring)
        snap_coords = jax.tree_util.tree_map(
            blend, dict(coords), kernel_state["snap_coords"]
        )
        snap_inds = jax.tree_util.tree_map(
            blend, dict(inds), kernel_state["snap_inds"]
        )
        friends = self.fix_friends_kernel(friends, snap_coords, snap_inds)

        for names, param_masks in self.gibbs_iterations_for(state):
            key, kprop, kacc = jax.random.split(key, 3)
            q, factors = self.group_proposal_kernel(
                kprop,
                {n: coords[n] for n in names},
                {n: inds[n] for n in names},
                friends,
                param_masks,
            )
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
        new_kernel_state = {
            "iter": it + 1,
            "friends": friends,
            "snap_coords": snap_coords,
            "snap_inds": snap_inds,
        }
        return new_state, accepted, new_kernel_state
