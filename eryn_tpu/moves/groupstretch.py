"""Group stretch: affine-invariant stretch against a stationary complement.

JAX re-design of
``/root/reference/src/eryn/moves/groupstretch.py:15-120``.  The stretch math
is shared with :class:`~eryn_tpu.moves.stretch.StretchMove`; the complement is
drawn from the stationary friends table (kernel state) instead of the live
ensemble, which makes the move reversible-jump compatible.

The reference leaves friend selection abstract (users subclass and implement
``setup_friends``/``find_friends`` — see
``/root/reference/tests/test_eryn.py:813-907``).  Here the same hooks exist as
traced kernels, with a usable default: the friends table is a snapshot of the
ensemble coordinates and each walker draws a uniformly random friend.
Subclasses can override ``setup_friends_kernel``/``find_friends_kernel`` for
e.g. nearest-neighbor friend maps.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .group import GroupMove
from .stretch import StretchMove

__all__ = ["GroupStretchMove"]


class GroupStretchMove(GroupMove, StretchMove):
    """Stretch proposal over a stationary friends group
    (ref ``groupstretch.py:15-32``)."""

    def __init__(self, a=2.0, **kwargs):
        GroupMove.__init__(self, **kwargs)
        self.a = float(a)

    def get_proposal(
        self,
        s_all,
        random,
        gibbs_ndim=None,
        s_inds_all=None,
        branch_supps=None,
        **kwargs,
    ):
        """Host-protocol proposal for reference-style subclasses
        (ref ``groupstretch.py:34-155``): stretch math against the
        complement from the user's ``find_friends`` hook.  Only reached
        through the legacy host bridge (see
        :mod:`eryn_tpu.moves.legacy`); the compiled path uses
        :meth:`group_proposal_kernel`."""
        from .legacy import groupstretch_get_proposal

        return groupstretch_get_proposal(
            self,
            s_all,
            random,
            gibbs_ndim=gibbs_ndim,
            s_inds_all=s_inds_all,
            branch_supps=branch_supps,
        )

    # -- default friend machinery ------------------------------------------
    def setup_friends_kernel(self, branches_coords, branches_inds):
        """Default: snapshot the ensemble as the stationary group."""
        nf = self.nfriends
        out = {}
        for name, c in branches_coords.items():
            if nf is not None and nf < c.shape[1]:
                out[name] = c[:, :nf]
            else:
                out[name] = c
        return out

    def find_friends_kernel(self, key, name, s_coords, s_inds, friends):
        """Default: a uniformly random friend per walker, excluding the
        walker's own snapshot column (a self-pick right after a refresh is an
        identity proposal that would count as an accept and inflate
        acceptance fractions at small ``nfriends``)."""
        table = friends[name]
        nfr = table.shape[1]
        ntemps, ns = s_coords.shape[:2]
        if nfr > 1:
            # the default table is an ensemble snapshot in walker order:
            # walkers whose own column exists (w < nfr) draw over the other
            # nfr-1 columns and skip past self; the rest draw over all nfr
            widx = jnp.arange(ns)[None, :]
            has_self = widx < nfr
            u = jax.random.uniform(key, (ntemps, ns))
            r_excl = jnp.floor(u * (nfr - 1)).astype(jnp.int32)
            r_excl = r_excl + (r_excl >= widx)
            r_full = jnp.floor(u * nfr).astype(jnp.int32)
            rint = jnp.where(has_self, r_excl, r_full)
        else:
            rint = jax.random.randint(key, (ntemps, ns), 0, nfr)
        return jnp.take_along_axis(table, rint[:, :, None, None], axis=1)

    # -- proposal -----------------------------------------------------------
    def group_proposal_kernel(self, key, s_coords, s_inds, friends, param_masks):
        names = list(s_coords.keys())
        first = s_coords[names[0]]
        ntemps, ns = first.shape[:2]
        dtype = first.dtype

        key_z, *branch_keys = jax.random.split(key, 1 + len(names))
        u = jax.random.uniform(key_z, (ntemps, ns), dtype=dtype)
        zz = ((self.a - 1.0) * u + 1.0) ** 2 / self.a

        newpos = {}
        ndim_active = jnp.zeros((ntemps, ns), dtype=dtype)
        for name, kb in zip(names, branch_keys):
            s = s_coords[name]
            c_temp = self.find_friends_kernel(kb, name, s, s_inds[name], friends)

            if self.periodic is not None:
                diff = self.periodic.distance({name: s}, {name: c_temp})[name]
            else:
                diff = c_temp - s
            temp = c_temp - diff * zz[:, :, None, None]
            if self.periodic is not None:
                temp = self.periodic.wrap({name: temp})[name]
            newpos[name] = temp

            mask = None if param_masks is None else param_masks.get(name)
            if mask is None:
                ndim_active = (
                    ndim_active + s_inds[name].sum(axis=-1) * s.shape[-1]
                )
            else:
                per_leaf = jnp.asarray(mask).sum(axis=-1).astype(dtype)
                ndim_active = ndim_active + (
                    s_inds[name] * per_leaf[None, None, :]
                ).sum(axis=-1)

        factors = (ndim_active - 1.0) * jnp.log(zz)
        return newpos, factors
