"""Red/blue group stretch: exact-detailed-balance group move.

Implements the reference's own roadmap item
(``/root/reference/docs/source/general/todos.rst``):

    "eryn.moves.group: Combine with red-blue where the stationary
    distribution is split in two according to two groups of walkers.
    Will guarantee detailed balance always."

:class:`~eryn_tpu.moves.group.GroupMove` keeps detailed balance only
approximately: its complement is a snapshot refreshed every
``n_iter_update`` iterations, which is stationary *within* a window but
re-seeded across windows.  The red/blue construction removes the
approximation entirely — the complement for each half-update is the OTHER
half's current coordinates, which are exactly fixed while the half moves
(block-Metropolis structure), so detailed balance holds every iteration
with no window machinery and no kernel state.

It is simultaneously the RJ-correct in-model stretch.  The reference
warns that its plain :class:`StretchMove` under reversible jump "will not
be using the correct complementary group of parameters"
(ref ``ensemble.py:505-514``): the stretch ray runs toward the complement
walker's same leaf SLOT, which may be inactive (holding stale dormant
coordinates).  Here each active leaf of a moving walker stretches toward
a uniformly chosen **active** leaf of the same branch anywhere in the
complement half, so proposals always target support the posterior
actually occupies.  Uniform selection over a fixed active set is
symmetric between forward and reverse moves, so the standard stretch
factors apply with ``N`` = the number of coordinates actually stretched.

Selection: the per-leaf masked-uniform complement choice is an
inverse-CDF over the flattened ``(complement walker, leaf)`` axis — one
running count of active entries shared by every moving walker, then the
(k+1)-th active entry picked either by an exact one-hot contraction
(``onehot[q, m] = (cs[m] == k_q + 1)`` against the zeroed-inactive
complement, at ``HIGHEST`` precision) or, once that ``(Q, M)`` pick tensor
would exceed ``_ONEHOT_BYTES_LIMIT``, by a batched ``searchsorted`` plus
``take_along_axis``.  Both select the same entry bit for bit
(``tests/test_rbgroupstretch.py``).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

# above this many bytes of (queries x complement) pick tensor, fall back
# to the gather formulation instead of materializing the one-hot matmul
_ONEHOT_BYTES_LIMIT = 256 * 1024 * 1024

from .stretch import StretchMove

__all__ = ["RedBlueGroupStretchMove"]


class RedBlueGroupStretchMove(StretchMove):
    """Stretch move whose complement is the other red/blue half's active
    leaves (exact detailed balance; RJ-correct complement selection).

    Accepts the :class:`StretchMove` arguments (``a``,
    ``use_log_proposal``, ``nsplits``, periodic wiring, Gibbs setups).
    Leaves the walker's inactive slots untouched — dormant coordinates are
    reversible-jump birth material, not part of the in-model target.
    """

    # ask RedBlueMove._propose_impl for the complement activation masks
    _needs_c_inds = True

    def get_proposal_kernel(
        self, key, s_coords, c_coords, s_inds, param_masks=None, c_inds=None
    ):
        names = list(s_coords.keys())
        first = s_coords[names[0]]
        ntemps, ns = first.shape[:2]
        dtype = first.dtype

        key_z, *branch_keys = jax.random.split(key, 1 + len(names))

        # one z per walker, shared across branches (as StretchMove)
        u = jax.random.uniform(key_z, (ntemps, ns), dtype=dtype)
        if self.use_log_proposal:
            zz = jnp.exp((2.0 * u - 1.0) * jnp.log(self.a))
        else:
            zz = ((self.a - 1.0) * u + 1.0) ** 2 / self.a

        newpos = {}
        ndim_active = jnp.zeros((ntemps, ns), dtype=dtype)
        for name, kb in zip(names, branch_keys):
            s = s_coords[name]  # (nt, ns, nl, nd)
            c = c_coords[name]  # (nt, nc, nl, nd)
            ci = (
                c_inds[name]
                if c_inds is not None
                else jnp.ones(c.shape[:3], dtype=bool)
            )
            nt, nc, nl, nd = c.shape
            nls = s.shape[2]

            # masked-uniform complement leaf per (temp, walker, leaf):
            # inverse CDF over the flattened (walker, leaf) complement axis
            M = nc * nl
            Q = ns * nls
            from ..ops.select_kernels import mask_cumsum

            m = ci.reshape(nt, M).astype(dtype)
            cnt = m.sum(axis=-1)  # (nt,) active complement leaves
            # (nt, M) nondecreasing running count
            cs = mask_cumsum(m)
            uu = jax.random.uniform(kb, (nt, ns, nls), dtype=dtype)
            # k-th active entry, k exact in f32 (counts < 2^24)
            k = jnp.floor(uu * jnp.maximum(cnt, 1.0)[:, None, None])
            kq = k.reshape(nt, Q)
            onehot_fits_hbm = (
                nt * Q * M * jnp.dtype(dtype).itemsize <= _ONEHOT_BYTES_LIMIT
            )
            if onehot_fits_hbm:
                # smallest i with cs[i] > k is the unique ACTIVE row with
                # running count cs == k+1 (k integer, counts exact in f32)
                # -> exact one-hot weights -> matmul selection.
                # Inactive rows sharing that count match too, but their
                # payload is zeroed below, so they add exact zeros.
                onehot = (cs[:, None, :] == kq[:, :, None] + 1.0).astype(
                    dtype
                )
                # zero inactive slots first: their (possibly NaN/stale)
                # coords would poison the 0-weighted sum, which a gather
                # never reads — and it is what makes the equality
                # formulation exact
                c_clean = jnp.where(
                    ci[..., None], c, jnp.zeros((), dtype)
                ).reshape(nt, M, nd)
                c_sel = jnp.einsum(
                    "tqm,tmd->tqd",
                    onehot,
                    c_clean,
                    precision=jax.lax.Precision.HIGHEST,
                ).reshape(nt, ns, nls, nd)
            else:
                # memory-lean fallback: same indices via searchsorted
                idx = jax.vmap(partial(jnp.searchsorted, side="right"))(
                    cs, kq
                )
                idx = jnp.minimum(idx, M - 1)
                c_sel = jnp.take_along_axis(
                    c.reshape(nt, M, nd), idx[..., None], axis=1
                ).reshape(nt, ns, nls, nd)

            if self.periodic is not None:
                diff = self.periodic.distance({name: s}, {name: c_sel})[name]
            else:
                diff = c_sel - s
            temp = c_sel - diff * zz[:, :, None, None]
            if self.periodic is not None:
                temp = self.periodic.wrap({name: temp})[name]

            # move only active leaves, and only where the complement half
            # has at least one active leaf to stretch toward (a temp row
            # with an empty active complement proposes identity for this
            # branch and its dims drop out of the factors below)
            has_c = (cnt > 0)[:, None, None, None]
            move_mask = s_inds[name][..., None] & has_c
            newpos[name] = jnp.where(move_mask, temp, s)

            mask = None if param_masks is None else param_masks.get(name)
            has_c2 = (cnt > 0)[:, None].astype(dtype)
            if mask is None:
                ndim_active = (
                    ndim_active + s_inds[name].sum(axis=-1) * nd * has_c2
                )
            else:
                per_leaf = jnp.asarray(mask).sum(axis=-1).astype(dtype)
                ndim_active = ndim_active + (
                    s_inds[name] * per_leaf[None, None, :]
                ).sum(axis=-1) * has_c2

        if self.use_log_proposal:
            factors = ndim_active * jnp.log(zz)
        else:
            factors = (ndim_active - 1.0) * jnp.log(zz)
        return newpos, factors
