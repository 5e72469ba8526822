"""Reversible-jump birth/death from a generating distribution.

JAX re-design of ``/root/reference/src/eryn/moves/distgenrj.py:14-222``:
birth coordinates are keyed draws from the branch's distribution (usually the
prior), deaths flip the mask, and detailed-balance factors are
``-logpdf(born)`` / ``+logpdf(removed)`` (``distgenrj.py:196-221``) — all as
one fused masked kernel instead of per-walker Python loops.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .rj import ReversibleJumpMove, rj_change_kernel
from ..prior import ProbDistContainer

__all__ = ["DistributionGenerateRJ"]


class DistributionGenerateRJ(ReversibleJumpMove):
    """Concrete RJ birth/death move (ref ``distgenrj.py:14``).

    Args:
        generate_dist: ``{branch_name: ProbDistContainer}`` to draw births
            from (typically the priors).
        nleaves_max / nleaves_min: per-branch leaf-count bounds.
        fix_change: force +1 (birth-only) or -1 (death-only) proposals.
    """

    def __init__(self, generate_dist, *args, **kwargs):
        if isinstance(generate_dist, ProbDistContainer):
            generate_dist = {"model_0": generate_dist}
        self.generate_dist = generate_dist
        super().__init__(*args, **kwargs)

    def run_branches(self, state):
        names = super().run_branches(state)
        return [n for n in names if n in self.generate_dist]

    # ------------------------------------------------------------------
    # reference host protocol (ref distgenrj.py:35-222) — used by legacy
    # custom-RJ subclasses through the host bridge; vectorized over
    # walkers instead of the reference's per-walker Python loops
    # ------------------------------------------------------------------
    def get_model_change_proposal(self, inds, random, nleaves_min, nleaves_max):
        """Pick birth/death slots per walker, returning the reference's
        ``{"+1": (n, 3) indices, "-1": (n, 3) indices}`` layout
        (ref ``distgenrj.py:35-122``)."""
        import numpy as np

        inds = np.asarray(inds, dtype=bool)
        ntemps, nwalkers, nlmax = inds.shape
        nleaves = inds.sum(axis=-1)

        if self.fix_change is None:
            change = random.choice([-1, +1], size=nleaves.shape)
        else:
            change = np.full(nleaves.shape, self.fix_change)
        change = (
            change * ((nleaves != nleaves_min) & (nleaves != nleaves_max))
            + (+1) * (nleaves == nleaves_min)
            + (-1) * (nleaves == nleaves_max)
        )

        # uniform slot choice without per-walker loops: a stable argsort
        # of the mask puts inactive slots first (False < True) in index
        # order, so the j-th inactive slot is order[..., j] and the j-th
        # active one is order[..., n_inactive + j]
        order = np.argsort(inds, axis=-1, kind="stable")
        n_inactive = nlmax - nleaves
        u = random.rand(ntemps, nwalkers)
        j_add = np.minimum(
            (u * np.maximum(n_inactive, 1)).astype(int), nlmax - 1
        )
        j_rem = np.minimum((u * np.maximum(nleaves, 1)).astype(int), nlmax - 1)
        slot_add = np.take_along_axis(order, j_add[..., None], -1)[..., 0]
        slot_rem = np.take_along_axis(
            order, np.minimum(n_inactive + j_rem, nlmax - 1)[..., None], -1
        )[..., 0]

        out = {}
        t, w = np.nonzero(change == +1)
        out["+1"] = np.stack([t, w, slot_add[t, w]], axis=-1).astype(int)
        t, w = np.nonzero(change == -1)
        out["-1"] = np.stack([t, w, slot_rem[t, w]], axis=-1).astype(int)
        return out

    get_model_change_proposal.__eryn_tpu_stock__ = True

    def get_proposal(
        self, all_coords, all_inds, nleaves_min_all, nleaves_max_all, random, **kwargs
    ):
        """Host RJ proposal with the reference's signature
        (ref ``distgenrj.py:124-222``): flip masks per
        :meth:`get_model_change_proposal`, draw birth coordinates from the
        branch's distribution, and return ``(q, new_inds, factors)`` with
        the ``-logpdf(born)`` / ``+logpdf(removed)`` factors."""
        import numpy as np

        q = {}
        new_inds = {}
        all_changes = {}
        for name, inds in all_inds.items():
            nmin = nleaves_min_all[name]
            nmax = nleaves_max_all[name]
            if nmin == nmax:
                continue
            if nmin > nmax:
                raise ValueError(
                    "nleaves_min is greater than nleaves_max. Not allowed."
                )
            all_changes[name] = self.get_model_change_proposal(
                inds, random, nmin, nmax
            )

        factors = None
        for name in all_coords:
            coords = np.asarray(all_coords[name])
            inds = np.asarray(all_inds[name], dtype=bool)
            ntemps, nwalkers = coords.shape[:2]
            q[name] = coords.copy()
            new_inds[name] = inds.copy()
            if factors is None:
                factors = np.zeros((ntemps, nwalkers))
            if name not in all_changes:
                continue
            dist = self.generate_dist[name]

            # deaths: True -> False; factor +logpdf(removed)
            rem = tuple(all_changes[name]["-1"].T)
            new_inds[name][rem] = False
            if rem[0].size:
                factors[rem[:2]] += np.asarray(dist.logpdf(q[name][rem]))

            # births: False -> True; draw coords; factor -logpdf(born)
            add = tuple(all_changes[name]["+1"].T)
            new_inds[name][add] = True
            if add[0].size:
                q[name][add] = np.asarray(dist.rvs(size=add[0].size))
                factors[add[:2]] -= np.asarray(dist.logpdf(q[name][add]))

        return q, new_inds, factors

    get_proposal.__eryn_tpu_stock__ = True

    def get_proposal_kernel(self, key, name, coords, inds):
        ntemps, nwalkers, nleaves_max, ndim = coords.shape
        dist = self.generate_dist[name]

        k_change, k_draw = jax.random.split(key)
        change, slot, new_inds = rj_change_kernel(
            k_change,
            inds,
            self.nleaves_min[name],
            self.nleaves_max[name],
            self.fix_change,
        )

        # birth draws for every walker (only used where change == +1)
        draw = dist.sample(k_draw, (ntemps, nwalkers)).astype(coords.dtype)

        slot_mask = (
            jax.lax.broadcasted_iota(jnp.int32, inds.shape, 2)
            == slot[:, :, None]
        )
        born = (change == 1)[:, :, None] & slot_mask
        q = jnp.where(born[..., None], draw[:, :, None, :], coords)

        # coords at the affected slot (old values — the removed leaf):
        # a one-hot reduce over the (tiny) leaf axis, which XLA fuses into
        # its neighbours, instead of a per-walker gather
        at_slot = jnp.sum(
            jnp.where(slot_mask[..., None], coords, jnp.zeros((), coords.dtype)),
            axis=2,
        )

        # factors (ref distgenrj.py:196-221): birth -> -logpdf(new);
        # death -> +logpdf(removed)
        lq_draw = dist.logpdf(draw)
        lq_removed = dist.logpdf(at_slot)
        factors = jnp.where(
            change == 1,
            -lq_draw,
            jnp.where(change == -1, lq_removed, 0.0),
        ).astype(coords.dtype)

        return q, new_inds, factors
