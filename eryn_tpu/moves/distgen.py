"""Independent distribution-draw MH move.

JAX re-design of ``/root/reference/src/eryn/moves/distgen.py:14-104``:
new coordinates are drawn per leaf from a given per-branch distribution inside
the traced kernel (keyed sampling), with detailed-balance factors
``+logq(old) - logq(new)`` summed over active leaves.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .mh import MHMove
from ..prior import ProbDistContainer

__all__ = ["DistributionGenerate"]


class DistributionGenerate(MHMove):
    """MH move drawing independently from ``generate_dist``
    (ref ``distgen.py:14``).

    Args:
        generate_dist: ``{branch_name: ProbDistContainer}`` to draw from.
    """

    def __init__(self, generate_dist, **kwargs):
        if isinstance(generate_dist, ProbDistContainer):
            generate_dist = {"model_0": generate_dist}
        self.generate_dist = generate_dist
        super().__init__(**kwargs)

    def run_branches(self, state):
        names = super().run_branches(state)
        return [n for n in names if n in self.generate_dist]

    def _check_mask_against_groups(self, name, dist, mask):
        """Reject Gibbs masks that select a proper subset of a multi-dim
        prior group: the joint-logpdf factors would then be conditional
        (given the unmasked dims) instead of the marginal proposal density,
        which is wrong for correlated groups."""
        import numpy as np

        rows = np.atleast_2d(np.asarray(mask, dtype=bool))
        for inds_g, _d in getattr(dist, "priors", []):
            if len(inds_g) <= 1:
                continue
            sub = rows[:, np.asarray(inds_g)]
            counts = sub.sum(axis=-1)
            if np.any((counts > 0) & (counts < len(inds_g))):
                raise ValueError(
                    f"Gibbs mask for branch '{name}' splits the "
                    f"multivariate prior group {tuple(int(i) for i in inds_g)}"
                    "; DistributionGenerate cannot compute marginal "
                    "proposal factors for a partial update of a correlated "
                    "group. Update the whole group in one Gibbs iteration."
                )

    def get_proposal_kernel(
        self, key, branch_coords, branch_inds, kernel_state, param_masks=None
    ):
        q = {}
        factors = None
        names = list(branch_coords.keys())
        keys = jax.random.split(key, len(names))
        for name, kb in zip(names, keys):
            coords = branch_coords[name]
            inds = branch_inds[name]
            dist = self.generate_dist[name]

            new = dist.sample(kb, coords.shape[:-1]).astype(coords.dtype)
            xnew = jnp.where(inds[..., None], new, coords)
            mask = None if param_masks is None else param_masks.get(name)
            if mask is not None:
                # restrict the update BEFORE computing factors: the Hastings
                # ratio must describe the masked proposal, not the full draw
                # (for the product-form containers this makes lq_old - lq_new
                # reduce to the selected dimensions' contributions).  The
                # joint-logpdf ratio equals the CONDITIONAL, not the
                # marginal, when a mask splits a correlated multivariate
                # group — refuse that case rather than sample a biased chain
                self._check_mask_against_groups(name, dist, mask)
                xnew = jnp.where(
                    jnp.asarray(mask)[None, None, :, :], xnew, coords
                )

            if self.periodic is not None:
                xnew = self.periodic.wrap({name: xnew})[name]
            q[name] = xnew

            # factors: +logq(old) - logq(new), active leaves only
            # (ref distgen.py:86-102)
            lq_old = jnp.where(inds, dist.logpdf(coords), 0.0).sum(axis=-1)
            lq_new = jnp.where(inds, dist.logpdf(xnew), 0.0).sum(axis=-1)
            f = lq_old - lq_new
            factors = f if factors is None else factors + f
        return q, factors, kernel_state
