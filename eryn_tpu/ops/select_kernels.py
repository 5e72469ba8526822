"""Masked-selection helpers for the RJ-correct group-stretch move.

:mod:`eryn_tpu.moves.rbgroupstretch` selects, for every active leaf of a
moving walker, a uniformly random ACTIVE leaf of the complement half: an
inverse-CDF over the flattened ``(complement walker, leaf)`` axis, driven
by the running count of active entries computed here.
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = ["mask_cumsum"]


def _round_up(x, mult):
    return -(-x // mult) * mult


def mask_cumsum(m):
    """Inclusive cumsum of a 0/1 activity mask along the last axis, exact,
    without ``reduce-window``.

    ``jnp.cumsum`` lowers to hierarchical ``reduce-window`` ops; this
    formulation is two small matmuls instead: within-128-block prefix sums
    against a triangular matrix and a block-offset correction.  Every
    operand is an exact small integer (mask 0/1, block totals <= 128) and
    every sum an integer below 2^24 accumulated in f32, so DEFAULT matmul
    precision is exact even where it rounds operands to bf16 or TF32.

    Args:
        m: ``(nt, M)`` float 0/1 mask.

    Returns:
        ``(nt, M)`` running counts, bitwise equal to ``jnp.cumsum(m, -1)``.
    """
    nt, M = m.shape
    dtype = m.dtype
    if M < 256:  # not worth the padding; cumsum is fine at tiny widths
        return jnp.cumsum(m, axis=-1)
    B = 128
    Mp = _round_up(M, B)
    if Mp != M:
        m = jnp.concatenate([m, jnp.zeros((nt, Mp - M), dtype)], axis=1)
    nb = Mp // B
    blocks = m.reshape(nt, nb, B)
    tri = jnp.tril(jnp.ones((B, B), dtype)).T  # tri[j, i] = 1 iff j <= i
    within = jnp.matmul(blocks, tri)  # (nt, nb, B) inclusive per block
    totals = within[..., -1]  # (nt, nb)
    # exclusive block offsets: strict lower-triangular contraction
    off_tri = (
        jnp.tril(jnp.ones((nb, nb), dtype)) - jnp.eye(nb, dtype=dtype)
    ).T
    offsets = jnp.matmul(totals, off_tri)  # (nt, nb)
    cs = within + offsets[..., None]
    return cs.reshape(nt, Mp)[:, :M]
