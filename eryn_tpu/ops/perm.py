"""Permutation utilities for the traced hot path.

``jnp.argsort(perm)`` — the obvious way to invert a permutation — is a
full sort.  Inverting a permutation needs no sort: it is a one-hot
contraction that XLA lowers to one reduce fusion, ``O(n^2)`` work that is
cheap at small ``n`` (which of the two is faster on the GPU at each size
is an open measurement).  Integer arithmetic throughout, so the result is
exactly ``argsort(perm)`` bit for bit.

(The permutation DRAW itself — sorting random u32 keys — is left alone:
that sort defines the sampled permutation, and replacing it would change
the proposal stream and invalidate the statistical sweep captures.)
"""

import jax.numpy as jnp

__all__ = ["invert_permutation"]


def invert_permutation(perm):
    """Exact inverse of a ``(..., n)`` integer permutation, without a sort.

    ``inv[perm[j]] = j`` computed as ``inv[i] = sum_j [perm[j] == i] * j``
    — one ``(..., n, n)`` equality + masked integer row-sum, fused by XLA.
    Inverts along the last axis (batch dims broadcast).
    """
    n = perm.shape[-1]
    iot = jnp.arange(n, dtype=perm.dtype)
    hit = perm[..., None, :] == iot[:, None]  # [..., i, j]: j = inv[i]
    return jnp.sum(jnp.where(hit, iot, 0), axis=-1)
