"""Periodic-parameter handling.

JAX re-design of ``/root/reference/src/eryn/utils/periodic.py:11-151``.
Instead of per-parameter Python loops over index dictionaries, each branch's
periods are baked into a dense ``(ndim,)`` vector (non-periodic entries hold
``inf``) so distance/wrap are single fused vector ops over the whole
``(..., nleaves_max, ndim)`` ensemble.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

__all__ = ["PeriodicContainer"]


class PeriodicContainer:
    """Minimal signed distance and wrapping for periodic parameters.

    Args:
        periodic: ``{branch_name: {param_index_or_name: period}}``.  Parameter
            keys may be ints or strings resolved against ``key_order`` like the
            reference (``periodic.py:21-47``).
    """

    def __init__(
        self,
        periodic: dict,
        ndims: dict | None = None,
        key_orders=None,
        key_order=None,
    ):
        if not isinstance(periodic, dict):
            raise ValueError("periodic must be a dict of dicts.")
        self.periodic_in = periodic
        # the reference spells the kwarg ``key_order`` (singular,
        # {branch: [param names]}, ref periodic.py:21-47); accept both
        self._key_orders = key_orders or key_order or {}
        self._ndims = dict(ndims) if ndims else {}
        self._vectors = {}
        for name, spec in periodic.items():
            self._vectors[name] = self._build_vector(name, spec)

    def _resolve_index(self, name, key):
        if isinstance(key, int):
            return key
        order = self._key_orders.get(name)
        if order is None:
            raise ValueError(
                f"String parameter key '{key}' requires a key_order for "
                f"branch '{name}'."
            )
        return order.index(key)

    def _build_vector(self, name, spec):
        idx = {self._resolve_index(name, k): float(v) for k, v in spec.items()}
        ndim = self._ndims.get(name, max(idx) + 1 if idx else 0)
        vec = np.full((ndim,), np.inf)
        for i, period in idx.items():
            vec[i] = period
        return vec

    def _vector_for(self, name, ndim):
        vec = self._vectors.get(name)
        if vec is None:
            return None
        if len(vec) < ndim:
            vec = np.concatenate([vec, np.full((ndim - len(vec),), np.inf)])
            self._vectors[name] = vec
        return jnp.asarray(vec[:ndim])

    def distance(self, p1: dict, p2: dict, xp=None) -> dict:
        """Minimal signed distance ``p2 - p1`` per branch, wrapping periodic
        dimensions into ``[-P/2, P/2)`` (ref ``periodic.py:49-98``)."""
        out = {}
        for name in p1:
            a = jnp.asarray(p1[name])
            b = jnp.asarray(p2[name])
            d = b - a
            vec = self._vector_for(name, a.shape[-1])
            if vec is None:
                out[name] = d
                continue
            periodic_mask = jnp.isfinite(vec)
            period = jnp.where(periodic_mask, vec, 1.0)
            wrapped = jnp.mod(d + 0.5 * period, period) - 0.5 * period
            out[name] = jnp.where(periodic_mask, wrapped, d)
        return out

    def wrap(self, p: dict, xp=None) -> dict:
        """Wrap coordinates into ``[0, P)`` per periodic dimension
        (ref ``periodic.py:100-151``)."""
        out = {}
        for name in p:
            x = jnp.asarray(p[name])
            vec = self._vector_for(name, x.shape[-1])
            if vec is None:
                out[name] = x
                continue
            periodic_mask = jnp.isfinite(vec)
            period = jnp.where(periodic_mask, vec, 1.0)
            wrapped = jnp.mod(x, period)
            out[name] = jnp.where(periodic_mask, wrapped, x)
        return out
