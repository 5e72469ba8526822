"""Goodman-Weare affine-invariant stretch move.

JAX re-design of ``/root/reference/src/eryn/moves/stretch.py:103-231``.
The proposal is one fused vector expression over the whole
``(ntemps, Ns, nleaves_max, ndim)`` block: a single ``z`` draw per walker
shared across branches, a random complement gather, a periodic-aware stretch,
and RJ-aware detailed-balance factors computed from the leaf-activation masks
instead of the reference's host-side bookkeeping.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

import numpy as np

from .red_blue import RedBlueMove

__all__ = ["StretchMove"]


class StretchMove(RedBlueMove):
    """Affine-invariant "stretch" proposal (Goodman & Weare 2010).

    ``z ~ ((a-1)u + 1)^2 / a``; proposal ``q = c + z (s - c)``; factors
    ``(ndim_active - 1) log z`` (ref ``stretch.py:128-132,223-229``).  Under
    reversible jump, ``ndim_active`` is the per-walker count of active
    parameters from the ``inds`` masks.

    ``use_log_proposal=True`` selects the ptemcee scaling-variable density
    instead — the reference's own roadmap item ("add log proposal option
    used in ptemcee", ref ``docs/source/general/todos.rst``): ``ln z``
    uniform on ``[-ln a, ln a]`` (``g(z) ∝ 1/z``), for which detailed
    balance on the stretch ray requires factors ``ndim_active * log z``
    (``z^{N-1} g(1/z) / (z g(z)) = z^N``; ptemcee ``sampler.py`` uses
    exactly ``dim * log(z)``).  The log proposal concentrates less density
    at extreme stretches, which helps very anisotropic targets; see
    ``tests/test_moves.py::test_stretch_log_proposal`` for the measured
    comparison.
    """

    def __init__(
        self,
        a=2.0,
        return_gpu=False,
        random_seed=None,
        use_log_proposal=False,
        **kwargs,
    ):
        super().__init__(**kwargs)
        self.a = float(a)
        self.use_log_proposal = bool(use_log_proposal)

    # ------------------------------------------------------------------
    # reference host-protocol API (ref stretch.py:103-231) — used by
    # legacy custom-move subclasses that call super().get_proposal(...) or
    # self.get_new_points(...); the sampler's own hot path is the traced
    # kernel below
    # ------------------------------------------------------------------
    def get_proposal(self, s_all, c_all, random, gibbs_ndim=None, **kwargs):
        """Host stretch proposal over sample/complement dicts, returning
        ``(q_dict, factors)`` (ref ``stretch.py:160-231``)."""
        from .legacy import stretch_get_proposal

        return stretch_get_proposal(
            self, s_all, c_all, random, gibbs_ndim=gibbs_ndim
        )

    get_proposal.__eryn_tpu_stock__ = True

    def get_new_points(
        self, name, s, c_temp, Ns, branch_shape, branch_i, random_number_generator
    ):
        """Stretch one branch along the ray to its chosen complement
        (ref ``stretch.py:103-158``).  ``self.zz`` is drawn once on the
        first branch and shared, as in the reference."""
        ntemps, nwalkers, nleaves_max, ndim_here = branch_shape
        s = np.asarray(s)
        c_temp = np.asarray(c_temp)
        if branch_i == 0:
            u = random_number_generator.rand(ntemps, Ns)
            if self.use_log_proposal:
                self.zz = np.exp((2.0 * u - 1.0) * np.log(self.a))
            else:
                self.zz = ((self.a - 1.0) * u + 1.0) ** 2 / self.a
        if self.periodic is not None:
            diff = np.asarray(
                self.periodic.distance(
                    {name: s.reshape(ntemps * Ns, nleaves_max, ndim_here)},
                    {name: c_temp.reshape(ntemps * Ns, nleaves_max, ndim_here)},
                )[name]
            ).reshape(ntemps, Ns, nleaves_max, ndim_here)
        else:
            diff = c_temp - s
        temp = c_temp - diff * self.zz[:, :, None, None]
        if self.periodic is not None:
            temp = np.asarray(
                self.periodic.wrap(
                    {name: temp.reshape(ntemps * Ns, nleaves_max, ndim_here)},
                )[name]
            ).reshape(ntemps, Ns, nleaves_max, ndim_here)
        return temp

    def adjust_factors(self, factors, ndims_old, ndims_new):
        """Gibbs dimension correction (ref ``stretch.py:55-72``):
        rescale ``log z`` terms from ``ndims_old - 1`` to ``ndims_new - 1``.

        API-parity helper for user code ported from the reference.  The
        in-repo kernels never call it: ``get_proposal_kernel`` already
        computes factors from the mask-aware active dimension count, so
        applying this on top of them would double-correct."""
        logzz = factors / (ndims_old - 1.0)
        return logzz * (ndims_new - 1.0)

    def choose_c_vals(self, key, c, ns):
        """Random complement pick per proposed walker
        (ref ``stretch.py:74-101``)."""
        ntemps, nc = c.shape[:2]
        rint = jax.random.randint(key, (ntemps, ns), 0, nc)
        return jnp.take_along_axis(c, rint[:, :, None, None], axis=1)

    def get_proposal_kernel(self, key, s_coords, c_coords, s_inds, param_masks=None):
        names = list(s_coords.keys())
        first = s_coords[names[0]]
        ntemps, ns = first.shape[:2]
        dtype = first.dtype

        key_z, *branch_keys = jax.random.split(key, 1 + len(names))

        # one z per walker, shared across branches (ref stretch.py:128-132)
        u = jax.random.uniform(key_z, (ntemps, ns), dtype=dtype)
        if self.use_log_proposal:
            # ln z ~ U[-ln a, ln a] (ptemcee)
            zz = jnp.exp((2.0 * u - 1.0) * jnp.log(self.a))
        else:
            zz = ((self.a - 1.0) * u + 1.0) ** 2 / self.a

        newpos = {}
        ndim_active = jnp.zeros((ntemps, ns), dtype=dtype)
        for name, kb in zip(names, branch_keys):
            s = s_coords[name]
            c_temp = self.choose_c_vals(kb, c_coords[name], ns)

            if self.periodic is not None:
                diff = self.periodic.distance({name: s}, {name: c_temp})[name]
            else:
                diff = c_temp - s

            temp = c_temp - diff * zz[:, :, None, None]

            if self.periodic is not None:
                temp = self.periodic.wrap({name: temp})[name]

            newpos[name] = temp

            # RJ/Gibbs-aware dimension count: active leaves x selected params
            # (ref red_blue.py:199-207 + stretch.py:55-72)
            mask = None if param_masks is None else param_masks.get(name)
            if mask is None:
                ndim_active = (
                    ndim_active + s_inds[name].sum(axis=-1) * s.shape[-1]
                )
            else:
                mask = jnp.asarray(mask)
                per_leaf = mask.sum(axis=-1).astype(dtype)  # (nleaves_max,)
                ndim_active = ndim_active + (
                    s_inds[name] * per_leaf[None, None, :]
                ).sum(axis=-1)

        if self.use_log_proposal:
            # g(z) ∝ 1/z: z^{N-1} * g(1/z)/(z g(z)) = z^N
            factors = ndim_active * jnp.log(zz)
        else:
            factors = (ndim_active - 1.0) * jnp.log(zz)
        return newpos, factors
