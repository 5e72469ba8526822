"""Multiple-try MH from a generating distribution.

JAX re-design of ``/root/reference/src/eryn/moves/mtdistgen.py:7-137``:
``num_try`` candidate parameter vectors per walker are drawn from the given
distribution, evaluated in one batched likelihood call (tries folded into the
walker axis), importance-selected, and accepted against the auxiliary set.
Targets a single branch with ``nleaves_max == 1`` (as the reference).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .move import mh_accept
from .multipletry import MultipleTryMove
from .tempering import tempered_log_likelihood
from ..prior import ProbDistContainer

__all__ = ["MTDistGenMove"]


class MTDistGenMove(MultipleTryMove):
    """MT-MH draw from ``generate_dist`` (ref ``mtdistgen.py:7``)."""

    def __init__(self, generate_dist, **kwargs):
        if isinstance(generate_dist, ProbDistContainer):
            generate_dist = {"model_0": generate_dist}
        self.generate_dist_all = generate_dist
        self.key_in = list(generate_dist.keys())[0]
        self.generate_dist = generate_dist[self.key_in]
        super().__init__(**kwargs)
        # reference-style custom MT subclasses override the special_* host
        # hooks (ref multipletry.py:113-199); they run through the legacy
        # host bridge (MH family — the stock host get_proposal below drives
        # the user hooks via get_mt_proposal)
        from .move import overrides_host_api

        if any(
            overrides_host_api(self, hook)
            for hook in (
                "special_like_func",
                "special_prior_func",
                "special_generate_func",
                "special_generate_logpdf",
                "get_proposal",
            )
        ):
            self.host_move = True
            self._legacy_family = "mh"

    # -- MT hooks ------------------------------------------------------------
    def special_generate_kernel(self, key, state, num_try):
        ntemps, nwalkers = state.log_like.shape
        tries = self.generate_dist.sample(key, (ntemps, nwalkers, num_try))
        tries = tries.astype(state.branches[self.key_in].coords.dtype)
        logq = self.generate_dist.logpdf(tries)
        return tries, logq

    def special_generate_logpdf_kernel(self, state, coords=None):
        if coords is None:
            coords = state.branches[self.key_in].coords[:, :, 0]
        return self.generate_dist.logpdf(coords)

    def _current_target_coords(self, state):
        return state.branches[self.key_in].coords[:, :, 0]

    def _with_target_coords(self, state, coords):
        # the generating distribution ignores the current position, so
        # anchoring on the chosen point is a coordinate swap with no effect
        # on the generator; implemented for contract completeness
        new_coords = dict(state.branches_coords)
        new_coords[self.key_in] = coords[:, :, None, :]
        return state.replace(
            coords=new_coords, inds=dict(state.branches_inds)
        )

    def mt_eval_kernel(self, ctx, state, tries):
        ntemps, nwalkers, num_try, ndim = tries.shape
        coords = {
            self.key_in: tries.reshape(ntemps, nwalkers * num_try, 1, ndim)
        }
        inds = {
            self.key_in: jnp.repeat(
                state.branches[self.key_in].inds, num_try, axis=1
            )
        }
        for name, b in state.branches.items():
            if name == self.key_in:
                continue
            coords[name] = jnp.repeat(b.coords, num_try, axis=1)
            inds[name] = jnp.repeat(b.inds, num_try, axis=1)
        lp = ctx.compute_log_prior(coords, inds)
        ll, _ = ctx.compute_log_like(coords, inds, lp)
        return (
            ll.reshape(ntemps, nwalkers, num_try),
            lp.reshape(ntemps, nwalkers, num_try),
        )

    # ------------------------------------------------------------------
    # reference host protocol (ref mtdistgen.py:29-137) — used by legacy
    # custom-MT subclasses through the host bridge; the compiled sampler
    # path uses the *_kernel hooks above
    # ------------------------------------------------------------------
    def special_generate_logpdf(self, generated_coords):
        """Proposal logpdf of ``generated_coords`` under ``generate_dist``
        (ref ``mtdistgen.py:29-40``)."""
        import numpy as np

        return np.asarray(self.generate_dist.logpdf(generated_coords))

    special_generate_logpdf.__eryn_tpu_stock__ = True

    def special_generate_func(
        self, coords, random, size=1, fill_tuple=None, fill_values=None, **kwargs
    ):
        """Draw ``size`` tries per walker from ``generate_dist`` + their
        logpdf (ref ``mtdistgen.py:41-82``)."""
        import numpy as np

        nwalkers = coords.shape[0]
        if not isinstance(size, int):
            raise ValueError("size must be an int.")
        generated_coords = np.asarray(
            self.generate_dist.rvs(size=(nwalkers, size))
        )
        if fill_values is not None:
            generated_coords[fill_tuple] = fill_values
        generated_logpdf = self.special_generate_logpdf(
            generated_coords.reshape(nwalkers * size, -1)
        ).reshape(nwalkers, size)
        return generated_coords, generated_logpdf

    special_generate_func.__eryn_tpu_stock__ = True

    def set_coords_and_inds(self, generated_coords):
        """Build the full coords dict for Likelihood/prior evaluation of
        the flattened tries (ref ``mtdistgen.py:83-106``): the target
        branch gets the tries, other branches repeat their current leaves
        per try."""
        import numpy as np

        ndim = self.current_state.branches[self.key_in].shape[-1]
        n_all = generated_coords.reshape(-1, ndim).shape[0]
        coords_in_dict = {
            self.key_in: generated_coords.reshape(-1, 1, ndim)[None, :]
        }
        for key, branch in self.current_state.branches.items():
            if key == self.key_in:
                continue
            flat = np.asarray(branch.coords).reshape(
                (-1,) + branch.shape[-2:]
            )
            reps = n_all // flat.shape[0]
            coords_in_dict[key] = np.repeat(flat, reps, axis=0)[None, :]
        return coords_in_dict

    set_coords_and_inds.__eryn_tpu_stock__ = True

    def special_like_func(self, generated_coords, **kwargs):
        """Likelihood per try via the sampler's evaluator
        (ref ``mtdistgen.py:107-122``)."""
        import numpy as np

        coords_in = self.set_coords_and_inds(generated_coords)
        ll = self.current_model.compute_log_like_fn(coords_in)[0]
        return np.asarray(ll)[0].reshape(-1, self.num_try)

    special_like_func.__eryn_tpu_stock__ = True

    def special_prior_func(self, generated_coords, **kwargs):
        """Prior per try (ref ``mtdistgen.py:123-137``)."""
        import numpy as np

        coords_in = self.set_coords_and_inds(generated_coords)
        lp = self.current_model.compute_log_prior_fn(coords_in)
        return np.asarray(lp).reshape(-1, self.num_try)

    special_prior_func.__eryn_tpu_stock__ = True


    # -- proposal -------------------------------------------------------------
    def _propose_impl(self, key, state, ctx, kernel_state=()):
        ntemps, nwalkers = state.log_like.shape
        betas = (
            state.betas
            if state.betas is not None
            else jnp.ones((ntemps,), dtype=state.log_like.dtype)
        )
        key, k_mt, k_acc = jax.random.split(key, 3)
        coords_out, ll_out, lp_out, factors = self.mt_select_kernel(
            k_mt, state, ctx
        )

        logP_new = tempered_log_likelihood(ll_out, betas) + lp_out
        logP_old = (
            tempered_log_likelihood(state.log_like, betas) + state.log_prior
        )
        acc = mh_accept(k_acc, factors, logP_new, logP_old)

        coords = dict(state.branches_coords)
        old = coords[self.key_in]
        coords[self.key_in] = jnp.where(
            acc[:, :, None, None], coords_out[:, :, None, :], old
        )
        logl = jnp.where(acc, ll_out, state.log_like)
        logp = jnp.where(acc, lp_out, state.log_prior)

        new_state = state.replace(
            coords=coords,
            inds=dict(state.branches_inds),
            log_like=logl,
            log_prior=logp,
        )
        return new_state, acc, kernel_state
