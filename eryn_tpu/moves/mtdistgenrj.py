"""Multiple-try reversible jump from a generating distribution.

JAX re-design of
``/root/reference/src/eryn/moves/mtdistgenrj.py:7-190`` +
``multipletry.py:597-776`` (the nested-RJ bookkeeping).  For every walker the
kernel evaluates the "one-less-leaf" base state and ``num_try`` candidate
leaves at the proposed slot in one fused batch; births importance-select among
candidates, deaths force try 0 to the removed leaf and invert the factors
(``multipletry.py:476-478``).  The final acceptance reduces to the MT ratio
``logsumexp(w) - (beta*ll_base + log num_try)`` for births (inverted for
deaths), plus the standard RJ edge factors.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from .move import mh_accept
from .multipletry import logsumexp
from .rj import ReversibleJumpMove, rj_change_kernel
from .tempering import tempered_log_likelihood
from ..prior import ProbDistContainer

__all__ = ["MTDistGenMoveRJ"]


class MTDistGenMoveRJ(ReversibleJumpMove):
    """MT-RJ birth/death move (ref ``mtdistgenrj.py:7``)."""

    def __init__(self, generate_dist, *args, num_try=1, rj=True, **kwargs):
        if isinstance(generate_dist, ProbDistContainer):
            generate_dist = {"model_0": generate_dist}
        self.generate_dist = generate_dist
        self.num_try = int(num_try)
        # host-protocol flags (MultipleTryMove contract; ref
        # multipletry.py:84-107 — rj forbids symmetric/independent)
        self.independent = False
        self.symmetric = False
        self.mt_rj = True
        super().__init__(*args, **kwargs)
        # reference-style custom MT-RJ subclasses override the special_*
        # host hooks; they run through the legacy host bridge (RJ family)
        from .move import overrides_host_api

        if any(
            overrides_host_api(self, hook)
            for hook in (
                "special_like_func",
                "special_prior_func",
                "special_generate_func",
                "special_generate_logpdf",
            )
        ):
            self.host_move = True
            self._legacy_family = "rj"

    def run_branches(self, state):
        names = super().run_branches(state)
        return [n for n in names if n in self.generate_dist]

    # ------------------------------------------------------------------
    # reference host protocol (ref mtdistgenrj.py:29-190): the MT driver
    # methods are shared with the in-model classes (same function objects,
    # mirroring the reference's multiple inheritance from
    # MultipleTryMoveRJ); the dist-backed special_* hooks below provide
    # the RJ variants
    # ------------------------------------------------------------------
    from .distgenrj import DistributionGenerateRJ as _DGRJ
    from .multipletry import MultipleTryMove as _MT, MultipleTryMoveRJ as _MTRJ

    get_mt_log_posterior = _MT.get_mt_log_posterior
    readout_adjustment = _MT.readout_adjustment
    get_mt_proposal = _MT.get_mt_proposal
    get_proposal = _MTRJ.get_proposal
    get_model_change_proposal = _DGRJ.get_model_change_proposal
    del _MT, _MTRJ, _DGRJ

    def special_generate_logpdf(self, generated_coords):
        """Proposal logpdf under the branch's distribution
        (ref ``mtdistgenrj.py:29-38``)."""
        import numpy as np

        return np.asarray(
            self.generate_dist[self.key_in].logpdf(generated_coords)
        )

    special_generate_logpdf.__eryn_tpu_stock__ = True

    def special_generate_func(
        self, coords, random, size=1, fill_tuple=None, fill_values=None, **kwargs
    ):
        """Draw ``size`` tries per walker; reverse (death) walkers get the
        removed leaf filled into try slot 0 via ``fill_tuple``
        (ref ``mtdistgenrj.py:41-78``)."""
        import numpy as np

        nwalkers = coords.shape[0]
        if not isinstance(size, int):
            raise ValueError("size must be an int.")
        generated_coords = np.asarray(
            self.generate_dist[self.key_in].rvs(size=(nwalkers, size))
        )
        if fill_values is not None:
            generated_coords[fill_tuple] = fill_values
        generated_logpdf = self.special_generate_logpdf(
            generated_coords.reshape(nwalkers * size, -1)
        ).reshape(nwalkers, size)
        return generated_coords, generated_logpdf

    special_generate_func.__eryn_tpu_stock__ = True

    def set_coords_and_inds(self, generated_coords, inds_leaves_rj=None):
        """Full coords/inds dicts for evaluating the flattened tries: each
    walker repeated ``num_try`` times with the changing leaf replaced by
        the generated try and its mask forced on
        (ref ``mtdistgenrj.py:80-152``, vectorized)."""
        import numpy as np

        st = self.current_state
        bc = np.asarray(st.branches[self.key_in].coords)
        bi = np.asarray(st.branches[self.key_in].inds)
        nl, nd = bc.shape[-2:]
        flat_c = bc.reshape(-1, nl, nd)
        flat_i = bi.reshape(-1, nl)
        n_all = flat_c.shape[0]
        coords_in = np.repeat(flat_c, self.num_try, axis=0)
        inds_in = np.repeat(flat_i, self.num_try, axis=0)
        rows = np.arange(n_all * self.num_try)
        leaves = np.repeat(np.asarray(inds_leaves_rj, dtype=int), self.num_try)
        coords_in[rows, leaves] = np.asarray(generated_coords).reshape(-1, nd)
        inds_in[rows, leaves] = True
        coords_dict = {self.key_in: coords_in[None]}
        inds_dict = {self.key_in: inds_in[None]}
        for key, branch in st.branches.items():
            if key == self.key_in:
                continue
            okc = np.asarray(branch.coords).reshape((-1,) + branch.shape[-2:])
            oki = np.asarray(branch.inds).reshape(-1, branch.shape[-2])
            coords_dict[key] = np.repeat(okc, self.num_try, axis=0)[None]
            inds_dict[key] = np.repeat(oki, self.num_try, axis=0)[None]
        return coords_dict, inds_dict

    set_coords_and_inds.__eryn_tpu_stock__ = True

    def special_like_func(self, generated_coords, inds_leaves_rj=None, **kwargs):
        """Likelihood per try with the changing leaf swapped in
        (ref ``mtdistgenrj.py:154-171``)."""
        import numpy as np

        coords_in, inds_in = self.set_coords_and_inds(
            generated_coords, inds_leaves_rj=inds_leaves_rj
        )
        ll = self.current_model.compute_log_like_fn(coords_in, inds=inds_in)[0]
        return np.asarray(ll)[0].reshape(-1, self.num_try)

    special_like_func.__eryn_tpu_stock__ = True

    def special_prior_func(self, generated_coords, inds_leaves_rj=None, **kwargs):
        """Prior per try (ref ``mtdistgenrj.py:173-190``)."""
        import numpy as np

        coords_in, inds_in = self.set_coords_and_inds(
            generated_coords, inds_leaves_rj=inds_leaves_rj
        )
        lp = self.current_model.compute_log_prior_fn(coords_in, inds=inds_in)
        return np.asarray(lp).reshape(-1, self.num_try)

    special_prior_func.__eryn_tpu_stock__ = True

    def _propose_impl(self, key, state, ctx, kernel_state=()):
        names = [
            n
            for split_names, _m in self.gibbs_iterations_for(state)
            for n in split_names
        ]
        coords = dict(state.branches_coords)
        inds = dict(state.branches_inds)
        logl = state.log_like
        logp = state.log_prior
        blobs = state.blobs
        ntemps, nwalkers = logl.shape
        betas = (
            state.betas
            if state.betas is not None
            else jnp.ones((ntemps,), dtype=logl.dtype)
        )
        T = self.num_try
        accepted_total = jnp.zeros((ntemps, nwalkers), dtype=logl.dtype)

        for name in names:
            dist = self.generate_dist[name]
            c = coords[name]
            m = inds[name]
            nt, nw, nl, nd = c.shape

            key, k_change, k_draw, k_pick, k_acc = jax.random.split(key, 5)
            change, slot, _ = rj_change_kernel(
                k_change,
                m,
                self.nleaves_min[name],
                self.nleaves_max[name],
                self.fix_change,
            )
            slot_onehot = (
                jax.lax.broadcasted_iota(jnp.int32, m.shape, 2)
                == slot[:, :, None]
            )
            inds_without = m & ~slot_onehot
            inds_with = inds_without | slot_onehot

            # base ("one less leaf") state evaluation
            base_inds = {**inds, name: inds_without}
            lp_without = ctx.compute_log_prior(coords, base_inds)
            ll_without, blobs_without = ctx.compute_log_like(
                coords, base_inds, lp_without
            )

            # candidate leaves; deaths use the removed leaf as try 0
            tries = dist.sample(k_draw, (nt, nw, T)).astype(c.dtype)
            # one-hot reduce over the leaf axis, not take_along_axis (see
            # distgenrj.py)
            at_slot = jnp.sum(
                jnp.where(
                    slot_onehot[..., None], c, jnp.zeros((), c.dtype)
                ),
                axis=2,
            )
            is_death = (change == -1)[:, :, None, None]
            try0_fill = (
                jax.lax.broadcasted_iota(jnp.int32, (nt, nw, T, 1), 2) == 0
            )
            tries = jnp.where(
                is_death & try0_fill, at_slot[:, :, None, :], tries
            )

            # evaluate all tries: candidate at `slot`, base leaves active
            coords_rep = {
                n2: jnp.repeat(coords[n2], T, axis=1) for n2 in coords
            }
            inds_rep = {
                n2: jnp.repeat(base_inds[n2], T, axis=1) for n2 in inds
            }
            slot_rep = jnp.repeat(slot, T, axis=1)  # (nt, nw*T)
            tries_flat = tries.reshape(nt, nw * T, nd)
            slot_mask_rep = (
                jax.lax.broadcasted_iota(
                    jnp.int32, (nt, nw * T, nl), 2
                )
                == slot_rep[:, :, None]
            )
            coords_rep[name] = jnp.where(
                slot_mask_rep[..., None], tries_flat[:, :, None, :], coords_rep[name]
            )
            inds_rep[name] = inds_rep[name] | slot_mask_rep

            lp_try = ctx.compute_log_prior(coords_rep, inds_rep)
            ll_try, blobs_try = ctx.compute_log_like(
                coords_rep, inds_rep, lp_try
            )
            lp_try = lp_try.reshape(nt, nw, T)
            ll_try = ll_try.reshape(nt, nw, T)
            if blobs_try is not None:
                blobs_try = blobs_try.reshape(
                    (nt, nw, T) + blobs_try.shape[2:]
                )

            # importance weights (proposal pdf gets +lp_base so existing-leaf
            # priors cancel; ref multipletry.py:349-351)
            logq = dist.logpdf(tries) + lp_without[:, :, None]
            logP_try = tempered_log_likelihood(ll_try, betas[:, None, None]) + lp_try
            logw = logP_try - logq
            log_sum_w = logsumexp(logw, axis=-1)

            j = jax.random.categorical(k_pick, logw, axis=-1)
            j = jnp.where(change == -1, 0, j)  # deaths keep the removed leaf
            one_hot = (
                jax.lax.broadcasted_iota(jnp.int32, logw.shape, 2)
                == j[:, :, None]
            )

            def pick(x):
                return jnp.sum(jnp.where(one_hot, x, 0.0), axis=-1)

            ll_chosen = pick(ll_try)
            lp_chosen = pick(lp_try)
            logP_chosen = pick(logP_try)
            try_chosen = jnp.sum(jnp.where(one_hot[..., None], tries, 0.0), axis=2)

            # auxiliary set: num_try repeats of the base state
            # (ref multipletry.py:421-431)
            base_logP = (
                tempered_log_likelihood(ll_without, betas) + lp_without
            )
            aux_log_sum_w = tempered_log_likelihood(
                ll_without, betas
            ) + float(np.log(T))

            factors_birth = (base_logP - aux_log_sum_w) - (
                logP_chosen - log_sum_w
            )
            factors = jnp.where(
                change == 1,
                factors_birth,
                jnp.where(change == -1, -factors_birth, 0.0),
            )
            factors = factors + self._edge_factors(
                name,
                m.sum(axis=-1),
                jnp.where(
                    change == 1,
                    inds_with.sum(axis=-1),
                    jnp.where(change == -1, inds_without.sum(axis=-1), m.sum(-1)),
                ),
                logl.dtype,
            )

            # proposed new per-walker state
            birth = change == 1
            death = change == -1
            new_inds_branch = jnp.where(
                birth[:, :, None],
                inds_with,
                jnp.where(death[:, :, None], inds_without, m),
            )
            new_coords_branch = jnp.where(
                (birth[:, :, None] & slot_onehot)[..., None],
                try_chosen[:, :, None, :],
                c,
            )
            ll_new = jnp.where(birth, ll_chosen, jnp.where(death, ll_without, logl))
            lp_new = jnp.where(birth, lp_chosen, jnp.where(death, lp_without, logp))
            blobs_new = None
            if blobs is not None and blobs_try is not None:
                # blob of the chosen try (births) / of the base state (deaths)
                oh = one_hot.reshape(
                    one_hot.shape + (1,) * (blobs_try.ndim - 3)
                )
                blobs_chosen = jnp.sum(jnp.where(oh, blobs_try, 0.0), axis=2)
                bsel = birth.reshape(birth.shape + (1,) * (blobs.ndim - 2))
                dsel = death.reshape(death.shape + (1,) * (blobs.ndim - 2))
                blobs_new = jnp.where(
                    bsel,
                    blobs_chosen,
                    jnp.where(dsel, blobs_without, blobs),
                )

            logP_new = tempered_log_likelihood(ll_new, betas) + lp_new
            logP_old = tempered_log_likelihood(logl, betas) + logp
            acc = mh_accept(k_acc, factors, logP_new, logP_old)
            acc = acc & (change != 0)

            coords[name] = jnp.where(
                acc[:, :, None, None], new_coords_branch, c
            )
            inds[name] = jnp.where(acc[:, :, None], new_inds_branch, m)
            logl = jnp.where(acc, ll_new, logl)
            logp = jnp.where(acc, lp_new, logp)
            if blobs is not None and blobs_new is not None:
                acc_b = acc.reshape(acc.shape + (1,) * (blobs.ndim - 2))
                blobs = jnp.where(acc_b, blobs_new, blobs)
            accepted_total = accepted_total + acc

        new_state = state.replace(
            coords=coords, inds=inds, log_like=logl, log_prior=logp,
            blobs=blobs,
        )
        return new_state, accepted_total, kernel_state
