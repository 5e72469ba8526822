"""Multiple-try Metropolis machinery.

JAX re-design of
``/root/reference/src/eryn/moves/multipletry.py:25-776``.  The ``num_try``
axis is just one more batch dimension: candidate generation, importance
weighting (``logP - logq``), categorical selection, and the auxiliary
reference set for detailed balance are all fused vector math over
``(ntemps, nwalkers, num_try)``, with likelihood tries evaluated through the
same batched evaluator as the main ensemble (tries folded into the walker
axis).

Acceptance identity used throughout (matching the reference's ``factors``
construction, ``multipletry.py:455-476``): the final ``lnpdiff`` reduces to
``logsumexp(w_new) - logsumexp(w_aux)``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .move import Move, mh_accept
from .tempering import tempered_log_likelihood

__all__ = ["MultipleTryMove", "get_mt_computations", "logsumexp"]


def logsumexp(a, axis=None):
    """Stable logsumexp (ref ``multipletry.py:25-33``)."""
    return jax.scipy.special.logsumexp(a, axis=axis)


def get_mt_computations(logP, log_proposal_pdf, symmetric=False, xp=None):
    """Importance weights + categorical try selection — the reference's
    public helper with its exact signature (ref ``multipletry.py:36-59``).

    ``(nbatch, num_try)`` inputs; draws selection uniforms through NumPy's
    global RNG like the reference (the compiled sampler path uses the keyed
    :meth:`MultipleTryMove.mt_select_kernel` instead).

    Returns:
        ``(log_importance_weights, log_sum_weights, inds_keep)``.
    """
    import numpy as np

    if xp is None:
        xp = np
    logP = xp.asarray(logP)
    if symmetric:
        log_importance_weights = logP
    else:
        log_importance_weights = logP - xp.asarray(log_proposal_pdf)
    max_w = xp.max(log_importance_weights, axis=-1)
    log_sum_weights = max_w + xp.log(
        xp.exp(log_importance_weights - max_w[:, None]).sum(axis=-1)
    )
    probs = xp.exp(log_importance_weights - log_sum_weights[:, None])
    u = xp.asarray(np.random.rand(probs.shape[0]))
    inds_keep = (probs.cumsum(1) > u[:, None]).argmax(1)
    return log_importance_weights, log_sum_weights, inds_keep


class MultipleTryMove(Move):
    """Generic multiple-try mixin (ref ``multipletry.py:62``).

    Subclasses provide:

    * ``special_generate_kernel(key, state, num_try) -> (tries, logq)`` with
      ``tries`` shaped ``(ntemps, nwalkers, num_try, ndim)`` and ``logq``
      ``(ntemps, nwalkers, num_try)`` — the proposal is anchored on
      ``state``'s current coordinates (ignored by state-independent
      generators);
    * ``special_generate_logpdf_kernel(state, coords=None) ->
      (ntemps, nwalkers)`` — the proposal logpdf of ``coords`` (default:
      ``state``'s current target coords) under the generator anchored on
      ``state``;
    * ``mt_eval_kernel(ctx, state, tries) -> (ll, lp)`` — likelihood/prior per
      try, each ``(ntemps, nwalkers, num_try)``;
    * for state-dependent generators with ``independent=False``,
      ``_with_target_coords(state, coords) -> state`` — a copy of ``state``
      whose target-branch coordinates are replaced by ``coords``
      ``(ntemps, nwalkers, ndim)`` (the auxiliary set must be anchored on
      the *chosen* point for detailed balance).

    Args:
        num_try: number of tries.
        independent: proposal independent of the current point.
        symmetric: symmetric proposal (importance weights are ``logP`` only).
    """

    def __init__(
        self, num_try=1, independent=False, symmetric=False, rj=False, **kwargs
    ):
        super().__init__(**kwargs)
        self.num_try = int(num_try)
        self.independent = independent
        self.symmetric = symmetric
        self.mt_rj = rj
        if rj and (symmetric or independent):
            raise ValueError(
                "If rj==True, symmetric and independent must both be False."
            )

    # -- subclass hooks -----------------------------------------------------
    def special_generate_kernel(self, key, state, num_try):
        raise NotImplementedError

    def special_generate_logpdf_kernel(self, state, coords=None):
        raise NotImplementedError

    def mt_eval_kernel(self, ctx, state, tries):
        raise NotImplementedError

    def _with_target_coords(self, state, coords):
        """Return ``state`` with the target branch's coordinates replaced by
        ``coords`` (used to anchor the auxiliary set on the chosen point).
        State-dependent generators with ``independent=False`` must override
        this; state-independent ones never need it."""
        raise NotImplementedError(
            "Non-independent multiple-try with a state-dependent generator "
            "requires _with_target_coords(state, coords) so the auxiliary "
            "set can be anchored on the chosen point."
        )

    def mt_select_kernel(self, key, state, ctx):
        """Run the full MT machinery for the in-model case.

        Returns ``(chosen coords (nt, nw, ndim), ll_out, lp_out, factors)``
        such that ``factors + logP_new - logP_old`` equals the MT weight-sum
        ratio.
        """
        ntemps, nwalkers = state.log_like.shape
        betas = (
            state.betas
            if state.betas is not None
            else jnp.ones((ntemps,), dtype=state.log_like.dtype)
        )
        key_gen, key_pick, key_aux = jax.random.split(key, 3)

        tries, logq = self.special_generate_kernel(key_gen, state, self.num_try)
        ll, lp = self.mt_eval_kernel(ctx, state, tries)
        logP = tempered_log_likelihood(ll, betas[:, None, None]) + lp

        logw = logP if self.symmetric else logP - logq
        log_sum_w = logsumexp(logw, axis=-1)

        # categorical selection over tries (ref multipletry.py:36-59)
        j = jax.random.categorical(key_pick, logw, axis=-1)
        one_hot = (
            jax.lax.broadcasted_iota(jnp.int32, logw.shape, 2) == j[:, :, None]
        )

        def pick(x):
            return jnp.sum(jnp.where(one_hot, x, 0.0), axis=-1)

        coords_out = jnp.sum(
            jnp.where(one_hot[..., None], tries, 0.0), axis=2
        )
        ll_out = pick(ll)
        lp_out = pick(lp)
        logP_out = pick(logP)

        # auxiliary reference set for detailed balance
        if self.independent:
            # replace the chosen slot with the current point
            # (ref multipletry.py:380-419)
            cur_logP = (
                tempered_log_likelihood(state.log_like, betas) + state.log_prior
            )
            if self.symmetric:
                aux_sub = cur_logP
            else:
                cur_logq = self.special_generate_logpdf_kernel(state)
                aux_sub = cur_logP - cur_logq
            aux_logw = jnp.where(one_hot, aux_sub[:, :, None], logw)
        else:
            # regenerate an auxiliary try set anchored on the CHOSEN point:
            # standard MTM draws the reference set from T(y, .) with y the
            # selected try (Liu, Liang & Wong 2000; ref multipletry.py:432-460)
            state_y = self._with_target_coords(state, coords_out)
            aux_tries, aux_logq = self.special_generate_kernel(
                key_aux, state_y, self.num_try
            )
            cur = self._current_target_coords(state)
            aux_tries = jnp.where(one_hot[..., None], cur[:, :, None, :], aux_tries)
            if not self.symmetric:
                # The chosen slot now holds the *current* point x, so its
                # importance weight must use T(y -> x) — the proposal logpdf
                # of the current point under the chosen-point anchor — not
                # the logpdf of the discarded random draw (the reference
                # computes the generate logpdf after filling the slot,
                # ref mtdistgen.py special_generate_func).
                cur_logq = self.special_generate_logpdf_kernel(
                    state_y, coords=cur
                )
                aux_logq = jnp.where(one_hot, cur_logq[:, :, None], aux_logq)
            aux_ll, aux_lp = self.mt_eval_kernel(ctx, state, aux_tries)
            aux_logP = tempered_log_likelihood(aux_ll, betas[:, None, None]) + aux_lp
            aux_logw = aux_logP if self.symmetric else aux_logP - aux_logq
            cur_logP = (
                tempered_log_likelihood(state.log_like, betas) + state.log_prior
            )

        aux_log_sum_w = logsumexp(aux_logw, axis=-1)

        # factors such that factors + logP_new - logP_old = log_sum_w -
        # aux_log_sum_w (ref multipletry.py:466-476)
        factors = (cur_logP - aux_log_sum_w) - (logP_out - log_sum_w)
        return coords_out, ll_out, lp_out, factors

    def _current_target_coords(self, state):
        raise NotImplementedError

    # ------------------------------------------------------------------
    # reference host protocol (the public custom-MT API; reference custom
    # moves override the ``special_*`` hooks and the stock
    # ``get_mt_proposal`` drives them — ref ``multipletry.py:113-505``).
    # Host NumPy; the compiled sampler path uses the ``*_kernel`` hooks
    # above instead.
    # ------------------------------------------------------------------
    def special_like_func(
        self, generated_coords, *args, inds_leaves_rj=None, **kwargs
    ):
        """Likelihood per try, ``(nbatch, num_try)`` (ref
        ``multipletry.py:113-134``).  Abstract, as in the reference."""
        raise NotImplementedError

    special_like_func.__eryn_tpu_stock__ = True

    def special_prior_func(self, generated_coords, *args, **kwargs):
        """Prior per try (ref ``multipletry.py:135-156``)."""
        raise NotImplementedError

    special_prior_func.__eryn_tpu_stock__ = True

    def special_generate_func(
        self, coords, random, size=1, *args, fill_tuple=None,
        fill_values=None, **kwargs
    ):
        """Draw tries + their proposal logpdf (ref
        ``multipletry.py:157-185``)."""
        raise NotImplementedError

    special_generate_func.__eryn_tpu_stock__ = True

    def special_generate_logpdf(self, coords):
        """Proposal logpdf of ``coords`` (ref ``multipletry.py:186-199``)."""
        raise NotImplementedError

    special_generate_logpdf.__eryn_tpu_stock__ = True

    def get_mt_log_posterior(self, ll, lp, betas=None):
        """Tempered try posterior (ref ``multipletry.py:200-224``)."""
        import numpy as np

        ll = np.asarray(ll)
        if betas is not None:
            betas = np.asarray(betas)
            ll = (
                betas[..., None] * ll if ll.ndim > betas.ndim else betas * ll
            )
        return ll + np.asarray(lp)

    def readout_adjustment(self, out_vals, all_vals_prop, aux_all_vals):
        """User hook to read proposal internals (ref
        ``multipletry.py:225-237``)."""
        pass

    def get_mt_proposal(
        self,
        coords,
        random,
        args_generate=(),
        kwargs_generate={},
        args_like=(),
        kwargs_like={},
        args_prior=(),
        kwargs_prior={},
        betas=None,
        ll_in=None,
        lp_in=None,
        inds_leaves_rj=None,
        inds_reverse_rj=None,
    ):
        """Host multiple-try proposal over flat independent walkers
        (reference public API, ref ``multipletry.py:238-505``): generate
        ``num_try`` candidates per walker through the ``special_*`` hooks,
        importance-select one, build the auxiliary reference set
        (independent / rj-nested / regenerated), and return
        ``(chosen points, factors)``.  Sets ``self.mt_ll`` / ``self.mt_lp``
        and the reference's readout attributes.

        Deviation from the reference (documented): in the regenerated
        (non-independent, non-symmetric, non-rj) branch the reference
        subtracts an undefined ``aux_log_proposal_pdf_sub`` (NameError at
        ``multipletry.py:460``); the correct quantity — and what this
        implementation uses — is the auxiliary set's own proposal logpdf.
        """
        import warnings

        import numpy as np

        rj = getattr(self, "mt_rj", False) or getattr(self, "rj", False)
        if rj:
            if (
                ll_in is None
                or lp_in is None
                or inds_leaves_rj is None
                or inds_reverse_rj is None
            ):
                raise ValueError(
                    "If using rj, must provide ll_in, lp_in, "
                    "inds_leaves_rj, and inds_reverse_rj."
                )
            fill_tuple = (inds_reverse_rj, np.zeros_like(inds_reverse_rj))
            fill_values = coords[inds_reverse_rj]
        else:
            fill_tuple = None
            fill_values = None

        generated_points, log_proposal_pdf = self.special_generate_func(
            coords,
            random,
            *args_generate,
            size=self.num_try,
            fill_values=fill_values,
            fill_tuple=fill_tuple,
            **kwargs_generate,
        )
        generated_points = np.asarray(generated_points)
        log_proposal_pdf = np.asarray(log_proposal_pdf, dtype=np.float64)

        ll = np.asarray(
            self.special_like_func(
                generated_points,
                *args_like,
                inds_leaves_rj=inds_leaves_rj,
                **kwargs_like,
            ),
            dtype=np.float64,
        )
        if np.any(np.isnan(ll)):
            warnings.warn("Getting nans for ll in multiple try.")
            ll[np.isnan(ll)] = -1e300

        lp = np.asarray(
            self.special_prior_func(
                generated_points,
                *args_prior,
                inds_leaves_rj=inds_leaves_rj,
                **kwargs_prior,
            ),
            dtype=np.float64,
        )

        if rj:
            # proposal density for already-existing leaves is their prior,
            # cancelling prior-vs-proposal outside (ref multipletry.py:352)
            log_proposal_pdf = log_proposal_pdf + lp_in[:, None]

        logP = self.get_mt_log_posterior(ll, lp, betas=betas)

        (
            log_importance_weights,
            log_sum_weights,
            inds_keep,
        ) = get_mt_computations(
            logP, log_proposal_pdf, symmetric=self.symmetric
        )
        inds_keep = np.asarray(inds_keep)
        if rj:
            inds_keep[np.asarray(inds_reverse_rj)] = 0
        inds_tuple = (np.arange(len(inds_keep)), inds_keep)

        lp_out = lp[inds_tuple]
        ll_out = ll[inds_tuple]
        logP_out = logP[inds_tuple]
        self.mt_lp = lp_out
        self.mt_ll = ll_out
        generated_points_out = generated_points[inds_tuple].copy()
        log_proposal_pdf_out = log_proposal_pdf[inds_tuple]

        if self.independent:
            # tries are reusable; substitute the current point into the
            # chosen slot (ref multipletry.py:380-419)
            aux_ll = ll.copy()
            aux_lp = lp.copy()
            aux_log_proposal_pdf_sub = np.asarray(
                self.special_generate_logpdf(coords)
            )
            # current points' Likelihood/prior: given directly, or through
            # the reference's fallback hooks (ref multipletry.py:389-402
            # names special_generate_like/special_generate_prior, which no
            # class defines there either — here they are consulted when
            # present, else a descriptive error replaces the AttributeError)
            if ll_in is None:
                if hasattr(self, "special_generate_like"):
                    ll_in = np.asarray(self.special_generate_like(coords))
                else:
                    raise ValueError(
                        "independent=True requires ll_in (or a "
                        "special_generate_like hook) for the current "
                        "points' Likelihood."
                    )
            if lp_in is None:
                if hasattr(self, "special_generate_prior"):
                    lp_in = np.asarray(self.special_generate_prior(coords))
                else:
                    raise ValueError(
                        "independent=True requires lp_in (or a "
                        "special_generate_prior hook) for the current "
                        "points' prior."
                    )
            aux_ll[inds_tuple] = np.asarray(ll_in)
            aux_lp[inds_tuple] = np.asarray(lp_in)
            aux_logP = self.get_mt_log_posterior(aux_ll, aux_lp, betas=betas)
            aux_log_proposal_pdf = log_proposal_pdf.copy()
            aux_log_proposal_pdf[inds_tuple] = aux_log_proposal_pdf_sub
            aux_log_importance_weights = aux_logP - aux_log_proposal_pdf
        elif rj:
            # reference set = repeats of the one-less-leaf model
            # (ref multipletry.py:421-433)
            aux_ll = np.repeat(np.asarray(ll_in)[:, None], self.num_try, -1)
            aux_lp = np.repeat(np.asarray(lp_in)[:, None], self.num_try, -1)
            aux_log_proposal_pdf = aux_lp.copy()
            aux_logP = self.get_mt_log_posterior(aux_ll, aux_lp, betas=betas)
            aux_log_importance_weights = aux_logP - aux_log_proposal_pdf
        else:
            # regenerate the reference set anchored on the chosen points,
            # with the CURRENT point x in the chosen slot: standard MTM
            # (Liu, Liang & Wong 2000) draws y*_{1..k-1} ~ T(y, .) and sets
            # y*_k = x, so aux_logP_out = logP(x) and the acceptance
            # reduces to the weight-sum ratio.  (The reference fills the
            # slot with y, multipletry.py:448 — combined with its undefined
            # aux_log_proposal_pdf_sub the branch is unusable there; the
            # fix here matches the kernel path, mt_select_kernel above.)
            (
                aux_generated_points,
                aux_log_proposal_pdf,
            ) = self.special_generate_func(
                generated_points_out,
                random,
                *args_generate,
                size=self.num_try,
                fill_tuple=inds_tuple,
                fill_values=coords,
                **kwargs_generate,
            )
            aux_ll = np.asarray(
                self.special_like_func(
                    np.asarray(aux_generated_points), *args_like, **kwargs_like
                ),
                dtype=np.float64,
            )
            aux_lp = np.asarray(
                self.special_prior_func(np.asarray(aux_generated_points)),
                dtype=np.float64,
            )
            aux_log_proposal_pdf = np.asarray(
                aux_log_proposal_pdf, dtype=np.float64
            )
            aux_logP = self.get_mt_log_posterior(aux_ll, aux_lp, betas=betas)
            if not self.symmetric:
                aux_log_importance_weights = aux_logP - aux_log_proposal_pdf
            else:
                aux_log_importance_weights = aux_logP

        aux_logP_out = aux_logP[inds_tuple]
        max_aux = np.max(aux_log_importance_weights, axis=-1)
        aux_log_sum_weights = max_aux + np.log(
            np.exp(aux_log_importance_weights - max_aux[:, None]).sum(-1)
        )
        aux_log_proposal_pdf_out = aux_log_proposal_pdf[inds_tuple]

        # lnpdiff = factors + logP_out - aux_logP_out reduces to the weight
        # sum ratio (ref multipletry.py:466-476)
        factors = (aux_logP_out - aux_log_sum_weights) - (
            logP_out - log_sum_weights
        )

        if rj:
            inds_reverse_rj = np.asarray(inds_reverse_rj)
            factors[inds_reverse_rj] *= -1
            self.mt_ll[inds_reverse_rj] = np.asarray(ll_in)[inds_reverse_rj]
            self.mt_lp[inds_reverse_rj] = np.asarray(lp_in)[inds_reverse_rj]
            self.inds_reverse_rj = inds_reverse_rj
            self.inds_forward_rj = np.delete(
                np.arange(coords.shape[0]), inds_reverse_rj
            )

        self.aux_logP_out = aux_logP_out
        self.logP_out = logP_out
        self.aux_ll = aux_ll
        self.aux_lp = aux_lp
        self.log_sum_weights = log_sum_weights
        self.aux_log_sum_weights = aux_log_sum_weights

        self.readout_adjustment(
            [logP_out, ll_out, lp_out, log_proposal_pdf_out, log_sum_weights],
            [logP, ll, lp, log_proposal_pdf, log_sum_weights],
            [
                aux_logP,
                aux_ll,
                aux_lp,
                aux_log_proposal_pdf,
                aux_log_sum_weights,
            ],
        )
        return generated_points_out, factors

    def get_proposal(self, branches_coords, random, branches_inds=None, **kwargs):
        """Host MT proposal with the reference's MH-protocol signature
        (ref ``multipletry.py:516-594``): flatten walkers, run
        :meth:`get_mt_proposal`, reshape; sets ``self.mt_ll`` /
        ``self.mt_lp`` for the bridge to reuse."""
        import numpy as np

        if len(branches_coords) > 1:
            raise ValueError(
                "Can only propose change to one model at a time with MT."
            )
        key_in = list(branches_coords.keys())[0]
        self.key_in = key_in
        if branches_inds is None:
            branches_inds = {
                key_in: np.ones(
                    branches_coords[key_in].shape[:-1], dtype=bool
                )
            }
        if np.any(branches_inds[key_in].sum(axis=-1) > 1):
            raise ValueError(
                "MT base proposals require exactly one active leaf."
            )
        ntemps, nwalkers = branches_coords[key_in].shape[:2]
        nl = branches_coords[key_in].shape[2]
        m = branches_inds[key_in]
        betas_here = None
        if self.temperature_control is not None:
            betas_here = np.repeat(
                np.asarray(self.temperature_control.betas)[:, None],
                nwalkers * nl,
            ).reshape(m.shape)[m]
        ll_here = np.repeat(
            np.asarray(self.current_state.log_like)[:, :, None], nl, axis=-1
        )[m]
        lp_here = np.repeat(
            np.asarray(self.current_state.log_prior)[:, :, None], nl, axis=-1
        )[m]

        generated_points, factors = self.get_mt_proposal(
            np.asarray(branches_coords[key_in])[m],
            random,
            betas=betas_here,
            ll_in=ll_here,
            lp_in=lp_here,
        )
        self.mt_ll = self.mt_ll.reshape(ntemps, nwalkers)
        self.mt_lp = self.mt_lp.reshape(ntemps, nwalkers)
        return (
            {key_in: generated_points.reshape(ntemps, nwalkers, 1, -1)},
            factors.reshape(ntemps, nwalkers),
        )

    get_proposal.__eryn_tpu_stock__ = True


class MultipleTryMoveRJ(MultipleTryMove):
    """Generic nested-RJ multiple-try mixin (ref ``multipletry.py:597-776``);
    see :class:`~eryn_tpu.moves.mtdistgenrj.MTDistGenMoveRJ` for the concrete
    distribution-draw implementation."""

    def __init__(self, *args, **kwargs):
        kwargs.setdefault("rj", True)
        super().__init__(*args, **kwargs)

    def mt_select_kernel(self, key, state, ctx):
        # the in-model machinery below has no RJ branch (no death-try
        # inversion, no one-less-leaf auxiliary base); using it for
        # trans-dimensional proposals would be silently wrong
        raise NotImplementedError(
            "MultipleTryMoveRJ's trans-dimensional factor bookkeeping lives "
            "in MTDistGenMoveRJ (death-try inversion + RJ auxiliary sets); "
            "subclass MTDistGenMoveRJ or adapt its _propose_impl rather "
            "than calling the in-model mt_select_kernel."
        )

    def get_proposal(
        self,
        branches_coords,
        branches_inds,
        nleaves_min_all,
        nleaves_max_all,
        random,
        **kwargs,
    ):
        """Host RJ multiple-try proposal with the reference's RJ-protocol
        signature (ref ``multipletry.py:598-776``): one branch, +1/-1 leaf
        changes from :meth:`get_model_change_proposal`, death proposals
        treated as inverted birth tries (the removed leaf fills try slot
        0), and the one-less-leaf model as the auxiliary base.  Returns
        ``(q, new_inds, factors)``; sets ``self.mt_ll`` / ``self.mt_lp``.

        Deviation from the reference (documented): the reverse walkers'
        one-less-leaf Likelihood call passes the REVERSE walkers' priors
        (the reference passes the full-ensemble ``lp_here``, whose shape
        cannot match its subset batch — ``multipletry.py:744``)."""
        import numpy as np

        if len(branches_coords) > 1:
            raise ValueError(
                "Can only propose change to one model at a time with MT."
            )
        key_in = list(branches_coords.keys())[0]
        self.key_in = key_in
        if branches_inds is None:
            raise ValueError("In MT RJ proposal, branches_inds cannot be None.")

        coords_b = np.asarray(branches_coords[key_in])
        inds_b = np.asarray(branches_inds[key_in], dtype=bool)
        ntemps, nwalkers, nleaves_max, ndim = coords_b.shape

        betas_here = None
        if self.temperature_control is not None:
            betas_here = np.repeat(
                np.asarray(self.temperature_control.betas)[:, None],
                nwalkers,
                axis=-1,
            ).flatten()
        ll_here = np.array(self.current_state.log_like, dtype=float).flatten()
        lp_here = np.array(self.current_state.log_prior, dtype=float).flatten()

        nleaves_min = nleaves_min_all[key_in]
        nleaves_max_v = nleaves_max_all[key_in]
        if nleaves_min == nleaves_max_v:
            raise ValueError(
                "MT RJ proposal requires that nleaves_min != nleaves_max."
            )
        if nleaves_min > nleaves_max_v:
            raise ValueError(
                "nleaves_min is greater than nleaves_max. Not allowed."
            )

        all_inds_for_change = self.get_model_change_proposal(
            inds_b, random, nleaves_min, nleaves_max_v
        )

        inds_leaves_rj = np.zeros(ntemps * nwalkers, dtype=int)
        coords_in = np.zeros((ntemps * nwalkers, ndim))
        inds_reverse_rj = None
        new_inds = {n: np.array(v) for n, v in branches_inds.items()}
        q = {n: np.array(v) for n, v in branches_coords.items()}
        for change, idx in all_inds_for_change.items():
            if change not in ("+1", "-1"):
                raise ValueError("MT RJ is only implemented for +1/-1 moves.")
            t_i, w_i, l_i = idx[:, 0], idx[:, 1], idx[:, 2]
            inds_leaves_rj[t_i * nwalkers + w_i] = l_i
            coords_in[t_i * nwalkers + w_i] = coords_b[(t_i, w_i, l_i)]
            new_inds[key_in][(t_i, w_i, l_i)] = change == "+1"
            if change == "-1":
                inds_reverse_rj = t_i * nwalkers + w_i

        if inds_reverse_rj is not None and inds_reverse_rj.size:
            # Likelihood/prior of the one-less-leaf model for the removers
            # (their mask already has the leaf off in new_inds)
            rev_coords = {}
            rev_inds = {}
            for key, branch in self.current_state.branches.items():
                bc = np.asarray(branch.coords)
                nl_k, nd_k = bc.shape[-2:]
                rev_coords[key] = bc.reshape(-1, nl_k, nd_k)[inds_reverse_rj][
                    None, :
                ]
                im = (
                    new_inds[key]
                    if key == key_in
                    else np.asarray(branch.inds)
                )
                rev_inds[key] = im.reshape(-1, nl_k)[inds_reverse_rj][None, :]
            lp_rev = np.asarray(
                self.current_model.compute_log_prior_fn(
                    rev_coords, inds=rev_inds
                )
            )[0]
            ll_rev = np.asarray(
                self.current_model.compute_log_like_fn(
                    rev_coords, inds=rev_inds, logp=lp_rev[None, :]
                )[0]
            )[0]
            ll_here[inds_reverse_rj] = ll_rev
            lp_here[inds_reverse_rj] = lp_rev
        elif inds_reverse_rj is None:
            inds_reverse_rj = np.array([], dtype=int)

        generated_points, factors = self.get_mt_proposal(
            coords_in,
            random,
            betas=betas_here,
            ll_in=ll_here,
            lp_in=lp_here,
            inds_leaves_rj=inds_leaves_rj,
            inds_reverse_rj=inds_reverse_rj,
        )

        self.mt_ll = self.mt_ll.reshape(ntemps, nwalkers)
        self.mt_lp = self.mt_lp.reshape(ntemps, nwalkers)

        inds_forward_rj = np.delete(
            np.arange(coords_in.shape[0]), inds_reverse_rj
        )
        add = all_inds_for_change.get("+1")
        if add is not None and add.size:
            t_i, w_i, l_i = add[:, 0], add[:, 1], add[:, 2]
            q[key_in][(t_i, w_i, l_i)] = generated_points[inds_forward_rj]

        return q, new_inds, np.asarray(factors).reshape(ntemps, nwalkers)

    get_proposal.__eryn_tpu_stock__ = True
