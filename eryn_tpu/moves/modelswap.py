"""Product-space model-comparison move (Carlin & Chib style).

Implements the reference's OWN roadmap item — "Product-Space MCMC for direct
model comparison" (``/root/reference/docs/source/general/todos.rst``) — whose
move class the reference once shipped and later removed (its stale example
``examples/two_models_swap_test.py:5`` still imports
``BasicSymmetricModelSwapRJMove`` from ``eryn.moves``, where it no longer
exists).

Setup: each candidate model is a branch with ``nleaves_max == 1``; exactly
one of the candidate branches is active per walker.  The move proposes
switching the active model: the current model's leaf dies, the proposed
model's leaf is born with coordinates drawn from its generating distribution
(usually the prior), and the Hastings factors are
``+log q_cur(theta_cur) - log q_new(theta_new)`` — the trans-dimensional
detailed-balance ratio for symmetric model choice.  With uniform model
priors the posterior model indicator then directly estimates Bayes factors:
``P(model k | data) = Z_k / sum_j Z_j``.

Formulation: the model indicator is *implicit* in the leaf masks
(no extra integer state), the switch is a pair of static-shape mask flips,
and all candidate bookkeeping is one-hot vector math over
``(ntemps, nwalkers, nmodels)`` — no per-walker control flow.

Like all RJ-family moves, temperature swaps run without ladder adaptation
in the epilogue.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from .move import mh_accept, state_branch_supps
from .rj import ReversibleJumpMove
from .tempering import tempered_log_likelihood
from ..prior import ProbDistContainer

__all__ = ["ModelSwapRJMove", "BasicSymmetricModelSwapRJMove"]


class ModelSwapRJMove(ReversibleJumpMove):
    """Switch which of several single-leaf branches is active per walker.

    Args:
        generate_dist: ``{branch_name: ProbDistContainer}`` — the candidate
            models and the distributions their coordinates are (re)born from
            (typically each model's prior, making the newly activated
            model's parameters a fresh prior draw).
        Remaining keywords as :class:`~eryn_tpu.moves.rj.ReversibleJumpMove`.

    The sampler configuration must give every candidate branch
    ``nleaves_max = 1`` and ``nleaves_min = 0``, with initial states holding
    EXACTLY ONE active candidate per walker (validated on the first
    concrete state).
    """

    def __init__(self, generate_dist=None, **kwargs):
        if isinstance(generate_dist, ProbDistContainer):
            raise ValueError(
                "ModelSwapRJMove needs at least two candidate branches: "
                "pass {branch_name: ProbDistContainer, ...}."
            )
        for kw in ("gibbs_sampling_setup", "proposal_branch_names"):
            if kwargs.get(kw) is not None:
                # the switch is inherently JOINT over the candidate set;
                # silently accepting a split would mislead
                raise ValueError(
                    f"ModelSwapRJMove does not support {kw}: the model "
                    "switch always updates all candidate branches jointly."
                )
        if generate_dist is None:
            # deferred form: candidate branches and their rebirth
            # distributions resolve from the sampler's per-branch priors
            # when the move is wired (wire_sampler_priors)
            self.generate_dist = None
            self.model_names = None
            super().__init__(**kwargs)
            return
        self.generate_dist = dict(generate_dist)
        self.model_names = list(self.generate_dist.keys())
        if len(self.model_names) < 2:
            raise ValueError(
                "ModelSwapRJMove needs at least two candidate branches."
            )
        kwargs.setdefault("nleaves_max", {n: 1 for n in self.model_names})
        kwargs.setdefault("nleaves_min", {n: 0 for n in self.model_names})
        super().__init__(**kwargs)

    def wire_sampler_priors(self, priors):
        """Resolve a deferred candidate set from the sampler's normalized
        per-branch priors ({branch: ProbDistContainer}).  Called by
        :class:`~eryn_tpu.ensemble.EnsembleSampler` during move wiring; a
        no-op when ``generate_dist`` was given explicitly."""
        if self.generate_dist is not None:
            return
        if len(priors) < 2:
            raise ValueError(
                "ModelSwapRJMove with generate_dist=None needs a sampler "
                f"with >= 2 branches; got {list(priors)}."
            )
        self.generate_dist = dict(priors)
        self.model_names = list(priors)
        if not self.nleaves_max:
            self.nleaves_max = {n: 1 for n in self.model_names}
        if not self.nleaves_min:
            self.nleaves_min = {n: 0 for n in self.model_names}

    def init_kernel_state(self, state):
        if self.model_names is None:
            raise RuntimeError(
                "ModelSwapRJMove was constructed with generate_dist=None "
                "but never wired to a sampler; pass it via rj_moves= or "
                "provide {branch: ProbDistContainer} explicitly."
            )
        # shape-only checks work on tracers too — never skippable
        for n in self.model_names:
            if n not in state.branches:
                raise ValueError(
                    f"Candidate '{n}' is not a branch of the state "
                    f"({list(state.branches)})."
                )
            if state.branches[n].nleaves_max != 1:
                raise ValueError(
                    f"Candidate branch '{n}' must have nleaves_max == 1."
                )
        # value check needs concrete masks; skipped only under tracing
        # (e.g. the vmapped para runner)
        try:
            active = np.stack(
                [
                    np.asarray(state.branches[n].inds.sum(axis=-1))
                    for n in self.model_names
                ],
                axis=-1,
            )
        except jax.errors.TracerArrayConversionError:
            return ()
        if active.shape[-1] and not (
            np.all(active.sum(axis=-1) == 1) and active.max() <= 1
        ):
            raise ValueError(
                "ModelSwapRJMove requires exactly one active leaf across "
                f"the candidate branches {self.model_names} per walker "
                "(nleaves_max=1 each); got active counts "
                f"{np.unique(active.sum(axis=-1))}."
            )
        return ()

    def _propose_impl(self, key, state, ctx, kernel_state=()):
        names = self.model_names
        K = len(names)
        coords = dict(state.branches_coords)
        inds = dict(state.branches_inds)
        logl = state.log_like
        logp = state.log_prior
        ntemps, nwalkers = logl.shape
        betas = (
            state.betas
            if state.betas is not None
            else jnp.ones((ntemps,), dtype=logl.dtype)
        )

        # current model indicator from the masks: (nt, nw, K) one-hot
        active = jnp.stack(
            [inds[n][..., 0] for n in names], axis=-1
        ).astype(logl.dtype)
        cur_idx = jnp.argmax(active, axis=-1)  # (nt, nw)

        key, k_pick, k_acc = jax.random.split(key, 3)
        k_draws = jax.random.split(key, K)

        # symmetric choice among the other K-1 models
        shift = jax.random.randint(k_pick, (ntemps, nwalkers), 1, K)
        new_idx = (cur_idx + shift) % K
        new_onehot = jax.nn.one_hot(new_idx, K, dtype=logl.dtype)

        # fresh coordinates for every candidate (used only where born) and
        # generation log-densities of both the born and the dying leaf
        lq_new = jnp.zeros((ntemps, nwalkers), dtype=logl.dtype)
        lq_old = jnp.zeros((ntemps, nwalkers), dtype=logl.dtype)
        q_coords = {}
        new_inds = {}
        for j, n in enumerate(names):
            dist = self.generate_dist[n]
            born = new_onehot[..., j] > 0
            dying = active[..., j] > 0
            draw = dist.sample(k_draws[j], (ntemps, nwalkers)).astype(
                coords[n].dtype
            )
            q_coords[n] = jnp.where(
                born[..., None, None], draw[:, :, None, :], coords[n]
            )
            new_inds[n] = born[..., None]
            lq_new = lq_new + jnp.where(born, dist.logpdf(draw), 0.0)
            lq_old = lq_old + jnp.where(
                dying, dist.logpdf(coords[n][:, :, 0]), 0.0
            )

        # non-candidate branches ride along unchanged
        q_full = {**coords, **q_coords}
        inds_full = {**inds, **new_inds}

        logp_new = ctx.compute_log_prior(q_full, inds_full)
        logl_new, blobs_new = ctx.compute_log_like(
            q_full, inds_full, logp_new, state_branch_supps(state)
        )

        # factors: death regenerates the removed leaf in reverse
        # (+log q_cur), birth pays its draw density (-log q_new)
        factors = (lq_old - lq_new).astype(logl.dtype)
        logP_new = tempered_log_likelihood(logl_new, betas) + logp_new
        logP_old = tempered_log_likelihood(logl, betas) + logp
        acc = mh_accept(k_acc, factors, logP_new, logP_old)

        for n in names:
            coords[n] = jnp.where(
                acc[:, :, None, None], q_coords[n], coords[n]
            )
            inds[n] = jnp.where(acc[:, :, None], new_inds[n], inds[n])
        logl = jnp.where(acc, logl_new, logl)
        logp = jnp.where(acc, logp_new, logp)
        blobs = state.blobs
        if blobs is not None and blobs_new is not None:
            acc_b = acc.reshape(acc.shape + (1,) * (blobs.ndim - 2))
            blobs = jnp.where(acc_b, blobs_new, blobs)

        new_state = state.replace(
            coords=coords, inds=inds, log_like=logl, log_prior=logp,
            blobs=blobs,
        )
        # counters accumulate in the scan carry as floats (bool would change
        # the carry pytree structure between iterations)
        return new_state, acc.astype(logl.dtype), kernel_state


class BasicSymmetricModelSwapRJMove(ModelSwapRJMove):
    """Name the reference's stale example still imports
    (``/root/reference/examples/two_models_swap_test.py:5,139``).

    Accepts both this package's primary signature
    (``{branch: ProbDistContainer}``) and the example's legacy positional
    form ``(nleaves_max, nleaves_min)`` (per-branch lists) — in the legacy
    form the candidate set and rebirth distributions resolve from the
    sampler's priors at wiring time.
    """

    def __init__(self, *args, **kwargs):
        if args and isinstance(args[0], dict):
            super().__init__(*args, **kwargs)
            return
        if not args and isinstance(kwargs.get("generate_dist"), dict):
            # primary signature passed by keyword
            super().__init__(**kwargs)
            return
        kwargs.pop("generate_dist", None)  # explicit None: deferred form
        nlmax = args[0] if len(args) > 0 else kwargs.pop("nleaves_max", None)
        nlmin = args[1] if len(args) > 1 else kwargs.pop("nleaves_min", None)
        for label, vals, ok in (
            ("nleaves_max", nlmax, 1),
            ("nleaves_min", nlmin, 0),
        ):
            if vals is not None and any(
                int(v) != ok for v in np.atleast_1d(vals)
            ):
                raise ValueError(
                    f"BasicSymmetricModelSwapRJMove requires {label} == "
                    f"{ok} for every candidate branch; got {vals}."
                )
        super().__init__(None, **kwargs)
