"""Hamiltonian Monte Carlo move — a JAX extension.

No reference equivalent (see :mod:`eryn_tpu.moves.mala`): the leapfrog
integrator differentiates the tempered log-posterior through the user's
traced likelihood with ``jax.grad``, unrolled by ``lax.scan`` inside the
compiled sampler step.  Momenta exist only on active RJ leaves, so the move
is reversible-jump compatible.

Acceptance is the standard Metropolis correction on the Hamiltonian error:

    H(x, p) = -logP(x) + ||p||^2 / 2
    accept with prob min(1, exp(H(x0, p0) - H(x1, p1)))

which maps onto the sampler's ``factors + logP_new - logP_old`` contract
with ``factors = (||p0||^2 - ||p1||^2) / 2``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .mala import MALAMove

__all__ = ["HMCMove"]


class HMCMove(MALAMove):
    """Leapfrog HMC proposal.

    Args:
        eps: leapfrog step size — scalar or ``{branch: scalar or (ndim,)
            array}`` (per-parameter mass preconditioning).
        num_leapfrog: number of leapfrog steps per proposal.  A tuple
            ``(lo, hi)`` jitters the trajectory length uniformly per
            proposal — the lockstep-ensemble answer to NUTS's resonance problem:
            on a lockstep ensemble every walker waits for the deepest tree
            anyway, so randomizing the (shared) length gives NUTS's
            robustness to periodic orbits at a fixed, fully-batched cost
            (Neal 2011 §3.2 "jittering"; exactness is untouched because the
            length is drawn independently of the state).  To tune the
            trajectory-length bound automatically, use
            :class:`~eryn_tpu.moves.chees.ChEESHMCMove`.
        target_acceptance / tune_steps: dual-averaging step-size adaptation
            (inherited from :class:`~eryn_tpu.moves.mala.MALAMove`; 0.65 is
            the HMC-optimal acceptance).
        ensemble_precondition: red/blue ensemble preconditioning (inherited
            semantics from :class:`~eryn_tpu.moves.mala.MALAMove`): walkers
            integrate in two sequential halves, each using the complement
            half's per-parameter standard deviations as the diagonal mass
            matrix — handles axis-anisotropic targets with no hand-set
            ``eps`` vector, at exact detailed balance.
    """

    #: optimal-scaling exponent for ``eps=None`` (HMC step size scales as
    #: d^(-1/4) at 0.65 acceptance, Beskos et al. 2013); the constant is
    #: deliberately conservative — dual averaging closes the gap
    _EPS_DIM_EXP = 0.25
    _EPS_DIM_CONST = 1.2

    def __init__(
        self,
        eps=None,
        num_leapfrog=5,
        target_acceptance=0.65,
        tune_steps=500,
        **kwargs,
    ):
        super().__init__(
            eps=eps,
            target_acceptance=target_acceptance,
            tune_steps=tune_steps,
            **kwargs,
        )
        if isinstance(num_leapfrog, (tuple, list)):
            lo, hi = int(num_leapfrog[0]), int(num_leapfrog[1])
            if not 1 <= lo <= hi:
                raise ValueError(
                    f"num_leapfrog range must satisfy 1 <= lo <= hi, got "
                    f"({lo}, {hi})."
                )
            self.num_leapfrog = hi
            self.num_leapfrog_min = lo
        else:
            self.num_leapfrog = int(num_leapfrog)
            self.num_leapfrog_min = None

    # -- shared leapfrog plumbing (also used by ChEESHMCMove) ---------------
    def _draw_momenta(self, k_p, names, coords, masks, dtype):
        """Unit-mass momenta on active leaves only (zero on RJ-masked)."""
        p_keys = jax.random.split(k_p, len(names))
        return {
            n: jnp.where(
                masks[n], jax.random.normal(kp, coords[n].shape, dtype), 0.0
            )
            for n, kp in zip(names, p_keys)
        }

    def _leapfrog_fns(self, names, masks, eps_vecs, dtype):
        """(kinetic, half_kick, drift) closures over the step sizes/masks."""

        def kinetic(p):
            total = jnp.zeros(masks[names[0]].shape[:2], dtype=dtype)
            for n in names:
                total = total + 0.5 * jnp.where(masks[n], p[n] ** 2, 0.0).sum(
                    axis=(-2, -1)
                )
            return total

        def half_kick(p, g):
            return {
                n: p[n] + 0.5 * eps_vecs[n] * jnp.where(masks[n], g[n], 0.0)
                for n in names
            }

        def drift(x, p):
            # periodic wrap keeps the trajectory on the torus; the gradient
            # field is periodic, so wrapped leapfrog stays reversible and
            # volume-preserving (the acceptance remains exact)
            return {
                n: self._wrap_periodic(
                    n, x[n] + eps_vecs[n] * jnp.where(masks[n], p[n], 0.0)
                )
                for n in names
            }

        return kinetic, half_kick, drift

    def _run_leapfrog(self, key, names, coords, masks, eps_vecs, grad_fn, dtype):
        """Momenta draw + (optionally length-jittered) leapfrog trajectory.

        Returns ``(key, x1, ll1, lp1, blobs1, factors)`` where ``factors``
        is the kinetic-energy Hastings correction ``K(p0) - K(p1)``."""
        key, k_p = jax.random.split(key)
        p0 = self._draw_momenta(k_p, names, coords, masks, dtype)
        kinetic, half_kick, drift = self._leapfrog_fns(
            names, masks, eps_vecs, dtype
        )

        (_, _aux0), g = grad_fn(coords)

        if self.num_leapfrog_min is not None:
            key, k_len = jax.random.split(key)
            # per-walker trajectory length in [lo, hi]: walkers past their
            # length freeze in place (the batch runs hi steps regardless —
            # on a lockstep ensemble that cost is paid either way)
            lengths = jax.random.randint(
                k_len,
                masks[names[0]].shape[:2],
                self.num_leapfrog_min,
                self.num_leapfrog + 1,
            )
        else:
            lengths = None

        def leapfrog(carry, i):
            x, p, g, aux = carry
            p_new = half_kick(p, g)
            x_new = drift(x, p_new)
            (_, aux_new), g_new = grad_fn(x_new)
            p_new = half_kick(p_new, g_new)
            if lengths is None:
                return (x_new, p_new, g_new, aux_new), None
            act = i < lengths
            a4 = act[:, :, None, None]
            x = {n: jnp.where(a4, x_new[n], x[n]) for n in names}
            p = {n: jnp.where(a4, p_new[n], p[n]) for n in names}
            g = {n: jnp.where(a4, g_new[n], g[n]) for n in names}
            ll_c, lp_c, blobs_c = aux
            ll_n, lp_n, blobs_n = aux_new
            ll = jnp.where(act, ll_n, ll_c)
            lp = jnp.where(act, lp_n, lp_c)
            if blobs_c is not None and blobs_n is not None:
                a_b = act.reshape(act.shape + (1,) * (blobs_c.ndim - 2))
                blobs = jnp.where(a_b, blobs_n, blobs_c)
            else:
                blobs = blobs_c
            return (x, p, g, (ll, lp, blobs)), None

        # aux carries (ll, lp, blobs) of the latest position: the final
        # carry IS the evaluation at x1 — no post-scan re-evaluation
        (x1, p1, _g1, (ll1, lp1, blobs1)), _ = jax.lax.scan(
            leapfrog,
            (coords, p0, g, _aux0),
            jnp.arange(self.num_leapfrog),
        )

        factors = kinetic(p0) - kinetic(p1)
        return key, x1, ll1, lp1, blobs1, factors

    def _propose_impl(self, key, state, ctx, kernel_state=()):
        if self.ensemble_precondition:
            return self._propose_impl_precond(key, state, ctx, kernel_state)
        names, coords, inds, betas, dtype, grad_fn = self._grad_setup(
            state, ctx
        )
        scale = self._current_scale(kernel_state, dtype)
        eps_vecs = {
            n: scale * self._eps_for(n, coords[n].shape[-1], dtype, kernel_state)
            for n in names
        }
        masks = {n: inds[n][..., None] for n in names}

        key, x1, ll1, lp1, blobs1, factors = self._run_leapfrog(
            key, names, coords, masks, eps_vecs, grad_fn, dtype
        )
        key, k_acc = jax.random.split(key)
        return self._accept_and_merge(
            k_acc, state, names, coords, x1, factors, ll1, lp1, blobs1,
            betas, dtype, kernel_state,
        )

    def _propose_impl_precond(self, key, state, ctx, kernel_state=()):
        """Red/blue ensemble-preconditioned HMC: walkers integrate in two
        sequential permuted halves, each with the COMPLEMENT half's
        per-parameter standard deviations as the diagonal mass matrix
        (scale independent of the moved walkers, so detailed balance holds
        exactly).  Delegates the half-ensemble machinery to
        :meth:`MALAMove._propose_impl_precond`, supplying the leapfrog
        trajectory as the block proposal core."""

        def leapfrog_block(key, names, x, masks_blk, eps_tree, grad_fn, dtype):
            return self._run_leapfrog(
                key, names, x, masks_blk, eps_tree, grad_fn, dtype
            )

        return super()._propose_impl_precond(
            key, state, ctx, kernel_state, propose_block=leapfrog_block
        )
