"""ChEES-HMC — self-tuning trajectory lengths, the lockstep-ensemble NUTS.

No reference equivalent (the reference cannot take gradients through its
NumPy likelihoods; see :mod:`eryn_tpu.moves.mala`).  NUTS — the usual
answer to "how long should an HMC trajectory be?" — is a poor fit for
SIMD ensembles: every walker recurses to a different tree depth, so a
lockstep batch pays the deepest walker's cost every step while the
per-walker control flow defeats XLA's batching.  ChEES-HMC (Hoffman,
Radul & Sountsov 2021, "An Adaptive-MCMC Scheme for Setting Trajectory
Lengths in Hamiltonian Monte Carlo") was designed at Google for exactly
this setting: ALL walkers share one jittered trajectory length per
proposal (a single ``lax.while_loop``, fully batched), and the length
bound adapts by Adam ascent on the ChEES criterion

    ChEES = (1/4) E[ (||x' - E x'||^2 - ||x - E x||^2)^2 ],

the change in the estimator of the expected squared jump distance of the
*centered second moment* — maximizing it drives the trajectory toward the
length that decorrelates the slowest (largest-variance) direction.  The
criterion needs cross-chain expectations; an ensemble sampler gets them
for free from its walker population (here: the cold-temperature walkers).

Step size adapts simultaneously by the dual-averaging machinery inherited
from :class:`~eryn_tpu.moves.mala.MALAMove` (the pairing used in the
paper).  Both freeze after ``tune_steps`` proposals, after which the move
is plain jittered-length HMC — detailed balance is exact from that point
on (run the tuning inside burn-in), and the jitter keeps NUTS's
robustness to periodic orbits (Neal 2011 §3.2).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .hmc import HMCMove

__all__ = ["ChEESHMCMove"]


def _halton2(t):
    """t-th element of the base-2 Halton (van der Corput) sequence in
    (0, 1) — the low-discrepancy trajectory jitter the ChEES paper uses
    (variance reduction over i.i.d. uniforms); computed by reversing the
    32 bits of ``t + 1``."""
    i = (t + 1).astype(jnp.uint32)
    i = ((i & 0x55555555) << 1) | ((i >> 1) & 0x55555555)
    i = ((i & 0x33333333) << 2) | ((i >> 2) & 0x33333333)
    i = ((i & 0x0F0F0F0F) << 4) | ((i >> 4) & 0x0F0F0F0F)
    i = ((i & 0x00FF00FF) << 8) | ((i >> 8) & 0x00FF00FF)
    i = (i << 16) | (i >> 16)
    return i.astype(jnp.float64 if jax.config.jax_enable_x64 else jnp.float32) * (
        2.0**-32
    )


class ChEESHMCMove(HMCMove):
    """HMC with ChEES-adapted jittered trajectory lengths.

    Per proposal: draw the shared jitter ``u`` from the Halton sequence,
    integrate ``L = clip(ceil(u * T / eps), 1, max_leapfrog)`` leapfrog
    steps for every walker in one ``lax.while_loop`` (the batch pays
    ``L`` gradient evaluations, not ``max_leapfrog``), then update
    ``log T`` by Adam on the per-walker ChEES gradient estimate

        g_i = alpha_i * (d_new_i - d_old_i) * <x'_i - mean x', p'_i> * u

    (``alpha`` the acceptance probability, ``p'`` the final momentum,
    ``d`` the centered squared radius over the cold-chain ensemble).

    Args:
        eps: leapfrog step size (scalar / per-branch / ``None`` for the
            dimension-aware heuristic), as :class:`HMCMove`.
        max_leapfrog: static cap on leapfrog steps per proposal (bounds
            the compiled loop; the adapted trajectory clips against it).
        init_num_leapfrog: initial trajectory length in units of steps.
        adam_lr: Adam learning rate for ``log T`` (paper default 0.025).
        target_acceptance / tune_steps: dual-averaging step-size
            adaptation, inherited (0.651 is the paper's target).

    Notes:
        Periodic parameters enter the ChEES statistic unwrapped — the
        criterion is a tuning heuristic only, so exactness is unaffected.
        RJ-masked leaves carry zero momentum and zero centered
        coordinates, so empty slots contribute nothing to the criterion.
    """

    def __init__(
        self,
        eps=None,
        max_leapfrog=32,
        init_num_leapfrog=5,
        adam_lr=0.025,
        target_acceptance=0.651,
        tune_steps=500,
        **kwargs,
    ):
        super().__init__(
            eps=eps,
            num_leapfrog=int(max_leapfrog),
            target_acceptance=target_acceptance,
            tune_steps=tune_steps,
            **kwargs,
        )
        if self.ensemble_precondition:
            raise NotImplementedError(
                "ensemble_precondition is not implemented for ChEESHMCMove "
                "(the ChEES criterion needs the full cold-chain ensemble, "
                "not red/blue halves); use HMCMove(ensemble_precondition="
                "True) or a per-parameter eps array."
            )
        self.max_leapfrog = int(max_leapfrog)
        self.init_num_leapfrog = int(init_num_leapfrog)
        self.adam_lr = float(adam_lr)
        if not 1 <= self.init_num_leapfrog <= self.max_leapfrog:
            raise ValueError(
                f"init_num_leapfrog must lie in [1, max_leapfrog], got "
                f"{init_num_leapfrog} with max_leapfrog={max_leapfrog}."
            )

    def init_kernel_state(self, state):
        ks = super().init_kernel_state(state)
        dtype = state.log_like.dtype
        names = self.run_branches(state)
        # scalar "time" step: geometric mean of the per-parameter step
        # sizes — converts the tuned trajectory TIME into a step count
        logs = [
            jnp.log(
                jnp.maximum(
                    jnp.abs(
                        self._eps_for(n, state.branches[n].ndim, dtype, ks)
                    ),
                    1e-12,
                )
            ).ravel()
            for n in names
        ]
        eps_time = jnp.exp(jnp.concatenate(logs).mean()).astype(dtype)
        ks["eps_time_base"] = eps_time
        ks["log_T"] = jnp.log(self.init_num_leapfrog * eps_time).astype(dtype)
        ks["adam_m"] = jnp.zeros((), dtype)
        ks["adam_v"] = jnp.zeros((), dtype)
        return ks

    def _propose_impl(self, key, state, ctx, kernel_state=()):
        names, coords, inds, betas, dtype, grad_fn = self._grad_setup(
            state, ctx
        )
        ks = kernel_state if isinstance(kernel_state, dict) else {}
        scale = self._current_scale(ks, dtype)
        eps_vecs = {
            n: scale * self._eps_for(n, coords[n].shape[-1], dtype, ks)
            for n in names
        }
        masks = {n: inds[n][..., None] for n in names}

        if ks:
            # the proposal counter drives the Halton jitter; dual averaging
            # only advances it when tune_steps > 0, so bump it here in the
            # frozen/no-tuning case to keep the jitter moving
            u = _halton2(ks["t"]).astype(dtype)
            eps_time = scale * ks["eps_time_base"]
            T = jnp.exp(ks["log_T"])
            L = jnp.clip(
                jnp.ceil(u * T / eps_time), 1, self.max_leapfrog
            ).astype(jnp.int32)
            if self.tune_steps <= 0:
                ks = {**ks, "t": ks["t"] + 1}
        else:
            # bare kernel call (no kernel state): fixed-length fallback —
            # no jitter counter exists, so the length cannot jitter
            eps_time = T = None
            L = jnp.asarray(self.init_num_leapfrog, jnp.int32)
            u = None

        key, k_p, k_acc = jax.random.split(key, 3)
        p0 = self._draw_momenta(k_p, names, coords, masks, dtype)
        kinetic, half_kick, drift = self._leapfrog_fns(
            names, masks, eps_vecs, dtype
        )

        (_, aux0), g0 = grad_fn(coords)

        def cond(carry):
            return carry[0] < L

        def body(carry):
            i, x, p, g, _aux = carry
            p = half_kick(p, g)
            x = drift(x, p)
            (_, aux), g = grad_fn(x)
            p = half_kick(p, g)
            return (i + 1, x, p, g, aux)

        _, x1, p1, _g1, (ll1, lp1, blobs1) = jax.lax.while_loop(
            cond, body, (jnp.zeros((), jnp.int32), coords, p0, g0, aux0)
        )
        factors = kinetic(p0) - kinetic(p1)

        if self.tune_steps > 0 and ks:
            ks = self._adapt_traj_length(
                ks, state, names, masks, coords, x1, p1, factors, ll1, lp1,
                betas, u, T, eps_time, eps_vecs, dtype,
            )

        return self._accept_and_merge(
            k_acc, state, names, coords, x1, factors, ll1, lp1, blobs1,
            betas, dtype, ks,
        )

    def _adapt_traj_length(
        self, ks, state, names, masks, coords, x1, p1, factors, ll1, lp1,
        betas, u, T, eps_time, eps_vecs, dtype,
    ):
        """One Adam ascent step on ``log T`` from the cold-chain ChEES
        gradient estimate; frozen (identity) once ``t >= tune_steps``."""
        alpha = self._acceptance_probability(
            state, betas, factors, ll1, lp1
        )[0]

        nwalkers = state.log_like.shape[1]

        def flat(d):
            return jnp.concatenate(
                [d[n][0].reshape(nwalkers, -1) for n in names], axis=-1
            )

        # mask-aware centering: means over ACTIVE slots only, and inactive
        # slots contribute exactly zero to the criterion (RJ leaf masks are
        # unchanged along an HMC trajectory, so one mask serves both ends)
        m_flat = flat(
            {n: jnp.broadcast_to(masks[n], coords[n].shape) for n in names}
        ).astype(dtype)
        cnt = jnp.maximum(m_flat.sum(axis=0, keepdims=True), 1.0)

        def centered(x_flat):
            mean = (x_flat * m_flat).sum(axis=0, keepdims=True) / cnt
            return jnp.where(m_flat > 0, x_flat - mean, 0.0)

        xc_o = centered(flat(coords))
        xc_n = centered(flat(x1))
        # the endpoint velocity per dimension is (eps_k / eps_time) * p'
        # when the trajectory is parametrized by time (per-parameter
        # preconditioning makes dimensions advance at different rates)
        eps_flat = flat(
            {
                n: jnp.broadcast_to(
                    eps_vecs[n], (1,) + coords[n].shape[1:]
                )
                for n in names
            }
        )
        p_new = flat(p1) * (eps_flat / eps_time)
        d_old = (xc_o**2).sum(axis=-1)
        d_new = (xc_n**2).sum(axis=-1)
        g_per = (d_new - d_old) * (xc_n * p_new).sum(axis=-1)
        w_sum = jnp.maximum(alpha.sum(), 1e-12)
        # d/dlogT = T * d/dT; the endpoint moves as dx'/dT = u * p'
        g_logT = jnp.nan_to_num((alpha * g_per).sum() / w_sum * u * T)

        tuning = ks["t"] < self.tune_steps
        tf = (ks["t"] + 1).astype(dtype)
        b1, b2 = 0.9, 0.999
        m = b1 * ks["adam_m"] + (1.0 - b1) * g_logT
        v = b2 * ks["adam_v"] + (1.0 - b2) * g_logT**2
        m_hat = m / (1.0 - b1**tf)
        v_hat = v / (1.0 - b2**tf)
        step = self.adam_lr * m_hat / (jnp.sqrt(v_hat) + 1e-8)
        log_T_new = jnp.clip(
            ks["log_T"] + step,
            jnp.log(eps_time),
            jnp.log(self.max_leapfrog * eps_time),
        )
        return {
            **ks,
            "log_T": jnp.where(tuning, log_T_new, ks["log_T"]),
            "adam_m": jnp.where(tuning, m, ks["adam_m"]),
            "adam_v": jnp.where(tuning, v, ks["adam_v"]),
        }
