"""Ensemble slice sampling — a JAX extension.

No reference equivalent.  Implements the differential ensemble slice
sampler of Karamanis & Beutler 2021 ("zeus", arXiv:2002.06212): each
walker slice-samples the tempered posterior along a random direction
``eta = mu * (c_l - c_m)`` built from two distinct walkers of the other
red/blue half.  Slice sampling accepts by construction (no
Metropolis rejection) and the single scale ``mu`` self-tunes, so the move
is tuning-free and mixes well on correlated targets where the stretch
move stalls.

Formulation.  The per-walker stepping-out / shrinkage recursions are
data-dependent loops the reference ecosystem runs walker-by-walker in
Python; here the whole half-ensemble runs them in lockstep —
``lax.while_loop`` over masked full-block likelihood evaluations, exiting
as soon as EVERY walker's interval is resolved (typically a handful of
iterations once ``mu`` is tuned).

Correctness notes:

- Stepping out uses Neal 2003's *capped* procedure done right: the
  expansion budget ``max_expand - 1`` is split randomly between the left
  and right ends (J ~ U{0..max_expand-1}, K = max_expand-1-J), which
  preserves detailed balance even when the cap binds (a deterministic cap
  would not).
- Shrinkage is guaranteed to terminate in principle (the interval
  contracts onto the current point, which lies in the slice); a bounded
  ``max_shrink`` keeps the compiled loop finite, and the vanishingly rare
  truncation falls back to the current point.
- Directions are drawn from the OTHER half's current coordinates —
  exactly stationary during the update (the same block-Metropolis
  argument as :class:`RedBlueGroupStretchMove`), and independent of the
  moving walker, as slice directions must be.
- Reversible jump / Gibbs: the direction is masked to the moving walker's
  active leaves (and the Gibbs parameter mask), so dormant slots never
  move and the slice target is exactly the masked posterior.

``mu`` adapts by the zeus recipe ``mu <- mu * 2 * Ne / (Ne + Nc)``
(expansions vs contractions balance) for the first ``tune_steps``
proposals, then freezes; the adaptation state lives in the traced kernel
state, so it works inside compiled segments.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..ops.perm import invert_permutation

from .move import Move, state_branch_supps
from .tempering import tempered_log_likelihood

__all__ = ["SliceMove"]


class SliceMove(Move):
    """Differential ensemble slice proposal (zeus-style).

    Args:
        mu: initial direction scale (self-tunes; see ``tune_steps``).
        max_expand: stepping-out cap per walker: ``max_expand - 1`` total
            interval expansions, split randomly between the left and right
            ends (the randomized split keeps Neal's capped procedure
            exact).  ``max_expand=1`` therefore allows no expansion.
        max_shrink: shrinkage iteration cap (truncation keeps the current
            point; with a tuned ``mu`` the loop resolves in a few steps).
        tune_steps: number of proposals that adapt ``mu`` (0 disables).
        nsplits: number of walker blocks updated sequentially (2 = the
            classic red/blue halves).
        randomize_split: permute walkers into blocks each proposal.
    """

    def __init__(
        self,
        mu=1.0,
        max_expand=6,
        max_shrink=16,
        tune_steps=500,
        nsplits=2,
        randomize_split=True,
        **kwargs,
    ):
        super().__init__(**kwargs)
        self.mu0 = float(mu)
        self.max_expand = int(max_expand)
        self.max_shrink = int(max_shrink)
        self.tune_steps = int(tune_steps)
        self.nsplits = int(nsplits)
        self.randomize_split = bool(randomize_split)
        if self.max_expand < 1 or self.max_shrink < 1:
            raise ValueError("max_expand and max_shrink must be >= 1.")

    def init_kernel_state(self, state):
        dtype = state.log_like.dtype
        return {
            "mu": jnp.asarray(self.mu0, dtype),
            "t": jnp.zeros((), jnp.int32),
        }

    def _displacement(self, name, a, b):
        """``b - a`` via the nearest periodic image when configured."""
        if self.periodic is not None:
            return self.periodic.distance({name: a}, {name: b})[name]
        return b - a

    def _wrap(self, name, q):
        if self.periodic is not None:
            return self.periodic.wrap({name: q})[name]
        return q

    def _propose_impl(self, key, state, ctx, kernel_state):
        ntemps, nwalkers = state.log_like.shape
        dtype = state.log_like.dtype

        coords = dict(state.branches_coords)
        inds = dict(state.branches_inds)
        logl = state.log_like
        logp = state.log_prior
        blobs = state.blobs
        betas = (
            state.betas
            if state.betas is not None
            else jnp.ones((ntemps,), dtype=dtype)
        )
        accepted = jnp.zeros((ntemps, nwalkers), dtype=bool)
        mu = kernel_state["mu"]
        ne_total = jnp.zeros((), dtype)
        nc_total = jnp.zeros((), dtype)

        sizes = [
            nwalkers // self.nsplits + (1 if i < nwalkers % self.nsplits else 0)
            for i in range(self.nsplits)
        ]
        offsets = [sum(sizes[:i]) for i in range(self.nsplits)]
        if nwalkers - max(sizes) < 2:
            raise RuntimeError(
                "SliceMove needs at least two complement walkers per block "
                f"(nwalkers={nwalkers}, nsplits={self.nsplits} leaves a "
                f"complement of {nwalkers - max(sizes)})."
            )
        all_names = list(coords.keys())

        for names, param_masks in self.gibbs_iterations_for(state):
            key, kperm = jax.random.split(key)
            if self.randomize_split:
                perm = jax.random.permutation(kperm, nwalkers)
                inv_perm = invert_permutation(perm)
            else:
                perm = inv_perm = jnp.arange(nwalkers)

            coords_p = {n: coords[n][:, perm] for n in all_names}
            inds_p = {n: inds[n][:, perm] for n in all_names}
            logl_p = logl[:, perm]
            logp_p = logp[:, perm]
            blobs_p = blobs[:, perm] if blobs is not None else None
            acc_p = accepted[:, perm]

            def blk(x, off, ns):
                return x[:, off : off + ns]

            def comp(x, off, ns):
                return jnp.concatenate([x[:, :off], x[:, off + ns :]], axis=1)

            def unblk(x, v, off):
                return jax.lax.dynamic_update_slice_in_dim(x, v, off, axis=1)

            for off, ns in zip(offsets, sizes):
                nc = nwalkers - ns
                s_coords = {n: blk(coords_p[n], off, ns) for n in names}
                s_inds = {n: blk(inds_p[n], off, ns) for n in names}

                # directions from two distinct complement walkers
                key, kl, km = jax.random.split(key, 3)
                l_idx = jax.random.randint(kl, (ntemps, ns), 0, nc)
                m_idx = jax.random.randint(km, (ntemps, ns), 0, nc - 1)
                m_idx = m_idx + (m_idx >= l_idx)  # skip l: distinct pair
                eta = {}
                for n in names:
                    c_all = comp(coords_p[n], off, ns)
                    c_l = jnp.take_along_axis(
                        c_all, l_idx[:, :, None, None], axis=1
                    )
                    c_m = jnp.take_along_axis(
                        c_all, m_idx[:, :, None, None], axis=1
                    )
                    e = mu * self._displacement(n, c_m, c_l)
                    e = e * s_inds[n][..., None]  # RJ: dormant slots pinned
                    mask = param_masks.get(n) if param_masks else None
                    if mask is not None:
                        e = e * jnp.asarray(mask)[None, None, :, :]
                    eta[n] = e.astype(dtype)

                # walkers with an identically-zero direction (RJ k=0, or a
                # Gibbs split masking out all their params) have nothing to
                # sample: the tempered posterior is constant along lam, so
                # they would otherwise drain the full expansion budget as
                # phantom "expansions" and poison the mu adaptation.  They
                # sit this block out entirely.
                act = jnp.zeros((ntemps, ns), dtype=bool)
                for n in names:
                    act = act | (eta[n] != 0).any(axis=(2, 3))

                # frozen non-moved branch blocks for the evaluations
                fixed = {
                    n: blk(coords_p[n], off, ns)
                    for n in all_names
                    if n not in names
                }
                inds_eval = {n: blk(inds_p[n], off, ns) for n in all_names}
                supps = state_branch_supps(state, perm=perm, block=(off, ns))

                def eval_at(lam):
                    """Tempered log-posterior (+ parts) at x + lam*eta."""
                    q = {
                        n: self._wrap(
                            n, s_coords[n] + lam[:, :, None, None] * eta[n]
                        )
                        for n in names
                    }
                    q_eval = {**fixed, **q}
                    lp = ctx.compute_log_prior(q_eval, inds_eval)
                    ll, bl = ctx.compute_log_like(q_eval, inds_eval, lp, supps)
                    return tempered_log_likelihood(ll, betas) + lp, ll, lp, bl, q

                # slice level below the CURRENT tempered posterior
                prev_logl = blk(logl_p, off, ns)
                prev_logp = blk(logp_p, off, ns)
                logP0 = tempered_log_likelihood(prev_logl, betas) + prev_logp
                key, ky, kJ, ku0, kshr = jax.random.split(key, 5)
                # log1p(-u) maps u in [0, 1) to log of (0, 1]: u == 0.0
                # (probability ~2^-24 per draw in float32) must not give
                # y = -inf, which would accept an arbitrary point of the
                # fully stepped-out interval unconditionally.
                y = logP0 + jnp.log1p(
                    -jax.random.uniform(ky, (ntemps, ns), dtype=dtype)
                )

                # ---- stepping out (Neal 2003, randomized capped budget) ----
                J = jax.random.randint(kJ, (ntemps, ns), 0, self.max_expand)
                K = (self.max_expand - 1) - J
                J = jnp.where(act, J, 0)
                K = jnp.where(act, K, 0)
                u0 = jax.random.uniform(ku0, (ntemps, ns), dtype=dtype)
                L0 = -u0
                R0 = L0 + 1.0

                def expand_cond(carry):
                    L, R, J, K, ne = carry
                    return (J > 0).any() | (K > 0).any()

                def expand_body(carry):
                    L, R, J, K, ne = carry
                    logP_L = eval_at(L)[0]
                    logP_R = eval_at(R)[0]
                    growL = (J > 0) & (logP_L > y)
                    growR = (K > 0) & (logP_R > y)
                    L = jnp.where(growL, L - 1.0, L)
                    R = jnp.where(growR, R + 1.0, R)
                    # a bound end stops consuming budget
                    J = jnp.where(growL, J - 1, 0)
                    K = jnp.where(growR, K - 1, 0)
                    ne = ne + growL.sum().astype(dtype) + growR.sum().astype(dtype)
                    return L, R, J, K, ne

                L, R, _, _, ne = jax.lax.while_loop(
                    expand_cond, expand_body, (L0, R0, J, K, jnp.zeros((), dtype))
                )

                # ---- shrinkage ------------------------------------------
                zeros_like_blobs = (
                    blk(blobs_p, off, ns) if blobs_p is not None else None
                )
                init = (
                    kshr,
                    L,
                    R,
                    jnp.zeros((ntemps, ns), dtype),  # selected lambda
                    ~act,  # done: zero-direction walkers sit out
                    prev_logl,
                    prev_logp,
                    zeros_like_blobs,
                    jnp.zeros((), dtype),  # contraction count
                    jnp.zeros((), jnp.int32),  # iteration
                )

                def shrink_cond(carry):
                    _, _, _, _, done, _, _, _, _, it = carry
                    return (~done).any() & (it < self.max_shrink)

                def shrink_body(carry):
                    k, L, R, lam_sel, done, ll_sel, lp_sel, bl_sel, ncnt, it = carry
                    k, kd = jax.random.split(k)
                    u = jax.random.uniform(kd, (ntemps, ns), dtype=dtype)
                    lam = L + u * (R - L)
                    logP, ll, lp, bl, _ = eval_at(lam)
                    in_slice = logP > y
                    newly = in_slice & ~done
                    lam_sel = jnp.where(newly, lam, lam_sel)
                    ll_sel = jnp.where(newly, ll, ll_sel)
                    lp_sel = jnp.where(newly, lp, lp_sel)
                    if bl_sel is not None and bl is not None:
                        nb = newly.reshape(
                            newly.shape + (1,) * (bl_sel.ndim - 2)
                        )
                        bl_sel = jnp.where(nb, bl, bl_sel)
                    shrinkL = ~in_slice & ~done & (lam < 0)
                    shrinkR = ~in_slice & ~done & (lam >= 0)
                    L = jnp.where(shrinkL, lam, L)
                    R = jnp.where(shrinkR, lam, R)
                    ncnt = ncnt + (shrinkL | shrinkR).sum().astype(dtype)
                    return (
                        k, L, R, lam_sel, done | in_slice,
                        ll_sel, lp_sel, bl_sel, ncnt, it + 1,
                    )

                (_, _, _, lam_sel, done, ll_sel, lp_sel, bl_sel, ncnt, _) = (
                    jax.lax.while_loop(shrink_cond, shrink_body, init)
                )
                ne_total = ne_total + ne
                nc_total = nc_total + ncnt

                # merge: walkers whose interval resolved take the slice
                # point; truncated walkers keep the current point
                lam_fin = jnp.where(done, lam_sel, 0.0)
                for n in names:
                    qn = self._wrap(
                        n, s_coords[n] + lam_fin[:, :, None, None] * eta[n]
                    )
                    coords_p[n] = unblk(
                        coords_p[n],
                        jnp.where(done[:, :, None, None], qn, s_coords[n]),
                        off,
                    )
                logl_p = unblk(
                    logl_p, jnp.where(done, ll_sel, prev_logl), off
                )
                logp_p = unblk(
                    logp_p, jnp.where(done, lp_sel, prev_logp), off
                )
                if blobs_p is not None and bl_sel is not None:
                    db = done.reshape(done.shape + (1,) * (blobs_p.ndim - 2))
                    blobs_p = unblk(
                        blobs_p,
                        jnp.where(db, bl_sel, blk(blobs_p, off, ns)),
                        off,
                    )
                acc_p = unblk(acc_p, (done & act) | blk(acc_p, off, ns), off)

            coords = {n: coords_p[n][:, inv_perm] for n in all_names}
            logl = logl_p[:, inv_perm]
            logp = logp_p[:, inv_perm]
            if blobs_p is not None:
                blobs = blobs_p[:, inv_perm]
            accepted = acc_p[:, inv_perm]

        # ---- mu adaptation (zeus eq. 16), frozen after tune_steps ----------
        t = kernel_state["t"]
        if self.tune_steps > 0:
            tuning = t < self.tune_steps
            total = ne_total + nc_total
            factor = jnp.where(
                total > 0, 2.0 * ne_total / jnp.maximum(total, 1.0), 1.0
            )
            # clipped: an all-contraction round must shrink mu, not zero it
            factor = jnp.clip(factor, 0.5, 2.0)
            mu_new = jnp.where(tuning, mu * factor, mu)
        else:
            mu_new = mu

        new_state = state.replace(
            coords=coords, inds=inds, log_like=logl, log_prior=logp, blobs=blobs
        )
        new_kernel_state = {"mu": mu_new, "t": t + 1}
        return new_state, accepted, new_kernel_state
