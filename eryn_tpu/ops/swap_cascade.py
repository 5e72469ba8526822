"""The stochastic PT swap cascade as one Pallas kernel (Triton route).

The rung loop of :func:`eryn_tpu.moves.tempering.cascade_provenance` is
sequential over ``ntemps - 1`` rungs, and each rung's gathers read what the
rung above wrote, so XLA launches a few small kernels per rung.  Here one
program runs the whole loop: per rung it gathers the two paired rows,
scatters the exchanged rows back through the same permutations, and waits
at a block barrier before the next rung reads them.

Same inputs and semantics as the XLA cascade — per-rung permutations
``perms[i - 1] = (iperm, i1perm)``, log acceptance thresholds ``raccept``
and rung gaps ``dbetas[i - 1] = betas[i - 1] - betas[i]`` — and the same
outputs bit for bit: only selects, no arithmetic on the carried values.
The inverse permutations the XLA form gathers through are not needed:
the kernel scatters through ``perms`` instead.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

__all__ = ["swap_cascade", "MAX_WALKERS"]

#: widest walker row the single-program kernel holds in registers (its
#: capacity; where it pays is the sampler's choice, see moves/tempering.py)
MAX_WALKERS = 8192


def _kernel(logl_ref, perm_ref, racc_ref, dbeta_ref,
            out_l_ref, out_p_ref, acc_ref, cur_l_ref, cur_p_ref,
            *, ntemps, nwalkers, block, interpret):
    # the interpreter runs the program's lanes in order: no barrier needed
    barrier = (lambda: None) if interpret else plgpu.debug_barrier
    lane = jnp.arange(block, dtype=jnp.int32)
    mask = lane < nwalkers
    top = ntemps - 1

    # the carried row (rung i's current contents) lives in one of two
    # scratch slots, alternating by rung parity; start with the top row
    slot = (top % 2) * nwalkers
    row = plgpu.load(logl_ref.at[pl.ds(top * nwalkers, block)], mask=mask, other=0.0)
    plgpu.store(cur_l_ref.at[pl.ds(slot, block)], row, mask=mask)
    plgpu.store(cur_p_ref.at[pl.ds(slot, block)], top * nwalkers + lane, mask=mask)
    barrier()

    def operands(i):
        # everything rung i reads that no earlier rung writes
        p0 = plgpu.load(perm_ref.at[pl.ds((2 * i - 2) * nwalkers, block)], mask=mask, other=lane)
        p1 = plgpu.load(perm_ref.at[pl.ds((2 * i - 1) * nwalkers, block)], mask=mask, other=lane)
        b = plgpu.load(logl_ref.at[(i - 1) * nwalkers + p1], mask=mask, other=0.0)
        racc = plgpu.load(racc_ref.at[pl.ds((i - 1) * nwalkers, block)], mask=mask, other=0.0)
        dbeta = plgpu.load(dbeta_ref.at[pl.ds(i - 1, 1)])
        return p0, p1, b, racc, dbeta

    def rung(r, ops):
        i = top - r
        p0, p1, b, racc, dbeta = ops
        src = (i & 1) * nwalkers
        dst = ((i - 1) & 1) * nwalkers
        a = plgpu.load(cur_l_ref.at[src + p0], mask=mask, other=0.0)
        ap = plgpu.load(cur_p_ref.at[src + p0], mask=mask, other=0)
        bp = (i - 1) * nwalkers + p1
        sel = (dbeta * (a - b) > racc) & mask
        # rung i is final after this rung; rung i - 1 becomes the carry
        plgpu.store(out_l_ref.at[i * nwalkers + p0], jnp.where(sel, b, a), mask=mask)
        plgpu.store(out_p_ref.at[i * nwalkers + p0], jnp.where(sel, bp, ap), mask=mask)
        plgpu.store(cur_l_ref.at[dst + p1], jnp.where(sel, a, b), mask=mask)
        plgpu.store(cur_p_ref.at[dst + p1], jnp.where(sel, ap, bp), mask=mask)
        count = jnp.sum(sel.astype(acc_ref.dtype))
        plgpu.store(acc_ref.at[pl.ds(i - 1, 1)], jnp.full((1,), count, acc_ref.dtype))
        # fetch the next rung's independent operands while the barrier
        # drains; the next rung then gathers what this one scattered
        nxt = operands(jnp.maximum(i - 1, 1))
        barrier()
        return nxt

    jax.lax.fori_loop(0, top, rung, operands(top))
    # the carry after rung 1 is the final rung-0 row (slot 0)
    row = plgpu.load(cur_l_ref.at[pl.ds(0, block)], mask=mask, other=0.0)
    prov = plgpu.load(cur_p_ref.at[pl.ds(0, block)], mask=mask, other=0)
    plgpu.store(out_l_ref.at[pl.ds(0, block)], row, mask=mask)
    plgpu.store(out_p_ref.at[pl.ds(0, block)], prov, mask=mask)


@functools.partial(jax.jit, static_argnames=("interpret",))
def swap_cascade(logl, dbetas, perms, raccept, interpret=False):
    """One launch of the whole rung cascade.

    Args:
        logl: ``(ntemps, nwalkers)`` float32 log-likelihoods.
        dbetas: ``(ntemps - 1,)`` rung gaps ``betas[:-1] - betas[1:]``.
        perms: ``(ntemps - 1, 2, nwalkers)`` int32 per-rung pairings.
        raccept: ``(ntemps - 1, nwalkers)`` log acceptance thresholds.
        interpret: run the Pallas interpreter (CPU tests).

    Returns:
        ``(logl, flat, swaps_accepted)`` exactly as
        :func:`eryn_tpu.moves.tempering.cascade_provenance`.
    """
    ntemps, nwalkers = logl.shape
    if ntemps < 2 or nwalkers > MAX_WALKERS:
        raise ValueError(
            f"swap_cascade needs ntemps >= 2 and nwalkers <= {MAX_WALKERS}; "
            f"got {(ntemps, nwalkers)}"
        )
    dtype = logl.dtype
    block = pl.next_power_of_2(nwalkers)
    kernel = functools.partial(
        _kernel, ntemps=ntemps, nwalkers=nwalkers, block=block,
        interpret=interpret,
    )
    # rows are read as power-of-two blocks from flat buffers: pad every
    # buffer so the last row's block stays inside it (masked lanes)
    pad = block - nwalkers

    def flat(x):
        x = x.reshape(-1)
        return jnp.concatenate([x, jnp.zeros((pad,), x.dtype)]) if pad else x

    def out(n, dt):
        return jax.ShapeDtypeStruct((n + pad,), dt)

    out_l, out_p, acc, _, _ = pl.pallas_call(
        kernel,
        out_shape=(
            out(ntemps * nwalkers, dtype),
            out(ntemps * nwalkers, jnp.int32),
            jax.ShapeDtypeStruct((ntemps - 1,), dtype),
            out(2 * nwalkers, dtype),  # carried-row scratch, two slots
            out(2 * nwalkers, jnp.int32),
        ),
        grid=(),
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=max(1, min(8, block // 128)), num_stages=1
        ),
        interpret=interpret,
        name="pt_swap_cascade",
    )(
        flat(logl),
        flat(perms.astype(jnp.int32)),
        flat(raccept.astype(dtype)),
        dbetas.astype(dtype),
    )
    n = ntemps * nwalkers
    return out_l[:n].reshape(ntemps, nwalkers), out_p[:n], acc
