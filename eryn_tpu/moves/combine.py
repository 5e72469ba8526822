"""Sequential combination of moves inside one proposal.

JAX re-design of ``/root/reference/src/eryn/moves/combine.py:16-135``:
child kernels run back-to-back inside the same traced step (each with its own
tempering epilogue, matching the reference), accepted counts summed.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .move import Move

__all__ = ["CombineMove"]


class CombineMove(Move):
    """Run a list of moves sequentially in one ``propose``
    (ref ``combine.py:16``)."""

    def __init__(self, moves, **kwargs):
        self.moves_list = list(moves)
        super().__init__(**kwargs)

    @property
    def moves(self):
        """Child moves (ref ``combine.py:55-57``)."""
        return self.moves_list

    @property
    def acceptance_fraction_separate(self):
        """Per-child acceptance fractions (ref ``combine.py:59-62``): list of
        ``(ntemps, nwalkers)`` arrays, one per child move, accumulated in the
        traced kernel state."""
        import numpy as np

        ks = getattr(self, "_host_kernel_state", None)
        if ks is None or not self.num_proposals:
            return None
        counts = np.asarray(ks[1])
        return [counts[i] / self.num_proposals for i in range(counts.shape[0])]

    def propagate_wiring(self):
        """Propagate temperature control / periodic into children
        (ref ``combine.py:64-97``)."""
        for m in self.moves_list:
            if m.temperature_control is None:
                m.temperature_control = self.temperature_control
            if m.periodic is None:
                m.periodic = self.periodic
            if hasattr(m, "propagate_wiring"):
                m.propagate_wiring()

    def init_kernel_state(self, state):
        ntemps, nwalkers = state.log_like.shape
        per_child = jnp.zeros(
            (len(self.moves_list), ntemps, nwalkers), dtype=state.log_like.dtype
        )
        return (
            tuple(m.init_kernel_state(state) for m in self.moves_list),
            per_child,
        )

    def propose_kernel(self, key, state, time, ctx, kernel_state=None):
        self.propagate_wiring()
        if kernel_state is None or kernel_state == ():
            kernel_state = self.init_kernel_state(state)
        child_states, per_child = kernel_state
        ntemps, nwalkers = state.log_like.shape
        accepted = jnp.zeros((ntemps, nwalkers), dtype=state.log_like.dtype)
        swaps = jnp.zeros((max(ntemps - 1, 0),), dtype=state.log_like.dtype)
        new_states = []
        for i, (m, ks) in enumerate(zip(self.moves_list, child_states)):
            key, sub = jax.random.split(key)
            state, acc, swaps, time, ks = m.propose_kernel(
                sub, state, time, ctx, ks
            )
            accepted = accepted + acc
            per_child = per_child.at[i].add(acc)
            new_states.append(ks)
        return state, accepted, swaps, time, (tuple(new_states), per_child)
