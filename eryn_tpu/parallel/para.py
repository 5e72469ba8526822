"""Batched independent sub-ensembles (the ParaState runner).

The reference defines ``ParaState`` with a ``groups_running`` mask for
ensembles of independent sub-runs but ships no runner for it
(``/root/reference/src/eryn/state.py:588-775``, unused in-tree).  The
natural realization is ``vmap``: one compiled sampler step mapped over a
leading ``ngroups`` axis, so hundreds of independent PT ensembles (e.g. one
per data segment, or one per initialization) advance in a single device
dispatch.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from ..ensemble import EnsembleSampler
from ..state import ParaState, State

__all__ = ["ParaEnsembleSampler"]


class ParaEnsembleSampler:
    """Run ``ngroups`` independent ensembles batched via ``vmap``.

    Accepts the same configuration as :class:`~eryn_tpu.ensemble.
    EnsembleSampler`; every group gets its own PRNG stream, temperature
    ladder (adapting independently), and chain.

    Note: the batched runner keeps its chain in memory
    (``(nsteps, ngroups, ntemps, nwalkers, ...)``); per-group HDF5 export can
    go through ordinary single-group backends.
    """

    def __init__(
        self,
        ngroups,
        nwalkers,
        ndims,
        log_like_fn,
        priors,
        seed=None,
        mesh=None,
        **kwargs,
    ):
        self.ngroups = int(ngroups)
        #: optional 1-D device mesh over the group axis (make_group_mesh):
        #: independent ensembles land on separate devices; the vmapped step
        #: is embarrassingly parallel, so XLA inserts no collectives
        self.mesh = mesh
        if mesh is not None:
            axis_sizes = tuple(mesh.shape.values())
            if len(axis_sizes) != 1:
                raise ValueError(
                    "ParaEnsembleSampler expects a 1-D group mesh "
                    "(parallel.make_group_mesh); got axes "
                    f"{dict(mesh.shape)}."
                )
            if self.ngroups % axis_sizes[0] != 0:
                raise ValueError(
                    f"ngroups ({self.ngroups}) must be divisible by the "
                    f"group-mesh size ({axis_sizes[0]})."
                )
            self._group_axis = tuple(mesh.shape.keys())[0]
        tempering_kwargs = dict(kwargs.pop("tempering_kwargs", {}) or {})
        if "backend" in kwargs:
            # silently dropping a backend would lose the user's chain file
            raise ValueError(
                "ParaEnsembleSampler keeps its batched chain in memory and "
                "does not accept a backend; export per group through "
                "ordinary single-group backends instead."
            )
        self.sampler = EnsembleSampler(
            nwalkers,
            ndims,
            log_like_fn,
            priors,
            tempering_kwargs=tempering_kwargs,
            seed=seed,
            **kwargs,
        )

        if seed is None:
            seed = int(np.random.randint(0, 2**31 - 1))
        self._keys = jax.random.split(
            jax.random.key(
                seed, impl=getattr(self.sampler, "_prng_impl", "rbg")
            ),
            self.ngroups,
        )
        self._chain = []
        self._log_like = []
        self._log_prior = []
        self._inds = []
        self._betas = []
        self._state = None
        self._fn_cache = {}
        #: per-group running mask (ParaState.groups_running contract);
        #: None means every group advances
        self._groups_running = None

    # ------------------------------------------------------------------
    def _setup_states(self, coords, inds=None):
        """coords: {name: (ngroups, ntemps, nwalkers, nleaves_max, ndim)} or
        a bare array for a single branch."""
        s = self.sampler

        def per_group(c_g, i_g):
            return s._setup_state(
                State(c_g, inds=i_g), skip_initial_state_check=True
            )

        if not isinstance(coords, dict):
            coords = {s.branch_names[0]: coords}

        def coerce5(c):
            # (ngroups, [ntemps,] nwalkers, [nleaves_max,] ndim) -> 5D
            if c.ndim == 3:
                c = c[:, None, :, None, :]
            elif c.ndim == 4:
                c = c[:, :, :, None, :]
            elif c.ndim != 5:
                raise ValueError(f"coords must be 3-5D, got {c.shape}")
            return c

        coords = {
            n: coerce5(jnp.asarray(c, dtype=s.dtype)) for n, c in coords.items()
        }
        if inds is None:
            inds = {n: jnp.ones(c.shape[:-1], dtype=bool) for n, c in coords.items()}
        else:
            if not isinstance(inds, dict):
                inds = {s.branch_names[0]: inds}
            inds = {n: jnp.asarray(v).astype(bool) for n, v in inds.items()}
        return jax.vmap(per_group)(coords, inds)

    def _batched_bulk(self, nstored, thin_by, store):
        cache_key = (nstored, thin_by, store)
        if cache_key in self._fn_cache:
            return self._fn_cache[cache_key]
        s = self.sampler
        fn = s._build_bulk_fn(nstored, thin_by, store)

        def one_group(key, state, time, ks):
            nm = len(s.moves)
            nrj = len(s.rj_moves)
            zeros = lambda *sh: jnp.zeros(sh, dtype=s.dtype)  # noqa: E731
            carry, snaps, _counters, _extras = fn(
                key,
                state,
                time,
                zeros(nm, s.ntemps, s.nwalkers),
                zeros(nm),
                zeros(nrj, s.ntemps, s.nwalkers),
                zeros(nrj),
                ks,
            )
            key, state, time = carry[0], carry[1], carry[2]
            return key, state, time, carry[7], snaps

        out = jax.jit(jax.vmap(one_group))
        self._fn_cache[cache_key] = out
        return out

    def _shard_groups(self, tree):
        """Distribute the leading ``ngroups`` axis of every leaf over the
        group mesh (no-op without a mesh)."""
        if self.mesh is None:
            return tree
        from jax.sharding import NamedSharding, PartitionSpec

        sh = NamedSharding(self.mesh, PartitionSpec(self._group_axis))
        return jax.tree_util.tree_map(
            lambda x: jax.device_put(x, sh), tree
        )

    def run_mcmc(
        self,
        coords,
        nsteps,
        burn=None,
        thin_by=1,
        inds=None,
        store=True,
        groups_running=None,
    ):
        """Advance all groups; returns the final batched State.

        ``groups_running``: optional ``(ngroups,)`` bool mask honoring the
        reference's ``ParaState.groups_running`` contract (ref
        ``state.py:588-713``, which ships the field but no runner): stopped
        groups are frozen — their state does not advance and their stored
        chain repeats the frozen snapshot.  The lockstep batch still
        computes every group (SPMD has no ragged shapes); gating is a
        ``where``-blend, so results for running groups are unaffected.
        The mask applies to THIS call only: omitting it (or passing
        ``None``) advances every group.
        """
        s = self.sampler
        if groups_running is None:
            self._groups_running = None
        else:
            self._groups_running = jnp.asarray(groups_running).astype(bool)
            if self._groups_running.shape != (self.ngroups,):
                raise ValueError(
                    f"groups_running must have shape ({self.ngroups},)."
                )
        if self._state is None or coords is not None:
            state = self._setup_states(coords, inds)
            time = jnp.zeros((self.ngroups,), dtype=jnp.int32)
            state_g0 = jax.tree_util.tree_map(lambda x: x[0], state)
            proto_ks = tuple(
                m.init_kernel_state(state_g0) for m in s.moves + s.rj_moves
            )
            ks = jax.tree_util.tree_map(
                lambda x: jnp.broadcast_to(
                    x, (self.ngroups,) + jnp.asarray(x).shape
                ),
                proto_ks,
            )
            state, time, ks = self._shard_groups((state, time, ks))
            self._keys = self._shard_groups(self._keys)
            self._state = (state, time, ks)

        state, time, ks = self._state
        running = self._groups_running
        all_running = running is None or bool(np.asarray(running).all())

        def gate(new_tree, old_tree):
            """Freeze stopped groups: keep their previous per-group leaves."""
            if all_running:
                return new_tree
            r = jnp.asarray(running)

            def blend(new, old):
                new = jnp.asarray(new)
                mask = r.reshape((-1,) + (1,) * (new.ndim - 1))
                return jnp.where(mask, new, old)

            return jax.tree_util.tree_map(blend, new_tree, old_tree)

        if burn:
            # burn counts raw proposal steps; thin_by is ignored while
            # burning (same contract as EnsembleSampler.run_mcmc)
            fn = self._batched_bulk(1, int(burn), store=False)
            self._keys, state2, time2, ks2, _ = fn(self._keys, state, time, ks)
            state, time, ks = gate((state2, time2, ks2), (state, time, ks))

        if nsteps:
            prev_state = state
            fn = self._batched_bulk(int(nsteps), thin_by, store=store)
            self._keys, state2, time2, ks2, snaps = fn(
                self._keys, state, time, ks
            )
            state, time, ks = gate(
                (state2, time2, ks2), (state, time, ks)
            )
            if store and snaps is not None:
                snaps = s._unpack_snaps(
                    jax.tree_util.tree_map(np.asarray, snaps)
                )
                r_host = (
                    None if all_running else np.asarray(running)
                )

                def stored(field_new, frozen):
                    """(ngroups, nstored, ...) -> (nstored, ngroups, ...),
                    with stopped groups repeating their FROZEN value."""
                    out = np.swapaxes(np.asarray(field_new), 0, 1)
                    if r_host is not None:
                        out = np.array(out)
                        out[:, ~r_host] = np.asarray(frozen)[~r_host]
                    return out

                self._chain.append(
                    {
                        n: stored(
                            snaps["coords"][n],
                            prev_state.branches[n].coords,
                        )
                        for n in snaps["coords"]
                    }
                )
                if "inds" in snaps:
                    inds_seg = {
                        n: stored(
                            snaps["inds"][n], prev_state.branches[n].inds
                        )
                        for n in snaps["inds"]
                    }
                else:
                    # non-RJ runs do not snapshot the constant leaf masks
                    nstored = snaps["log_like"].shape[1]
                    inds_seg = {
                        n: np.broadcast_to(
                            np.asarray(b.inds)[None],
                            (nstored,) + b.inds.shape,
                        )
                        for n, b in state.branches.items()
                    }
                self._inds.append(inds_seg)
                self._log_like.append(
                    stored(snaps["log_like"], prev_state.log_like)
                )
                self._log_prior.append(
                    stored(snaps["log_prior"], prev_state.log_prior)
                )
                self._betas.append(stored(snaps["betas"], prev_state.betas))

        self._state = (state, time, ks)
        return ParaState(
            {n: b.coords for n, b in state.branches.items()},
            inds={n: b.inds for n, b in state.branches.items()},
            log_like=state.log_like,
            log_prior=state.log_prior,
            betas=state.betas,
            groups_running=(
                jnp.ones((self.ngroups,), dtype=bool)
                if running is None
                else jnp.asarray(running)
            ),
        )

    # ------------------------------------------------------------------
    def get_chain(self):
        return {
            n: np.concatenate([c[n] for c in self._chain], axis=0)
            for n in self._chain[0]
        }

    def get_inds(self):
        return {
            n: np.concatenate([c[n] for c in self._inds], axis=0)
            for n in self._inds[0]
        }

    def get_log_like(self):
        return np.concatenate(self._log_like, axis=0)

    def get_log_prior(self):
        return np.concatenate(self._log_prior, axis=0)

    def get_betas(self):
        return np.concatenate(self._betas, axis=0)
