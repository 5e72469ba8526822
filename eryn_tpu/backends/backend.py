"""In-memory chain storage backend.

Behavioral re-design of ``/root/reference/src/eryn/backends/backend.py:16-1159``
for the compiled sampler: the device produces snapshots at storage boundaries, the
backend holds host-side NumPy buffers with the reference's layout
``(nsteps, ntemps, nwalkers, nleaves_max, ndim)`` per branch, NaN-masks dead
leaves on save (``backend.py:1049-1059``), and serves the same getter /
diagnostic surface.
"""

from __future__ import annotations

import numpy as np

from ..state import State

__all__ = ["Backend"]


def _key_data(rs):
    """Raw array form of a (possibly typed) JAX PRNG key for storage."""
    if rs is None:
        return None
    try:
        return np.asarray(rs)
    except TypeError:
        import jax

        return np.asarray(jax.random.key_data(rs))


class Backend:
    """In-memory backend (ref ``backends/backend.py:16``)."""

    def __init__(self, store_missing_leaves=np.nan, dtype=None):
        self.initialized = False
        self.store_missing_leaves = store_missing_leaves
        self.dtype = dtype if dtype is not None else np.float64

    def reset_base(self):
        """Clear all stored data (ref ``backend.py:62-74``)."""
        self.initialized = False

    def reset(
        self,
        nwalkers,
        ndims,
        nleaves_max=1,
        ntemps=1,
        branch_names=None,
        nbranches=1,
        rj=False,
        moves=None,
        info=None,
        key_order=None,
    ):
        """Allocate empty chain storage (ref ``backend.py:76-257``)."""
        if branch_names is None:
            branch_names = [f"model_{i}" for i in range(nbranches)]
        if isinstance(branch_names, str):
            branch_names = [branch_names]
        nbranches = len(branch_names)

        def to_dict(val):
            if isinstance(val, (int, np.integer)):
                return {bn: int(val) for bn in branch_names}
            if isinstance(val, (list, np.ndarray)):
                return {bn: int(v) for bn, v in zip(branch_names, val)}
            return {k: int(v) for k, v in val.items()}

        self.nwalkers = int(nwalkers)
        self.ntemps = int(ntemps)
        self.nbranches = nbranches
        self.branch_names = list(branch_names)
        self.ndims = to_dict(ndims)
        self.nleaves_max = to_dict(nleaves_max)
        self.rj = rj
        self.move_keys = list(moves) if moves else None
        self.info = dict(info) if info else {}
        self.key_order = dict(key_order) if key_order else None

        self.iteration = 0
        self.chain = {
            name: np.empty(
                (0, ntemps, nwalkers, self.nleaves_max[name], self.ndims[name]),
                dtype=self.dtype,
            )
            for name in branch_names
        }
        self.inds = {
            name: np.empty(
                (0, ntemps, nwalkers, self.nleaves_max[name]), dtype=bool
            )
            for name in branch_names
        }
        self.log_like = np.empty((0, ntemps, nwalkers), dtype=self.dtype)
        self.log_prior = np.empty((0, ntemps, nwalkers), dtype=self.dtype)
        self.betas = np.empty((0, ntemps), dtype=self.dtype)
        self.blobs = None

        self.accepted = np.zeros((ntemps, nwalkers), dtype=self.dtype)
        self.rj_accepted = (
            np.zeros((ntemps, nwalkers), dtype=self.dtype) if rj else None
        )
        self.swaps_accepted = (
            np.zeros((ntemps - 1,), dtype=self.dtype) if ntemps > 1 else None
        )
        self.moves_accepted_fraction = (
            {key: np.zeros((ntemps, nwalkers)) for key in self.move_keys}
            if self.move_keys
            else None
        )

        self.random_state = None
        self._kernel_state_leaves = None
        self._tempering_time = None
        self.initialized = True

    # ------------------------------------------------------------------
    # move kernel-state checkpointing (beyond the reference: its proposal
    # tuning state lives only on in-memory move objects, so a resumed run
    # silently re-tunes — here the tuned state survives the checkpoint)
    # ------------------------------------------------------------------
    @staticmethod
    def _kernel_state_host_leaves(kernel_states):
        """Flatten per-move kernel states to host leaf lists.

        Device transfers are started for ALL leaves first
        (``copy_to_host_async``) so the conversion pays one overlapped
        transfer, not one blocking round-trip per leaf.  Object-dtype
        leaves (host-side payloads of custom moves) become ``None``
        placeholders — position is preserved so array leaves still restore.
        """
        import jax

        per_move = [jax.tree_util.tree_leaves(ks) for ks in kernel_states]
        for leaves in per_move:
            for leaf in leaves:
                if hasattr(leaf, "copy_to_host_async"):
                    leaf.copy_to_host_async()
        out = []
        for leaves in per_move:
            host = []
            for leaf in leaves:
                arr = np.asarray(leaf)
                host.append(None if arr.dtype == object else arr)
            out.append(host)
        return out

    def save_kernel_states(self, kernel_states, move_keys=None):
        """Store the per-move kernel states (tuned step sizes, trajectory
        lengths, slice scales, friends tables, adaptation clocks) as flat
        leaf lists, one per move, with the move keys they belong to.
        Called by the sampler at run end; the sampler validates structure
        AND move keys against freshly initialized states on restore."""
        self._kernel_state_leaves = (
            list(move_keys) if move_keys is not None else None,
            self._kernel_state_host_leaves(kernel_states),
        )

    def get_kernel_states(self):
        """``(move_keys, per-move leaf lists)`` stored by
        :meth:`save_kernel_states`, or ``None``.  ``None`` entries in a
        leaf list mark unpersistable (object-dtype) leaves; the sampler
        keeps the fresh value at those positions."""
        return getattr(self, "_kernel_state_leaves", None)

    def save_sampler_clock(self, time):
        """Checkpoint ``TemperatureControl.time`` — the ladder adaptation
        clock and DEO parity counter.  Without it a resumed run restarts
        adaptation at t=0: the vousden gain (~1/(t+t0)) jumps, betas drift
        from the continuous-run trajectory, and marginal swap decisions
        flip a few steps after the resume (caught by the kill/resume drill,
        ``benchmarks/soak_resume.py``, as a bitwise prefix mismatch)."""
        self._tempering_time = int(time)

    def get_sampler_clock(self):
        """Stored tempering clock, or ``None`` (fresh run / old file)."""
        return getattr(self, "_tempering_time", None)

    # ------------------------------------------------------------------
    @property
    def move_info(self):
        """Per-move info dict keyed by move name (ref ``backend.py:243-257``,
        ``1005-1012``): each entry carries its latest per-walker
        ``acceptance_fraction``."""
        if self.moves_accepted_fraction is None:
            return None
        return {
            key: {"acceptance_fraction": np.asarray(val)}
            for key, val in self.moves_accepted_fraction.items()
        }

    def get_move_info(self):
        """Get move information (ref ``backend.py:1005-1012``)."""
        return self.move_info

    @property
    def reset_args(self):
        """Positional args that reproduce :meth:`reset` (ref
        ``backend.py:118``)."""
        return (self.nwalkers, self.ndims)

    @property
    def reset_kwargs(self):
        """Keyword args that reproduce :meth:`reset` (ref
        ``backend.py:119-127``)."""
        return dict(
            nleaves_max=self.nleaves_max,
            ntemps=self.ntemps,
            branch_names=self.branch_names,
            rj=self.rj,
            moves=self.move_keys,
            key_order=self.key_order,
            info=self.info,
        )

    # ------------------------------------------------------------------
    @property
    def shape(self):
        """Dict of per-branch shapes (ref ``backend.py:330-352``)."""
        return {
            name: (
                self.ntemps,
                self.nwalkers,
                self.nleaves_max[name],
                self.ndims[name],
            )
            for name in self.branch_names
        }

    def has_blobs(self):
        return self.blobs is not None

    # ------------------------------------------------------------------
    def grow(self, ngrow, blobs=None):
        """Preallocate ``ngrow`` more steps (ref ``backend.py:849-913``)."""
        if not self.initialized:
            raise AttributeError("Backend must be reset before growing.")
        ngrow = int(ngrow)

        def extend(arr, shape_tail):
            extra = np.full((ngrow,) + shape_tail, np.nan, dtype=arr.dtype)
            return np.concatenate([arr, extra], axis=0)

        for name in self.branch_names:
            self.chain[name] = extend(
                self.chain[name],
                (
                    self.ntemps,
                    self.nwalkers,
                    self.nleaves_max[name],
                    self.ndims[name],
                ),
            )
            extra_inds = np.zeros(
                (ngrow, self.ntemps, self.nwalkers, self.nleaves_max[name]),
                dtype=bool,
            )
            self.inds[name] = np.concatenate([self.inds[name], extra_inds], axis=0)
        self.log_like = extend(self.log_like, (self.ntemps, self.nwalkers))
        self.log_prior = extend(self.log_prior, (self.ntemps, self.nwalkers))
        self.betas = extend(self.betas, (self.ntemps,))
        if blobs is not None:
            blobs = np.asarray(blobs)
            if self.blobs is None:
                self.blobs = np.full(
                    (ngrow,) + blobs.shape, np.nan, dtype=blobs.dtype
                )
            else:
                self.blobs = np.concatenate(
                    [
                        self.blobs,
                        np.full(
                            (ngrow,) + blobs.shape, np.nan, dtype=blobs.dtype
                        ),
                    ],
                    axis=0,
                )

    # ------------------------------------------------------------------
    def save_step(
        self,
        state,
        accepted,
        rj_accepted=None,
        swaps_accepted=None,
        moves_accepted_fraction=None,
    ):
        """Append one stored step from a State (ref ``backend.py:1014-1091``)."""
        self.save_snapshot(
            coords={
                n: np.asarray(state.branches[n].coords) for n in self.branch_names
            },
            inds={
                n: np.asarray(state.branches[n].inds) for n in self.branch_names
            },
            log_like=np.asarray(state.log_like),
            log_prior=np.asarray(state.log_prior),
            betas=np.asarray(state.betas) if state.betas is not None else None,
            blobs=np.asarray(state.blobs) if state.blobs is not None else None,
            accepted=accepted,
            rj_accepted=rj_accepted,
            swaps_accepted=swaps_accepted,
            moves_accepted_fraction=moves_accepted_fraction,
            random_state=_key_data(state.random_state),
        )

    def save_snapshot(
        self,
        coords,
        inds,
        log_like,
        log_prior,
        betas=None,
        blobs=None,
        accepted=None,
        rj_accepted=None,
        swaps_accepted=None,
        moves_accepted_fraction=None,
        random_state=None,
    ):
        """Append one stored step from raw host arrays (bulk-flush path)."""
        it = self.iteration
        for name in self.branch_names:
            c = np.asarray(coords[name], dtype=self.dtype).copy()
            m = np.asarray(inds[name], dtype=bool)
            # mask dead leaves (ref backend.py:1049-1059)
            c[~m] = self.store_missing_leaves
            self.chain[name][it] = c
            self.inds[name][it] = m
        self.log_like[it] = np.asarray(log_like, dtype=self.dtype)
        self.log_prior[it] = np.asarray(log_prior, dtype=self.dtype)
        if betas is not None:
            self.betas[it] = np.asarray(betas, dtype=self.dtype)
        if blobs is not None and self.blobs is not None:
            self.blobs[it] = np.asarray(blobs)

        if accepted is not None:
            self.accepted += np.asarray(accepted, dtype=self.dtype)
        if self.rj_accepted is not None and rj_accepted is not None:
            self.rj_accepted += np.asarray(rj_accepted, dtype=self.dtype)
        if self.swaps_accepted is not None and swaps_accepted is not None:
            self.swaps_accepted += np.asarray(swaps_accepted, dtype=self.dtype)
        if (
            self.moves_accepted_fraction is not None
            and moves_accepted_fraction is not None
        ):
            for key, val in moves_accepted_fraction.items():
                if val is not None:
                    self.moves_accepted_fraction[key] = np.asarray(val)

        if random_state is not None:
            self.random_state = np.asarray(random_state)

        self.iteration += 1

    def save_segment(
        self,
        coords,
        inds,
        log_like,
        log_prior,
        betas=None,
        blobs=None,
        accepted=None,
        rj_accepted=None,
        swaps_accepted=None,
        moves_accepted_fraction=None,
        random_state=None,
    ):
        """Append a whole segment of stored steps in one slab write.

        Every array carries a leading ``nstored`` axis (``accepted`` /
        ``rj_accepted`` / ``swaps_accepted`` are per-step counts and are
        summed into the cumulative counters).  This is the bulk-flush
        analogue of the reference's per-step ``save_step``
        (``/root/reference/src/eryn/backends/backend.py:1014-1091``) — same
        stored layout, one ingestion call per device segment instead of one
        per step.
        """
        log_like = np.asarray(log_like, dtype=self.dtype)
        n = log_like.shape[0]
        it = self.iteration
        sl = slice(it, it + n)
        for name in self.branch_names:
            c = np.asarray(coords[name], dtype=self.dtype).copy()
            m = np.asarray(inds[name], dtype=bool)
            c[~m] = self.store_missing_leaves
            self.chain[name][sl] = c
            self.inds[name][sl] = m
        self.log_like[sl] = log_like
        self.log_prior[sl] = np.asarray(log_prior, dtype=self.dtype)
        if betas is not None:
            self.betas[sl] = np.asarray(betas, dtype=self.dtype)
        if blobs is not None and self.blobs is not None:
            self.blobs[sl] = np.asarray(blobs)

        if accepted is not None:
            self.accepted += np.asarray(accepted, dtype=self.dtype).sum(axis=0)
        if self.rj_accepted is not None and rj_accepted is not None:
            self.rj_accepted += np.asarray(rj_accepted, dtype=self.dtype).sum(
                axis=0
            )
        if self.swaps_accepted is not None and swaps_accepted is not None:
            self.swaps_accepted += np.asarray(
                swaps_accepted, dtype=self.dtype
            ).sum(axis=0)
        if (
            self.moves_accepted_fraction is not None
            and moves_accepted_fraction is not None
        ):
            for key, val in moves_accepted_fraction.items():
                if val is not None:
                    self.moves_accepted_fraction[key] = np.asarray(val)
        if random_state is not None:
            self.random_state = np.asarray(random_state)

        self.iteration += n

    # ------------------------------------------------------------------
    # getters (ref backend.py:263-384)
    # ------------------------------------------------------------------
    def get_value(
        self,
        name,
        thin=1,
        discard=0,
        temp_index=None,
        branch_names=None,
        slice_vals=None,
    ):
        if not self.initialized or self.iteration <= 0:
            raise AttributeError(
                "You must run the sampler with 'store == True' before "
                "accessing the results."
            )
        if slice_vals is None:
            slice_vals = slice(discard + thin - 1, self.iteration, thin)

        if branch_names is None:
            keep_branches = self.branch_names
        elif isinstance(branch_names, str):
            keep_branches = [branch_names]
        else:
            keep_branches = list(branch_names)

        scalar_step = isinstance(slice_vals, (int, np.integer)) or (
            isinstance(slice_vals, np.ndarray) and slice_vals.ndim == 0
        )

        def read(arr):
            # slice_vals resolves against the STORED range: the buffers are
            # preallocated to the full run length, so negative indices or
            # descending slices on the raw array would reach unwritten rows
            # after an interrupted run (and disagree with HDF/Device reads)
            out = arr[: self.iteration][slice_vals]
            if temp_index is None:
                return out
            # a scalar slice_vals drops the step axis, putting temps first
            return out[temp_index] if scalar_step else out[:, temp_index]

        if name == "chain":
            return {n: read(self.chain[n]) for n in keep_branches}
        if name == "inds":
            return {n: read(self.inds[n]) for n in keep_branches}
        if name in ("log_like", "log_prior", "betas", "blobs"):
            arr = getattr(self, name)
            if arr is None:
                raise AttributeError(f"No {name} stored.")
            return read(arr)
        raise ValueError(f"Unknown value name: {name}")

    def get_chain(self, **kwargs):
        return self.get_value("chain", **kwargs)

    def get_inds(self, **kwargs):
        return self.get_value("inds", **kwargs)

    def get_nleaves(self, **kwargs):
        inds = self.get_value("inds", **kwargs)
        return {n: inds[n].sum(axis=-1) for n in inds}

    def get_log_like(self, **kwargs):
        return self.get_value("log_like", **kwargs)

    def get_log_prior(self, **kwargs):
        return self.get_value("log_prior", **kwargs)

    def get_log_posterior(self, temper=False, **kwargs):
        logl = self.get_value("log_like", **kwargs)
        logp = self.get_value("log_prior", **kwargs)
        if temper:
            betas = self.get_value("betas", **kwargs)
            # with temp_index set, betas is (nsteps,) and logl (nsteps, nw);
            # otherwise (nsteps, ntemps) against (nsteps, ntemps, nw)
            betas = betas.reshape(betas.shape + (1,) * (logl.ndim - betas.ndim))
            return betas * logl + logp
        return logl + logp

    def get_betas(self, **kwargs):
        return self.get_value("betas", **kwargs)

    def get_blobs(self, **kwargs):
        if self.blobs is None:
            return None
        return self.get_value("blobs", **kwargs)

    def get_a_sample(self, it):
        """Reconstruct the State stored at iteration ``it``
        (ref ``backend.py:558-614``)."""
        if not self.initialized or self.iteration <= 0:
            raise AttributeError(
                "You must run the sampler with 'store == True' before "
                "accessing the results."
            )
        # resolve against the STORED range: the chain is preallocated to the
        # full run length, so raw indexing could silently return unwritten
        # (NaN) rows after an interrupted run
        it = int(it)
        if it < 0:
            it += self.iteration
        if not 0 <= it < self.iteration:
            raise IndexError(
                f"Sample index {int(it)} out of range for {self.iteration} "
                "stored iterations."
            )
        coords = {}
        inds = {}
        for name in self.branch_names:
            c = self.chain[name][it].copy()
            m = self.inds[name][it]
            c[~m] = 0.0  # strip NaN mask for live use
            coords[name] = c
            inds[name] = m
        blobs = self.blobs[it] if self.blobs is not None else None
        return State(
            coords,
            inds=inds,
            log_like=self.log_like[it],
            log_prior=self.log_prior[it],
            betas=self.betas[it],
            blobs=blobs,
            random_state=self.random_state,
        )

    def get_last_sample(self):
        return self.get_a_sample(self.iteration - 1)

    # ------------------------------------------------------------------
    # diagnostics (filled in by eryn_tpu.utils.utility; ref backend.py:616-817)
    # ------------------------------------------------------------------
    def get_autocorr_thin_burn(self, tau=None):
        """Suggested ``(discard, thin)`` from the per-parameter integrated
        autocorrelation times (ref ``backend.py:354-384``): discard = 2x the
        maximum tau, thin = 0.5x the minimum tau.  ``tau`` may be passed to
        reuse an already-computed ``get_autocorr_time`` result."""
        if tau is None:
            tau = self.get_autocorr_time()
        tau_max = max(np.nanmax(np.atleast_1d(v)) for v in tau.values())
        tau_min = min(np.nanmin(np.atleast_1d(v)) for v in tau.values())
        discard = int(2 * tau_max)
        thin = max(int(0.5 * tau_min), 1)
        return discard, thin

    def get_autocorr_time(
        self, discard=0, thin=1, all_temps=False, multiply_thin=True, **kwargs
    ):
        """Per-parameter integrated autocorrelation time per branch
        (ref ``backend.py:616-662``).

        Returns ``{branch: tau}`` with tau shaped
        ``(ntemps_kept, nleaves_max, ndim)`` (``average=True``, the default)
        — per-parameter values with the reference's ``average`` /
        ``all_temps`` / ``window`` / ``tol`` semantics.  Unlike the
        reference (which raises for ``ntemps > 1`` or RJ), tempered and RJ
        chains are supported: taus are computed on the kept temperatures and
        RJ-masked leaves are NaN-filled per column.
        """
        from ..utils.utility import get_integrated_act

        if all_temps:
            x = self.get_chain(discard=discard, thin=thin)
        else:
            # fetch only the cold chain (1/ntemps of the bytes on a
            # device-resident backend), re-inserting the temp axis
            cold = self.get_chain(discard=discard, thin=thin, temp_index=0)
            x = {name: arr[:, None] for name, arr in cold.items()}
        out = get_integrated_act(x, **kwargs)
        thin_factor = thin if multiply_thin else 1
        return {name: values * thin_factor for name, values in out.items()}

    def get_evidence_estimate(
        self, discard=0, thin=1, return_error=True, method="therodynamic", **ss_kwargs
    ):
        """Log-evidence via thermodynamic integration or stepping-stone
        (ref ``backend.py:664-733``)."""
        from ..utils.utility import (
            stepping_stone_log_evidence,
            thermodynamic_integration_log_evidence,
        )

        logls_all = self.get_log_like(discard=discard, thin=thin)
        betas_all = self.get_betas(discard=discard, thin=thin)
        if betas_all.shape[0] == 0:
            raise ValueError(
                f"discard={discard} / thin={thin} leave no stored samples "
                f"({self.iteration} iterations stored); cannot compute "
                "evidence."
            )
        if not (betas_all == betas_all[0]).all():
            raise ValueError(
                "Cannot compute evidence while betas are adapting. Use "
                "stop_adaptation or discard the adaptation phase."
            )
        betas = betas_all[0]
        if method.startswith("thero") or method.startswith("thermo"):
            logls = np.mean(logls_all, axis=(0, -1))
            logZ, dlogZ = thermodynamic_integration_log_evidence(betas, logls)
        else:
            logZ, dlogZ = stepping_stone_log_evidence(betas, logls_all, **ss_kwargs)
        if return_error:
            return logZ, dlogZ
        return logZ

    def get_gelman_rubin_convergence_diagnostic(
        self, discard=0, thin=1, doprint=True, **kwargs
    ):
        """Gelman-Rubin R-hat per branch (ref ``backend.py:735-817``)."""
        from ..utils.utility import psrf

        # cold chain only: fetch just that temperature
        chain = self.get_chain(discard=discard, thin=thin, temp_index=0)
        inds = self.get_inds(discard=discard, thin=thin, temp_index=0)
        out = {}
        for name, arr in chain.items():
            # active leaves flattened
            x = arr
            m = inds[name]
            nsteps, nwalkers, nleaves_max, ndim = x.shape
            vals = np.where(m[..., None], x, np.nan).reshape(
                nsteps, nwalkers, nleaves_max * ndim
            )
            keep = ~np.all(np.isnan(vals), axis=(0, 1))
            Rhat = psrf(vals[:, :, keep], keep.sum(), **kwargs)
            out[name] = Rhat
            if doprint:
                print(f"Gelman-Rubin R-hat for {name}: {Rhat}")
        return out

    def get_rank_normalized_rhat(
        self, discard=0, thin=1, doprint=False, return_parts=False
    ):
        """Rank-normalized split-R-hat per branch (Vehtari et al. 2021) —
        beyond the reference: its classic Gelman-Rubin diagnostic
        (:meth:`get_gelman_rubin_convergence_diagnostic`) compares chain
        means only, so chains agreeing in location but not scale pass it.
        Convergence rule of thumb: max R-hat < 1.01."""
        from ..utils.utility import rank_normalized_rhat

        chain = self.get_chain(discard=discard, thin=thin, temp_index=0)
        inds = self.get_inds(discard=discard, thin=thin, temp_index=0)
        out = {}
        for name, arr in chain.items():
            m = inds[name]
            nsteps, nwalkers, nleaves_max, ndim = arr.shape
            vals = np.where(m[..., None], arr, np.nan).reshape(
                nsteps, nwalkers, nleaves_max * ndim
            )
            keep = ~np.all(np.isnan(vals), axis=(0, 1))
            res = rank_normalized_rhat(
                vals[:, :, keep], int(keep.sum()), return_parts=return_parts
            )
            out[name] = res
            if doprint:
                rhat = res[0] if return_parts else res
                print(f"rank-normalized R-hat for {name}: {rhat}")
        return out

    def get_effective_sample_size(
        self, discard=0, thin=1, doprint=False, return_parts=False
    ):
        """Bulk/tail effective sample size per branch (Vehtari et al.
        2021) — the mixing companion to :meth:`get_rank_normalized_rhat`;
        beyond the reference, whose only mixing diagnostic is the IACT.
        Rule of thumb: both ESS components should exceed ~100 per
        parameter."""
        from ..utils.utility import effective_sample_size

        chain = self.get_chain(discard=discard, thin=thin, temp_index=0)
        inds = self.get_inds(discard=discard, thin=thin, temp_index=0)
        out = {}
        for name, arr in chain.items():
            m = inds[name]
            nsteps, nwalkers, nleaves_max, ndim = arr.shape
            vals = np.where(m[..., None], arr, np.nan).reshape(
                nsteps, nwalkers, nleaves_max * ndim
            )
            keep = ~np.all(np.isnan(vals), axis=(0, 1))
            res = effective_sample_size(
                vals[:, :, keep], int(keep.sum()), return_parts=return_parts
            )
            out[name] = res
            if doprint:
                ess = res[0] if return_parts else res
                print(f"effective sample size for {name}: {ess}")
        return out

    def get_info(self, discard=0, thin=1):
        """Bundle of everything stored (ref ``backend.py:1093-1153``)."""
        samples = self.get_chain(discard=discard, thin=thin)
        out = {"samples": samples, **self.info}
        out["thin"] = thin
        out["burn"] = discard
        out["log_like"] = self.get_log_like(discard=discard, thin=thin)
        out["log_prior"] = self.get_log_prior(discard=discard, thin=thin)
        out["inds"] = self.get_inds(discard=discard, thin=thin)
        out["betas"] = self.get_betas(discard=discard, thin=thin)
        out["shapes"] = self.shape
        out["ntemps"] = self.ntemps
        out["nwalkers"] = self.nwalkers
        out["nbranches"] = self.nbranches
        out["branch names"] = self.branch_names
        out["ndims"] = self.ndims
        try:
            tau = self.get_autocorr_time()
            out["tau"] = tau
            out["ac_burn"], out["ac_thin"] = self.get_autocorr_thin_burn(tau)
        except Exception as e:  # noqa: BLE001 — mirror the reference's guard
            print(
                "Failed to calculate the autocorrelation length. Will not "
                f"output this piece of information. \n\n Actual error: [{e}]"
            )
            out["tau"] = None
            out["ac_thin"] = 1
            out["ac_burn"] = 1
        if out["ac_thin"] < 1:
            out["ac_thin"] = 1
        return out
