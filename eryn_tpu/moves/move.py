"""Move base class and proposal evaluation context.

JAX re-design of ``/root/reference/src/eryn/moves/move.py:16-703``.
The reference ``Move`` mixes configuration, mutable counters, and array
mutation helpers; here each move is a *static configuration shell* whose
:meth:`propose_kernel` is a pure traced function

    ``(key, state, time, ctx) -> (state, accepted, swaps_accepted, time)``

suitable for ``lax.switch`` dispatch inside one jitted sampler step.  The
accepted-merge machinery of the reference (``move.py:472-703``, take/put_along
-axis over every state field) becomes functional ``where``/scatter updates in
each concrete move.

Host-facing compatibility: moves still expose ``propose(model, state)``,
acceptance-fraction counters, and the ``temperature_control`` /
``periodic`` injection points the reference sampler uses
(``ensemble.py:516-536``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np

import jax
import jax.numpy as jnp

from .tempering import tempered_log_likelihood

__all__ = ["Move", "EvalContext", "mh_accept"]


class EvalContext(NamedTuple):
    """Capability bundle handed to every move kernel.

    The traced analogue of the reference ``Model`` namedtuple
    (``/root/reference/src/eryn/model.py:8-18``).

    Attributes:
        compute_log_prior: ``(coords_dict, inds_dict) -> (ntemps, n)`` traced.
        compute_log_like: ``(coords_dict, inds_dict, logp) -> (logl, blobs)``
            traced; ``logp`` is used to guard evaluation outside the prior
            support (ref ``ensemble.py:1264-1292``).
        tempering: :class:`eryn_tpu.moves.tempering.TemperatureControl` or None.
        periodic: :class:`eryn_tpu.utils.periodic.PeriodicContainer` or None.
        prior_containers: ``{branch: ProbDistContainer}`` (for distribution
            draws / RJ births inside kernels).
    """

    compute_log_prior: Callable
    compute_log_like: Callable
    tempering: Optional[object]
    periodic: Optional[object]
    prior_containers: Optional[dict] = None


def mh_accept(key, factors, logP_new, logP_old, dtype=None):
    """Vectorized Metropolis-Hastings acceptance.

    ``lnpdiff = factors + logP_new - logP_old``; accept where
    ``lnpdiff > log U`` (ref ``red_blue.py:283-303``).  NaN-safe: a NaN
    ``lnpdiff`` (e.g. ``-inf - -inf``) never accepts.
    """
    u = jax.random.uniform(key, logP_new.shape, dtype=dtype or logP_new.dtype)
    lnpdiff = factors + logP_new - logP_old
    return lnpdiff > jnp.log(u)


class Move:
    """Base class for proposals.

    Subclasses implement ``_propose_impl(key, state, ctx) ->
    (state, accepted)``; the base class appends the tempering epilogue the
    reference runs at the end of every ``propose``
    (``red_blue.py:329-331``, ``mh.py`` tail, ``rj.py:381-382``).
    """

    #: reversible-jump moves skip ladder adaptation (ref ``rj.py:381-382``)
    adapt_temps = True
    #: marks trans-dimensional moves (sampler schedules them separately)
    is_rj = False
    #: reference-style custom moves (host get_proposal / friends hooks) are
    #: flagged at construction and run the legacy host protocol
    host_move = False

    def __init__(
        self,
        temperature_control=None,
        periodic=None,
        gibbs_sampling_setup=None,
        prevent_swaps=False,
        skip_supp_names_update=(),
        proposal_branch_names=None,
        **kwargs,
    ):
        self.temperature_control = temperature_control
        self.periodic = periodic
        self.prevent_swaps = prevent_swaps
        self.skip_supp_names_update = list(skip_supp_names_update)
        self.proposal_branch_names = proposal_branch_names
        # a reference-style move that overrides propose() itself (rather
        # than a get_proposal hook) can only run on the host — the compiled
        # scan calls propose_kernel and would silently skip the override
        cls_propose = type(self).propose
        if not getattr(cls_propose, "__eryn_tpu_stock__", False):
            self.host_move = True
            self._legacy_family = "custom-propose"
        # API parity with the reference's device switch (ref move.py:98-111):
        # everything runs on the JAX device under jit, so the flag is inert
        self.use_gpu = bool(kwargs.pop("use_gpu", False))
        self._initialize_branch_setup(gibbs_sampling_setup, is_rj=self.is_rj)

        # host-side counters (mirrors ``move.py:404-421``); synced from the
        # device carry by the sampler at segment boundaries.
        self.accepted = None
        self.num_proposals = 0
        self.time = 0
        self._host_kernel_state = None

    # ------------------------------------------------------------------
    # configuration helpers
    # ------------------------------------------------------------------
    @property
    def xp(self):
        """Array namespace (ref ``move.py:98-111`` returns numpy/cupy; the
        compiled sampler's arrays are jax.numpy)."""
        import jax.numpy as jnp

        return jnp

    @property
    def accepted_hist(self):
        return self.accepted

    @property
    def acceptance_fraction(self):
        """Ref ``move.py:418-421``."""
        if self.accepted is None or self.num_proposals == 0:
            return None
        return np.asarray(self.accepted) / self.num_proposals

    def run_branches(self, state):
        """Branch names this move proposes on (all by default)."""
        if self.proposal_branch_names is not None:
            names = self.proposal_branch_names
            if isinstance(names, str):
                names = [names]
            return [n for n in state.branches if n in names]
        return list(state.branches.keys())

    # ------------------------------------------------------------------
    # Gibbs sampling setup (re-design of ref ``move.py:113-246``)
    # ------------------------------------------------------------------
    def _initialize_branch_setup(self, gibbs_sampling_setup, is_rj=False):
        """Parse ``gibbs_sampling_setup`` into a list of Gibbs iterations,
        each ``[(branch_name, (nleaves_max, ndim) bool mask or None), ...]``.

        Accepted forms (matching the reference): a branch-name string, a
        ``(branch_name, mask)`` tuple, a ``{branch_name: mask}`` dict (all
        entries in one iteration), or a list of those (sequential
        iterations).  RJ moves only allow branch-level splits.
        """
        self.gibbs_sampling_setup_input = gibbs_sampling_setup
        if gibbs_sampling_setup is None:
            self.gibbs_iterations = [None]
            return

        if type(gibbs_sampling_setup) not in (str, tuple, list, dict):
            raise ValueError(
                "gibbs_sampling_setup must be string, dict, tuple, or list."
            )
        if not isinstance(gibbs_sampling_setup, list):
            gibbs_sampling_setup = [gibbs_sampling_setup]

        def check_mask(mask):
            if mask is None:
                return None
            if is_rj:
                raise ValueError(
                    "inputting gibbs indexing at the leaf/parameter level is "
                    "not allowed with an RJ proposal. Only branch names."
                )
            mask = np.asarray(mask)
            if mask.ndim != 2:
                raise ValueError(
                    "When inputing gibbs indexing and using a 2-tuple, second "
                    "item must be None or 2D np.ndarray of shape "
                    "(nleaves_max, ndim)."
                )
            return mask.astype(bool)

        iterations = []
        for item in gibbs_sampling_setup:
            if isinstance(item, str):
                iterations.append([(item, None)])
            elif isinstance(item, tuple):
                if len(item) != 2:
                    raise ValueError("Gibbs tuple must be (branch_name, mask).")
                iterations.append([(item[0], check_mask(item[1]))])
            elif isinstance(item, dict):
                iterations.append(
                    [(k, check_mask(v)) for k, v in item.items()]
                )
            else:
                raise ValueError(
                    "If providing a list for gibbs_sampling_setup, each item "
                    "needs to be a string, tuple, or dict."
                )
        self.gibbs_iterations = iterations

    def gibbs_iterations_for(self, state):
        """Yield ``(branch_names, {name: mask_or_None})`` per Gibbs split."""
        all_names = self.run_branches(state)
        for split in self.gibbs_iterations:
            if split is None:
                yield all_names, {n: None for n in all_names}
            else:
                names = [n for n, _ in split if n in state.branches]
                yield names, {n: m for n, m in split}

    def tune(self, state, accepted):
        """Hook for acceptance-targeted tuning (ref ``move.py:459``)."""
        pass

    def setup(self, branches):
        """Per-proposal setup hook (ref ``red_blue.py:84-87``,
        ``mh.py:36-40``): receives the branches (host mode) or coords."""
        pass

    # ------------------------------------------------------------------
    # kernel interface
    # ------------------------------------------------------------------
    def init_kernel_state(self, state):
        """Per-move mutable carry (traced): e.g. the sequential-dim counter of
        GaussianMove or GroupMove friends tables.  Default: empty tuple."""
        return ()

    def _propose_impl(self, key, state, ctx, kernel_state):
        raise NotImplementedError

    def propose_kernel(self, key, state, time, ctx: EvalContext, kernel_state=()):
        """Pure traced proposal + tempering epilogue.

        Returns ``(state, accepted, swaps_accepted, time, kernel_state)``
        where ``accepted`` is a ``(ntemps, nwalkers)`` float array of
        per-walker accept flags and ``swaps_accepted`` is ``(ntemps - 1,)``.
        """
        key, k_prop, k_temp = jax.random.split(key, 3)
        state, accepted, kernel_state = self._propose_impl(
            k_prop, state, ctx, kernel_state
        )
        ntemps = state.log_like.shape[0]
        if (
            ctx.tempering is not None
            and ntemps > 1
            and not self.prevent_swaps
        ):
            state, swaps_accepted, time = ctx.tempering.temper_kernel(
                k_temp, state, time, adapt=self.adapt_temps
            )
        else:
            swaps_accepted = jnp.zeros(
                (max(ntemps - 1, 0),), dtype=state.log_like.dtype
            )
        return (
            state,
            accepted.astype(state.log_like.dtype),
            swaps_accepted,
            time,
            kernel_state,
        )

    # ------------------------------------------------------------------
    # host-facing Eryn-compatible API
    # ------------------------------------------------------------------
    def propose(self, model, state):
        """Eryn-compatible host entry point (ref ``move.py:16``).

        ``model`` is the sampler's :class:`eryn_tpu.model.Model` carrier; the
        proposal itself runs as one jitted kernel.  Reference-style custom
        moves (host ``get_proposal``/friends hooks) run the reference's host
        protocol instead (see :mod:`eryn_tpu.moves.legacy`).
        """
        if getattr(self, "host_move", False):
            from .legacy import host_propose

            return host_propose(self, model, state)
        ctx = model.get_eval_context()
        key, subkey = jax.random.split(model.current_key())
        if state.betas is not None and not isinstance(
            state.betas, jnp.ndarray
        ):
            # a preceding legacy host-bridge proposal (mixed schedule in
            # host/hybrid mode) hands back NumPy betas; the eager kernel
            # epilogue indexes them with .at[]
            state = state.replace(
                betas=jnp.asarray(state.betas, dtype=state.log_like.dtype)
            )
        time = jnp.asarray(
            getattr(model.temperature_control, "time", 0) or 0, dtype=jnp.int32
        )
        if getattr(self, "_host_kernel_state", None) is None:
            self._host_kernel_state = self.init_kernel_state(state)
        state, accepted, swaps_accepted, _, self._host_kernel_state = (
            self.propose_kernel(
                subkey, state, time, ctx, self._host_kernel_state
            )
        )
        model.set_key(key)
        if model.temperature_control is not None:
            tc = model.temperature_control
            tc.swaps_accepted = np.asarray(swaps_accepted)
            if self.adapt_temps and tc.adaptive:
                tc.time += 1
                tc.betas = np.asarray(state.betas)
            elif (
                getattr(tc, "swap_scheme", "cascade") == "deo"
                and tc.ntemps > 1
                and not self.prevent_swaps
            ):
                # the counter doubles as the DEO parity clock: it must tick
                # on every swap phase (adapting or not) — and ONLY when a
                # phase actually ran, mirroring propose_kernel's gate
                tc.time += 1
        accepted_np = np.asarray(accepted)
        if self.accepted is None:
            self.accepted = np.zeros_like(accepted_np)
        self.accepted = self.accepted + accepted_np
        self.num_proposals += 1
        return state, accepted_np

    # only a USER propose() override flags host mode (see __init__)
    propose.__eryn_tpu_stock__ = True

    # compatibility no-ops -------------------------------------------------
    def compute_log_posterior_tempered(self, logl, logp, betas=None):
        if self.temperature_control is not None:
            return self.temperature_control.compute_log_posterior_tempered(
                logl, logp, betas=betas
            )
        return jnp.asarray(logl) + jnp.asarray(logp)

    # ------------------------------------------------------------------
    # reference host-protocol helpers (the public custom-move API;
    # reference custom ``propose``/``get_proposal`` implementations call
    # these on ``self`` — each delegates to the vectorized host bridge in
    # :mod:`eryn_tpu.moves.legacy`)
    # ------------------------------------------------------------------
    def gibbs_sampling_setup_iterator(self, all_branch_names):
        """Yield ``(branch_names_run, inds_run)`` Gibbs splits
        (ref ``move.py:223-246``)."""
        from .legacy import _gibbs_iterator

        yield from _gibbs_iterator(self, all_branch_names)

    def setup_proposals(
        self, branch_names_run, inds_run, branches_coords, branches_inds
    ):
        """Gibbs-aware proposal inputs: ``(coords, inds,
        at_least_one_proposal)`` (ref ``move.py:248-295``)."""
        from .legacy import _setup_proposals

        return _setup_proposals(
            branch_names_run, inds_run, branches_coords, branches_inds
        )

    def cleanup_proposals_gibbs(
        self,
        branch_names_run,
        inds_run,
        q,
        branches_coords,
        new_inds=None,
        branches_inds=None,
        new_branch_supps=None,
        branches_supplemental=None,
    ):
        """Restore parameters fixed this Gibbs round; back-fill branches
        that were not proposed (ref ``move.py:297-336``).  Mutates ``q`` /
        ``new_inds`` / ``new_branch_supps`` in place, as the reference
        does."""
        import copy

        from .legacy import _cleanup_proposals_gibbs

        _cleanup_proposals_gibbs(branch_names_run, inds_run, q, branches_coords)
        for key in branches_coords:
            if new_inds is not None and key not in new_inds:
                if branches_inds is None:
                    raise ValueError(
                        "new_inds given without branches_inds to back-fill "
                        f"branch {key!r}."
                    )
                new_inds[key] = np.array(branches_inds[key])
            if new_branch_supps is not None and key not in new_branch_supps:
                if branches_supplemental is None:
                    raise ValueError(
                        "new_branch_supps given without "
                        f"branches_supplemental to back-fill branch {key!r}."
                    )
                new_branch_supps[key] = copy.deepcopy(
                    branches_supplemental[key]
                )

    def ensure_ordering(self, correct_key_order, q, new_inds, new_branch_supps):
        """Reorder proposal dicts to ``correct_key_order``
        (ref ``move.py:338-366``)."""
        import copy

        correct_key_order = list(correct_key_order)
        if list(q.keys()) != correct_key_order:
            q = {key: q[key] for key in correct_key_order}
        if list(new_inds.keys()) != correct_key_order:
            new_inds = {key: new_inds[key] for key in correct_key_order}
        if (
            new_branch_supps is not None
            and list(new_branch_supps.keys()) != correct_key_order
        ):
            temp = {key: None for key in correct_key_order}
            for key in new_branch_supps:
                temp[key] = new_branch_supps[key]
            new_branch_supps = copy.deepcopy(temp)
        return q, new_inds, new_branch_supps

    def fix_logp_gibbs(self, branch_names_run, inds_run, logp, inds):
        """Walkers with no active leaves in this split get ``-inf`` /
        ``0`` priors, mutating ``logp`` in place (ref ``move.py:368-402``)."""
        from .legacy import _fix_logp_gibbs

        _fix_logp_gibbs(branch_names_run, inds_run, logp, inds)

    def compute_log_posterior_basic(self, logl, logp):
        """Untempered ``logl + logp`` (ref ``move.py:443-457``)."""
        return logl + logp

    def update(self, old_state, new_state, accepted, subset=None):
        """Merge accepted walkers from ``new_state`` into ``old_state``
        (ref ``move.py:472-703``): coords, inds, log-like/prior, blobs.

        ``subset`` is an ``(ntemps, Ns)`` walker-index array when
        ``new_state`` covers only part of the ensemble (the red/blue
        half); ``accepted`` is always full ``(ntemps, nwalkers)``.
        Host-side NumPy — mutates and returns ``old_state``."""
        accepted = np.asarray(accepted).astype(bool)
        ntemps, nwalkers = np.asarray(old_state.log_like).shape
        if subset is None:
            subset = np.tile(np.arange(nwalkers), (ntemps, 1))
        subset = np.asarray(subset)
        acc_sub = np.take_along_axis(accepted, subset, axis=1)
        t_idx, s_idx = np.nonzero(acc_sub)
        w_idx = subset[t_idx, s_idx]

        def merge(old, new):
            out = np.array(old)
            out[t_idx, w_idx] = np.asarray(new)[t_idx, s_idx]
            return out

        def merge_supp(old_supp, new_supp):
            """Accepted walkers take the new holder's array entries (ref
            ``move.py:559-657``), skipping ``skip_supp_names_update``.
            Host-side object holders are left to the sampler's
            swap-tracking machinery."""
            if old_supp is None or new_supp is None:
                return
            old_h = getattr(old_supp, "holder", None)
            new_h = getattr(new_supp, "holder", None)
            if old_h is None or new_h is None:
                return
            for key, new_arr in new_h.items():
                if key in self.skip_supp_names_update or key not in old_h:
                    continue
                old_arr = np.array(old_h[key])
                new_arr = np.asarray(new_arr)
                if old_arr.shape[:2] != (ntemps, nwalkers):
                    continue
                old_arr[t_idx, w_idx] = new_arr[t_idx, s_idx]
                old_h[key] = old_arr

        for name, b_new in new_state.branches.items():
            b_old = old_state.branches[name]
            b_old.coords = merge(b_old.coords, b_new.coords)
            if b_old.inds is not None and b_new.inds is not None:
                b_old.inds = merge(b_old.inds, b_new.inds)
            merge_supp(
                getattr(b_old, "branch_supplemental", None),
                getattr(b_new, "branch_supplemental", None),
            )
        merge_supp(
            getattr(old_state, "supplemental", None),
            getattr(new_state, "supplemental", None),
        )
        old_state.log_like = merge(old_state.log_like, new_state.log_like)
        if old_state.log_prior is not None and new_state.log_prior is not None:
            old_state.log_prior = merge(
                old_state.log_prior, new_state.log_prior
            )
        if old_state.blobs is not None and new_state.blobs is not None:
            old_state.blobs = merge(old_state.blobs, new_state.blobs)
        return old_state


def stock_host_api(fn):
    """Mark a framework-provided implementation of a reference host-API
    method (``get_proposal`` and friends).  Host-move detection classifies
    a move as legacy only when the method is a USER override — i.e. not
    carrying this marker."""
    fn.__eryn_tpu_stock__ = True
    return fn


def overrides_host_api(obj, name):
    """True when ``type(obj)`` provides ``name`` and it is not a
    stock-marked framework implementation."""
    fn = getattr(type(obj), name, None)
    return fn is not None and not getattr(fn, "__eryn_tpu_stock__", False)


def state_branch_supps(state, perm=None, block=None):
    """Collect per-branch supplemental holders for likelihood evaluation,
    optionally walker-permuted and block-sliced.  Returns None when no branch
    carries supplemental data."""
    out = {}
    found = False
    for name, supp in state.branches_supplemental.items():
        if supp is None:
            continue
        holder = supp.holder
        if perm is not None:
            holder = {k: v[:, perm] for k, v in holder.items()}
        if block is not None:
            off, ns = block
            holder = {k: v[:, off : off + ns] for k, v in holder.items()}
        out[name] = holder
        found = True
    return out if found else None


def active_ndim(state, names=None):
    """Per-walker active dimensionality: ``sum_b nleaves_b * ndim_b`` from the
    leaf masks — the RJ-aware dimension count used in detailed-balance factors
    (ref ``red_blue.py:199-207``)."""
    names = names or list(state.branches.keys())
    total = 0
    for name in names:
        b = state.branches[name]
        total = total + b.inds.sum(axis=-1) * b.ndim
    return total
