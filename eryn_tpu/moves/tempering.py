"""Parallel-tempering engine: temperature ladder, swaps, and adaptation.

JAX re-design of ``/root/reference/src/eryn/moves/tempering.py:10-649``
(itself ptemcee-derived).  The reference implements the swap cascade as a
sequential Python loop with in-place NumPy scatters; here the whole cascade is
one traced function: each rung is a vectorized permuted compare-and-swap over
the walker axis, unrolled over the (static, small) number of rungs so XLA can
fuse the gathers/scatters, and ladder adaptation is pure arithmetic on the
``betas`` carry so the entire PT epilogue lives inside ``jit``/``lax.scan``.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from ..ops.perm import invert_permutation
from ..ops.swap_cascade import swap_cascade

__all__ = ["TemperatureControl", "make_ladder"]


# Geometric temperature-step table indexed by dimension, targeting a 25%
# swap-acceptance ratio for a Gaussian posterior.  These are published
# algorithmic constants from ptemcee (github.com/willvousden/ptemcee), also
# used by the reference (``tempering.py:58-160``).
_TSTEP_TABLE = np.array([
    25.2741, 7.0, 4.47502, 3.5236, 3.0232, 2.71225, 2.49879, 2.34226, 2.22198,
    2.12628, 2.04807, 1.98276, 1.92728, 1.87946, 1.83774, 1.80096, 1.76826,
    1.73895, 1.7125, 1.68849, 1.66657, 1.64647, 1.62795, 1.61083, 1.59494,
    1.58014, 1.56632, 1.55338, 1.54123, 1.5298, 1.51901, 1.50881, 1.49916,
    1.49, 1.4813, 1.47302, 1.46512, 1.45759, 1.45039, 1.4435, 1.4369, 1.43056,
    1.42448, 1.41864, 1.41302, 1.40761, 1.40239, 1.39736, 1.3925, 1.38781,
    1.38327, 1.37888, 1.37463, 1.37051, 1.36652, 1.36265, 1.35889, 1.35524,
    1.3517, 1.34825, 1.3449, 1.34164, 1.33847, 1.33538, 1.33236, 1.32943,
    1.32656, 1.32377, 1.32104, 1.31838, 1.31578, 1.31325, 1.31076, 1.30834,
    1.30596, 1.30364, 1.30137, 1.29915, 1.29697, 1.29484, 1.29275, 1.29071,
    1.2887, 1.28673, 1.2848, 1.28291, 1.28106, 1.27923, 1.27745, 1.27569,
    1.27397, 1.27227, 1.27061, 1.26898, 1.26737, 1.26579, 1.26424, 1.26271,
    1.26121, 1.25973,
])


def make_ladder(ndim, ntemps=None, Tmax=None):
    """Build a geometric inverse-temperature ladder.

    Same selection algorithm as the reference (``tempering.py:10-197``,
    originally ptemcee): 25%-swap-acceptance geometric spacing by dimension,
    with optional ``Tmax=inf`` appending a beta=0 rung.
    """
    if not isinstance(ndim, (int, np.integer)) or ndim < 1:
        raise ValueError("Invalid number of dimensions specified.")
    if ntemps is None and Tmax is None:
        raise ValueError("Must specify one of ``ntemps`` and ``Tmax``.")
    if Tmax is not None and Tmax <= 1:
        raise ValueError("``Tmax`` must be greater than 1.")
    if ntemps is not None and (
        not isinstance(ntemps, (int, np.integer)) or ntemps < 1
    ):
        raise ValueError("Invalid number of temperatures specified.")

    if ndim > _TSTEP_TABLE.shape[0]:
        # large-dimension asymptotic approximation
        tstep = 1.0 + 2.0 * np.sqrt(np.log(4.0)) / np.sqrt(ndim)
    else:
        tstep = _TSTEP_TABLE[ndim - 1]

    append_inf = False
    if Tmax == np.inf:
        if ntemps is None:
            # the reference crashes with TypeError here; raise the intended
            # error instead (ref tempering.py:90-97)
            raise ValueError(
                "Must specify at least one of ntemps and finite Tmax."
            )
        append_inf = True
        Tmax = None
        ntemps = ntemps - 1

    if ntemps is not None:
        if Tmax is None:
            Tmax = tstep ** (ntemps - 1)
    else:
        if Tmax is None:
            raise ValueError("Must specify at least one of ntemps and finite Tmax.")
        ntemps = int(np.log(Tmax) / np.log(tstep) + 2)

    betas = np.logspace(0, -np.log10(Tmax), ntemps)
    if append_inf:
        betas = np.concatenate((betas, [0.0]))
    return betas


def tempered_log_likelihood(logl, betas):
    """beta * logl with the ptemcee beta==0 singularity guard
    (ref ``tempering.py:308-349``): anywhere ``beta*logl`` is NaN
    (``0 * -inf``), return ``-inf``."""
    logl = jnp.asarray(logl)
    betas = jnp.asarray(betas)
    if logl.ndim == 2 and betas.ndim == 1:
        betas = betas[:, None]
    out = logl * betas
    return jnp.where(jnp.isnan(out), -jnp.inf, out)


def _check_provenance_capacity(ntemps, nwalkers):
    # provenance indices ride the f32 data channel and are exact only up to
    # 2^24; beyond that the final gather would silently corrupt the ensemble
    if ntemps * nwalkers >= 2**24:
        raise ValueError(
            f"swap cascade provenance is carried in float32 and supports "
            f"at most 2**24 - 1 ensemble slots; got ntemps*nwalkers = "
            f"{ntemps * nwalkers}."
        )


#: widest walker row for which the single-launch cascade kernel beat the
#: XLA rung loop end to end on an H100 (measured at 100, 256 and 512
#: walkers; at 1000 the one-SM kernel's memory parallelism falls behind)
CASCADE_KERNEL_MAX_WALKERS = 512


def _use_cascade_kernel(logl):
    """The single-launch cascade kernel serves float32 ensembles on a GPU
    up to ``CASCADE_KERNEL_MAX_WALKERS``; everything else runs the XLA rung
    loop (bitwise the same result)."""
    return (
        jax.default_backend() == "gpu"
        and logl.dtype == jnp.float32
        and logl.shape[1] <= CASCADE_KERNEL_MAX_WALKERS
    )


def cascade_draws(key, ntemps, nwalkers, dtype, permute=True):
    """All randomness of one stochastic swap cascade, in two fused draws.

    Returns ``(perms, inv_perms, raccept)``: per-rung uniform walker
    permutations ``perms[i - 1] = (iperm, i1perm)`` shaped
    ``(ntemps - 1, 2, nwalkers)`` (a batched argsort of iid uniforms), their
    inverses, and the log acceptance thresholds ``(ntemps - 1, nwalkers)``
    — the reference's two permutations and one uniform per rung
    (ref ``tempering.py:506-522``)."""
    k_perm, k_acc = jax.random.split(key)
    if permute:
        perms = jnp.argsort(
            jax.random.uniform(k_perm, (ntemps - 1, 2, nwalkers)), axis=-1
        )
    else:
        perms = jnp.broadcast_to(
            jnp.arange(nwalkers), (ntemps - 1, 2, nwalkers)
        )
    inv_perms = invert_permutation(perms)
    raccept = jnp.log(
        jax.random.uniform(k_acc, (ntemps - 1, nwalkers), dtype=dtype)
    )
    return perms, inv_perms, raccept


def cascade_provenance(logl, betas, perms, inv_perms, raccept):
    """Sequential highest -> lowest rung cascade over ``logl`` alone.

    Rung ``i`` pairs walker ``perms[i-1, 0, j]`` with walker
    ``perms[i-1, 1, j]`` of rung ``i - 1`` and swaps them where
    ``(betas[i-1] - betas[i]) * (logl_i - logl_{i-1}) > raccept[i-1, j]``
    (ref ``tempering.py:484-561``).  Only the ``(ntemps, nwalkers)``
    log-likelihoods and a flat provenance index ride the loop; the caller
    moves the heavy state with one gather by the returned provenance.

    Returns:
        ``(logl, flat, swaps_accepted)``: swapped log-likelihoods, the
        int32 ``(ntemps * nwalkers,)`` source slot of every output slot,
        and the ``(ntemps - 1,)`` accepted-swap counts.
    """
    ntemps, nwalkers = logl.shape
    # carry (logl, provenance) as one stacked array: provenance indices
    # stay exact in f32 up to 2^24 entries (f64 carries exact to 2^53)
    if jnp.dtype(logl.dtype).itemsize <= 4:
        _check_provenance_capacity(ntemps, nwalkers)
    origin0 = jnp.arange(ntemps * nwalkers, dtype=logl.dtype).reshape(
        ntemps, nwalkers
    )
    data = jnp.stack([logl, origin0], axis=-1)  # (ntemps, nwalkers, 2)
    swaps_accepted = jnp.zeros((ntemps - 1,), dtype=logl.dtype)

    for i in range(ntemps - 1, 0, -1):
        dbeta = betas[i - 1] - betas[i]
        di = data[i][perms[i - 1, 0]]  # (nwalkers, 2)
        di1 = data[i - 1][perms[i - 1, 1]]
        paccept = dbeta * (di[:, 0] - di1[:, 0])
        sel = (paccept > raccept[i - 1])[:, None]
        swaps_accepted = swaps_accepted.at[i - 1].set(
            sel.sum().astype(logl.dtype)
        )
        # the pairwise exchange as gathers through the inverse permutations
        # plus full-row updates (no scatter)
        new_i = jnp.where(sel, di1, di)[inv_perms[i - 1, 0]]
        new_i1 = jnp.where(sel, di, di1)[inv_perms[i - 1, 1]]
        data = data.at[i].set(new_i)
        data = data.at[i - 1].set(new_i1)

    flat = data[..., 1].astype(jnp.int32).reshape(-1)
    return data[..., 0], flat, swaps_accepted


class TemperatureControl:
    """PT configuration + traced swap/adaptation kernels.

    Host-visible attributes (``betas``, ``time``, ``swaps_accepted``,
    ``swaps_proposed``) mirror the reference object
    (``tempering.py:200-282``); the sampler syncs them from device carries at
    segment boundaries.  The device-side entry point is
    :meth:`temper_kernel`, the traced analogue of ``temper_comps``
    (``tempering.py:598-649``).
    """

    def __init__(
        self,
        effective_ndim=None,
        nwalkers=None,
        ntemps=1,
        betas=None,
        Tmax=None,
        adaptive=True,
        adaptation_lag=10000,
        adaptation_time=100,
        stop_adaptation=-1,
        permute=True,
        skip_swap_supp_names=(),
        swap_scheme="cascade",
        adaptation_scheme="vousden",
    ):
        if betas is None:
            if ntemps == 1:
                betas = np.array([1.0])
            else:
                betas = make_ladder(effective_ndim, ntemps=ntemps, Tmax=Tmax)
        betas = np.asarray(betas, dtype=np.float64)

        self.nwalkers = nwalkers
        self.betas = betas
        self.ntemps = ntemps = len(betas)
        self.permute = permute
        self.skip_swap_supp_names = list(skip_swap_supp_names)

        self.time = 0
        if swap_scheme not in ("cascade", "deo"):
            raise ValueError(
                f"swap_scheme must be 'cascade' or 'deo', got {swap_scheme!r}."
            )
        #: "cascade" = the reference's stochastic highest->lowest sweep with
        #: randomized walker pairings (ptemcee-style, reversible);
        #: "deo" = deterministic even-odd non-reversible PT (Okabe et al.
        #: 2001; Syed et al. 2021): alternate parity classes of DISJOINT
        #: rung pairs, same-walker partners.  Replicas travel the ladder
        #: ballistically instead of diffusively — O(1/ntemps) round trips
        #: vs O(1/ntemps^2) for the STOCHASTIC even-odd variant (Syed's
        #: baseline).  Against the cascade (which attempts every boundary
        #: sequentially each phase) the measured trade is different: DEO
        #: attempts half the boundaries but does so in ONE fully parallel
        #: exchange (three shifted selects, critical path O(1) instead of
        #: O(ntemps)) with higher per-attempt replica flow — see
        #: benchmarks/replica_flow.py for measured round-trip rates.
        self.swap_scheme = swap_scheme
        if adaptation_scheme not in ("vousden", "syed"):
            raise ValueError(
                "adaptation_scheme must be 'vousden' or 'syed', got "
                f"{adaptation_scheme!r}."
            )
        #: "vousden" = the reference's ladder adjustment (arXiv:1501.05823,
        #: ref ``tempering.py:563-585``): each interior rung drifts by the
        #: local difference of neighboring acceptance ratios.  "syed" =
        #: communication-barrier schedule optimization (Syed et al. 2021,
        #: JRSS-B, §5): estimate the cumulative barrier
        #: ``Λ̂(β) = Σ rejection`` as piecewise linear over the current
        #: ladder and damp the rungs toward its equal-rejection inverse —
        #: a GLOBAL reshaping per update (the natural partner of
        #: ``swap_scheme="deo"``, from the same paper).
        self.adaptation_scheme = adaptation_scheme
        self.adaptive = adaptive
        self.adaptation_time = adaptation_time
        self.adaptation_lag = adaptation_lag
        self.stop_adaptation = stop_adaptation

        self.swaps_proposed = np.full(ntemps - 1, nwalkers)
        self.swaps_accepted = np.zeros(ntemps - 1)

    # ------------------------------------------------------------------
    # host-compatible helpers (reference API surface)
    # ------------------------------------------------------------------
    def tempered_likelihood(self, logl, betas=None):
        """Ref ``tempering.py:308-349``."""
        if betas is None:
            if jnp.asarray(logl).ndim == 1:
                raise ValueError(
                    "If inputing a 1D logl array, need to provide 1D betas "
                    "array of the same length."
                )
            betas = self.betas
        return tempered_log_likelihood(logl, betas)

    def compute_log_posterior_tempered(self, logl, logp, betas=None):
        """Ref ``tempering.py:284-306``."""
        if betas is None:
            betas = self.betas
        return tempered_log_likelihood(logl, betas) + jnp.asarray(logp)

    # ------------------------------------------------------------------
    # traced kernels
    # ------------------------------------------------------------------
    def swap_kernel(self, key, swap_tree, logl, betas, time=None):
        """One full swap phase: the stochastic cascade (default) or, with
        ``swap_scheme="deo"``, one deterministic even-odd parity sweep
        (ref ``tempering.py:484-561`` for the cascade the default mirrors).

        The sequential rung cascade only needs the ``(ntemps, nwalkers)``
        log-likelihood matrix, so the loop swaps ``logl`` plus a flat
        *provenance index* (:func:`cascade_provenance`); the heavy state
        tree (coords, masks, priors, blobs) is exchanged with a single
        fused gather at the end instead of per-rung scatters.

        Args:
            key: PRNG key.
            swap_tree: pytree of arrays with leading ``(ntemps, nwalkers)``
                dims to be exchanged alongside ``logl`` (coords, inds,
                log_prior, blobs, supplementals).
            logl: ``(ntemps, nwalkers)`` log-likelihoods (drives acceptance
                and is itself swapped).

        Returns:
            ``(swap_tree, logl, swaps_accepted, swaps_proposed)`` with
            ``swaps_accepted``/``swaps_proposed`` shaped ``(ntemps - 1,)``
            (``swaps_proposed`` is ``nwalkers`` per rung for the cascade;
            DEO proposes zero on the boundaries it does not attempt).
        """
        ntemps, nwalkers = logl.shape
        swaps_accepted = jnp.zeros((max(ntemps - 1, 0),), dtype=logl.dtype)
        swaps_proposed = jnp.full(
            (max(ntemps - 1, 0),), nwalkers, dtype=logl.dtype
        )
        if ntemps == 1:
            return swap_tree, logl, swaps_accepted, swaps_proposed

        if self.swap_scheme == "deo":
            if time is None:
                time = jnp.asarray(int(self.time), dtype=jnp.int32)
            return self._swap_kernel_deo(key, swap_tree, logl, betas, time)

        if getattr(self, "sharding_active", False):
            # the provenance+gather formulation below applies the composed
            # permutation with a data-dependent gather over the flattened
            # (temp * walker) axis; on a mesh GSPMD lowers that as an
            # ALL-GATHER of the whole ensemble every step — route to the
            # boundary-local variant (same draws, same math, bitwise
            # identical results; traffic is one adjacent-rung payload row
            # per boundary, riding collective-permutes between devices)
            return self._swap_kernel_cascade_boundary(
                key, swap_tree, logl, betas
            )

        perms, inv_perms, raccept = cascade_draws(
            key, ntemps, nwalkers, logl.dtype, self.permute
        )
        if _use_cascade_kernel(logl):
            # one launch for the whole rung loop (bitwise the same result;
            # the kernel scatters through perms, so inv_perms goes unused)
            logl, flat, swaps_accepted = swap_cascade(
                logl, betas[:-1] - betas[1:], perms, raccept
            )
        else:
            logl, flat, swaps_accepted = cascade_provenance(
                logl, betas, perms, inv_perms, raccept
            )

        def gather_leaf(x):
            return x.reshape((ntemps * nwalkers,) + x.shape[2:])[flat].reshape(
                x.shape
            )

        swap_tree = jax.tree_util.tree_map(gather_leaf, swap_tree)
        return swap_tree, logl, swaps_accepted, swaps_proposed

    def _swap_kernel_deo(self, key, swap_tree, logl, betas, time):
        """Deterministic even-odd (non-reversible) swap phase.

        Non-reversible PT (Okabe et al. 2001 "replica exchange with
        even-odd alternation"; Syed, Bouchard-Côté, Deligiannidis & Doucet
        2021, "Non-reversible parallel tempering: a scalable highly
        parallel MCMC scheme", JRSS-B) replaces the stochastic sweep with a
        deterministic alternation: phase ``t`` attempts exactly the rung
        boundaries ``b`` with ``b % 2 == t % 2``, pairing EACH WALKER with
        ITSELF at the neighboring rung.  Replicas then travel the ladder
        ballistically rather than diffusively (O(1/ntemps) round trips vs
        O(1/ntemps^2) for the stochastic even-odd variant) — and because a
        parity class is a set of DISJOINT pairs, the whole phase is three
        shifted selects with no sequential rung loop at all: critical path
        O(1) in the ladder depth, the ideal shape for a lockstep ensemble.
        Measured replica-flow comparison against the cascade:
        ``benchmarks/replica_flow.py``.

        Each boundary's Metropolis rule is the standard one, so every
        phase leaves the product of tempered posteriors invariant; only
        the SEQUENCE of phases is non-reversible.
        """
        ntemps, nwalkers = logl.shape
        dtype = logl.dtype
        raccept = jnp.log(
            jax.random.uniform(key, (ntemps - 1, nwalkers), dtype=dtype)
        )
        parity = (time % 2).astype(jnp.int32)
        active_b = (
            jnp.arange(ntemps - 1, dtype=jnp.int32) % 2 == parity
        )  # (ntemps-1,)

        dbetas = (betas[:-1] - betas[1:]).astype(dtype)  # > 0, (ntemps-1,)
        # boundary b swaps temps (b, b+1): accept iff
        # dbeta_b * (logl[b+1] - logl[b]) > log u   (ref tempering.py:522)
        paccept = dbetas[:, None] * (logl[1:] - logl[:-1])
        sel = (paccept > raccept) & active_b[:, None]  # (ntemps-1, nw)

        pad = jnp.zeros((1, nwalkers), dtype=bool)
        move_down = jnp.concatenate([sel, pad], axis=0)  # swaps with i+1
        move_up = jnp.concatenate([pad, sel], axis=0)  # swaps with i-1

        def exchange(x):
            # rows are (ntemps, nwalkers, ...); parity pairs are disjoint,
            # so the permutation is three shifted selects (no gather)
            down = jnp.concatenate([x[1:], x[-1:]], axis=0)  # x[i+1]
            up = jnp.concatenate([x[:1], x[:-1]], axis=0)  # x[i-1]
            extra = (1,) * (x.ndim - 2)
            md = move_down.reshape(move_down.shape + extra)
            mu = move_up.reshape(move_up.shape + extra)
            return jnp.where(md, down, jnp.where(mu, up, x))

        logl_new = exchange(logl)
        swap_tree = jax.tree_util.tree_map(exchange, swap_tree)

        swaps_accepted = sel.sum(axis=-1).astype(dtype)
        # unattempted boundaries propose zero this phase; consumers divide
        # accepted/proposed, so their ratios are per-ATTEMPT and unbiased
        # in expectation over consecutive phases
        swaps_proposed = jnp.where(
            active_b, jnp.asarray(float(nwalkers), dtype), 0.0
        )
        return swap_tree, logl_new, swaps_accepted, swaps_proposed

    def _swap_kernel_cascade_boundary(self, key, swap_tree, logl, betas):
        """Boundary-local stochastic cascade for SHARDED ensembles.

        Identical math and PRNG stream to the provenance cascade (same
        per-rung permutations, same acceptance draws, same top-to-bottom
        sweep, so a replica can still ride the whole ladder in one sweep) —
        but each boundary's exchange is applied to the full swap tree
        immediately with static-index row reads/updates instead of
        composing a provenance index and gathering once at the end.  A
        data-dependent gather over the flattened ``(ntemps * nwalkers)``
        axis cannot be partitioned by GSPMD and lowers to an all-gather of
        the WHOLE ensemble per step; static rung-row exchanges lower to
        one adjacent-rung collective-permute per boundary over the temp
        axis of the mesh (verified against the compiled HLO in
        ``tests/test_comm_pattern.py``).  Ref anchor for the traffic this
        maps: ``/root/reference/src/eryn/moves/tempering.py:515-559``.
        """
        ntemps, nwalkers = logl.shape
        dtype = logl.dtype
        swaps_proposed = jnp.full((ntemps - 1,), nwalkers, dtype=dtype)

        perms, inv_perms, raccept = cascade_draws(
            key, ntemps, nwalkers, dtype, self.permute
        )

        accepted = []
        tree = (logl, swap_tree)
        for i in range(ntemps - 1, 0, -1):
            dbeta = betas[i - 1] - betas[i]
            iperm = perms[i - 1, 0]
            i1perm = perms[i - 1, 1]
            inv_ip = inv_perms[i - 1, 0]
            inv_i1p = inv_perms[i - 1, 1]

            li = tree[0][i][iperm]
            li1 = tree[0][i - 1][i1perm]
            sel = (dbeta * (li - li1)) > raccept[i - 1]  # (nwalkers,)
            accepted.append(sel.sum().astype(dtype))

            def exch(x, sel=sel, i=i, iperm=iperm, i1perm=i1perm,
                     inv_ip=inv_ip, inv_i1p=inv_i1p):
                xi = x[i][iperm]
                xi1 = x[i - 1][i1perm]
                selx = sel.reshape(sel.shape + (1,) * (xi.ndim - 1))
                new_i = jnp.where(selx, xi1, xi)[inv_ip]
                new_i1 = jnp.where(selx, xi, xi1)[inv_i1p]
                return x.at[i].set(new_i).at[i - 1].set(new_i1)

            tree = jax.tree_util.tree_map(exch, tree)

        logl, swap_tree = tree
        swaps_accepted = jnp.stack(accepted[::-1])
        return swap_tree, logl, swaps_accepted, swaps_proposed

    def ladder_adjustment_kernel(self, time, betas, ratios):
        """Traced ladder adjustment per arXiv:1501.05823
        (ref ``tempering.py:563-585``)."""
        decay = self.adaptation_lag / (time + self.adaptation_lag)
        kappa = decay / self.adaptation_time
        dSs = kappa * (ratios[:-1] - ratios[1:])
        deltaTs = jnp.diff(1.0 / betas[:-1]) * jnp.exp(dSs)
        new_mid = 1.0 / (jnp.cumsum(deltaTs) + 1.0 / betas[0])
        return betas.at[1:-1].set(new_mid)

    def syed_schedule_kernel(self, time, betas, ratios, proposed=None):
        """Traced communication-barrier schedule update (Syed,
        Bouchard-Côté, Deligiannidis & Doucet 2021, JRSS-B, §5.1).

        The cumulative communication barrier ``Λ̂`` is estimated as
        piecewise linear over the CURRENT ladder from the measured
        per-boundary rejection rates (``Λ̂(β_k) = Σ_{i<k} r_i``); the
        updated schedule is its inverse at equally spaced barrier targets
        — the schedule at which every boundary rejects at the same rate,
        which maximizes the replica round-trip rate.  Instead of Syed's
        batch rounds, the rungs are damped toward that inverse with the
        same decaying gain the Vousden kernel uses, giving a stochastic
        approximation that runs inside the compiled scan.

        Args:
            time: adaptation clock (sets the decaying gain).
            betas: ``(ntemps,)`` descending ladder; endpoints are fixed.
            ratios: ``(ntemps - 1,)`` per-boundary PER-ATTEMPT acceptance
                (not the DEO 2x-rescaled reporting value).
            proposed: optional per-boundary proposal counts (or bool mask)
                for this phase.  Boundaries that proposed nothing (the
                inactive DEO parity class) are filled with the mean
                rejection of the attempted ones — at the equal-rejection
                fixed point the filler equals the truth, so the fixed
                point is preserved exactly.
        """
        dtype = betas.dtype
        acc = jnp.clip(ratios.astype(dtype), 0.0, 1.0)
        r = 1.0 - acc
        if proposed is not None:
            attempted = proposed > 0
            n_att = jnp.maximum(jnp.sum(attempted.astype(dtype)), 1.0)
            mean_r = jnp.sum(jnp.where(attempted, r, 0.0)) / n_att
            r = jnp.where(attempted, r, mean_r)
        # a floor keeps the cumulative barrier strictly increasing so its
        # inverse (the interp below) stays well defined on flat stretches
        r = jnp.maximum(r, 1e-4)
        lam = jnp.concatenate([jnp.zeros((1,), dtype), jnp.cumsum(r)])
        n = betas.shape[0]
        targets = lam[-1] * jnp.arange(n, dtype=dtype) / (n - 1)
        # lam is ascending while betas descend: interp inverts the barrier
        beta_star = jnp.interp(targets, lam, betas)
        decay = self.adaptation_lag / (time + self.adaptation_lag)
        kappa = decay / self.adaptation_time
        new_mid = (1.0 - kappa) * betas[1:-1] + kappa * beta_star[1:-1]
        return betas.at[1:-1].set(new_mid)

    def communication_barrier(self, ratios=None):
        """Estimated cumulative communication barrier ``Λ̂(β_k)`` (Syed et
        al. 2021, §3.2): the running sum of measured per-boundary rejection
        rates from the cold rung down.

        ``Λ̂`` quantifies how hard the ladder is to traverse independent of
        its discretization: the non-reversible round-trip rate approaches
        ``1 / (2 + 2Λ̂)`` under an optimized schedule, and ``ntemps ≈ 1 +
        Λ̂`` rungs suffice — use the total to size the ladder.

        Args:
            ratios: optional ``(ntemps - 1,)`` per-attempt acceptance
                fractions; defaults to the accumulated
                ``swaps_accepted / swaps_proposed``.

        Returns:
            ``(lambdas, total)`` — ``lambdas[k] = Λ̂(β_k)`` shaped
            ``(ntemps,)``, and ``total = Λ̂(β_min)``.
        """
        if ratios is None:
            ratios = np.asarray(self.swaps_accepted) / np.maximum(
                np.asarray(self.swaps_proposed, dtype=float), 1.0
            )
        r = 1.0 - np.clip(np.asarray(ratios, dtype=float), 0.0, 1.0)
        lam = np.concatenate([[0.0], np.cumsum(r)])
        return lam, float(lam[-1])

    def temper_kernel(self, key, state, time, adapt=True):
        """Traced analogue of ``temper_comps`` (ref ``tempering.py:598-649``):
        swap cascade, then (optionally) ladder adaptation.

        Args:
            key: PRNG key.
            state: :class:`eryn_tpu.state.State`.
            time: traced int32 adaptation counter (the reference keeps this as
                mutable object state; it lives in the scan carry here).
            adapt: static bool — in-model moves adapt the ladder, reversible
                jump moves do not (ref ``rj.py:381-382``).

        Returns:
            ``(state, swaps_accepted, time)``.
        """
        ntemps, nwalkers = state.log_like.shape
        if ntemps == 1:
            return state, jnp.zeros((0,), dtype=state.log_like.dtype), time

        swap_tree = {
            "coords": state.branches_coords,
            "inds": state.branches_inds,
            "log_prior": state.log_prior,
        }
        branch_supps = {
            name: supp.holder
            for name, supp in state.branches_supplemental.items()
            if supp is not None
        }
        if branch_supps:
            swap_tree["branch_supps"] = branch_supps
        if state.blobs is not None:
            swap_tree["blobs"] = state.blobs
        if state.supplemental is not None:
            supp = state.supplemental
            swap_tree["supps"] = {
                name: arr
                for name, arr in supp.holder.items()
                if name not in self.skip_swap_supp_names
            }

        # subclasses written against the pre-DEO signature (no ``time``
        # kwarg) keep working: only pass the parity clock if accepted
        import inspect

        sk_params = inspect.signature(self.swap_kernel).parameters
        sk_kwargs = (
            {"time": time}
            if "time" in sk_params
            or any(
                p.kind == inspect.Parameter.VAR_KEYWORD
                for p in sk_params.values()
            )
            else {}
        )
        if not sk_kwargs and self.swap_scheme == "deo":
            # the fallback parity source (int(self.time)) is baked in at
            # TRACE time — inside a compiled segment every step would
            # attempt the same parity class, disconnecting the other
            # boundaries; tell the subclass author what to change
            import warnings

            warnings.warn(
                "swap_scheme='deo' with a swap_kernel override that does "
                "not accept the `time` kwarg: the parity clock cannot "
                "alternate inside compiled segments. Add `time=None` to "
                "the override's signature and forward it to super().",
                stacklevel=2,
            )
        # stable scope name: profiler traces attribute the swap phase's
        # device kernels by it
        with jax.named_scope("pt_swap"):
            swap_tree, logl, swaps_accepted, swaps_proposed = self.swap_kernel(
                key, swap_tree, state.log_like, state.betas, **sk_kwargs
            )
        # every consumer outside this kernel (backend accumulation, the
        # swap_acceptance_fraction property, plots, host adapt_temps)
        # normalizes by nwalkers proposals per rung; rescale counts from
        # swap kernels that proposed fewer pairings (a subclass override)
        # so those ratios stay unbiased.  DEO attempts each boundary on
        # exactly every other phase (deterministic alternation), so its
        # per-phase ratios are doubled: time-averaged statistics (backend
        # swap fractions, plots, ladder adaptation) then converge to the
        # true PER-ATTEMPT acceptance, matching the cascade's semantics
        # instead of reading half of it.
        raw_ratios = swaps_accepted / jnp.maximum(swaps_proposed, 1.0)
        ratios = raw_ratios
        if self.swap_scheme == "deo":
            ratios = 2.0 * ratios
        swaps_accepted = ratios * nwalkers

        betas = state.betas
        advanced = False
        if adapt and self.adaptive and ntemps > 1:
            if self.adaptation_scheme == "syed":
                # the barrier estimate wants true per-attempt rates plus
                # the attempted-boundary mask, not the rescaled reporting
                # values (under DEO those alternate between 2x and 0)
                new_betas = self.syed_schedule_kernel(
                    time.astype(betas.dtype),
                    betas,
                    raw_ratios,
                    proposed=swaps_proposed,
                )
            else:
                new_betas = self.ladder_adjustment_kernel(
                    time.astype(betas.dtype), betas, ratios
                )
            if self.stop_adaptation >= 0:
                keep_adapting = time < self.stop_adaptation
                betas = jnp.where(keep_adapting, new_betas, betas)
            else:
                betas = new_betas
            time = time + 1
            advanced = True
        if self.swap_scheme == "deo" and not advanced:
            # the counter doubles as the DEO parity clock: it must tick on
            # every phase, including non-adapting (RJ) epilogues
            time = time + 1

        from ..state import BranchSupplemental

        supplemental = state.supplemental
        if supplemental is not None:
            new_holder = dict(supplemental.holder)
            new_holder.update(swap_tree.get("supps", {}))
            supplemental = BranchSupplemental(
                new_holder, base_shape=supplemental.base_shape
            )

        branch_supplemental = dict(state.branches_supplemental)
        for name, holder in swap_tree.get("branch_supps", {}).items():
            old = branch_supplemental[name]
            branch_supplemental[name] = BranchSupplemental(
                holder, base_shape=old.base_shape
            )

        new_state = state.replace(
            coords=swap_tree["coords"],
            inds=swap_tree["inds"],
            branch_supplemental=branch_supplemental,
            log_like=logl,
            log_prior=swap_tree["log_prior"],
            blobs=swap_tree.get("blobs", state.blobs),
            betas=betas,
            supplemental=supplemental,
        )
        return new_state, swaps_accepted, time

    # host-side convenience mirroring reference mutation-style API ------
    def temperature_swaps(
        self,
        x,
        logP,
        logl,
        logp,
        inds=None,
        blobs=None,
        supps=None,
        branch_supps=None,
    ):
        """Host-callable swap cascade with the reference's public signature
        (ref ``tempering.py:484-561``): swaps every input highest -> lowest
        rung and updates ``self.swaps_accepted``.

        Randomness comes from a fresh key drawn through NumPy's global RNG
        (the reference consumes ``np.random`` directly); chains match the
        reference statistically, never bitwise.  ``logP`` is re-tempered
        from the swapped components, which is exactly what the reference's
        in-place re-tempering produces."""
        key = jax.random.PRNGKey(np.random.randint(0, 2**31 - 1))
        swap_tree = {"logp": jnp.asarray(logp)}
        if x is not None:
            swap_tree["x"] = {
                name: jnp.asarray(val) for name, val in x.items()
            }
        if inds is not None:
            swap_tree["inds"] = {
                name: jnp.asarray(val) for name, val in inds.items()
            }
        if blobs is not None:
            swap_tree["blobs"] = jnp.asarray(blobs)
        supps_holder = getattr(supps, "holder", None)
        if supps_holder:
            swap_tree["supps"] = {
                k: jnp.asarray(v)
                for k, v in supps_holder.items()
                if k not in self.skip_swap_supp_names
            }
        bs_holders = {}
        if branch_supps is not None:
            for name, bs in branch_supps.items():
                holder = getattr(bs, "holder", None)
                if holder:
                    bs_holders[name] = {
                        k: jnp.asarray(v) for k, v in holder.items()
                    }
        if bs_holders:
            swap_tree["branch_supps"] = bs_holders

        betas = jnp.asarray(self.betas)
        swap_tree, logl_new, swaps_accepted, swaps_proposed = self.swap_kernel(
            key, swap_tree, jnp.asarray(logl), betas
        )
        nwalkers = np.asarray(logl).shape[-1]
        ratios = np.asarray(swaps_accepted) / np.maximum(
            np.asarray(swaps_proposed), 1.0
        )
        if self.swap_scheme == "deo":
            # same per-attempt rescale as temper_kernel: each boundary is
            # attempted every other phase, so doubling makes time-averaged
            # statistics (and adapt_temps) see the true per-attempt rate
            ratios = 2.0 * ratios
        self.swaps_accepted = ratios * nwalkers
        self.swaps_proposed = np.full(self.ntemps - 1, nwalkers)
        if self.swap_scheme == "deo":
            # the DEO parity clock ticks every phase; remember the tick so
            # the reference's documented composition temperature_swaps() +
            # adapt_temps() does not advance it twice (which would freeze
            # the parity and disconnect the other boundary class)
            self.time += 1
            self._deo_phase_ticked = True

        logl_out = np.asarray(logl_new)
        logp_out = np.asarray(swap_tree["logp"])
        logP_out = np.asarray(
            self.compute_log_posterior_tempered(logl_out, logp_out)
        )
        x_out = (
            {n: np.asarray(v) for n, v in swap_tree["x"].items()}
            if x is not None
            else None
        )
        inds_out = (
            {n: np.asarray(v) for n, v in swap_tree["inds"].items()}
            if inds is not None
            else None
        )
        blobs_out = (
            np.asarray(swap_tree["blobs"]) if blobs is not None else None
        )
        if supps_holder:
            for k, v in swap_tree["supps"].items():
                supps[k] = np.asarray(v)
        if bs_holders:
            for name, holder in swap_tree["branch_supps"].items():
                for k, v in holder.items():
                    branch_supps[name][k] = np.asarray(v)
        return (
            x_out,
            logP_out,
            logl_out,
            logp_out,
            inds_out,
            blobs_out,
            supps,
            branch_supps,
        )

    def do_swaps_indexing(
        self,
        i,
        iperm_sel,
        i1perm_sel,
        dbeta,
        x,
        logP,
        logl,
        logp,
        inds=None,
        blobs=None,
        supps=None,
        branch_supps=None,
    ):
        """Apply one rung's ACCEPTED swaps in place between temperatures
        ``i`` and ``i-1`` (reference public host API, ref
        ``tempering.py:351-482``): ``iperm_sel`` / ``i1perm_sel`` are the
        accepted walker indices at rungs ``i`` and ``i-1``; ``logP`` is
        re-thermalized with ``dbeta = betas[i-1] - betas[i]`` (the
        reference's convention, ref ``tempering.py:522``).  Arrays are
        host NumPy and mutated in place; returns the reference's 8-tuple
        ``(x, logP, logl, logp, inds, blobs, supps, branch_supps)``.

        The compiled sampler never calls this — the traced swap cascade
        runs inside the scan; this exists so user code written against the
        reference API executes."""
        iperm_sel = np.asarray(iperm_sel)
        i1perm_sel = np.asarray(i1perm_sel)

        def swap_pairwise(arr):
            keep_hi = np.copy(arr[i, iperm_sel])
            arr[i, iperm_sel] = arr[i - 1, i1perm_sel]
            arr[i - 1, i1perm_sel] = keep_hi

        for name in x:
            swap_pairwise(x[name])
            if inds is not None and name in inds:
                swap_pairwise(inds[name])
            if branch_supps is not None and branch_supps.get(name) is not None:
                holder = branch_supps[name]
                tmp_hi = holder[i, iperm_sel]
                tmp_lo = holder[i - 1, i1perm_sel]
                for key in self.skip_swap_supp_names:
                    if hasattr(tmp_hi, "pop"):
                        tmp_hi.pop(key, None)
                    if hasattr(tmp_lo, "pop"):
                        tmp_lo.pop(key, None)
                holder[i, iperm_sel] = tmp_lo
                holder[i - 1, i1perm_sel] = tmp_hi

        logl_hi = np.copy(logl[i, iperm_sel])
        logl_lo = np.copy(logl[i - 1, i1perm_sel])
        logp_hi = np.copy(logp[i, iperm_sel])
        logP_hi = np.copy(logP[i, iperm_sel])
        logP_lo = np.copy(logP[i - 1, i1perm_sel])

        logl[i, iperm_sel] = logl_lo
        logp[i, iperm_sel] = logp[i - 1, i1perm_sel]
        logP[i, iperm_sel] = logP_lo - dbeta * logl_lo
        logl[i - 1, i1perm_sel] = logl_hi
        logp[i - 1, i1perm_sel] = logp_hi
        logP[i - 1, i1perm_sel] = logP_hi + dbeta * logl_hi

        if blobs is not None:
            swap_pairwise(blobs)
        if supps is not None:
            s_hi = supps[i, iperm_sel]
            s_lo = supps[i - 1, i1perm_sel]
            for key in self.skip_swap_supp_names:
                if hasattr(s_hi, "pop"):
                    s_hi.pop(key, None)
                if hasattr(s_lo, "pop"):
                    s_lo.pop(key, None)
            supps[i, iperm_sel] = s_lo
            supps[i - 1, i1perm_sel] = s_hi

        return (x, logP, logl, logp, inds, blobs, supps, branch_supps)

    def temper_comps(self, state, adapt=True):
        """Host entry point with the reference's public name and semantics
        (ref ``tempering.py:598-649``): swap a filled ``State``, then
        (optionally) adapt the ladder and advance ``self.time``.

        The compiled sampler never calls this — segments run
        :meth:`temper_kernel` inside the scan; this exists so user code
        written against the reference API executes."""
        from ..state import State

        betas = state.betas if state.betas is not None else self.betas
        work = State(state, copy=True)
        work.betas = np.asarray(betas)
        key = jax.random.PRNGKey(np.random.randint(0, 2**31 - 1))
        new_state, swaps_accepted, _ = self.temper_kernel(
            key,
            work,
            jnp.asarray(self.time, dtype=jnp.int32),
            adapt=False,
        )
        self.swaps_accepted = np.asarray(swaps_accepted)
        self.swaps_proposed = np.full(self.ntemps - 1, self.nwalkers)
        t0 = self.time
        if adapt:
            self.adapt_temps()  # advances self.time, mutates self.betas
        if self.swap_scheme == "deo" and self.time == t0:
            self.time += 1  # the DEO parity clock ticks every phase
        new_state.betas = np.asarray(self.betas)
        return new_state

    def thermodynamic_integration_log_evidence(self, logls, betas=None):
        """TI log-evidence over this control's ladder — the reference's
        roadmap asks for evidence estimation ON the tempering module
        (ref ``docs/source/general/todos.rst``: "add stepping-stone
        integration" to ``eryn.moves.tempering``).

        Args:
            logls: ``(ntemps,)`` mean log-likelihood per rung (or anything
                :func:`eryn_tpu.utils.utility.thermodynamic_integration_log_evidence`
                accepts alongside the ladder).
            betas: optional ladder override; defaults to the CURRENT
                (possibly adapted) ``self.betas``.

        Returns:
            ``(log_evidence, error_estimate)``.
        """
        from ..utils.utility import thermodynamic_integration_log_evidence

        betas = self.betas if betas is None else betas
        return thermodynamic_integration_log_evidence(betas, logls)

    def stepping_stone_log_evidence(
        self, logls, betas=None, block_len=50, repeats=100, seed=None
    ):
        """Stepping-stone log-evidence over this control's ladder (the
        accurate estimator when the ladder is coarse — see
        ``tests/test_backends.py``; roadmap item, ref
        ``docs/source/general/todos.rst``).

        Args:
            logls: ``(nsteps, ntemps, nwalkers)`` log-likelihood samples.
            betas: optional ladder override; defaults to ``self.betas``.

        Returns:
            ``(log_evidence, bootstrap_error)``.
        """
        from ..utils.utility import stepping_stone_log_evidence

        betas = self.betas if betas is None else betas
        return stepping_stone_log_evidence(
            betas, logls, block_len=block_len, repeats=repeats, seed=seed
        )

    def adapt_temps(self):
        """Host-side ladder adaptation (reference-compatible mutation API,
        ref ``tempering.py:587-596``)."""
        ratios = self.swaps_accepted / self.swaps_proposed
        if self.adaptive and self.ntemps > 1:
            if self.stop_adaptation < 0 or self.time < self.stop_adaptation:
                betas = jnp.asarray(self.betas)
                if self.adaptation_scheme == "syed":
                    raw = np.asarray(ratios, dtype=float)
                    proposed = None
                    if self.swap_scheme == "deo":
                        # host accumulators hold the 2x per-attempt
                        # reporting values with zeros on the inactive
                        # parity class: undo the rescale and treat the
                        # zeros as unattempted
                        proposed = jnp.asarray(raw > 0)
                        raw = raw / 2.0
                    new_betas = self.syed_schedule_kernel(
                        float(self.time),
                        betas,
                        jnp.asarray(raw),
                        proposed=proposed,
                    )
                else:
                    new_betas = self.ladder_adjustment_kernel(
                        float(self.time), betas, jnp.asarray(ratios)
                    )
                self.betas = np.asarray(new_betas)
            if getattr(self, "_deo_phase_ticked", False):
                # temperature_swaps already ticked this phase's parity
                self._deo_phase_ticked = False
            else:
                self.time += 1
