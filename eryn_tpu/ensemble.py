"""EnsembleSampler: the user-facing orchestrator.

JAX re-design of ``/root/reference/src/eryn/ensemble.py:211-1700``.
The reference runs a Python loop per MCMC step with NumPy array ops and an
optional ``pool.map`` fan-out for likelihoods; here the hot loop is a single
jitted function — move selection (``lax.switch`` over the weighted schedule),
proposal, tempering swaps/adaptation, and per-move acceptance counters all
live on device, composed with ``lax.scan`` over iterations.  The host touches
the chain only at storage/yield boundaries.

Likelihood contract:

* If ``log_like_fn`` is JAX-traceable it is ``vmap``-ed over the flattened
  ``(ntemps * nwalkers)`` ensemble (or called once, batched, with
  ``vectorize=True``) and fused into the sampler step.
* Legacy NumPy likelihoods still work: they are bridged with
  ``jax.pure_callback`` reproducing the reference's per-walker grouping
  semantics (``ensemble.py:1408-1481``) — correct but host-bound; a warning
  points users at the traced contract.
"""

from __future__ import annotations

import warnings
from itertools import count

import numpy as np

import jax
import jax.numpy as jnp

from .backends import Backend, HDFBackend
from .model import Model
from .moves import StretchMove
from .moves.move import EvalContext, Move

# re-exported names available from the reference's ensemble namespace
# (ref ensemble.py imports; kept importable for ported user code)
from .moves import GaussianMove  # noqa: F401
from .moves.distgenrj import DistributionGenerateRJ  # noqa: F401
from .utils.plot import PlotContainer  # noqa: F401
from .utils.utility import groups_from_inds  # noqa: F401
from .moves.tempering import TemperatureControl, tempered_log_likelihood
from .pbar import get_progress_bar
from .prior import ProbDistContainer
from .state import State
from .utils.periodic import PeriodicContainer

__all__ = ["EnsembleSampler", "walkers_independent"]


def _finite_min(dtype):
    return float(np.finfo(np.dtype(dtype)).min / 2)


def _crossed(prev, now, interval):
    """True when the count advanced across a multiple of ``interval``
    between ``prev`` (exclusive) and ``now`` (inclusive).  Segment sizes
    need not divide the interval: a hook fires on the first boundary at or
    past each multiple instead of silently never firing."""
    return now // interval > prev // interval


def _segment_plan(nsteps, seg, taper=False, min_seg=64):
    """Plan segment sizes: full segments of ``seg`` plus the remainder
    decomposed into powers of two.  Each distinct length costs one jit
    compile, so power-of-two remainders bound the compile
    cache at ~log2(seg) programs across ALL runs instead of one fresh
    compile per distinct remainder.

    ``taper=True`` additionally replaces the FINAL segment with a halving
    cascade down to ``min_seg`` (same total, still powers of two).  Host
    backends flush each segment's chain device->host overlapped with the
    next segment's compute; the last flush has nothing to hide behind, so
    shrinking the tail segment turns an unoverlappable full-segment
    transfer into a ``min_seg``-step one."""
    plan = [seg] * (nsteps // seg)
    rem = nsteps % seg
    while rem:
        b = 1 << (rem.bit_length() - 1)
        plan.append(b)
        rem -= b
    # only power-of-two segments taper exactly into power-of-two halves
    # (keeping the jit cache bounded); non-pow2 segments (explicit sizes,
    # short runs) stay whole
    if taper and any(
        v > min_seg and (v & (v - 1)) == 0 for v in plan
    ):
        # taper the last LARGE segment (a tiny pow2 remainder after it
        # cannot hide a full-segment flush behind its compute)
        i = max(
            i
            for i, v in enumerate(plan)
            if v > min_seg and (v & (v - 1)) == 0
        )
        last = plan[i]
        cascade = []
        b = last // 2
        while b > min_seg:
            cascade.append(b)
            b //= 2
        cascade.append(b)
        cascade.append(b)
        plan[i : i + 1] = cascade
    return plan


class PriorEvaluator:
    """Traced (or callback-bridged) evaluation of the summed log-prior over
    active leaves (re-design of ``ensemble.py:1127-1217``)."""

    def __init__(self, containers: dict, dtype):
        self.containers = containers
        self.dtype = dtype

    def __call__(self, coords: dict, inds: dict):
        """coords: {name: (..., nleaves_max, ndim)}; inds: {name: (...,
        nleaves_max)}.  Returns summed log-prior with the leading batch
        shape."""
        total = None
        for name, container in self.containers.items():
            c = coords[name]
            m = inds[name]
            if getattr(container, "traceable", False):
                lp_leaf = container.logpdf(c)
            else:
                batch = c.shape[:-1]
                lp_leaf = jax.pure_callback(
                    lambda arr, _con=container: np.asarray(
                        _con.logpdf(np.asarray(arr).reshape(-1, arr.shape[-1]))
                    )
                    .reshape(arr.shape[:-1])
                    .astype(self.dtype),
                    jax.ShapeDtypeStruct(batch, self.dtype),
                    c,
                    vmap_method="sequential",
                )
            lp_leaf = jnp.where(m, lp_leaf, 0.0)
            lp = lp_leaf.sum(axis=-1)
            total = lp if total is None else total + lp
        return total.astype(self.dtype)


class LikelihoodEvaluator:
    """Batched likelihood evaluation (re-design of ``ensemble.py:1219-1545``).

    Chooses one of three execution modes at construction:

    * ``traced-walker``: traceable fn, ``vmap`` over flattened walkers.
    * ``traced-batched``: traceable fn with ``vectorize=True`` — called once
      with the full flattened batch.
    * ``callback``: host NumPy fn bridged via ``jax.pure_callback`` with the
      reference's per-walker active-leaf argument convention.
    """

    def __init__(
        self,
        fn,
        *,
        branch_names,
        ndims,
        nleaves_max,
        nleaves_min,
        args,
        kwargs,
        vectorize,
        provide_groups,
        provide_supplemental,
        fill_zero_leaves_val,
        rj,
        dtype,
        pool=None,
    ):
        self.fn = fn
        self.pool = pool
        self.branch_names = list(branch_names)
        self.ndims = ndims
        self.nleaves_max = nleaves_max
        self.nleaves_min = nleaves_min
        self.args = tuple(args) if args is not None else ()
        self.kwargs = dict(kwargs) if kwargs is not None else {}
        self.vectorize = vectorize
        self.provide_groups = provide_groups
        self.provide_supplemental = provide_supplemental
        self.rj = rj
        self.dtype = dtype
        fill = fill_zero_leaves_val
        self.fill_zero_leaves_val = max(float(fill), _finite_min(dtype))

        self._simple = (
            len(self.branch_names) == 1
            and self.nleaves_max[self.branch_names[0]] == 1
            and not rj
            and not provide_groups
        )
        self.returns_blobs = False
        self.blob_shape = None
        self._eager = False  # True only inside host_call (blob discovery)
        self.mode = self._detect_mode()

    # -- argument building -------------------------------------------------
    def _supp_args(self, sdict):
        """Supplemental arguments appended when ``provide_supplemental``:
        single branch gets the bare ``{key: arr}`` dict, multi-branch gets
        ``{branch: {key: arr}}`` (ref ensemble.py:1296-1406 semantics)."""
        if not self.provide_supplemental:
            return ()
        if sdict is None:
            sdict = {}
        if len(self.branch_names) == 1:
            return (sdict.get(self.branch_names[0]) or {},)
        return ({n: sdict.get(n) or {} for n in self.branch_names},)

    def _walker_args(self, cdict, idict, sdict=None):
        """Per-walker traced arguments: padded coords (+ mask when needed)."""
        supp = self._supp_args(sdict)
        if self._simple:
            name = self.branch_names[0]
            return (cdict[name][0],) + supp
        if len(self.branch_names) == 1:
            name = self.branch_names[0]
            return (cdict[name], idict[name]) + supp
        return (cdict, idict) + supp

    def _coerce_out(self, out):
        if isinstance(out, (tuple, list)):
            ll, blobs = out[0], out[1]
            return jnp.asarray(ll, dtype=self.dtype), jnp.asarray(blobs)
        return jnp.asarray(out, dtype=self.dtype)

    def _traced_walker(self, cdict, idict, sdict=None):
        out = self.fn(
            *self._walker_args(cdict, idict, sdict), *self.args, **self.kwargs
        )
        return self._coerce_out(out)

    def _traced_batched(self, cdict, idict, sdict=None):
        supp = self._supp_args(sdict)
        if self._simple:
            name = self.branch_names[0]
            x = cdict[name][:, 0]  # (N, ndim)
            out = self.fn(x, *supp, *self.args, **self.kwargs)
        elif len(self.branch_names) == 1:
            name = self.branch_names[0]
            out = self.fn(
                cdict[name], idict[name], *supp, *self.args, **self.kwargs
            )
        else:
            out = self.fn(cdict, idict, *supp, *self.args, **self.kwargs)
        return self._coerce_out(out)

    def _detect_mode(self):
        example_c = {
            n: jnp.zeros((2, self.nleaves_max[n], self.ndims[n]), dtype=self.dtype)
            for n in self.branch_names
        }
        example_i = {
            n: jnp.ones((2, self.nleaves_max[n]), dtype=bool)
            for n in self.branch_names
        }
        def check_shape(shape):
            # a tuple/list output means (log_like, blobs)
            if isinstance(shape, (tuple, list)):
                ll_shape, blob_shape = shape[0], shape[1]
                if ll_shape.shape != (2,):
                    raise TypeError(
                        f"likelihood returned shape {ll_shape.shape}"
                    )
                self.returns_blobs = True
                self.blob_shape = tuple(blob_shape.shape[1:])
                return
            if shape.shape != (2,):
                raise TypeError(f"likelihood returned shape {shape.shape}")

        if self.provide_supplemental:
            # supplemental keys are unknown until runtime: defer the
            # traced-vs-callback decision to the first evaluation, where the
            # real supp arrays are available (see __call__)
            return None

        probe_args = (example_c, example_i)
        try:
            if self.vectorize:
                check_shape(jax.eval_shape(self._traced_batched, *probe_args))
                return "traced-batched"
            check_shape(
                jax.eval_shape(jax.vmap(self._traced_walker), *probe_args)
            )
            return "traced-walker"
        except Exception:
            warnings.warn(
                "log_like_fn is not JAX-traceable (or indexes supplemental "
                "keys unknown at setup); falling back to a host callback "
                "(jax.pure_callback). For accelerator performance, provide "
                "a jax.numpy likelihood.",
                stacklevel=2,
            )
            return "callback"

    # -- host callback path --------------------------------------------------
    def _host_eval_vectorized(
        self, coords_flat, inds_flat, logp_flat, supps_flat=None
    ):
        """Reference ``vectorize=True`` grouping semantics
        (``ensemble.py:1305-1406``): flattened active-leaf arrays per branch
        plus flat walker-group ids, one call for the whole batch; active-leaf
        branch supplementals as a ``branch_supps`` kwarg (bare for a single
        branch, list otherwise — ref ``ensemble.py:1387-1399``)."""
        names = self.branch_names
        N = logp_flat.shape[0]
        out = np.full(N, -np.inf, dtype=np.float64)
        finite = np.isfinite(logp_flat)
        # zero-leaf walkers never reach the user function
        # (ref ensemble.py:1486-1499)
        nleaves_tot = sum(inds_flat[n].sum(axis=-1) for n in names)
        out[(nleaves_tot == 0) & finite] = self.fill_zero_leaves_val
        keep = np.where(finite & (nleaves_tot > 0))[0]
        if keep.size == 0:
            return out, self._blob_buffer(N, None)

        x_in = []
        groups_in = []
        supps_in = []
        for n in names:
            m = inds_flat[n][keep]  # (nkeep, nl)
            c = coords_flat[n][keep]
            walker_ids = np.broadcast_to(
                np.arange(keep.size)[:, None], m.shape
            )
            x_in.append(c[m])
            groups_in.append(walker_ids[m])
            if self.provide_supplemental and supps_flat and n in supps_flat:
                supps_in.append(
                    {
                        k: (
                            v[keep][m]
                            if v.shape[1:2] == m.shape[1:2]
                            else v[keep]
                        )
                        for k, v in supps_flat[n].items()
                    }
                )
            else:
                supps_in.append(None)

        if len(names) == 1:
            args = (x_in[0],)
            if self.provide_groups:
                args = (x_in[0], groups_in[0])
        else:
            args = (x_in,)
            if self.provide_groups:
                args = (x_in, groups_in)
        kwargs_in = {}
        if self.provide_supplemental and supps_flat:
            kwargs_in["branch_supps"] = (
                supps_in[0] if len(names) == 1 else supps_in
            )

        res = np.asarray(
            self.fn(*args, *self.args, **{**self.kwargs, **kwargs_in})
        )
        if res.ndim == 2 and res.shape[1] == 1:
            # a (nkeep, 1) return is a plain likelihood, not zero-width
            # blobs (the reference squeezes the same way, ensemble.py:1490)
            res = res[:, 0]
        if res.ndim == 2:
            # (nkeep, 1 + nblobs): second axis carries blobs
            # (ref ensemble.py:1489-1500)
            out_blobs = self._blob_buffer(N, res.shape[1] - 1)
            out[keep] = res[:, 0]
            out_blobs[keep] = res[:, 1:]
            return out, out_blobs
        out[keep] = res.reshape(keep.size)
        return out, self._blob_buffer(N, None)

    def _host_eval(self, coords_flat, inds_flat, logp_flat, supps_flat=None):
        """Reference per-walker grouping semantics
        (``ensemble.py:1408-1481``): active leaves per branch, ``None`` for
        zero-leaf branches in the multi-branch case, active-leaf branch
        supplementals as a ``branch_supps`` kwarg when
        ``provide_supplemental``, and a user ``pool.map`` fan-out when a
        pool is configured."""
        if self.vectorize:
            return self._host_eval_vectorized(
                coords_flat, inds_flat, logp_flat, supps_flat
            )
        names = self.branch_names
        N = logp_flat.shape[0]
        out = np.full(N, -np.inf, dtype=np.float64)
        multi = len(names) > 1
        items = []
        keep = []
        for i in range(N):
            if not np.isfinite(logp_flat[i]):
                continue
            per_branch = []
            total_active = 0
            for n in names:
                m = inds_flat[n][i]
                active = coords_flat[n][i][m]
                total_active += active.shape[0]
                per_branch.append(active if active.shape[0] > 0 else None)
            if total_active == 0:
                out[i] = self.fill_zero_leaves_val
                continue
            kwargs_i = {}
            if self.provide_supplemental and supps_flat:
                kwargs_i["branch_supps"] = {
                    n: (
                        {
                            k: (
                                v[i][inds_flat[n][i]]
                                if v[i].shape[:1]
                                == inds_flat[n][i].shape[:1]
                                else v[i]
                            )
                            for k, v in supps_flat[n].items()
                        }
                        if n in supps_flat
                        else None
                    )
                    for n in names
                }
            if multi:
                arg = per_branch
            else:
                arg = per_branch[0]
                if self.nleaves_max[names[0]] == 1 and not self.rj:
                    arg = arg[0]
            items.append((arg, kwargs_i))
            keep.append(i)

        out_blobs = None
        if items:
            worker = _CallbackWorker(self.fn, self.args, self.kwargs)
            map_func = self.pool.map if self.pool is not None else map
            results = list(map_func(worker, items))
            for i, res in zip(keep, results):
                res = np.asarray(res, dtype=np.float64).reshape(-1)
                if res.size > 1:
                    # [log_like, *blobs] per walker (ref ensemble.py:1489-1500)
                    if out_blobs is None:
                        out_blobs = self._blob_buffer(N, res.size - 1)
                    out[i] = res[0]
                    out_blobs[i] = res[1:]
                else:
                    out[i] = res[0]
        if out_blobs is None:
            out_blobs = self._blob_buffer(N, None)
        return out, out_blobs

    def _blob_buffer(self, N, nblobs):
        """Host blob buffer for the callback path.  ``nblobs`` from the
        observed result width, or ``None`` to fall back to the declared
        ``blob_shape`` (the traced callback must return static shapes)."""
        if nblobs is None:
            if not self.returns_blobs:
                return None
            return np.full((N,) + tuple(self.blob_shape), np.nan)
        shape = (int(nblobs),)
        if self.returns_blobs and tuple(self.blob_shape) != shape:
            raise ValueError(
                f"Callback likelihood returned {nblobs} blob value(s) per "
                f"walker but {self.blob_shape[0]} were detected at setup."
            )
        if not self.returns_blobs:
            if not self._eager:
                # the traced pure_callback has already declared its output
                # shapes; blobs can only be DISCOVERED on an eager host_call
                raise ValueError(
                    "Callback likelihood returned blobs, but none were "
                    "detected at setup. Let the sampler evaluate the initial "
                    "state (pass coordinates without a precomputed log_like) "
                    "so the blob shape can be probed before compilation."
                )
            self.returns_blobs = True
            self.blob_shape = shape
        return np.full((N,) + shape, np.nan)

    # -- main traced entry ---------------------------------------------------
    def __call__(self, coords: dict, inds: dict, logp, branch_supps=None):
        """coords: {name: (ntemps, n, nleaves_max, ndim)}; logp: (ntemps, n);
        branch_supps: optional {name: {key: (ntemps, n, ...)}}.
        Returns ``(log_like (ntemps, n), blobs_or_None)``."""
        batch_shape = logp.shape
        N = int(np.prod(batch_shape))
        cf = {
            n: coords[n].reshape((N,) + coords[n].shape[2:]) for n in coords
        }
        inf = {n: inds[n].reshape((N,) + inds[n].shape[2:]) for n in inds}
        logp_flat = logp.reshape((N,))
        sf = None
        if branch_supps is not None and self.provide_supplemental:
            sf = {
                n: {
                    k: v.reshape((N,) + v.shape[2:]) for k, v in holder.items()
                }
                for n, holder in branch_supps.items()
                if holder is not None
            }

        finite = jnp.isfinite(logp_flat)
        # guard the user fn against out-of-support coordinates: substitute
        # zeros where the prior already rejected (ref ensemble.py:1264-1292)
        cf_safe = {
            n: jnp.where(
                finite.reshape((N,) + (1,) * (cf[n].ndim - 1)), cf[n], 0.0
            )
            for n in cf
        }

        if self.mode is None:
            # deferred decision (provide_supplemental=True): try the traced
            # contract with the REAL supp arrays; a fn that is not traceable
            # (or expects host conventions) falls back to the callback bridge
            try:
                if self.vectorize:
                    jax.eval_shape(self._traced_batched, cf_safe, inf, sf)
                    self.mode = "traced-batched"
                else:
                    jax.eval_shape(
                        jax.vmap(self._traced_walker), cf_safe, inf, sf
                    )
                    self.mode = "traced-walker"
            except Exception:
                warnings.warn(
                    "log_like_fn with provide_supplemental=True is not "
                    "JAX-traceable; falling back to a host callback "
                    "(jax.pure_callback). For accelerator performance, provide "
                    "a jax.numpy likelihood.",
                    stacklevel=2,
                )
                self.mode = "callback"

        blobs = None
        if self.mode == "traced-walker":
            out = jax.vmap(self._traced_walker)(cf_safe, inf, sf)
            ll, blobs = out if isinstance(out, tuple) else (out, None)
        elif self.mode == "traced-batched":
            out = self._traced_batched(cf_safe, inf, sf)
            ll, blobs = out if isinstance(out, tuple) else (out, None)
        else:
            def _cb_host(c, i, lp, s):
                ll_h, bl_h = self._host_eval(
                    jax.tree_util.tree_map(np.asarray, c),
                    jax.tree_util.tree_map(np.asarray, i),
                    np.asarray(lp),
                    jax.tree_util.tree_map(np.asarray, s),
                )
                if not self.returns_blobs:
                    return ll_h.astype(self.dtype)
                if bl_h is None:
                    bl_h = np.full(
                        (ll_h.shape[0],) + tuple(self.blob_shape), np.nan
                    )
                return ll_h.astype(self.dtype), bl_h.astype(self.dtype)

            if self.returns_blobs:
                out_struct = (
                    jax.ShapeDtypeStruct((N,), self.dtype),
                    jax.ShapeDtypeStruct(
                        (N,) + tuple(self.blob_shape), self.dtype
                    ),
                )
            else:
                out_struct = jax.ShapeDtypeStruct((N,), self.dtype)
            out = jax.pure_callback(
                _cb_host,
                out_struct,
                cf,
                inf,
                logp_flat,
                sf,
                vmap_method="sequential",
            )
            ll, blobs = out if isinstance(out, tuple) else (out, None)

        ll = jnp.where(finite, ll, -jnp.inf)

        # zero-leaf walkers get the fill value (ref ensemble.py:1486-1499)
        nleaves_total = None
        for n in inf:
            s = inf[n].sum(axis=-1)
            nleaves_total = s if nleaves_total is None else nleaves_total + s
        ll = jnp.where(
            (nleaves_total == 0) & finite, self.fill_zero_leaves_val, ll
        )
        if blobs is not None:
            blobs = blobs.reshape(batch_shape + blobs.shape[1:])
        return ll.reshape(batch_shape).astype(self.dtype), blobs

    def host_call(self, coords, inds, logp, branch_supps=None):
        """Eager host evaluation for callback mode: the same contract as
        :meth:`__call__` but on concrete arrays.  Used for the setup-time
        initial evaluation so blob returns (``[log_like, *blobs]`` per
        walker, ref ``ensemble.py:1489-1500``) can be *discovered* before
        the traced path must declare static output shapes."""
        logp = np.asarray(logp)
        batch_shape = logp.shape
        N = int(np.prod(batch_shape))

        def flat(x):
            x = np.asarray(x)
            return x.reshape((N,) + x.shape[2:])

        cf = {n: flat(coords[n]) for n in coords}
        inf = {n: flat(inds[n]) for n in inds}
        sf = None
        if branch_supps is not None and self.provide_supplemental:
            sf = {
                n: {k: flat(v) for k, v in holder.items()}
                for n, holder in branch_supps.items()
                if holder is not None
            }
        self._eager = True
        try:
            ll, bl = self._host_eval(cf, inf, logp.reshape(N), sf)
        finally:
            self._eager = False
        ll = jnp.asarray(ll.reshape(batch_shape), dtype=self.dtype)
        blobs = (
            None
            if bl is None
            else jnp.asarray(
                bl.reshape(batch_shape + bl.shape[1:]), dtype=self.dtype
            )
        )
        return ll, blobs


class _CallbackWorker:
    """Picklable per-walker likelihood invocation for the legacy callback
    path: one ``(active_leaf_params, kwargs)`` item per walker, fanned out
    through a user pool's ``.map`` (ref ``ensemble.py:1408-1481``)."""

    def __init__(self, fn, args, kwargs):
        self.fn = fn
        self.args = tuple(args) if args else ()
        self.kwargs = dict(kwargs) if kwargs else {}

    def __call__(self, item):
        arg, kwargs_i = item
        return self.fn(arg, *self.args, **{**self.kwargs, **kwargs_i})


class _FunctionWrapper:
    """Pickle-friendly likelihood wrapper (API parity with
    ``ensemble.py:1623-1667``)."""

    def __init__(self, f, args, kwargs):
        self.f = f
        self.args = args or ()
        self.kwargs = kwargs or {}

    def __call__(self, x):
        return self.f(x, *self.args, **self.kwargs)


def _normalize_key_order(key_order):
    """Coerce a per-branch key-order mapping to plain Python types so
    sampler-side lists compare equal to HDF5-attr round-tripped arrays."""

    def norm(v):
        out = []
        for x in np.atleast_1d(np.asarray(v)).tolist():
            if isinstance(x, bytes):
                x = x.decode()
            out.append(x)
        return out

    return {name: norm(v) for name, v in dict(key_order).items()}


def walkers_independent(coords):
    """Check walkers span the parameter space (ref ``ensemble.py:1670-1700``)."""
    coords = np.asarray(coords)
    flat = coords.reshape(coords.shape[0], -1)
    if not np.all(np.isfinite(flat)):
        return False
    c = flat - np.mean(flat, axis=0)[None, :]
    scale = np.max(np.abs(c), axis=0)
    scale[scale == 0.0] = 1.0
    c = c / scale
    cond = np.linalg.cond(c.astype(float))
    return cond <= 1e8


class EnsembleSampler:
    """Omni-MCMC ensemble sampler on an accelerator (API parity with
    ``/root/reference/src/eryn/ensemble.py:31-1620``)."""

    def __init__(
        self,
        nwalkers,
        ndims,
        log_like_fn,
        priors,
        provide_groups=False,
        provide_supplemental=False,
        tempering_kwargs={},
        branch_names=None,
        nbranches=1,
        nleaves_max=1,
        nleaves_min=0,
        pool=None,
        moves=None,
        rj_moves=None,
        dr_moves=None,
        dr_max_iter=5,
        args=None,
        kwargs=None,
        backend=None,
        vectorize=False,
        blobs_dtype=None,
        plot_iterations=-1,
        plot_generator=None,
        plot_folder=None,
        periodic=None,
        update_fn=None,
        update_iterations=-1,
        stopping_fn=None,
        stopping_iterations=-1,
        fill_zero_leaves_val=-1e300,
        num_repeats_in_model=1,
        num_repeats_rj=1,
        track_moves=True,
        info={},
        seed=None,
        dtype=None,
        prng_impl="rbg",
    ):
        self.provide_groups = provide_groups
        self.provide_supplemental = provide_supplemental
        self.num_repeats_in_model = num_repeats_in_model
        self.num_repeats_rj = num_repeats_rj
        self.track_moves = track_moves
        self.pool = pool  # accepted for API parity; likelihoods are batched
        self.vectorize = vectorize
        self.blobs_dtype = blobs_dtype
        self.info = info

        self.dtype = jnp.dtype(dtype) if dtype is not None else jnp.float32
        self.fill_zero_leaves_val = max(
            float(fill_zero_leaves_val), _finite_min(self.dtype)
        )

        # ---- branch normalization (ref ensemble.py:264-317) -------------
        if branch_names is not None:
            if isinstance(branch_names, str):
                branch_names = [branch_names]
            elif not isinstance(branch_names, list):
                raise ValueError("branch_names must be string or list of strings.")
        else:
            branch_names = [f"model_{i}" for i in range(nbranches)]
        nbranches = len(branch_names)

        ndims = self._normalize_per_branch(ndims, branch_names, "ndims")
        nleaves_max = self._normalize_per_branch(
            nleaves_max, branch_names, "nleaves_max"
        )
        if isinstance(nleaves_min, int):
            nleaves_min = {bn: nleaves_min for bn in branch_names}
        else:
            nleaves_min = self._normalize_per_branch(
                nleaves_min, branch_names, "nleaves_min"
            )

        self.nbranches = nbranches
        self.branch_names = branch_names
        self.ndims = ndims
        self.nleaves_max = nleaves_max
        self.nleaves_min = nleaves_min
        self.nwalkers = nwalkers

        # ---- tempering (ref ensemble.py:319-332) -------------------------
        if tempering_kwargs == {}:
            self.ntemps = 1
            self.temperature_control = None
        else:
            total_ndim = sum(
                self.nleaves_max[k] * self.ndims[k] for k in branch_names
            )
            self.temperature_control = TemperatureControl(
                total_ndim, nwalkers, **tempering_kwargs
            )
            self.ntemps = self.temperature_control.ntemps

        # ---- priors -------------------------------------------------------
        self.priors = priors
        #: per-branch prior key ordering (ref ensemble.py:755), persisted to
        #: the backend and validated on resume
        self.key_order = {
            name: list(getattr(c, "key_order", []))
            for name, c in self.priors.items()
        }

        # ---- periodic (after priors: string parameter keys resolve through
        # the priors' key_order, ref periodic.py:21-47) -------------------
        if periodic is not None and not isinstance(periodic, PeriodicContainer):
            if not isinstance(periodic, dict):
                raise ValueError(
                    "periodic must be PeriodicContainer or dict if not None."
                )
            periodic = PeriodicContainer(
                periodic, ndims=self.ndims, key_orders=self.key_order
            )
        self.periodic = periodic

        # ---- moves schedule (ref ensemble.py:349-514) ----------------------
        if moves is None:
            self.moves = [StretchMove()]
            self.weights = [1.0]
        else:
            self.moves, self.weights = self._parse_moves(moves)

        if rj_moves is not None:
            self.rj_moves, self.rj_weights = self._parse_rj_moves(rj_moves)
            self.has_reversible_jump = len(self.rj_moves) > 0
        else:
            self.rj_moves = []
            self.rj_weights = []
            self.has_reversible_jump = False
        if self.has_reversible_jump:
            # leaf counts can only vary where RJ has room to move them
            variable = {
                n
                for n in self.branch_names
                if self.nleaves_min.get(n, self.nleaves_max[n])
                != self.nleaves_max[n]
            }

            def _walk(moves_list):
                for m in moves_list:
                    yield m
                    # CombineMove children (and any future composite)
                    for child in getattr(m, "moves", None) or []:
                        yield child

            for m in _walk(self.moves + self.rj_moves):
                if not getattr(m, "requires_fixed_dimension", False):
                    continue
                run = m.proposal_branch_names
                if run is None:
                    run = list(self.branch_names)
                elif isinstance(run, str):
                    run = [run]
                clash = sorted(variable.intersection(run))
                if clash:
                    # an initial all-active mask would pass the move's own
                    # check and then silently bias once leaves deactivate —
                    # reject the combination outright (restrict the move
                    # with proposal_branch_names to fixed-dimension
                    # branches to combine it with RJ elsewhere)
                    raise ValueError(
                        f"{type(m).__name__} requires fixed-dimension "
                        "models and cannot propose on reversible-jump "
                        f"branches {clash} (leaf masks change the meaning "
                        "of the flattened parameter vector). Use "
                        "KDEMove/DEMove for trans-dimensional targets, or "
                        "restrict the move with proposal_branch_names."
                    )
            # the reference's own warning (ref ensemble.py:505-514) — plus
            # the fix it asks for, which the reference does not have
            if any(
                type(m) is StretchMove
                for m in self.moves
            ):
                warnings.warn(
                    "Using the plain StretchMove for in-model proposals "
                    "under reversible jump is not advised: the stretch ray "
                    "targets the complement walker's same leaf slot, which "
                    "may be inactive (dormant coordinates). Use "
                    "RedBlueGroupStretchMove instead — it stretches each "
                    "active leaf toward an ACTIVE complement leaf with "
                    "exact detailed balance.",
                    stacklevel=2,
                )
        if dr_moves:
            # The reference ships the DR-on-rejected-RJ-births machinery but
            # raises on this path (ref rj.py:350-374) — for good reason:
            # retrying only rejected births (never deaths) breaks
            # trans-dimensional detailed balance because the reverse
            # intermediate (another k+1 sibling) is not reachable from the
            # birthed state, so Mira's recursion does not apply (verified
            # empirically: the k-posterior inflates by ~0.10 on a quadrature-
            # checked problem). The *correct* retry-rejected-births mechanism
            # is multiple-try RJ.
            raise NotImplementedError(
                "dr_moves (delayed rejection nested inside reversible jump) "
                "is not implemented — the reference raises on this path too "
                "(rj.py:350-353), and the naive birth-only retry provably "
                "biases the leaf-count posterior. Use MTDistGenMoveRJ "
                "(multiple-try RJ) for unbiased birth retries, or the "
                "standalone DelayedRejection move for in-model proposals."
            )

        #: leaf masks can only change when an RJ move runs; non-RJ runs skip
        #: snapshotting them and rebuild from a host copy at flush time
        self._inds_change = self.has_reversible_jump or any(
            getattr(m, "is_rj", False) for m in self.moves
        )
        self._static_inds = None

        # inject temperature control & periodic (ref ensemble.py:516-536)
        for move in self.moves + self.rj_moves:
            move.temperature_control = self.temperature_control
            if move.periodic is None:
                move.periodic = self.periodic
            if hasattr(move, "wire_sampler_priors"):
                # moves with a deferred generating distribution (e.g.
                # ModelSwapRJMove built via the reference example's legacy
                # signature) resolve it from the per-branch priors
                move.wire_sampler_priors(self.priors)
            if hasattr(move, "propagate_wiring"):
                move.propagate_wiring()

        #: reference-style custom moves (host get_proposal / friends hooks)
        #: cannot enter the compiled scan; the whole chain runs host-step
        #: mode instead (see _run_host_segment / moves/legacy.py)
        self._has_host_moves = any(
            getattr(m, "host_move", False)
            for m in self.moves + self.rj_moves
        )
        #: hybrid scheduling: when the schedule mixes host and native moves,
        #: stored steps whose pre-drawn slots are all native run compiled
        #: (_run_hybrid_segment); the bridge drops to host step-by-step only
        #: for steps containing a host-move draw.  Requires at least one
        #: native in-model move (the compiled subset kernel needs one) and,
        #: under RJ, at least one native RJ move (every step draws RJ slots).
        self._hybrid_host = (
            self._has_host_moves
            and any(
                not getattr(m, "host_move", False) for m in self.moves
            )
            and (
                not self.rj_moves
                or any(
                    not getattr(m, "host_move", False) for m in self.rj_moves
                )
            )
        )
        if self._has_host_moves:
            if self._hybrid_host:
                warnings.warn(
                    "One or more moves implement the reference's host "
                    "extension protocol (get_proposal / setup_friends / "
                    "find_friends); the sampler runs HYBRID: steps drawing "
                    "only native moves stay compiled, steps drawing the "
                    "custom move run on the host. Port the hook to the "
                    "*_kernel API (docs/migration.md) for full compiled "
                    "performance.",
                    stacklevel=2,
                )
            else:
                warnings.warn(
                    "One or more moves implement the reference's host "
                    "extension protocol (get_proposal / setup_friends / "
                    "find_friends); the sampler will run step-by-step on "
                    "the host. This is correct but much slower than the "
                    "compiled path — port the hook to the *_kernel API "
                    "(docs/migration.md) for compiled performance.",
                    stacklevel=2,
                )

        # move-tracking registry; key naming matches the reference exactly
        # (ref ensemble.py:556-590: always ``<ClassName>_<count>`` starting
        # at 0) so HDF5 files written here carry ``moves/<key>`` groups the
        # reference sampler accepts on resume (its move-configuration check
        # compares these keys literally, ref ensemble.py:606-618)
        self.all_moves = {}
        counts = {}
        for move in self.moves + self.rj_moves:
            base = type(move).__name__
            i = counts.get(base, 0)
            counts[base] = i + 1
            self.all_moves[f"{base}_{i}"] = move

        # ---- evaluators ----------------------------------------------------
        self.log_like_fn = log_like_fn
        self.lnprob_args = args
        self.lnprob_kwargs = kwargs
        self._prior_eval = PriorEvaluator(self.priors, self.dtype)
        self._like_eval = LikelihoodEvaluator(
            log_like_fn,
            branch_names=branch_names,
            ndims=ndims,
            nleaves_max=nleaves_max,
            nleaves_min=nleaves_min,
            args=args,
            kwargs=kwargs,
            vectorize=vectorize,
            provide_groups=provide_groups,
            provide_supplemental=provide_supplemental,
            fill_zero_leaves_val=fill_zero_leaves_val,
            rj=self.has_reversible_jump,
            dtype=self.dtype,
            pool=pool,
        )

        # hooks
        self.update_fn = update_fn
        self.update_iterations = update_iterations
        self.stopping_fn = stopping_fn
        self.stopping_iterations = stopping_iterations
        self.plot_iterations = plot_iterations
        self.plot_generator = plot_generator

        # ---- RNG ------------------------------------------------------------
        # default PRNG is XLA's random-bit generator ("rbg", typed keys);
        # pass prng_impl="threefry2x32" for jax-default draws
        if seed is None:
            seed = int(np.random.randint(0, 2**31 - 1))
        self._prng_impl = prng_impl
        self._key = jax.random.key(seed, impl=prng_impl)

        # ---- backend ---------------------------------------------------------
        if backend is None:
            # store in the compute dtype: the device chain IS float32 by
            # default, so a float64 backend would only burn host memory and
            # flush time on a lossless upcast.
            #
            # On an accelerator backend the default is the HBM-resident
            # DeviceBackend: chain segments append at memory bandwidth and
            # getters/diagnostics transfer only what they read — on a
            # bandwidth-constrained host link the out-of-the-box stored run
            # then samples at the compute rate, not the wire rate.  A
            # 4 GiB HBM budget triggers automatic host offload; pass an
            # explicit Backend()/DeviceBackend() to override.
            if not self._has_host_moves and jax.default_backend() not in (
                "cpu",
            ):
                from .backends import DeviceBackend

                self.backend = DeviceBackend(
                    dtype=np.dtype(self.dtype),
                    max_device_bytes=4 << 30,
                )
            else:
                self.backend = Backend(dtype=np.dtype(self.dtype))
        elif isinstance(backend, str):
            self.backend = HDFBackend(backend)
        else:
            self.backend = backend

        self._previous_state = None
        self._host_supps = {}
        if not self.backend.initialized:
            self._reset_backend()
        else:
            # resume path (ref ensemble.py:605-652): validate move keys,
            # prior key order, and shape before restoring state + RNG
            if self.track_moves:
                backend_move_keys = getattr(self.backend, "move_keys", None)
                if backend_move_keys is not None:
                    ours = list(self.all_moves.keys())
                    theirs = list(backend_move_keys)
                    if len(ours) != len(theirs) or any(
                        k not in theirs for k in ours
                    ):
                        raise ValueError(
                            "Configuration of moves has changed. Cannot use "
                            "the same backend. Declare a new backend and "
                            "start from the previous state. If you would "
                            "prefer not to track move acceptance fraction, "
                            "set track_moves to False in the EnsembleSampler."
                        )
            backend_key_order = getattr(self.backend, "key_order", None)
            if backend_key_order:
                if _normalize_key_order(
                    {
                        n: v
                        for n, v in self.key_order.items()
                        if n in backend_key_order
                    }
                ) != _normalize_key_order(backend_key_order):
                    raise ValueError(
                        "Input key order from priors does not match backend."
                    )
            if self.backend.shape != self.shape:
                raise ValueError(
                    f"Backend shape {self.backend.shape} incompatible with "
                    f"sampler shape {self.shape}."
                )
            if self.backend.iteration > 0:
                self._previous_state = self.backend.get_last_sample()
                rs = getattr(self.backend, "random_state", None)
                if rs is not None:
                    self._key = self._wrap_key(rs)
                clock_getter = getattr(
                    self.backend, "get_sampler_clock", None
                )
                clock = clock_getter() if clock_getter is not None else None
                if clock is not None and self.temperature_control is not None:
                    # continue ladder adaptation (and DEO parity) where the
                    # checkpointed run left off
                    self.temperature_control.time = clock

        # default runtime plot generator (ref ensemble.py:660-674)
        if self.plot_iterations > 0 and self.plot_generator is None:
            from .utils.plot import PlotContainer

            self.plot_generator = PlotContainer(
                fp="output",
                backend=self.backend,
                plot_dir=plot_folder or ".",
                which_plots=("base", "tempering", "rj")
                if self.ntemps > 1
                else ("base",),
            )

        # per-device-segment counters
        self._reset_move_counters()
        self._step_cache = {}
        self._kernel_states = None
        #: mesh the ensemble state is sharded over (None = single device);
        #: detected from the concrete state at dispatch time
        self._sharding_mesh = None
        # max stored iterations buffered on device per dispatch.  Larger
        # segments amortize per-dispatch fixed costs; host backends flush
        # each segment's chain overlapped with the next segment's compute
        # (and the tapered tail keeps the final, unoverlappable flush at
        # ~64 steps), so they also afford long segments (a 2048-step
        # north-star segment is ~60 MB of packed snapshot).  Device-resident
        # backends never ship the snapshot to the host at all, so their
        # segment length is sized to a ~256 MB packed buffer (pow2-floored,
        # clamped to [1024, 8192]): small ensembles get single-dispatch
        # 8192-step segments, LISA-scale ensembles stay within HBM.
        if getattr(self.backend, "device_resident", False):
            itemsize = np.dtype(self.dtype).itemsize
            bytes_per_step = 0
            for n in self.branch_names:
                nt_, nw_, nl_, nd_ = self.shape[n]
                bytes_per_step += nt_ * nw_ * nl_ * nd_ * itemsize  # coords
                bytes_per_step += nt_ * nw_ * nl_  # u8 inds
            # log_like, log_prior, accepted (+swaps u8, betas — minor)
            bytes_per_step += 3 * self.ntemps * self.nwalkers * itemsize
            cap = max(1, int((256 << 20) // max(bytes_per_step, 1)))
            self._max_segment = min(8192, max(1024, 1 << (cap.bit_length() - 1)))
        else:
            self._max_segment = 2048
        from .utils.profiling import SegmentTimer

        #: per-segment wall-time / throughput instrumentation
        self.timing = SegmentTimer()

    # ------------------------------------------------------------------
    @staticmethod
    def _normalize_per_branch(value, branch_names, label):
        if isinstance(value, (int, np.integer)):
            # a scalar broadcasts to every branch (ref ensemble.py:277-317)
            return {bn: int(value) for bn in branch_names}
        if isinstance(value, (list, np.ndarray)):
            if len(branch_names) != len(value):
                raise ValueError(
                    f"{label} list has {len(value)} entries for "
                    f"{len(branch_names)} branches."
                )
            return {bn: int(v) for bn, v in zip(branch_names, value)}
        if isinstance(value, dict):
            for key_name in value:
                if key_name not in branch_names:
                    raise ValueError(
                        f"{key_name} is in {label} but does not appear in "
                        f"branch_names: {branch_names}."
                    )
            return {k: int(v) for k, v in value.items()}
        raise ValueError(f"{label} must be a scalar int, list or dict.")

    @property
    def priors(self):
        """Per-branch prior containers.  The setter normalizes like the
        reference's priors property (ref ensemble.py:715-757), so assigning
        a bare dict of distributions after construction keeps working."""
        return self._priors

    @priors.setter
    def priors(self, priors):
        self._priors = self._normalize_priors(priors)

    def _normalize_priors(self, priors):
        if isinstance(priors, ProbDistContainer):
            return {self.branch_names[0]: priors}
        if isinstance(priors, dict):
            out = {}
            for name, val in priors.items():
                if isinstance(val, ProbDistContainer):
                    out[name] = val
                elif isinstance(val, dict):
                    out[name] = ProbDistContainer(val)
                elif hasattr(val, "logpdf"):
                    # a bare distribution over the branch's full parameter
                    # vector (e.g. scipy multivariate_normal), accepted by
                    # the reference's priors setter (ref ensemble.py:740-742)
                    out[name] = ProbDistContainer(
                        {tuple(range(self.ndims[name])): val}
                    )
                else:
                    raise ValueError(
                        "priors dict values must be ProbDistContainer, a dict "
                        "of distributions, or an object with .logpdf."
                    )
            # single flat dict of dists for a single branch
            if set(out.keys()) - set(self.branch_names):
                raise ValueError(
                    f"priors keys {list(out)} do not match branch_names "
                    f"{self.branch_names}."
                )
            return out
        raise ValueError("priors must be a ProbDistContainer or dict.")

    def _parse_moves(self, moves):
        if not isinstance(moves, (list, tuple)):
            moves = [moves]
        move_list, weights = [], []
        for entry in moves:
            if isinstance(entry, tuple):
                move, w = entry
            else:
                move, w = entry, 1.0
            move_list.append(move)
            weights.append(float(w))
        total = sum(weights)
        return move_list, [w / total for w in weights]

    def _parse_rj_moves(self, rj_moves):
        from .moves import DistributionGenerateRJ

        if isinstance(rj_moves, bool):
            if not rj_moves:
                return [], []
            move = DistributionGenerateRJ(
                self.priors,
                nleaves_max=self.nleaves_max,
                nleaves_min=self.nleaves_min,
            )
            return [move], [1.0]
        if isinstance(rj_moves, str):
            if rj_moves == "together":
                return self._parse_rj_moves(True)
            if rj_moves == "iterate_branches":
                out = [
                    DistributionGenerateRJ(
                        {name: self.priors[name]},
                        nleaves_max={name: self.nleaves_max[name]},
                        nleaves_min={name: self.nleaves_min[name]},
                        proposal_branch_names=[name],
                    )
                    for name in self.branch_names
                ]
                return out, [1.0 / len(out)] * len(out)
            if rj_moves == "separate_branches":
                return self._parse_rj_moves("iterate_branches")
            raise ValueError(f"Unknown rj_moves mode: {rj_moves}")
        return self._parse_moves(rj_moves)

    # ------------------------------------------------------------------
    # key management
    # ------------------------------------------------------------------
    def next_key(self):
        self._key, sub = jax.random.split(self._key)
        return sub

    def set_key(self, key):
        self._key = key

    def _wrap_key(self, value):
        """Coerce raw checkpointed key data back into a typed PRNG key.
        Old chains persisted (2,)-uint32 threefry keys; new ones persist the
        key data of the sampler's impl."""
        value = jnp.asarray(value)
        if jnp.issubdtype(value.dtype, jax.dtypes.prng_key):
            return value
        impl = (
            "threefry2x32"
            if value.shape[-1] == 2 and self._prng_impl != "threefry2x32"
            else self._prng_impl
        )
        return jax.random.wrap_key_data(
            value.astype(jnp.uint32), impl=impl
        )

    @property
    def random_state(self):
        return np.asarray(jax.random.key_data(self._key))

    @random_state.setter
    def random_state(self, value):
        try:
            self._key = self._wrap_key(value)
        except Exception:
            pass

    # ------------------------------------------------------------------
    @property
    def shape(self):
        return {
            name: (self.ntemps, self.nwalkers, self.nleaves_max[name], self.ndims[name])
            for name in self.branch_names
        }

    @property
    def iteration(self):
        return self.backend.iteration

    def __getstate__(self):
        """Make the sampler picklable for process pools (ref
        ``ensemble.py:773-778`` drops the pool; here the compiled-step and
        device-counter caches are also dropped — they hold jitted
        executables and live device buffers that cannot cross a process
        boundary and rebuild lazily on the next step)."""
        d = self.__dict__.copy()
        d["pool"] = None
        d["_step_cache"] = {}
        d["_counters_dev"] = None
        # SegmentTimer may hold an open jax profiler session
        d.pop("timing", None)
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        if "timing" not in self.__dict__:
            from .utils.profiling import SegmentTimer

            self.timing = SegmentTimer()

    def _reset_backend(self):
        self.backend.reset(
            self.nwalkers,
            self.ndims,
            nleaves_max=self.nleaves_max,
            ntemps=self.ntemps,
            branch_names=self.branch_names,
            nbranches=self.nbranches,
            rj=self.has_reversible_jump,
            moves=list(self.all_moves.keys()) if self.track_moves else None,
            info=self.info,
            key_order=self.key_order,
        )

    def reset(self, **info):
        self._reset_backend()

    def _reset_move_counters(self):
        nm = len(self.moves)
        nrj = len(self.rj_moves)
        self._move_accepted = np.zeros((nm, self.ntemps, self.nwalkers))
        self._move_nprop = np.zeros((nm,))
        self._rj_move_accepted = np.zeros((nrj, self.ntemps, self.nwalkers))
        self._rj_move_nprop = np.zeros((nrj,))
        #: device-resident counter arrays reused across dispatches (rebuilt
        #: from the host mirrors when None)
        self._counters_dev = None
        #: packed device counter vector from the last segment, not yet
        #: fetched (see _materialize_counters)
        self._counters_packed = None

    def _materialize_counters(self):
        """Fold the last segment's packed device counters into the host
        mirrors and the move objects' ``accepted``/``num_proposals``.
        ONE blocking fetch, deferred to the consumers that actually read
        host counters (tune hooks, user code between yields, host-backend
        fraction bookkeeping) so the per-segment path never blocks."""
        packed = self._counters_packed
        if packed is None:
            return
        m_acc, m_np, rj_acc, rj_np = self._counters_dev
        packed = np.asarray(packed)
        sizes = np.cumsum(
            [m_acc.size, m_np.size, rj_acc.size, rj_np.size]
        )[:-1]
        a, b, c, d = np.split(packed, sizes)
        self._move_accepted = a.reshape(self._move_accepted.shape)
        self._move_nprop = b.reshape(self._move_nprop.shape)
        self._rj_move_accepted = c.reshape(self._rj_move_accepted.shape)
        self._rj_move_nprop = d.reshape(self._rj_move_nprop.shape)
        nmoves = len(self.moves)
        for i, move in enumerate(self.moves):
            move.accepted = self._move_accepted[i]
            move.num_proposals = int(self._move_nprop[i])
        for i, move in enumerate(self.rj_moves):
            move.accepted = self._rj_move_accepted[i]
            move.num_proposals = int(self._rj_move_nprop[i])
        self._counters_packed = None

    # ------------------------------------------------------------------
    # evaluation API (host-facing, ref ensemble.py:1127-1545)
    # ------------------------------------------------------------------
    def get_eval_context(self):
        return EvalContext(
            compute_log_prior=self._prior_eval,
            compute_log_like=self._like_eval,
            tempering=self.temperature_control,
            periodic=self.periodic,
            prior_containers=self.priors,
        )

    def compute_log_prior(self, coords, inds=None, supps=None, branch_supps=None):
        coords, inds = self._coerce_eval_inputs(coords, inds)
        out = self._prior_eval(coords, inds)
        return np.asarray(out)

    def compute_log_like(
        self, coords, inds=None, logp=None, supps=None, branch_supps=None
    ):
        coords, inds = self._coerce_eval_inputs(coords, inds)
        if logp is None:
            logp = self._prior_eval(coords, inds)
        else:
            logp = jnp.asarray(logp, dtype=self.dtype)
        ll, blobs = self._like_eval(coords, inds, logp)
        return np.asarray(ll), blobs

    def _coerce_eval_inputs(self, coords, inds):
        if not isinstance(coords, dict):
            coords = {self.branch_names[0]: coords}
        coords = {
            n: jnp.asarray(c, dtype=self.dtype) for n, c in coords.items()
        }
        fixed = {}
        for n, c in coords.items():
            if c.ndim == 2:
                c = c[None, :, None, :]
            elif c.ndim == 3:
                c = c[:, :, None, :]
            fixed[n] = c
        coords = fixed
        if inds is None:
            inds = {
                n: jnp.ones(c.shape[:-1], dtype=bool) for n, c in coords.items()
            }
        else:
            if not isinstance(inds, dict):
                inds = {self.branch_names[0]: inds}
            inds = {n: jnp.asarray(v).astype(bool) for n, v in inds.items()}
        return coords, inds

    def get_model(self):
        """Reference-compatible model carrier (ref ensemble.py:780-806)."""
        return Model(
            self.log_like_fn,
            self.compute_log_like,
            self.compute_log_prior,
            self.temperature_control,
            map,
            np.random,
            eval_context=self.get_eval_context(),
            sampler=self,
        )

    # ------------------------------------------------------------------
    # compiled step machinery
    # ------------------------------------------------------------------
    def _make_one_step(self, native_only=False):
        """Build the single-sampler-step function (in-model repeats + rj
        repeats + tempering) used inside all compiled segments.

        ``native_only=True`` builds the step over the NATIVE (non-host)
        move subset with renormalized weights — the compiled half of hybrid
        host-move scheduling (see ``_run_hybrid_segment``)."""
        ctx = self.get_eval_context()
        nmoves_all = len(self.moves)
        if native_only:
            # hybrid host-move scheduling: this kernel runs ONLY the native
            # moves with their weights renormalized — it executes the steps
            # whose pre-drawn move classes are all native (the per-draw
            # class plan is sampled by _run_hybrid_segment), so the subset
            # distribution is exactly the conditional one.  mstates/counter
            # indices stay ABSOLUTE so tuning state and acceptance counts
            # land on the right move objects.
            im_sel = [
                (j, m)
                for j, m in enumerate(self.moves)
                if not getattr(m, "host_move", False)
            ]
            rj_sel = [
                (j, m)
                for j, m in enumerate(self.rj_moves)
                if not getattr(m, "host_move", False)
            ]
            w_im = np.asarray(self.weights, dtype=float)[
                [j for j, _ in im_sel]
            ]
            moves = [m for _, m in im_sel]
            im_abs = [j for j, _ in im_sel]
            im_cnt = list(im_abs)
            weights = jnp.log(
                jnp.asarray(w_im / w_im.sum(), dtype=self.dtype)
            )
            rj_moves = [m for _, m in rj_sel]
            rj_abs = [nmoves_all + j for j, _ in rj_sel]
            rj_cnt = [j for j, _ in rj_sel]
            if rj_moves:
                w_rj = np.asarray(self.rj_weights, dtype=float)[rj_cnt]
                rj_weights = jnp.log(
                    jnp.asarray(w_rj / w_rj.sum(), dtype=self.dtype)
                )
            else:
                rj_weights = None
        else:
            moves = self.moves
            im_abs = list(range(nmoves_all))
            im_cnt = list(im_abs)
            weights = jnp.log(jnp.asarray(self.weights, dtype=self.dtype))
            rj_moves = self.rj_moves
            rj_abs = [nmoves_all + j for j in range(len(rj_moves))]
            rj_cnt = list(range(len(rj_moves)))
            rj_weights = (
                jnp.log(jnp.asarray(self.rj_weights, dtype=self.dtype))
                if rj_moves
                else None
            )
        num_repeats = self.num_repeats_in_model
        num_repeats_rj = self.num_repeats_rj
        nt, nw = self.ntemps, self.nwalkers

        def dispatch(
            key, state, time, mstates, move_list, log_w, counters, nprop,
            abs_idx, cnt_idx,
        ):
            key, k_idx, k_move = jax.random.split(key, 3)
            if len(move_list) == 1:
                a0, c0 = abs_idx[0], cnt_idx[0]
                state, acc, swaps, time, st = move_list[0].propose_kernel(
                    k_move, state, time, ctx, mstates[a0]
                )
                mstates = mstates[:a0] + (st,) + mstates[a0 + 1 :]
                counters = counters.at[c0].add(acc)
                nprop = nprop.at[c0].add(1.0)
            else:
                idx = jax.random.categorical(k_idx, log_w)

                def make_branch(j, m):
                    aj = abs_idx[j]

                    def br(k, s, t, ms):
                        s2, acc, sw, t2, stj = m.propose_kernel(
                            k, s, t, ctx, ms[aj]
                        )
                        ms2 = ms[:aj] + (stj,) + ms[aj + 1 :]
                        return s2, acc, sw, t2, ms2

                    return br

                branches = [make_branch(j, m) for j, m in enumerate(move_list)]
                state, acc, swaps, time, mstates = jax.lax.switch(
                    idx, branches, k_move, state, time, mstates
                )
                cnt = jnp.asarray(cnt_idx)[idx]
                counters = counters.at[cnt].add(acc)
                nprop = nprop.at[cnt].add(1.0)
            return key, state, time, acc, swaps, counters, nprop, mstates

        sharding_mesh = self._sharding_mesh

        def one_step(carry, _):
            key, state, time, m_acc, m_np, rj_acc_c, rj_np, mstates = carry
            accepted = jnp.zeros((nt, nw), dtype=self.dtype)
            swaps = jnp.zeros((max(nt - 1, 0),), dtype=self.dtype)
            for _r in range(num_repeats):
                key, state, time, acc, swaps, m_acc, m_np, mstates = dispatch(
                    key, state, time, mstates, moves, weights, m_acc, m_np,
                    im_abs, im_cnt,
                )
                accepted = accepted + acc
            if rj_moves:
                rj_accepted = jnp.zeros((nt, nw), dtype=self.dtype)
                for _r in range(num_repeats_rj):
                    (
                        key,
                        state,
                        time,
                        racc,
                        _rswaps,
                        rj_acc_c,
                        rj_np,
                        mstates,
                    ) = dispatch(
                        key,
                        state,
                        time,
                        mstates,
                        rj_moves,
                        rj_weights,
                        rj_acc_c,
                        rj_np,
                        rj_abs,
                        rj_cnt,
                    )
                    rj_accepted = rj_accepted + racc
            else:
                rj_accepted = jnp.zeros((0, 0), dtype=self.dtype)
            if sharding_mesh is not None:
                # anchor the carry: XLA must keep the (temp, walker) layout
                # across steps instead of silently resharding mid-scan
                from .parallel.mesh import constrain_state

                state = constrain_state(state, sharding_mesh)
            new_carry = (key, state, time, m_acc, m_np, rj_acc_c, rj_np, mstates)
            return new_carry, (accepted, rj_accepted, swaps)

        return one_step

    def _build_bulk_fn(self, nstored, thin_by, store, native_only=False):
        """Compile ``nstored * thin_by`` sampler steps as a nested lax.scan:
        the inner scan runs ``thin_by`` steps, the outer scan stacks one
        device-side snapshot per stored iteration.  One dispatch per segment —
        the chain buffer lives in HBM until the host flush."""
        one_step = self._make_one_step(native_only=native_only)
        inds_change = self._inds_change
        if store:
            # snapshots are packed into ONE float buffer + ONE uint8 buffer
            # per step: the device->host path moves a single large 2-D
            # (nstored, packed) array instead of many small-strided 5-D
            # leaves, and per-leaf transfer latency is paid once
            names = list(self.branch_names)
            nt, nw = self.ntemps, self.nwalkers
            fp_layout = [
                (
                    "coords",
                    n,
                    (nt, nw, self.nleaves_max[n], self.ndims[n]),
                )
                for n in names
            ] + [
                ("log_like", None, (nt, nw)),
                ("log_prior", None, (nt, nw)),
                ("betas", None, (nt,)),
                ("swaps", None, (max(nt - 1, 0),)),
            ]
            u8_layout = [("accepted", None, (nt, nw))]
            if self.has_reversible_jump:
                u8_layout.append(("rj_accepted", None, (nt, nw)))
            if inds_change:
                u8_layout += [
                    ("inds", n, (nt, nw, self.nleaves_max[n])) for n in names
                ]
            self._snap_layout = (fp_layout, u8_layout)

        def stored_block(carry, _):
            if thin_by == 1:
                # flat path: a nested length-1 scan adds per-step loop
                # machinery XLA does not always elide
                carry, (accepted, rj_accepted, swaps) = one_step(carry, None)
            else:
                carry, outs = jax.lax.scan(
                    one_step, carry, None, length=thin_by
                )
                accepted, rj_accepted, swaps = (o[-1] for o in outs)
            key, state, time, m_acc, m_np, rj_acc_c, rj_np, mstates = carry
            if store:
                # keep the transfer lean: accept counts fit uint8 (bounded by
                # num_repeats); per-move counters are NOT snapshotted per step
                # (only segment-final values persist in the backend); leaf
                # masks are only snapshotted when an RJ move can flip them
                # (otherwise they are constant and the host already has them)
                fp = jnp.concatenate(
                    [
                        state.branches_coords[n].reshape(-1)
                        for n in self.branch_names
                    ]
                    + [
                        state.log_like.reshape(-1),
                        state.log_prior.reshape(-1),
                        state.betas.reshape(-1).astype(self.dtype),
                        swaps.reshape(-1),
                    ]
                )
                u8_parts = [accepted.astype(jnp.uint8).reshape(-1)]
                if self.has_reversible_jump:
                    u8_parts.append(rj_accepted.astype(jnp.uint8).reshape(-1))
                if inds_change:
                    u8_parts += [
                        state.branches_inds[n].astype(jnp.uint8).reshape(-1)
                        for n in self.branch_names
                    ]
                snap = {"fp": fp, "u8": jnp.concatenate(u8_parts)}
                if state.blobs is not None:
                    snap["blobs"] = state.blobs
            else:
                snap = None
            return carry, snap

        def bulk(key, state, time, m_acc, m_np, rj_acc_c, rj_np, mstates):
            carry = (key, state, time, m_acc, m_np, rj_acc_c, rj_np, mstates)
            carry, snaps = jax.lax.scan(stored_block, carry, None, length=nstored)
            # per-move counters packed into ONE host-fetchable vector: each
            # device->host transfer pays a fixed latency, so 4 small fetches
            # per segment would cost more than the whole counter payload
            counters = jnp.concatenate(
                [jnp.reshape(c, (-1,)) for c in carry[3:7]]
            )
            # everything a device-resident backend needs per segment,
            # computed INSIDE this dispatch: the per-segment save path then
            # issues ZERO further device ops, each of which would pay its
            # own dispatch latency
            extras = None
            if store:
                nt_, nw_ = self.ntemps, self.nwalkers
                extras = {
                    "accepted_sum": snaps["u8"][:, : nt_ * nw_]
                    .astype(self.dtype)
                    .sum(0)
                    .reshape(nt_, nw_)
                }
                if self.has_reversible_jump:
                    extras["rj_accepted_sum"] = (
                        snaps["u8"][:, nt_ * nw_ : 2 * nt_ * nw_]
                        .astype(self.dtype)
                        .sum(0)
                        .reshape(nt_, nw_)
                    )
                if nt_ > 1:
                    # swaps are the last fp_layout entry
                    sw_size = nt_ - 1
                    sw = snaps["fp"][:, -sw_size:]
                    extras["swaps_accepted_sum"] = sw.sum(0)
                    extras["swaps_last"] = sw[-1]
                if self.track_moves:
                    m_acc_f, m_np_f, rj_acc_f, rj_np_f = carry[3:7]
                    fr_m = m_acc_f / jnp.maximum(m_np_f, 1.0).reshape(
                        -1, 1, 1
                    )
                    fr_rj = rj_acc_f / jnp.maximum(rj_np_f, 1.0).reshape(
                        -1, 1, 1
                    )
                    # pre-sliced per move: slicing inside jit is free;
                    # outside it would be one dispatched op per move
                    extras["fr_moves"] = tuple(
                        fr_m[i] for i in range(fr_m.shape[0])
                    )
                    extras["fr_rj"] = tuple(
                        fr_rj[i] for i in range(fr_rj.shape[0])
                    )
                extras["key_data"] = jax.random.key_data(carry[0])
            return carry, snaps, counters, extras

        return jax.jit(bulk)

    def _get_bulk_fn(self, nstored, thin_by, store, native_only=False):
        cache_key = (nstored, thin_by, store, native_only, self._sharding_mesh)
        fn = self._step_cache.get(cache_key)
        if fn is None:
            fn = self._build_bulk_fn(
                nstored, thin_by, store, native_only=native_only
            )
            self._step_cache[cache_key] = fn
        return fn

    def _detect_sharding(self, state):
        """Detect a multi-device NamedSharding on the concrete state and
        tell the temperature control, whose swap cascade takes its
        boundary-local form on a mesh."""
        from .parallel.mesh import mesh_of_state

        try:
            mesh = mesh_of_state(state)
        except Exception:
            mesh = None
        if mesh is not self._sharding_mesh:
            self._sharding_mesh = mesh
            if self.temperature_control is not None:
                self.temperature_control.sharding_active = mesh is not None

    def _inject_prov(self, state):
        """Add an identity ``__prov__`` index to the state supplemental: the
        swap cascade permutes it with everything else, so at segment end it
        holds the composed (temp, walker) source index of every slot —
        exactly what host-side object supplementals need to follow their
        walkers."""
        from .state import BranchSupplemental

        nt, nw = self.ntemps, self.nwalkers
        prov = jnp.arange(nt * nw, dtype=jnp.int32).reshape(nt, nw)
        supp = state.supplemental
        holder = dict(supp.holder) if supp is not None else {}
        holder["__prov__"] = prov
        return state.replace(
            supplemental=BranchSupplemental(holder, base_shape=(nt, nw))
        )

    def _apply_prov(self, state):
        """Reorder host-side object supplementals by the segment's composed
        swap permutation and re-attach them to the live state containers."""
        from .state import BranchSupplemental

        nt, nw = self.ntemps, self.nwalkers
        supp = state.supplemental
        prov = None
        if supp is not None and "__prov__" in getattr(supp, "holder", {}):
            prov = np.asarray(supp.holder.pop("__prov__")).ravel()
            if np.array_equal(prov, np.arange(nt * nw)):
                prov = None
        if prov is not None:
            for holder in self._host_supps.values():
                for key, arr in list(holder.items()):
                    flat = arr.reshape((nt * nw,) + arr.shape[2:])
                    holder[key] = flat[prov].reshape(arr.shape)
        host_state = self._host_supps.get("__state__")
        if host_state is not None:
            if supp is None:
                supp = BranchSupplemental({}, base_shape=(nt, nw))
                state.supplemental = supp
            supp.host_holder = host_state
        elif supp is not None and not supp.holder:
            state.supplemental = None
        for name, holder in self._host_supps.items():
            if name == "__state__":
                continue
            b = state.branches[name]
            if b.supplemental is None:
                b.supplemental = BranchSupplemental({}, base_shape=(nt, nw))
            b.supplemental.host_holder = holder
        return state

    def initial_step_carry(self, key, state, time):
        """Zero-initialized carry in the layout consumed by
        ``_make_one_step``: ``(key, state, time, per-move accept counters,
        per-move proposal counts, rj counterparts, kernel states)``.
        Exists so external drivers (e.g. the compile-check entry point)
        never hand-encode the private carry structure."""
        nm, nrj = len(self.moves), len(self.rj_moves)

        def z(*sh):
            return jnp.zeros(sh, dtype=self.dtype)

        kernel_states = tuple(
            m.init_kernel_state(state) for m in self.moves + self.rj_moves
        )
        return (
            key,
            state,
            time,
            z(nm, self.ntemps, self.nwalkers),
            z(nm),
            z(nrj, self.ntemps, self.nwalkers),
            z(nrj),
            kernel_states,
        )

    def _init_kernel_states(self, state):
        """Fresh per-move kernel states, or — on a resumed backend — the
        checkpointed ones (tuned step sizes/trajectory lengths/slice
        scales/adaptation clocks survive a process restart; beyond the
        reference, whose tuning state lives only on in-memory move
        objects).  Stored leaves are validated leaf-by-leaf against the
        fresh structure; any mismatch (move config changed) falls back to
        fresh initialization with a warning."""
        fresh = tuple(
            m.init_kernel_state(state) for m in self.moves + self.rj_moves
        )
        try:
            getter = getattr(self.backend, "get_kernel_states", None)
            stored = getter() if getter is not None else None
            if stored is None or self.backend.iteration == 0:
                return fresh
            stored_keys, stored_leaves = stored
            if stored_keys is not None and stored_keys != list(
                self.all_moves.keys()
            ):
                raise ValueError("move keys changed")
            if len(stored_leaves) != len(fresh):
                raise ValueError("move count changed")
            out = []
            for f, leaves in zip(fresh, stored_leaves):
                f_leaves, treedef = jax.tree_util.tree_flatten(f)
                if len(leaves) != len(f_leaves):
                    raise ValueError("kernel-state structure changed")
                coerced = []
                for a, b in zip(f_leaves, leaves):
                    if b is None or getattr(
                        np.asarray(b), "dtype", None
                    ) == np.dtype(object):
                        # unpersistable (object-dtype) leaf: keep fresh
                        coerced.append(a)
                        continue
                    b = jnp.asarray(b)
                    a_arr = jnp.asarray(a)
                    if a_arr.shape != b.shape:
                        raise ValueError("kernel-state shape changed")
                    coerced.append(b.astype(a_arr.dtype))
                out.append(jax.tree_util.tree_unflatten(treedef, coerced))
            return tuple(out)
        except Exception as err:  # noqa: BLE001 — degrade, don't die
            warnings.warn(
                "Stored move kernel states are incompatible with the "
                f"current move configuration ({err}); proposal tuning "
                "state restarts fresh on this resume.",
                stacklevel=2,
            )
            return fresh

    def _seed_host_kernel_states(self, state):
        """Host-step mode initializes per-move kernel state lazily inside
        ``propose()``; seed it from the checkpoint so resumed runs keep
        their tuned proposal state."""
        if not (
            self._has_host_moves
            and self._kernel_states is None
            and self.backend.initialized
            and self.backend.iteration > 0
        ):
            return
        self._kernel_states = self._init_kernel_states(state)
        nm = len(self.moves)
        for i, m in enumerate(self.moves):
            if getattr(m, "_host_kernel_state", None) is None:
                m._host_kernel_state = self._kernel_states[i]
        for i, m in enumerate(self.rj_moves):
            if getattr(m, "_host_kernel_state", None) is None:
                m._host_kernel_state = self._kernel_states[nm + i]

    def _finalize_kernel_states(self, state, store):
        """Checkpoint the current kernel states (once, at run end — the
        leaves are small but fetching them per segment would add blocking
        device round-trips to the hot path).  Host-step mode reassembles
        the tuple from the per-move copies first; moves never proposed
        this run keep their previous (or fresh) state."""
        if self._has_host_moves:
            host = [
                getattr(m, "_host_kernel_state", None)
                for m in self.moves + self.rj_moves
            ]
            if any(ks is not None for ks in host):
                base = self._kernel_states or tuple(
                    m.init_kernel_state(state)
                    for m in self.moves + self.rj_moves
                )
                self._kernel_states = tuple(
                    h if h is not None else b for h, b in zip(host, base)
                )
        if not store:
            return
        tc = self.temperature_control
        clock_saver = getattr(self.backend, "save_sampler_clock", None)
        if (
            tc is not None
            and clock_saver is not None
            and self.backend.initialized
        ):
            # the adaptation/DEO clock must survive a process restart or a
            # resumed run re-enters early adaptation (large vousden gain)
            # and drifts off the continuous-run beta trajectory
            clock_saver(int(np.asarray(tc.time)))
        if self._kernel_states is None:
            return
        saver = getattr(self.backend, "save_kernel_states", None)
        if saver is not None and self.backend.initialized:
            saver(self._kernel_states, move_keys=list(self.all_moves.keys()))

    def _dispatch_bulk(
        self, state, nstored, thin_by=1, store=True, native_only=False
    ):
        """Dispatch ``nstored * thin_by`` compiled steps asynchronously.

        Returns ``(carry, snaps, t0)`` of *device* arrays — nothing blocks;
        call :meth:`_sync_bulk` on the carry to commit host mirrors."""
        tc = self.temperature_control
        time = jnp.asarray(tc.time if tc is not None else 0, dtype=jnp.int32)
        if self._host_supps and self.ntemps > 1:
            state = self._inject_prov(state)
        self._detect_sharding(state)
        if self._kernel_states is None:
            self._kernel_states = self._init_kernel_states(state)
        fn = self._get_bulk_fn(nstored, thin_by, store, native_only)
        import time as _time

        if self._counters_dev is None:
            self._counters_dev = (
                jnp.asarray(self._move_accepted, dtype=self.dtype),
                jnp.asarray(self._move_nprop, dtype=self.dtype),
                jnp.asarray(self._rj_move_accepted, dtype=self.dtype),
                jnp.asarray(self._rj_move_nprop, dtype=self.dtype),
            )
        _t0 = _time.perf_counter()
        carry, snaps, counters, extras = fn(
            self._key,
            state,
            time,
            *self._counters_dev,
            self._kernel_states,
        )
        return carry, snaps, counters, extras, _t0

    def _sync_bulk(self, carry, snaps, counters, nsteps, t0, block=True):
        """Sync host mirrors after a dispatched segment.  ``snaps`` stays on
        device; device->host transfers are *started* here
        (``copy_to_host_async``) so the flush overlaps the next dispatch.

        ``block=False`` skips the ``block_until_ready`` barrier entirely:
        every host mirror below is a device value (futures chain into the
        next dispatch), so hook-free segment boundaries cost ZERO device
        round-trips — the caller records timing at its next real barrier."""
        import time as _time

        tc = self.temperature_control
        if block:
            jax.block_until_ready(carry[1].log_like)
            if t0 is not None:
                self.timing.record(nsteps, _time.perf_counter() - t0)
        (
            self._key,
            state,
            time,
            m_acc,
            m_np,
            rj_acc,
            rj_np,
            self._kernel_states,
        ) = carry

        # device counters feed the next dispatch without a host round-trip;
        # the host mirrors materialize lazily (_materialize_counters) — a
        # blocking fetch stalls the dispatch pipeline, so nothing in the
        # per-segment path is allowed to block on small arrays
        self._counters_dev = (m_acc, m_np, rj_acc, rj_np)
        self._counters_packed = counters
        nmoves = len(self.moves)
        for i, move in enumerate(self.moves):
            move._host_kernel_state = self._kernel_states[i]
        for i, move in enumerate(self.rj_moves):
            move._host_kernel_state = self._kernel_states[nmoves + i]
        if tc is not None:
            # device scalars/vectors: consumers coerce on access, and the
            # next dispatch feeds them straight back to the device
            tc.time = time
            tc.betas = state.betas

        if self._host_supps:
            state = self._apply_prov(state)

        if snaps is not None and not getattr(
            self.backend, "device_resident", False
        ):
            for leaf in jax.tree_util.tree_leaves(snaps):
                if hasattr(leaf, "copy_to_host_async"):
                    leaf.copy_to_host_async()
        return state

    def _unpack_snaps(self, snaps, xp=np, layout=None):
        """Expand packed ``{"fp", "u8"[, "blobs"]}`` snapshot buffers back
        into the named per-field dict (any number of leading batch axes).

        ``xp=np`` materializes on the host; ``xp=jnp`` keeps every field on
        device (zero-copy slicing views) for device-resident backends."""
        if snaps is None or "fp" not in snaps:
            return snaps
        fp_layout, u8_layout = (
            layout if layout is not None else self._snap_layout
        )
        out = {"coords": {}, "inds": {}}

        def split(buf, layout, post=None):
            lead = buf.shape[:-1]
            off = 0
            for kind, name, shape in layout:
                size = int(np.prod(shape))
                arr = buf[..., off : off + size].reshape(lead + shape)
                off += size
                if post is not None:
                    arr = post(kind, arr)
                if name is not None:
                    out[kind][name] = arr
                else:
                    out[kind] = arr

        split(xp.asarray(snaps["fp"]), fp_layout)
        split(
            xp.asarray(snaps["u8"]),
            u8_layout,
            post=lambda kind, a: a.astype(bool) if kind == "inds" else a,
        )
        if not out["inds"]:
            del out["inds"]
        if "blobs" in snaps:
            out["blobs"] = xp.asarray(snaps["blobs"])
        return out

    def _run_bulk(self, state, nstored, thin_by=1, store=True):
        """Run ``nstored * thin_by`` compiled steps in ONE device dispatch.

        Returns ``(state, snaps)`` with ``snaps`` a host-side dict of stacked
        per-stored-step arrays (or None when ``store=False``).  For a
        device-resident backend the snapshots stay PACKED (the in-dispatch
        extras ride along under ``"__extras__"``); ``_save_snaps`` hands
        them to the backend without issuing any further device ops."""
        carry, snaps, counters, extras, t0 = self._dispatch_bulk(
            state, nstored, thin_by, store
        )
        state = self._sync_bulk(carry, snaps, counters, nstored * thin_by, t0)
        if snaps is not None:
            # host mirrors of swap diagnostics are owned by _save_snaps
            if getattr(self.backend, "device_resident", False):
                snaps = dict(snaps)
                snaps["__extras__"] = extras
            else:
                snaps = self._unpack_snaps(
                    jax.tree_util.tree_map(np.asarray, snaps)
                )
        return state, snaps

    def _make_seg_unpacker(self):
        """Closure expanding ONE packed segment ``{"fp","u8"[,"blobs"]}``
        into the device-backend segment schema (``chain`` NaN-masked on dead
        leaves, static ``inds`` stored without the step axis).  Captures the
        layouts by value so later reconfiguration cannot corrupt segments
        already stored."""
        fp_layout, u8_layout = self._snap_layout
        branch_names = list(self.branch_names)
        inds_change = self._inds_change
        static_inds = None if inds_change else dict(self._static_inds)
        missing = self.backend.store_missing_leaves
        layout_ref = (fp_layout, u8_layout)

        def unpack(packed):
            out = self._unpack_snaps(packed, xp=jnp, layout=layout_ref)
            seg = {"chain": {}, "inds": {}}
            for n in branch_names:
                c = out["coords"][n]
                if inds_change:
                    m = out["inds"][n]
                    mask = m
                else:
                    m = jnp.asarray(static_inds[n])  # no step axis: static
                    mask = m[None]
                fill = jnp.asarray(missing, dtype=c.dtype)
                seg["chain"][n] = jnp.where(mask[..., None], c, fill)
                seg["inds"][n] = m
            seg["log_like"] = out["log_like"]
            seg["log_prior"] = out["log_prior"]
            seg["betas"] = out["betas"]
            seg["blobs"] = out.get("blobs")
            return seg

        return unpack

    def _save_snaps_packed(self, snaps):
        """Zero-device-op flush for a device-resident backend: the segment
        stays PACKED in HBM (the backend unpacks lazily on first read) and
        every per-segment reduction (counter sums, per-move fractions, the
        PRNG key snapshot) was already computed inside the bulk dispatch."""
        extras = snaps.pop("__extras__", None) or {}
        fractions = None
        if self.track_moves and "fr_moves" in extras:
            fractions = {}
            fr_m = extras["fr_moves"]
            fr_rj = extras["fr_rj"]
            for i, key_name in enumerate(self.all_moves.keys()):
                if i < len(self.moves):
                    fractions[key_name] = fr_m[i]
                else:
                    fractions[key_name] = fr_rj[i - len(self.moves)]
        nstored = int(snaps["fp"].shape[0])
        self.backend.save_segment_packed(
            nstored,
            snaps,
            self._make_seg_unpacker(),
            accepted_sum=extras.get("accepted_sum"),
            rj_accepted_sum=extras.get("rj_accepted_sum")
            if self.has_reversible_jump
            else None,
            swaps_accepted_sum=extras.get("swaps_accepted_sum")
            if self.ntemps > 1
            else None,
            moves_accepted_fraction=fractions,
            random_state=extras.get("key_data"),
        )
        tc = self.temperature_control
        if tc is not None and self.ntemps > 1 and "swaps_last" in extras:
            # device slice computed in-dispatch; host consumers coerce
            tc.swaps_accepted = extras["swaps_last"]

    def _save_snaps(self, snaps):
        """Flush a bulk segment of stored snapshots into the backend with ONE
        slab ingestion call (one HDF5 open for :class:`HDFBackend`).

        Per-move acceptance fractions use the segment-final counters: the
        backend only retains the latest value per move (matching the
        reference, which overwrites them every save).  ``snaps`` may hold
        device arrays; they are materialized here (transfers were started by
        ``_sync_bulk``, so this overlaps the next segment's device compute)."""
        device_resident = getattr(self.backend, "device_resident", False)
        if device_resident and "fp" in snaps and (
            hasattr(self.backend, "save_segment_packed")
        ):
            return self._save_snaps_packed(snaps)
        if device_resident:
            snaps = self._unpack_snaps(snaps, xp=jnp)
        else:
            snaps = self._unpack_snaps(
                jax.tree_util.tree_map(np.asarray, snaps)
            )
        if "inds" in snaps:
            inds = snaps["inds"]
        elif device_resident:
            # static masks: stored once per segment, broadcast at read time
            inds = dict(self._static_inds)
        else:
            nstored = snaps["log_like"].shape[0]
            inds = {
                n: np.broadcast_to(v, (nstored,) + v.shape)
                for n, v in self._static_inds.items()
            }
        if self.track_moves:
            fractions = {}
            if device_resident and self._counters_dev is not None:
                # fractions as DEVICE slices — two async ops, no fetch; the
                # backend's readers materialize them lazily
                m_acc, m_np, rj_acc, rj_np = self._counters_dev
                fr_m = jnp.asarray(m_acc) / jnp.maximum(
                    jnp.asarray(m_np), 1.0
                ).reshape(-1, 1, 1)
                fr_rj = jnp.asarray(rj_acc) / jnp.maximum(
                    jnp.asarray(rj_np), 1.0
                ).reshape(-1, 1, 1)
                for i, key_name in enumerate(self.all_moves.keys()):
                    if i < len(self.moves):
                        fractions[key_name] = fr_m[i]
                    else:
                        fractions[key_name] = fr_rj[i - len(self.moves)]
            else:
                self._materialize_counters()
                for i, key_name in enumerate(self.all_moves.keys()):
                    if i < len(self.moves):
                        acc = self._move_accepted[i]
                        nprop = self._move_nprop[i]
                    else:
                        acc = self._rj_move_accepted[i - len(self.moves)]
                        nprop = self._rj_move_nprop[i - len(self.moves)]
                    fractions[key_name] = acc / max(nprop, 1.0)
        else:
            fractions = None
        key_data = jax.random.key_data(self._key)
        self.backend.save_segment(
            coords=snaps["coords"],
            inds=inds,
            log_like=snaps["log_like"],
            log_prior=snaps["log_prior"],
            betas=snaps["betas"],
            blobs=snaps.get("blobs"),
            accepted=snaps["accepted"],
            rj_accepted=snaps["rj_accepted"]
            if self.has_reversible_jump
            else None,
            swaps_accepted=snaps["swaps"] if self.ntemps > 1 else None,
            moves_accepted_fraction=fractions,
            random_state=key_data
            if device_resident
            else np.asarray(key_data),
        )
        tc = self.temperature_control
        if tc is not None and self.ntemps > 1:
            # device slice; host consumers (plots, adapt_temps) coerce
            tc.swaps_accepted = snaps["swaps"][-1]
        # file-backed checkpoints also persist the adaptation clock per
        # segment (it rides the same materialization barrier as the PRNG
        # key above, so a kill inside a run resumes with a clock matching
        # the last stored segment).  Device-resident backends skip it:
        # their per-segment path is zero-device-ops by design, and an
        # in-memory backend dies with the process anyway.
        clock_saver = getattr(self.backend, "save_sampler_clock", None)
        if clock_saver is not None and not device_resident and tc is not None:
            clock_saver(int(np.asarray(tc.time)))

    # ------------------------------------------------------------------
    # host-step mode (legacy custom moves; see moves/legacy.py)
    # ------------------------------------------------------------------
    def _run_host_segment(self, state, nstored, thin_by=1, store=True):
        """Run ``nstored * thin_by`` sampler steps on the HOST, one
        ``move.propose(model, state)`` call at a time — the reference's own
        execution model (ref ``ensemble.py:963-1045``).  Engaged only when a
        reference-style custom move is configured (its host hooks cannot
        enter the compiled scan).  Returns ``(state, snaps)`` with ``snaps``
        in the unpacked per-field layout ``_save_snaps_host`` consumes."""
        model = self.get_model()
        w = np.asarray(self.weights, dtype=float)
        w = w / w.sum()
        if self.rj_moves:
            rj_w = np.asarray(self.rj_weights, dtype=float)
            rj_w = rj_w / rj_w.sum()
        nt, nw = self.ntemps, self.nwalkers
        tc = self.temperature_control

        snaps = (
            {
                "coords": {n: [] for n in self.branch_names},
                "inds": {n: [] for n in self.branch_names},
                "log_like": [],
                "log_prior": [],
                "betas": [],
                "swaps": [],
                "accepted": [],
                "rj_accepted": [],
                "blobs": [],
            }
            if store
            else None
        )
        for _ in range(nstored):
            acc_step = np.zeros((nt, nw))
            rj_acc_step = np.zeros((nt, nw))
            for _ in range(thin_by):
                for _ in range(self.num_repeats_in_model):
                    move = self.moves[np.random.choice(len(self.moves), p=w)]
                    state, acc = move.propose(model, state)
                    acc_step += np.asarray(acc)
                if self.has_reversible_jump:
                    for _ in range(self.num_repeats_rj):
                        rj_move = self.rj_moves[
                            np.random.choice(len(self.rj_moves), p=rj_w)
                        ]
                        state, acc = rj_move.propose(model, state)
                        rj_acc_step += np.asarray(acc)
            if store:
                for n in self.branch_names:
                    snaps["coords"][n].append(
                        np.asarray(state.branches_coords[n])
                    )
                    snaps["inds"][n].append(np.asarray(state.branches_inds[n]))
                snaps["log_like"].append(np.asarray(state.log_like))
                snaps["log_prior"].append(np.asarray(state.log_prior))
                betas = (
                    state.betas if state.betas is not None else
                    (tc.betas if tc is not None else np.ones(nt))
                )
                snaps["betas"].append(np.asarray(betas, dtype=float))
                swaps = (
                    np.asarray(tc.swaps_accepted, dtype=float)
                    if tc is not None and self.ntemps > 1
                    else np.zeros(max(nt - 1, 0))
                )
                snaps["swaps"].append(swaps)
                snaps["accepted"].append(acc_step)
                snaps["rj_accepted"].append(rj_acc_step)
                if state.blobs is not None:
                    snaps["blobs"].append(np.asarray(state.blobs))
        if store:
            out = {
                "coords": {
                    n: np.stack(v) for n, v in snaps["coords"].items()
                },
                "inds": {n: np.stack(v) for n, v in snaps["inds"].items()},
                "log_like": np.stack(snaps["log_like"]),
                "log_prior": np.stack(snaps["log_prior"]),
                "betas": np.stack(snaps["betas"]),
                "swaps": np.stack(snaps["swaps"]),
                "accepted": np.stack(snaps["accepted"]),
                "rj_accepted": np.stack(snaps["rj_accepted"]),
                "blobs": np.stack(snaps["blobs"]) if snaps["blobs"] else None,
            }
        else:
            out = None
        self._previous_state = state
        return state, out

    def _save_snaps_host(self, snaps):
        """Flush a host-mode segment into the backend (fractions from the
        move objects' own counters, which host propose maintains)."""
        if self.track_moves:
            fractions = {}
            for key_name, move in self.all_moves.items():
                acc = (
                    move.accepted
                    if move.accepted is not None
                    else np.zeros((self.ntemps, self.nwalkers))
                )
                fractions[key_name] = np.asarray(acc) / max(
                    move.num_proposals, 1
                )
        else:
            fractions = None
        self.backend.save_segment(
            coords=snaps["coords"],
            inds=snaps["inds"],
            log_like=snaps["log_like"],
            log_prior=snaps["log_prior"],
            betas=snaps["betas"],
            blobs=snaps.get("blobs"),
            accepted=snaps["accepted"],
            rj_accepted=snaps["rj_accepted"]
            if self.has_reversible_jump
            else None,
            swaps_accepted=snaps["swaps"] if self.ntemps > 1 else None,
            moves_accepted_fraction=fractions,
            random_state=np.asarray(jax.random.key_data(self._key)),
        )
        clock_saver = getattr(self.backend, "save_sampler_clock", None)
        tc = self.temperature_control
        if clock_saver is not None and tc is not None:
            clock_saver(int(np.asarray(tc.time)))

    # ------------------------------------------------------------------
    # hybrid host-move scheduling
    # ------------------------------------------------------------------
    def _push_host_counters(self):
        """Host ``propose()`` calls updated the move objects' counters; make
        the host mirrors authoritative so the next compiled dispatch
        re-uploads them (``_dispatch_bulk`` rebuilds ``_counters_dev`` from
        the mirrors when it is None)."""
        def rebuild(arr_a, arr_n, moves):
            # np.array: the mirrors may be read-only views of fetched
            # device buffers after _materialize_counters
            arr_a = np.array(arr_a)
            arr_n = np.array(arr_n)
            for i, m in enumerate(moves):
                if m.accepted is not None:
                    arr_a[i] = np.asarray(m.accepted)
                arr_n[i] = float(m.num_proposals)
            return arr_a, arr_n

        self._move_accepted, self._move_nprop = rebuild(
            self._move_accepted, self._move_nprop, self.moves
        )
        self._rj_move_accepted, self._rj_move_nprop = rebuild(
            self._rj_move_accepted, self._rj_move_nprop, self.rj_moves
        )
        self._counters_dev = None
        self._counters_packed = None

    def _run_native_chunk(self, state, nstored, thin_by, store):
        """One compiled bulk dispatch over the NATIVE move subset (hybrid
        scheduling).  Re-syncs kernel states from the per-move host copies
        first, since interleaved host steps may have tuned them."""
        all_moves = self.moves + self.rj_moves
        if self._kernel_states is None and any(
            getattr(m, "_host_kernel_state", None) is not None
            for m in all_moves
        ):
            # host steps already tuned some moves this run; a fresh init
            # would silently discard that state
            self._kernel_states = self._init_kernel_states(state)
        if self._kernel_states is not None:
            self._kernel_states = tuple(
                getattr(m, "_host_kernel_state", None)
                if getattr(m, "_host_kernel_state", None) is not None
                else ks
                for m, ks in zip(all_moves, self._kernel_states)
            )
        carry, snaps, counters, extras, t0 = self._dispatch_bulk(
            state, nstored, thin_by, store, native_only=True
        )
        state = self._sync_bulk(carry, snaps, counters, nstored * thin_by, t0)
        if snaps is not None:
            snaps = self._unpack_snaps(
                jax.tree_util.tree_map(np.asarray, snaps)
            )
        return state, snaps

    def _native_snaps_to_host(self, snaps, nsteps):
        """Coerce one native chunk's unpacked snapshots into the host-layout
        segment schema ``_save_snaps_host`` consumes (tile static leaf masks,
        float counters)."""
        out = {
            "coords": {n: np.asarray(c) for n, c in snaps["coords"].items()},
            "log_like": np.asarray(snaps["log_like"]),
            "log_prior": np.asarray(snaps["log_prior"]),
            "betas": np.asarray(snaps["betas"], dtype=float),
            "swaps": np.asarray(snaps["swaps"], dtype=float),
            "accepted": np.asarray(snaps["accepted"], dtype=float),
            "blobs": np.asarray(snaps["blobs"]) if "blobs" in snaps else None,
        }
        if "inds" in snaps:
            out["inds"] = {
                n: np.asarray(m) for n, m in snaps["inds"].items()
            }
        else:
            out["inds"] = {
                n: np.broadcast_to(
                    np.asarray(self._static_inds[n], dtype=bool),
                    (nsteps,) + tuple(np.shape(self._static_inds[n])),
                ).copy()
                for n in self.branch_names
            }
        out["rj_accepted"] = (
            np.asarray(snaps["rj_accepted"], dtype=float)
            if "rj_accepted" in snaps
            else np.zeros((nsteps, self.ntemps, self.nwalkers))
        )
        return out

    def _run_hybrid_segment(self, state, nstored, thin_by=1, store=True):
        """Hybrid host-move scheduling: one reference-style custom move must
        not cost the whole run the compiled path (the most common migration
        state is 1 custom + N native moves).

        The segment's per-slot move plan is pre-drawn on the host from the
        FULL weight vector.  Stored steps whose every slot drew a native
        move run as compiled bulk scans over the native subset with
        renormalized weights — exactly the conditional proposal distribution
        given the plan — while stored steps containing at least one
        host-move draw execute slot-by-slot through ``move.propose`` (the
        reference's own execution model, ref ``ensemble.py:963-1045``).
        Native runs are chunked on the power-of-two plan to bound the jit
        cache.  Returns host-layout snaps for ``_save_snaps_host``."""
        model = self.get_model()
        n_rep = self.num_repeats_in_model
        n_rj = self.num_repeats_rj if self.has_reversible_jump else 0

        w = np.asarray(self.weights, dtype=float)
        w = w / w.sum()
        im_is_host = np.asarray(
            [bool(getattr(m, "host_move", False)) for m in self.moves]
        )
        plan_im = np.random.choice(
            len(self.moves), size=(nstored, thin_by, n_rep), p=w
        )
        step_has_host = im_is_host[plan_im].any(axis=(1, 2))
        plan_rj = None
        if self.rj_moves:
            rj_w = np.asarray(self.rj_weights, dtype=float)
            rj_w = rj_w / rj_w.sum()
            rj_is_host = np.asarray(
                [bool(getattr(m, "host_move", False)) for m in self.rj_moves]
            )
            plan_rj = np.random.choice(
                len(self.rj_moves), size=(nstored, thin_by, n_rj), p=rj_w
            )
            step_has_host |= rj_is_host[plan_rj].any(axis=(1, 2))

        chunks = []  # host-layout dicts, each with a leading step axis
        i = 0
        while i < nstored:
            if not step_has_host[i]:
                k = 1
                while i + k < nstored and not step_has_host[i + k]:
                    k += 1
                for c in _segment_plan(k, self._max_segment):
                    state, snaps = self._run_native_chunk(
                        state, c, thin_by, store
                    )
                    if store:
                        chunks.append(self._native_snaps_to_host(snaps, c))
                i += k
            else:
                state, snap = self._run_host_stored_step(
                    state,
                    model,
                    plan_im[i],
                    plan_rj[i] if plan_rj is not None else None,
                    store,
                )
                if store:
                    chunks.append(snap)
                i += 1

        # fold the last native chunk's counters into the move objects so
        # _save_snaps_host's fractions (and user hooks) see current totals
        self._materialize_counters()
        self._previous_state = state
        if not store:
            return state, None

        def cat(key_name):
            return np.concatenate([c[key_name] for c in chunks], axis=0)

        out = {
            "coords": {
                n: np.concatenate([c["coords"][n] for c in chunks], axis=0)
                for n in self.branch_names
            },
            "inds": {
                n: np.concatenate([c["inds"][n] for c in chunks], axis=0)
                for n in self.branch_names
            },
            "log_like": cat("log_like"),
            "log_prior": cat("log_prior"),
            "betas": cat("betas"),
            "swaps": cat("swaps"),
            "accepted": cat("accepted"),
            "rj_accepted": cat("rj_accepted"),
            "blobs": (
                cat("blobs") if chunks[0]["blobs"] is not None else None
            ),
        }
        return state, out

    def _run_host_stored_step(self, state, model, plan_im, plan_rj, store):
        """One stored step executed slot-by-slot on the host following the
        pre-drawn move plan (rows of ``(thin_by, num_repeats)`` move
        indices).  Mirrors one iteration of ``_run_host_segment``; counters
        are pushed back to the host mirrors afterwards so the next compiled
        chunk resumes from them."""
        nt, nw = self.ntemps, self.nwalkers
        tc = self.temperature_control
        # host proposes accumulate into the move objects; fold any pending
        # device counters in first so totals stay monotonic
        self._materialize_counters()
        acc_step = np.zeros((nt, nw))
        rj_acc_step = np.zeros((nt, nw))
        thin_by = plan_im.shape[0]
        for t in range(thin_by):
            # match the compiled path's snapshot convention: the stored
            # acceptance reflects the LAST thin step
            acc_step[:] = 0.0
            rj_acc_step[:] = 0.0
            for j in plan_im[t]:
                state, acc = self.moves[int(j)].propose(model, state)
                acc_step += np.asarray(acc)
            if plan_rj is not None:
                for j in plan_rj[t]:
                    state, acc = self.rj_moves[int(j)].propose(model, state)
                    rj_acc_step += np.asarray(acc)
        self._push_host_counters()
        if not store:
            return state, None
        betas = (
            state.betas
            if state.betas is not None
            else (tc.betas if tc is not None else np.ones(nt))
        )
        swaps = (
            np.asarray(tc.swaps_accepted, dtype=float)
            if tc is not None and self.ntemps > 1
            else np.zeros(max(nt - 1, 0))
        )
        snap = {
            "coords": {
                n: np.asarray(state.branches_coords[n])[None]
                for n in self.branch_names
            },
            "inds": {
                n: np.asarray(state.branches_inds[n])[None]
                for n in self.branch_names
            },
            "log_like": np.asarray(state.log_like)[None],
            "log_prior": np.asarray(state.log_prior)[None],
            "betas": np.asarray(betas, dtype=float)[None],
            "swaps": swaps[None],
            "accepted": acc_step[None],
            "rj_accepted": rj_acc_step[None],
            "blobs": (
                np.asarray(state.blobs)[None]
                if state.blobs is not None
                else None
            ),
        }
        return state, snap

    def _blobs_example(self, state):
        """Blob exemplar for backend allocation: honor a user ``blobs_dtype``
        (ref ensemble.py:1490-1515) instead of the device array's dtype."""
        if state.blobs is None:
            return None
        if self.blobs_dtype is None:
            return state.blobs
        return np.empty(state.blobs.shape, dtype=self.blobs_dtype)

    # ------------------------------------------------------------------
    # sampling loop (ref ensemble.py:808-1125)
    # ------------------------------------------------------------------
    def _setup_state(self, initial_state, skip_initial_state_check=False):
        if initial_state is None:
            if self._previous_state is None:
                raise ValueError(
                    "Cannot have initial_state=None if run_mcmc has never "
                    "been called."
                )
            state = self._previous_state
        else:
            state = (
                initial_state
                if isinstance(initial_state, State)
                else State(initial_state)
            )
            state = State(state)

        # normalize branch coordinate arrays / dtypes / temps
        coords = {}
        inds = {}
        for name in self.branch_names:
            b = state.branches[name]
            c = jnp.asarray(b.coords, dtype=self.dtype)
            m = b.inds
            if c.shape[0] == 1 and self.ntemps > 1:
                c = jnp.tile(c, (self.ntemps, 1, 1, 1))
                m = jnp.tile(m, (self.ntemps, 1, 1))
            if c.shape != self.shape[name]:
                raise ValueError(
                    f"Branch {name} coords shape {c.shape} does not match "
                    f"expected {self.shape[name]}."
                )
            coords[name] = c
            inds[name] = m

        betas = state.betas
        if self.temperature_control is not None:
            if betas is None:
                betas = jnp.asarray(self.temperature_control.betas, dtype=self.dtype)
            else:
                # store as-is (device values stay device values — a resume
                # from our own run must not cost a blocking fetch; host
                # consumers of tc.betas coerce lazily, as after _sync_bulk)
                self.temperature_control.betas = betas
                betas = jnp.asarray(betas, dtype=self.dtype)
        else:
            betas = jnp.ones((1,), dtype=self.dtype)

        log_prior = state.log_prior
        log_like = state.log_like
        blobs = state.blobs
        if log_prior is not None and log_like is not None:
            log_prior = jnp.asarray(log_prior, dtype=self.dtype).reshape(
                self.ntemps, self.nwalkers
            )
            log_like = jnp.asarray(log_like, dtype=self.dtype).reshape(
                self.ntemps, self.nwalkers
            )
        elif log_prior is None and log_like is not None:
            # only the prior is missing: don't waste a full-ensemble
            # likelihood evaluation (+ compile) computing a discarded ll
            if "init_prior" not in self._step_cache:
                self._step_cache["init_prior"] = jax.jit(self._prior_eval)
            log_prior = self._step_cache["init_prior"](coords, inds)
            log_like = jnp.asarray(log_like, dtype=self.dtype).reshape(
                self.ntemps, self.nwalkers
            )
        else:
            from .moves.move import state_branch_supps

            if self._like_eval.mode == "callback":
                # eager host path: runs the legacy likelihood with concrete
                # arrays, which also discovers blob returns so the traced
                # path can declare static shapes (host_call docstring)
                if "init_prior" not in self._step_cache:
                    self._step_cache["init_prior"] = jax.jit(self._prior_eval)
                lp_new = self._step_cache["init_prior"](coords, inds)
                ll_new, blobs_new = self._like_eval.host_call(
                    coords, inds, lp_new, state_branch_supps(state)
                )
            else:
                if "init_eval" not in self._step_cache:
                    def _init_eval(c, i, supps):
                        lp = self._prior_eval(c, i)
                        ll, bl = self._like_eval(c, i, lp, supps)
                        return lp, ll, bl

                    self._step_cache["init_eval"] = jax.jit(_init_eval)
                lp_new, ll_new, blobs_new = self._step_cache["init_eval"](
                    coords, inds, state_branch_supps(state)
                )
            if log_prior is None:
                log_prior = lp_new
            else:
                log_prior = jnp.asarray(log_prior, dtype=self.dtype).reshape(
                    self.ntemps, self.nwalkers
                )
            if log_like is None:
                log_like = ll_new
                if blobs is None:
                    blobs = blobs_new
            else:
                log_like = jnp.asarray(log_like, dtype=self.dtype).reshape(
                    self.ntemps, self.nwalkers
                )

        # every host materialization below rides ONE batched transfer: each
        # separate blocking fetch is a host round-trip, and a resume
        # (run_mcmc(None, ...)) hits this path on every call
        check = (
            None
            if skip_initial_state_check
            else (log_like, log_prior)
        )
        # masks are constant without RJ: one host copy per run rebuilds
        # the stored-chain inds at flush time (no per-segment snapshot)
        inds_fetch = None if self._inds_change else inds
        if check is not None or inds_fetch is not None:
            if any(
                isinstance(leaf, jax.core.Tracer)
                for leaf in jax.tree_util.tree_leaves((check, inds_fetch))
            ):
                # traced setup (ParaEnsembleSampler vmaps _setup_state);
                # para skips the state check and rebuilds masks from its
                # own state at flush time
                check, inds_fetch = None, None
            else:
                check, inds_fetch = jax.device_get((check, inds_fetch))

        if check is not None:
            ll, lp = np.asarray(check[0]), np.asarray(check[1])
            if np.any(np.isnan(ll)):
                raise ValueError("The initial log_like was NaN.")
            if np.any(np.isnan(lp)) or np.all(np.isinf(lp)):
                raise ValueError("The initial log_prior was NaN or all -inf.")

        if not self._inds_change:
            self._static_inds = (
                None
                if inds_fetch is None
                else {n: np.asarray(v) for n, v in inds_fetch.items()}
            )

        # host-side object supplementals (ref state.py:84-96): registered
        # here, then reordered by the composed temperature-swap permutation
        # at every segment boundary (_sync_bulk) so they follow their walkers.
        # the registry is rebuilt per setup so a later run with a clean state
        # does not inherit a previous run's objects
        self._host_supps = {}
        supp = state.supplemental
        if supp is not None and getattr(supp, "host_holder", None):
            self._host_supps["__state__"] = supp.host_holder
        for name, bsup in state.branches_supplemental.items():
            if bsup is not None and getattr(bsup, "host_holder", None):
                self._host_supps[name] = bsup.host_holder

        return State(
            coords,
            inds=inds,
            branch_supplemental=state.branches_supplemental,
            log_like=log_like,
            log_prior=log_prior,
            betas=betas,
            blobs=blobs,
            supplemental=state.supplemental,
            random_state=None,
        )

    def sample(
        self,
        initial_state,
        iterations=1,
        tune=False,
        skip_initial_state_check=True,
        thin_by=1,
        store=True,
        progress=False,
    ):
        """Generator yielding the state every ``thin_by`` compiled steps
        (ref ``ensemble.py:808-1045``).

        ``tune=True`` fires ``move.tune(state, move.accepted)`` on every move
        that overrides the base stub, at yield boundaries (the reference
        calls it per proposal, ``ensemble.py:983-984``; here proposals run
        inside the compiled segment, so tuning uses the synced per-move
        cumulative accepted counters).  ``update_fn`` fires every
        ``update_iterations`` *proposal steps* as in the reference's
        in-``sample()`` hook (``ensemble.py:1033-1038``, which counts thin
        steps, not yields): with ``thin_by > 1`` each yield advances the
        proposal counter by ``thin_by`` and the hook fires whenever it
        crosses a multiple of ``update_iterations``.
        """
        if iterations is None and store:
            raise ValueError("Cannot have iterations be None if store == True.")

        thin_by = int(thin_by)
        if thin_by <= 0:
            raise ValueError("thin_by must be a positive integer.")

        state = self._setup_state(initial_state, skip_initial_state_check)
        self._seed_host_kernel_states(state)

        if store:
            self.backend.grow(iterations, self._blobs_example(state))

        tuned_moves = (
            [
                m
                for m in self.moves + self.rj_moves
                if type(m).tune is not Move.tune
            ]
            if tune
            else []
        )

        total = None if iterations is None else iterations * thin_by
        try:
            with get_progress_bar(progress, total) as pbar:
                iterator = count() if iterations is None else range(iterations)
                i = 0
                for _ in iterator:
                    if self._has_host_moves:
                        seg_fn = (
                            self._run_hybrid_segment
                            if self._hybrid_host
                            else self._run_host_segment
                        )
                        state, snaps = seg_fn(state, 1, thin_by, store=store)
                        if store:
                            self._save_snaps_host(snaps)
                    else:
                        state, snaps = self._run_bulk(
                            state, 1, thin_by, store=store
                        )
                        if store:
                            self._save_snaps(snaps)
                    # user code runs between yields and may read counters
                    self._materialize_counters()
                    for m in tuned_moves:
                        # tune hooks that mutate traced move config must
                        # clear sampler._step_cache (AdjustStretchProposalScale)
                        m.tune(state, m.accepted)
                    i += 1
                    if (
                        self.update_iterations > 0
                        and self.update_fn is not None
                        and _crossed((i - 1) * thin_by, i * thin_by,
                                     self.update_iterations)
                    ):
                        self.update_fn(i, state, self)
                    pbar.update(thin_by)
                    self._previous_state = state
                    yield state
        finally:
            # fires on exhaustion, break, AND abandoned generators — the
            # tuned kernel state must reach the checkpoint on every exit
            self._finalize_kernel_states(state, store)

    def run_mcmc(
        self,
        initial_state,
        nsteps,
        burn=None,
        post_burn_update=False,
        tune=False,
        skip_initial_state_check=False,
        thin_by=1,
        store=True,
        progress=False,
        segment_size=None,
    ):
        """Run the chain (ref ``ensemble.py:1047-1125``).

        Compiled execution: iterations are grouped into segments (one device
        dispatch each, chain buffered on device); host hooks (stopping,
        update, plotting) fire at the same iteration counts as the reference
        — segments default to the GCD of the hook intervals, and an explicit
        ``segment_size`` that does not divide them still fires each hook on
        the first segment boundary at or past its multiple.
        """
        import math
        import time as time_mod

        if initial_state is None:
            if self._previous_state is None:
                raise ValueError(
                    "Cannot have initial_state=None if run_mcmc has never "
                    "been called."
                )
            initial_state = self._previous_state

        state = self._setup_state(initial_state, skip_initial_state_check)
        thin_by = int(thin_by)

        self._seed_host_kernel_states(state)

        tuned_moves = (
            [
                m
                for m in self.moves + self.rj_moves
                if type(m).tune is not Move.tune
            ]
            if tune
            else []
        )

        # burn-in: compiled scans, nothing stored; thin_by is ignored while
        # burning, as documented by the reference (ensemble.py:1061,1085-1087)
        if burn is not None and burn > 0:
            for n in _segment_plan(int(burn), 4 * self._max_segment):
                if self._has_host_moves:
                    seg_fn = (
                        self._run_hybrid_segment
                        if self._hybrid_host
                        else self._run_host_segment
                    )
                    state, _ = seg_fn(state, n, 1, store=False)
                else:
                    state, _ = self._run_bulk(state, 1, n, store=False)
                if tuned_moves:
                    self._materialize_counters()
                for m in tuned_moves:
                    m.tune(state, m.accepted)
            if post_burn_update and self.update_fn is not None:
                self.update_fn(0, state, self)

        # hook-aligned segment size
        intervals = []
        if self.stopping_fn is not None and self.stopping_iterations > 0:
            intervals.append(self.stopping_iterations)
        if self.update_fn is not None and self.update_iterations > 0:
            intervals.append(self.update_iterations)
        if self.plot_generator is not None and self.plot_iterations > 0:
            intervals.append(self.plot_iterations)
        if segment_size is not None:
            seg = int(segment_size)
        elif intervals:
            seg = math.gcd(*intervals)
        else:
            seg = max(1, min(int(nsteps), self._max_segment))

        if store:
            self.backend.grow(nsteps, self._blobs_example(state))

        def plot_fires(i0, i):
            return (
                self.plot_iterations > 0
                and self.plot_generator is not None
                and _crossed(i0, i, self.plot_iterations)
            )

        def stop_fires(i0, i):
            return (
                self.stopping_iterations > 0
                and self.stopping_fn is not None
                and _crossed(i0, i, self.stopping_iterations)
            )

        def update_fires(i0, i):
            # proposal-step cadence, matching the reference's in-sample()
            # hook (ensemble.py:1033-1038); this also covers its run_mcmc
            # yield cadence, since any yield crossing of U is a proposal
            # crossing of U for every thin_by >= 1
            return (
                self.update_iterations > 0
                and self.update_fn is not None
                and _crossed(
                    i0 * thin_by, i * thin_by, self.update_iterations
                )
            )

        total = nsteps * thin_by
        i = 0
        # hook-free boundaries never block, so the final flush of a host
        # backend is the only transfer with no compute to hide behind —
        # taper the tail so that flush is ~min_seg steps, not a full segment
        taper = (
            store
            and not getattr(self.backend, "device_resident", False)
            and not self._has_host_moves
        )
        segment_plan = _segment_plan(int(nsteps), seg, taper=taper)
        pending = None  # previous segment's snaps, not yet flushed
        # zero-round-trip boundaries: timing is recorded per blocking window
        anchor = time_mod.perf_counter()
        steps_since_anchor = 0
        with get_progress_bar(progress, total) as pbar:
            while i < nsteps:
                n = segment_plan.pop(0)
                if self._has_host_moves:
                    seg_fn = (
                        self._run_hybrid_segment
                        if self._hybrid_host
                        else self._run_host_segment
                    )
                    state, snaps = seg_fn(state, n, thin_by, store=store)
                    i0, i = i, i + n
                    if store:
                        self._save_snaps_host(snaps)
                else:
                    # software pipeline: dispatch segment k+1, then flush
                    # segment k's chain to the backend while the device
                    # computes
                    carry, snaps, counters, extras, t0 = self._dispatch_bulk(
                        state, n, thin_by, store=store
                    )
                    if pending is not None:
                        self._save_snaps(pending)
                        pending = None
                    i0, i = i, i + n
                    # block only when host code at this boundary actually
                    # reads results (tuners / user hooks); otherwise the
                    # carry chains into the next dispatch as device futures
                    hook_now = (
                        bool(tuned_moves)
                        or plot_fires(i0, i)
                        or stop_fires(i0, i)
                        or update_fires(i0, i)
                    )
                    state = self._sync_bulk(
                        carry, snaps, counters, n * thin_by, None,
                        block=hook_now,
                    )
                    steps_since_anchor += n * thin_by
                    if hook_now:
                        # run_mcmc owns timing: one record per blocking
                        # window (unblocked segments have no barrier of
                        # their own to time against)
                        now = time_mod.perf_counter()
                        self.timing.record(steps_since_anchor, now - anchor)
                        anchor = now
                        steps_since_anchor = 0
                    if snaps is not None and getattr(
                        self.backend, "device_resident", False
                    ):
                        snaps = dict(snaps)
                        snaps["__extras__"] = extras
                    if store:
                        if (
                            plot_fires(i0, i)
                            or stop_fires(i0, i)
                            or update_fires(i0, i)
                            or not segment_plan
                        ):
                            # hooks read the backend; it must be current
                            self._save_snaps(snaps)
                        else:
                            pending = snaps
                pbar.update(n * thin_by)
                self._previous_state = state

                if tuned_moves or plot_fires(i0, i) or stop_fires(i0, i) or (
                    update_fires(i0, i)
                ):
                    # hooks and tuners read host-side counters
                    self._materialize_counters()
                for m in tuned_moves:
                    m.tune(state, m.accepted)
                if plot_fires(i0, i):
                    self.plot_generator.generate_plot_info(burn=0, thin=1)
                if stop_fires(i0, i):
                    stop = self.stopping_fn(i, state, self)
                    if stop:
                        break
                if update_fires(i0, i):
                    self.update_fn(i, state, self)

        if pending is not None:
            self._save_snaps(pending)

        self._materialize_counters()  # final barrier: drains the queue
        if steps_since_anchor > 0:
            self.timing.record(
                steps_since_anchor, time_mod.perf_counter() - anchor
            )
        self._finalize_kernel_states(state, store)
        self._previous_state = state
        return state

    # ------------------------------------------------------------------
    # acceptance / passthrough properties (ref ensemble.py:1547-1620)
    # ------------------------------------------------------------------
    @property
    def acceptance_fraction(self):
        return self.backend.accepted / float(self.backend.iteration)

    @property
    def rj_acceptance_fraction(self):
        if not self.has_reversible_jump:
            return None
        return self.backend.rj_accepted / float(self.backend.iteration)

    @property
    def swap_acceptance_fraction(self):
        if self.ntemps == 1:
            return None
        return self.backend.swaps_accepted / float(
            self.backend.iteration * self.nwalkers
        )

    def get_chain(self, **kwargs):
        return self.backend.get_chain(**kwargs)

    def get_blobs(self, **kwargs):
        return self.backend.get_blobs(**kwargs)

    def get_log_like(self, **kwargs):
        return self.backend.get_log_like(**kwargs)

    def get_log_prior(self, **kwargs):
        return self.backend.get_log_prior(**kwargs)

    def get_log_posterior(self, **kwargs):
        return self.backend.get_log_posterior(**kwargs)

    def get_inds(self, **kwargs):
        return self.backend.get_inds(**kwargs)

    def get_nleaves(self, **kwargs):
        return self.backend.get_nleaves(**kwargs)

    def get_betas(self, **kwargs):
        return self.backend.get_betas(**kwargs)

    def get_value(self, name, **kwargs):
        return self.backend.get_value(name, **kwargs)

    def get_autocorr_time(self, **kwargs):
        return self.backend.get_autocorr_time(**kwargs)

    def get_last_sample(self, **kwargs):
        return self.backend.get_last_sample(**kwargs)
