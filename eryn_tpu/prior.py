"""Prior distributions and the :class:`ProbDistContainer`.

JAX re-design of ``/root/reference/src/eryn/prior.py:12-497``.  Every
distribution exposes two sampling paths:

* the Eryn-compatible host path ``rvs(size=...)`` (NumPy RNG, used for
  initial-walker generation on the host), and
* a keyed, traced path ``sample(key, shape)`` used *inside* jitted kernels
  (reversible-jump birth draws, distribution-draw proposals) where the
  reference calls ``rvs`` with global NumPy state
  (``/root/reference/src/eryn/moves/distgenrj.py:196-221``).

``logpdf`` is pure ``jax.numpy`` and batch-shaped, so priors vectorize over
the whole ``(ntemps, nwalkers, nleaves_max)`` ensemble in one fused kernel
instead of the reference's per-group Python loop
(``/root/reference/src/eryn/prior.py:337-392``).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

__all__ = [
    "UniformDistribution",
    "MappedUniformDistribution",
    "LogUniformDistribution",
    "NormalDistribution",
    "MultivariateNormalDistribution",
    "uniform_dist",
    "log_uniform",
    "normal_dist",
    "mvn_dist",
    "ProbDistContainer",
]


class JaxDistribution:
    """Base class marking a distribution as JAX-traceable.

    Subclasses implement ``logpdf`` (pure jnp, batched) and
    ``sample(key, shape)`` (traced).  ``rvs(size=)`` gives Eryn-compatible
    host sampling via NumPy.
    """

    #: number of parameters this distribution covers (1 for scalar dists)
    ndim = 1
    traceable = True

    # host RNG for the compat path
    _host_rng = np.random

    def rvs(self, size=1):
        if isinstance(size, int):
            size = (size,)
        elif not isinstance(size, tuple):
            raise ValueError("size must be an integer or tuple of ints.")
        key = jax.random.PRNGKey(int(self._host_rng.randint(0, 2**31 - 1)))
        out = np.asarray(self.sample(key, size))
        return out

    def pdf(self, x):
        return jnp.exp(self.logpdf(x))

    def copy(self):
        import copy as _copy

        return _copy.deepcopy(self)


class UniformDistribution(JaxDistribution):
    """Uniform distribution on ``[min_val, max_val]``
    (ref ``prior.py:12-112``)."""

    def __init__(self, min_val, max_val, use_cupy=False, return_gpu=False):
        # `use_cupy`/`return_gpu` accepted for API parity; arrays always live
        # on the default JAX device.
        if min_val > max_val:
            min_val, max_val = max_val, min_val
        elif min_val == max_val:
            raise ValueError("Min and max values are the same.")
        self.min_val = float(min_val)
        self.max_val = float(max_val)
        self.diff = self.max_val - self.min_val
        self.pdf_val = 1.0 / self.diff
        self.logpdf_val = float(np.log(self.pdf_val))

    def logpdf(self, x):
        x = jnp.asarray(x)
        in_range = (x >= self.min_val) & (x <= self.max_val)
        return jnp.where(in_range, self.logpdf_val, -jnp.inf)

    def pdf(self, x):
        x = jnp.asarray(x)
        in_range = (x >= self.min_val) & (x <= self.max_val)
        return jnp.where(in_range, self.pdf_val, 0.0)

    def ppf(self, q):
        # namespace-following: NumPy input stays float64 (host quantile
        # transforms), tracers stay traced
        return self.min_val + q * self.diff

    def sample(self, key, shape=()):
        return jax.random.uniform(
            key, shape, minval=self.min_val, maxval=self.max_val
        )


class MappedUniformDistribution(JaxDistribution):
    """Uniform distribution remapped so in-range logpdf is exactly 0
    (ref ``prior.py:139-216``)."""

    def __init__(self, min, max, use_cupy=False, return_gpu=False):
        if min > max:
            raise ValueError("min must be less than max.")
        self.min, self.max = float(min), float(max)
        self.diff = self.max - self.min

    def logpdf(self, x):
        x = jnp.asarray(x)
        temp = 1.0 - (self.max - x) / self.diff
        in_range = (temp >= 0.0) & (temp <= 1.0)
        return jnp.where(in_range, 0.0, -jnp.inf)

    def sample(self, key, shape=()):
        temp = jax.random.uniform(key, shape)
        return self.max + (temp - 1.0) * self.diff


class LogUniformDistribution(JaxDistribution):
    """Reciprocal (log-uniform) distribution on ``[min_val, max_val]``.

    The reference returns ``scipy.stats.loguniform`` (``prior.py:115-136``);
    this is the traced equivalent: pdf(x) = 1 / (x * log(max/min)).
    (Deviation: the reference passes ``max - min`` as scipy's upper bound —
    an apparent loc/scale mix-up that silently shrinks the support; this
    implementation uses the stated ``[min, max]``.)
    """

    def __init__(self, min_val, max_val):
        if min_val > max_val:
            min_val, max_val = max_val, min_val
        if min_val <= 0:
            raise ValueError("log-uniform requires positive support.")
        self.min_val = float(min_val)
        self.max_val = float(max_val)
        self._log_ratio = float(np.log(self.max_val / self.min_val))

    def logpdf(self, x):
        x = jnp.asarray(x)
        in_range = (x >= self.min_val) & (x <= self.max_val)
        val = -jnp.log(x) - float(np.log(self._log_ratio))
        return jnp.where(in_range, val, -jnp.inf)

    def ppf(self, q):
        xp = np if isinstance(q, np.ndarray) else jnp
        return self.min_val * xp.exp(q * self._log_ratio)

    def sample(self, key, shape=()):
        u = jax.random.uniform(key, shape)
        return self.ppf(u)


class NormalDistribution(JaxDistribution):
    """Scalar normal distribution (extension; the reference relies
    on ``scipy.stats.norm`` duck-typing)."""

    def __init__(self, loc=0.0, scale=1.0):
        self.loc = float(loc)
        self.scale = float(scale)

    def logpdf(self, x):
        x = jnp.asarray(x)
        z = (x - self.loc) / self.scale
        return -0.5 * z * z - jnp.log(self.scale) - 0.5 * jnp.log(2 * jnp.pi)

    def ppf(self, q):
        if isinstance(q, np.ndarray):
            from scipy.special import ndtri  # float64 host path

            return self.loc + self.scale * ndtri(q)
        return self.loc + self.scale * jnp.sqrt(2.0) * jax.scipy.special.erfinv(
            2.0 * jnp.asarray(q) - 1.0
        )

    def sample(self, key, shape=()):
        return self.loc + self.scale * jax.random.normal(key, shape)


class MultivariateNormalDistribution(JaxDistribution):
    """Multivariate normal over a tuple prior key (the reference uses
    ``scipy.stats.multivariate_normal``; see
    ``/root/reference/tests/test_eryn.py:1235-1241``)."""

    def __init__(self, mean, cov):
        self.mean = jnp.asarray(mean, dtype=jnp.result_type(float))
        cov = jnp.asarray(cov, dtype=self.mean.dtype)
        if cov.ndim == 0:
            cov = jnp.eye(self.mean.shape[0]) * cov
        elif cov.ndim == 1:
            cov = jnp.diag(cov)
        self.cov = cov
        self.ndim = self.mean.shape[0]
        self._chol = jnp.linalg.cholesky(cov)
        self._inv = jnp.linalg.inv(cov)
        self._logdet = 2.0 * jnp.sum(jnp.log(jnp.diag(self._chol)))

    def logpdf(self, x):
        x = jnp.asarray(x)
        diff = x - self.mean
        maha = jnp.einsum(
            "...i,ij,...j->...",
            diff,
            self._inv,
            diff,
            precision=jax.lax.Precision.HIGHEST,
        )
        k = self.ndim
        return -0.5 * (maha + k * jnp.log(2 * jnp.pi) + self._logdet)

    def sample(self, key, shape=()):
        z = jax.random.normal(key, tuple(shape) + (self.ndim,))
        return self.mean + jnp.matmul(
            z, self._chol.T, precision=jax.lax.Precision.HIGHEST
        )


def uniform_dist(min, max, use_cupy=False, return_gpu=False):
    """Build a :class:`UniformDistribution` (ref ``prior.py:94-112``)."""
    return UniformDistribution(min, max)


def log_uniform(min, max):
    """Build a log-uniform distribution (ref ``prior.py:115-136``)."""
    return LogUniformDistribution(min, max)


def normal_dist(loc=0.0, scale=1.0):
    return NormalDistribution(loc, scale)


def mvn_dist(mean, cov):
    return MultivariateNormalDistribution(mean, cov)


def _is_traceable(dist):
    return getattr(dist, "traceable", False)


class ProbDistContainer:
    """Maps parameter indices (int, tuple-of-int, or named string keys) to
    distributions; mirrors ``/root/reference/src/eryn/prior.py:219-497``.

    Differences from the reference, by design:

    * ``logpdf`` accepts *any* leading batch shape ``(..., ndim)`` and is pure
      ``jax.numpy`` when every component distribution is traceable, so it can
      be vmapped/jitted over the full ensemble.
    * ``sample(key, shape)`` is the keyed, traced analogue of ``rvs``.
    * SciPy distribution objects still work through the host paths
      (``rvs``/``logpdf_host``); containers holding them report
      ``traceable == False`` and the sampler falls back to a host callback.
    """

    #: array-module compat attribute (the reference exposes ``xp`` as its
    #: NumPy/CuPy switch, ``prior.py:324-335``; here host paths are NumPy)
    xp = np

    def __init__(self, priors_in: dict, use_cupy=False, return_gpu=False):
        self.priors_in = dict(priors_in)
        self.priors = []

        has_strings = False
        has_ints = False
        current_ind = 0
        key_order = []

        temp_inds = []
        for inds, dist in priors_in.items():
            if isinstance(inds, tuple):
                inds_tmp = []
                for i, sub in enumerate(inds):
                    if isinstance(sub, str):
                        assert not has_ints
                        has_strings = True
                        inds_tmp.append(current_ind)
                        key_order.append(sub)
                    elif isinstance(sub, int):
                        assert not has_strings
                        has_ints = True
                        inds_tmp.append(sub)
                    else:
                        raise ValueError(
                            "Index in tuple must be int or str and all be the "
                            "same type."
                        )
                    current_ind += 1
                inds_in = np.asarray(inds_tmp)
                self.priors.append([inds_in, dist])
            elif isinstance(inds, int):
                has_ints = True
                assert not has_strings
                self.priors.append([np.array([inds]), dist])
                current_ind += 1
            elif isinstance(inds, str):
                assert not has_ints
                has_strings = True
                key_order.append(inds)
                self.priors.append([np.array([current_ind]), dist])
                current_ind += 1
            else:
                raise ValueError(
                    "Keys for prior dictionary must be an integer, string, or "
                    "tuple."
                )
            temp_inds.append(np.asarray(self.priors[-1][0]))

        self.has_strings = has_strings
        self.has_ints = has_ints
        if has_strings:
            self.key_order = key_order
        else:
            self.key_order = list(range(current_ind))

        all_inds = np.concatenate(temp_inds)
        uni_inds = np.unique(all_inds)
        if len(uni_inds) != uni_inds.max() + 1:
            raise ValueError(
                "Please ensure all sampled parameters are included in priors."
            )
        if len(all_inds) != len(uni_inds):
            # overlap would double-count the shared dimension's logpdf —
            # a silently wrong posterior, so fail at construction
            raise ValueError(
                "Parameter indices overlap between priors; each sampled "
                "dimension must appear in exactly one prior."
            )
        self.ndim = int(uni_inds.max() + 1)
        self.use_cupy = use_cupy

        # fast path: all-scalar-uniform containers fuse into one vector op
        self._fused_uniform = None
        if all(
            isinstance(d, UniformDistribution) and len(inds) == 1
            for inds, d in self.priors
        ) and len(self.priors) == self.ndim:
            mins = np.zeros(self.ndim)
            maxs = np.zeros(self.ndim)
            logvals = np.zeros(self.ndim)
            for inds, d in self.priors:
                mins[inds[0]] = d.min_val
                maxs[inds[0]] = d.max_val
                logvals[inds[0]] = d.logpdf_val
            self._fused_uniform = (
                jnp.asarray(mins),
                jnp.asarray(maxs),
                jnp.asarray(logvals),
            )

    @property
    def traceable(self):
        return all(_is_traceable(d) for _, d in self.priors)

    # ------------------------------------------------------------------
    def logpdf(self, x, keys=None):
        """Summed logpdf over component distributions.

        Accepts ``x`` with any leading batch shape ``(..., ndim)``; fully
        traced when all components are traceable (ref ``prior.py:337-392``).
        """
        x = jnp.asarray(x)
        squeeze_scalar = x.ndim == 1
        batch_shape = x.shape[:-1]

        if self._fused_uniform is not None and keys is None:
            mins, maxs, logvals = self._fused_uniform
            in_range = (x >= mins) & (x <= maxs)
            per_dim = jnp.where(in_range, logvals.astype(x.dtype), -jnp.inf)
            return per_dim.sum(axis=-1)

        total = jnp.zeros(batch_shape, dtype=x.dtype)
        for inds, dist in self.priors:
            if keys is not None and not self._key_selected(inds, keys):
                continue
            vals_in = x[..., inds]
            if len(inds) == 1:
                vals_in = vals_in[..., 0]
            fn = getattr(dist, "logpdf", None) or dist.logpmf
            if _is_traceable(dist):
                lp = fn(vals_in)
            else:
                # host-only distribution (e.g. scipy): not traceable
                lp = jnp.asarray(np.asarray(fn(np.asarray(vals_in))))
                lp = lp.reshape(batch_shape)
            total = total + lp
        if squeeze_scalar:
            return total  # 0-d array; .item() on host if needed
        return total

    def _key_selected(self, inds, keys):
        if len(inds) > 1:
            return tuple(inds) in keys
        return inds[0] in keys

    def ppf(self, x, keys=None):
        """Per-parameter inverse CDF (quantile function) — unimplemented in
        the reference (``prior.py:394-405`` raises); provided here because
        quantile transforms are how you build stratified/low-discrepancy
        walker initializations.

        Args:
            x: quantiles in [0, 1], shaped ``(..., ndim)`` (or ``(...,)``
                with ``keys`` selecting a single parameter).
            keys: optional iterable restricting which parameter keys to
                transform (same semantics as :meth:`logpdf`).

        Returns:
            Array shaped like ``x`` with each selected column mapped
            through its distribution's ``ppf``.  Multivariate (tuple-key)
            distributions are rejected — a joint quantile transform is not
            defined per coordinate.
        """
        x = np.asarray(x)
        if keys is not None:
            keys = list(keys)  # materialize: generators survive only one pass
        single = x.ndim == 0 or (
            keys is not None and len(keys) == 1 and x.shape[-1:] != (self.ndim,)
        )
        vals = np.array(x, dtype=np.float64, ndmin=1)
        out = np.array(vals, copy=True)
        for inds, dist in self.priors:
            if keys is not None and not self._key_selected(inds, keys):
                continue
            if len(inds) > 1:
                raise ValueError(
                    "ppf is per-parameter; the multivariate distribution "
                    f"over indices {tuple(inds)} has no coordinate-wise "
                    "quantile function."
                )
            if not hasattr(dist, "ppf"):
                raise TypeError(
                    f"Distribution for index {inds[0]} has no ppf."
                )
            col = vals if single else vals[..., inds[0]]
            res = np.asarray(dist.ppf(col))
            if single:
                out = res
            else:
                out[..., inds[0]] = res
        return out

    def rvs_stratified(self, size=1, seed=None):
        """Latin-hypercube prior draw (beyond the reference) — the
        stratified walker initialization :meth:`ppf` exists for.

        Each parameter's N samples occupy the N equal-probability quantile
        strata exactly once (one uniform jitter per stratum, strata
        independently permuted across parameters), so the initial ensemble
        covers every prior marginal with maximal uniformity instead of the
        clumping of iid draws — fewer stranded walkers on wide priors.
        Multivariate (tuple-key) blocks have no coordinate-wise quantile
        function and fall back to iid draws.

        Args:
            size: int or tuple — leading sample shape, as :meth:`rvs`.
            seed: optional int for a reproducible draw (``None`` uses the
                global NumPy stream, like :meth:`rvs`).

        Returns:
            ``size + (ndim,)`` array.
        """
        if isinstance(size, int):
            size = (size,)
        elif not isinstance(size, tuple):
            raise ValueError("size must be an integer or tuple of ints.")
        n = int(np.prod(size))
        rng = np.random.default_rng(
            seed if seed is not None else np.random.randint(0, 2**31 - 1)
        )
        out = np.empty((n, self.ndim), dtype=np.float64)
        for inds, dist in self.priors:
            if len(inds) > 1 or not hasattr(dist, "ppf"):
                if hasattr(dist, "sample"):  # traceable dist: seeded key
                    k = jax.random.PRNGKey(int(rng.integers(0, 2**31 - 1)))
                    draws = np.asarray(dist.sample(k, (n,)))
                else:
                    draws = np.asarray(dist.rvs(size=n))
                out[:, list(inds)] = draws.reshape(n, len(inds))
                continue
            strata = (rng.permutation(n) + rng.uniform(size=n)) / n
            out[:, inds[0]] = np.asarray(dist.ppf(strata))
        return out.reshape(size + (self.ndim,))

    # ------------------------------------------------------------------
    def rvs(self, size=1, keys=None):
        """Host-side sampling with Eryn semantics (ref ``prior.py:432-497``)."""
        if isinstance(size, int):
            size = (size,)
        elif not isinstance(size, tuple):
            raise ValueError("Size must be int or tuple of ints.")
        out = np.zeros(size + (self.ndim,))
        rvs_key = None
        for inds, dist in self.priors:
            if keys is not None and not self._key_selected(inds, keys):
                continue
            if hasattr(dist, "rvs"):
                vals = np.asarray(dist.rvs(size=size))
            elif hasattr(dist, "sample"):
                # traceable-protocol distribution (sample/logpdf only):
                # draw through its keyed sampler rather than silently
                # leaving the column at zero
                if rvs_key is None:
                    rvs_key = jax.random.key(
                        int(np.random.randint(0, 2**31 - 1))
                    )
                rvs_key, sub = jax.random.split(rvs_key)
                vals = np.asarray(dist.sample(sub, size))
            else:
                raise TypeError(
                    f"Distribution for indices {inds} has neither rvs nor "
                    "sample; cannot draw from it."
                )
            if len(inds) == 1:
                out[..., inds[0]] = vals.reshape(size)
            else:
                out[..., inds] = vals.reshape(size + (len(inds),))
        return out

    def sample(self, key, shape=()):
        """Keyed, traced sampling of the full parameter vector."""
        if isinstance(shape, int):
            shape = (shape,)
        keys = jax.random.split(key, len(self.priors))
        pieces = jnp.zeros(tuple(shape) + (self.ndim,))
        for (inds, dist), k in zip(self.priors, keys):
            if not _is_traceable(dist):
                raise TypeError(
                    f"Distribution for indices {inds} is not JAX-traceable; "
                    "use .rvs on the host instead."
                )
            vals = dist.sample(k, tuple(shape))
            if len(inds) == 1:
                pieces = pieces.at[..., inds[0]].set(vals)
            else:
                pieces = pieces.at[..., jnp.asarray(inds)].set(vals)
        return pieces
