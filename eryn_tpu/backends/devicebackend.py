"""Device-resident (HBM) chain storage backend.

The reference's default in-memory backend keeps the chain in host RAM
(``/root/reference/src/eryn/backends/backend.py:196-257``) because its
compute is host-side.  Here the chain stays in device memory: stored
segments are appended on device (a device-to-device copy at memory
bandwidth), and device-to-host transfer happens **lazily, per getter
request** — a user reading the cold chain of a 10-temperature run moves a
tenth of the bytes, and a stored run samples at the compute rate instead
of the host link's rate.

Semantics match :class:`eryn_tpu.backends.backend.Backend`: same getter /
diagnostic surface, NaN-masked dead leaves, cumulative acceptance counters.
Differences:

* Chain data lives in device memory until read; every getter returns
  NumPy arrays of exactly the requested slice.
* Memory budget is device memory: at S bytes per stored step a run holds
  ``max_device_bytes / S`` steps before it offloads to host RAM.  Call
  :meth:`offload` to move everything accumulated so far into host RAM and
  keep sampling (subsequent segments stay on device until the next
  offload / read).
* Not persistent: use :class:`HDFBackend` for checkpoint/restart files.
"""

from __future__ import annotations

import numpy as np

from .backend import Backend


def _pad_steps_to_bucket(x):
    """Pad the step axis to the next power of two with the per-column
    (masked) mean so the IACT estimator compiles once per LENGTH BUCKET
    instead of once per chain length (each fresh FFT compile costs seconds;
    users call ``get_autocorr_time`` after runs of arbitrary length).

    Exactness: the estimator fills non-finite entries with the per-column
    masked mean, its autocovariances are raw sums of centered products,
    and the normalization is the ratio ``acf_k / acf_0``
    (:func:`eryn_tpu.utils.utility.get_integrated_act_jax`) — so NaN pad
    rows become the column mean, center to ~0, and contribute nothing:
    tau over the padded chain equals tau over the raw chain to float
    precision.  All-NaN columns stay all-NaN and still yield
    ``tau = NaN``.  NaN (vs precomputed-mean) padding keeps the
    per-length work to a single pad primitive; everything expensive
    specializes on the bucket only.
    """
    import jax.numpy as jnp

    n = int(x.shape[0])
    bucket = 1 << max(n - 1, 1).bit_length()
    if bucket == n:
        return x
    pad_widths = [(0, bucket - n)] + [(0, 0)] * (x.ndim - 1)
    return jnp.pad(x, pad_widths, constant_values=jnp.nan)

__all__ = ["DeviceBackend"]


class _LazySeg:
    """One stored segment kept PACKED in HBM until first read.

    The sampler's bulk dispatch emits ``{"fp", "u8"[, "blobs"]}`` buffers;
    ingesting them verbatim costs zero device ops per segment (each
    dispatched op pays its own launch latency, and an eager per-segment
    unpack+mask pipeline issues about a dozen).  Readers index this
    like the eager segment dict; the first access runs the captured
    ``unpack`` closure once and caches the expanded fields, dropping the
    packed buffers so the HBM footprint stays ~1x."""

    __slots__ = ("n", "_packed", "_unpack", "_data")

    def __init__(self, n, packed, unpack):
        self.n = int(n)
        self._packed = packed
        self._unpack = unpack
        self._data = None

    @property
    def unpacked(self):
        return self._data is not None

    def packed_nbytes(self):
        total = 0
        for arr in (self._packed or {}).values():
            total += arr.size * arr.dtype.itemsize
        return total

    def _ensure(self):
        if self._data is None:
            self._data = self._unpack(self._packed)
            self._packed = None
        return self._data

    def __getitem__(self, key):
        if key == "n":
            return self.n
        return self._ensure()[key]

    def __contains__(self, key):
        return key == "n" or key in self._ensure()


class DeviceBackend(Backend):
    """In-memory backend whose chain buffers live in device memory (see module
    docstring).  The sampler detects ``device_resident`` and hands stored
    segments over as device arrays without materializing them.

    Cumulative counters (``accepted``, ``rj_accepted``, ``swaps_accepted``)
    accumulate *on device*: ``save_segment`` dispatches one async add and
    never blocks — a blocking host round-trip per segment would stall the
    dispatch pipeline.  The host
    mirror materializes lazily on first read (acceptance-fraction
    properties, ``get_info``)."""

    device_resident = True

    _DEV_COUNTERS = ("accepted", "rj_accepted", "swaps_accepted")

    def __init__(
        self,
        store_missing_leaves=np.nan,
        dtype=None,
        max_device_bytes=None,
    ):
        """``max_device_bytes`` caps the HBM footprint: when an ingested
        segment pushes the stored chain past the cap, everything accumulated
        so far is offloaded to host RAM automatically (one bulk transfer)
        and sampling continues with a fresh device buffer."""
        self._counter_host = {}
        self._counter_dev = {}
        super().__init__(
            store_missing_leaves=store_missing_leaves, dtype=dtype
        )
        self.max_device_bytes = max_device_bytes

    # -- lazily materialized cumulative counters ------------------------
    def _counter_get(self, name):
        host = self._counter_host.get(name)
        dev = self._counter_dev.get(name)
        if dev:
            # fold the pending per-segment device sums into the host mirror
            # once, with ONE device reduction (appending per segment costs
            # no device op at all; the old running device add was one
            # dispatched op per segment)
            import jax.numpy as jnp

            folded = dev[0] if len(dev) == 1 else jnp.sum(
                jnp.stack(dev), axis=0
            )
            host = (0 if host is None else host) + np.asarray(
                folded, dtype=self.dtype
            )
            self._counter_host[name] = host
            self._counter_dev[name] = []
        return host

    def _counter_set(self, name, value):
        self._counter_host[name] = value
        self._counter_dev[name] = []

    def _counter_add_dev(self, name, seg_sum):
        self._counter_dev.setdefault(name, []).append(seg_sum)

    accepted = property(
        lambda self: self._counter_get("accepted"),
        lambda self, v: self._counter_set("accepted", v),
    )
    rj_accepted = property(
        lambda self: self._counter_get("rj_accepted"),
        lambda self, v: self._counter_set("rj_accepted", v),
    )
    swaps_accepted = property(
        lambda self: self._counter_get("swaps_accepted"),
        lambda self, v: self._counter_set("swaps_accepted", v),
    )

    def reset(self, *args, **kwargs):
        super().reset(*args, **kwargs)
        # replace the host buffers with per-segment device lists
        self.chain = None
        self.inds = None
        self.log_like = None
        self.log_prior = None
        self.betas = None
        self.blobs = None
        self._segs = []  # device segments: {"n", "chain", "inds", ...}
        self._host = None  # offloaded prefix (dict of concatenated np arrays)
        self._has_blobs = False

    # ------------------------------------------------------------------
    # ingestion
    # ------------------------------------------------------------------
    def grow(self, ngrow, blobs=None):
        if blobs is not None:
            self._has_blobs = True

    def has_blobs(self):
        return self._has_blobs

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
        """Append a segment of stored steps as *device* arrays.

        ``inds`` entries whose leading axis is 1 (or absent) are static
        masks shared by every step of the segment; they are stored once and
        broadcast at read time.
        """
        import jax.numpy as jnp

        log_like = jnp.asarray(log_like)
        n = int(log_like.shape[0])
        seg = {"n": n, "chain": {}, "inds": {}}
        for name in self.branch_names:
            c = jnp.asarray(coords[name])
            m = jnp.asarray(inds[name]).astype(bool)
            if m.ndim == c.ndim - 2:
                # no leading step axis: static mask shared by every step
                mask = m[None]
            elif m.shape[0] == 1 and n != 1:
                # leading axis of 1 on a longer segment: also static; store
                # without the step axis so reads broadcast it
                mask = m
                m = m[0]
            else:
                mask = m
            # NaN-mask dead leaves at ingestion (ref backend.py:1049-1059);
            # fill in the COORDS dtype so storage is never silently promoted
            missing = jnp.asarray(self.store_missing_leaves, dtype=c.dtype)
            c = jnp.where(mask[..., None], c, missing)
            seg["chain"][name] = c
            seg["inds"][name] = m
        seg["log_like"] = log_like
        seg["log_prior"] = jnp.asarray(log_prior)
        seg["betas"] = None if betas is None else jnp.asarray(betas)
        seg["blobs"] = None if blobs is None else jnp.asarray(blobs)
        if seg["blobs"] is not None:
            self._has_blobs = True
        self._segs.append(seg)

        # cumulative counters: one async device add each, zero host blocks
        # (the host mirror folds these in lazily on first read)
        if accepted is not None:
            self._counter_add_dev(
                "accepted", jnp.sum(jnp.asarray(accepted), axis=0)
            )
        if self._counter_host.get("rj_accepted") is not None and (
            rj_accepted is not None
        ):
            self._counter_add_dev(
                "rj_accepted", jnp.sum(jnp.asarray(rj_accepted), axis=0)
            )
        if self._counter_host.get("swaps_accepted") is not None and (
            swaps_accepted is not None
        ):
            self._counter_add_dev(
                "swaps_accepted", jnp.sum(jnp.asarray(swaps_accepted), axis=0)
            )
        if (
            self.moves_accepted_fraction is not None
            and moves_accepted_fraction is not None
        ):
            for key, val in moves_accepted_fraction.items():
                if val is not None:
                    # may be a device scalar/array; materialized by readers
                    self.moves_accepted_fraction[key] = val
        if random_state is not None:
            # device key data is kept as-is; resume materializes it
            self.random_state = random_state
        self.iteration += n
        if (
            self.max_device_bytes is not None
            and self.device_bytes() > self.max_device_bytes
        ):
            self.offload()

    def save_segment_packed(
        self,
        n,
        packed,
        unpack,
        accepted_sum=None,
        rj_accepted_sum=None,
        swaps_accepted_sum=None,
        moves_accepted_fraction=None,
        random_state=None,
    ):
        """Append a segment as the sampler's PACKED snapshot buffers.

        The hot-path cost is zero device ops: the buffers are stored as-is
        (first read unpacks via the captured closure, see :class:`_LazySeg`),
        counter updates append pre-reduced per-segment sums computed inside
        the sampler's bulk dispatch, and per-move fractions arrive as
        in-dispatch slices."""
        seg = _LazySeg(n, dict(packed), unpack)
        self._segs.append(seg)
        if "blobs" in packed:
            self._has_blobs = True
        if accepted_sum is not None:
            self._counter_add_dev("accepted", accepted_sum)
        if self._counter_host.get("rj_accepted") is not None and (
            rj_accepted_sum is not None
        ):
            self._counter_add_dev("rj_accepted", rj_accepted_sum)
        if self._counter_host.get("swaps_accepted") is not None and (
            swaps_accepted_sum is not None
        ):
            self._counter_add_dev("swaps_accepted", swaps_accepted_sum)
        if (
            self.moves_accepted_fraction is not None
            and moves_accepted_fraction is not None
        ):
            for key, val in moves_accepted_fraction.items():
                if val is not None:
                    # device slices; readers materialize lazily
                    self.moves_accepted_fraction[key] = val
        if random_state is not None:
            self.random_state = random_state
        self.iteration += seg.n
        if (
            self.max_device_bytes is not None
            and self.device_bytes() > self.max_device_bytes
        ):
            self.offload()

    def save_snapshot(self, coords, inds, log_like, log_prior, **kwargs):
        """Single-step append: a segment of length 1."""
        import jax.numpy as jnp

        def lead(x):
            return None if x is None else jnp.asarray(x)[None]

        self.save_segment(
            coords={n: lead(c) for n, c in coords.items()},
            inds={n: jnp.asarray(m) for n, m in inds.items()},
            log_like=lead(log_like),
            log_prior=lead(log_prior),
            betas=lead(kwargs.get("betas")),
            blobs=lead(kwargs.get("blobs")),
            accepted=lead(kwargs.get("accepted")),
            rj_accepted=lead(kwargs.get("rj_accepted")),
            swaps_accepted=lead(kwargs.get("swaps_accepted")),
            moves_accepted_fraction=kwargs.get("moves_accepted_fraction"),
            random_state=kwargs.get("random_state"),
        )

    # ------------------------------------------------------------------
    # lazy reads
    # ------------------------------------------------------------------
    def _seg_arrays(self, field, branch=None):
        """Per-segment arrays for one field (static inds broadcast to the
        segment length).  Mixed presence across segments is an error, not a
        silent drop."""
        import jax.numpy as jnp

        parts = []
        missing = 0
        for seg in self._segs:
            arr = seg[field][branch] if branch is not None else seg[field]
            if arr is None:
                missing += 1
                continue
            if field == "inds" and arr.ndim == len(self.shape[branch]) - 1:
                arr = jnp.broadcast_to(arr[None], (seg["n"],) + arr.shape)
            parts.append(arr)
        if parts and missing:
            raise ValueError(
                f"Field '{field}' was stored for only some segments "
                f"({missing} of {len(self._segs)} missing) — cannot "
                "reconstruct a contiguous chain."
            )
        return parts

    def _gather_device(self, field, branch, idx, temp_index):
        """Transfer the device steps at (device-region-relative, sorted)
        indices ``idx`` — gathering per segment so the full chain is NEVER
        concatenated in HBM (a concatenated copy would double the footprint
        behind ``device_bytes()``'s back)."""
        parts = self._seg_arrays(field, branch)
        if not parts:
            return None
        out = []
        off = 0
        for arr in parts:
            n = arr.shape[0]
            sel = idx[(idx >= off) & (idx < off + n)] - off
            off += n
            if sel.size == 0:
                continue
            sub = arr[np.asarray(sel)]
            if temp_index is not None:
                sub = sub[:, temp_index]
            out.append(np.asarray(sub))
        if not out:  # empty selection: shape-correct empty result
            empty = parts[0][0:0]
            if temp_index is not None:
                empty = empty[:, temp_index]
            return np.asarray(empty)
        return np.concatenate(out, axis=0) if len(out) > 1 else out[0]

    def _read(self, field, branch, slice_vals, temp_index):
        """Slice a field and materialize ONLY the result.  Presence must be
        consistent across the offload boundary: a field stored on one side
        but not the other is an error, not a silent drop."""
        host = None
        if self._host is not None:
            host = (
                self._host[field][branch]
                if branch is not None
                else self._host[field]
            )
        has_dev = any(
            (seg[field][branch] if branch is not None else seg[field])
            is not None
            for seg in self._segs
        )
        if self._host is not None and self._segs:
            if host is None and has_dev:
                raise ValueError(
                    f"Field '{field}' is present in live device segments but "
                    "missing from the offloaded prefix — cannot reconstruct "
                    "a contiguous chain."
                )
            if host is not None and not has_dev:
                raise ValueError(
                    f"Field '{field}' is present in the offloaded prefix but "
                    "missing from the live device segments — cannot "
                    "reconstruct a contiguous chain."
                )
        if host is None and not has_dev:
            return None

        n_host = 0 if host is None else host.shape[0]
        idx = np.arange(self.iteration)[slice_vals]
        # gather in ascending step order (host prefix, then device segments
        # front-to-back), then restore the REQUESTED order — descending or
        # unsorted slice_vals must read like the in-memory backend
        order = np.argsort(idx, kind="stable")
        sorted_idx = idx[order]
        h_idx = sorted_idx[sorted_idx < n_host]
        d_idx = sorted_idx[sorted_idx >= n_host] - n_host

        parts = []
        if h_idx.size:
            h = host[h_idx]
            parts.append(h if temp_index is None else h[:, temp_index])
        if has_dev and (d_idx.size or not parts):
            parts.append(self._gather_device(field, branch, d_idx, temp_index))
        if not parts:
            # empty selection entirely in the host region
            h = host[0:0]
            return h if temp_index is None else h[:, temp_index]
        out = np.concatenate(parts, axis=0) if len(parts) > 1 else parts[0]
        if idx.size and not np.array_equal(order, np.arange(idx.size)):
            inv = np.empty(idx.size, dtype=np.intp)
            inv[order] = np.arange(idx.size)
            out = out[inv]
        return out

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
        drop_step_axis = False
        if isinstance(slice_vals, (int, np.integer)) or (
            isinstance(slice_vals, np.ndarray) and slice_vals.ndim == 0
        ):
            # scalar step index: read one row, drop the step axis like the
            # in-memory backend (negatives resolve against the stored range)
            iv = int(slice_vals)
            if iv < 0:
                iv += self.iteration
            slice_vals = slice(iv, iv + 1)
            drop_step_axis = True
        if branch_names is None:
            keep = self.branch_names
        elif isinstance(branch_names, str):
            keep = [branch_names]
        else:
            keep = list(branch_names)

        def maybe_drop(x):
            return x[0] if drop_step_axis else x

        if name == "chain":
            return {
                n: maybe_drop(self._read("chain", n, slice_vals, temp_index))
                for n in keep
            }
        if name == "inds":
            return {
                n: maybe_drop(self._read("inds", n, slice_vals, temp_index))
                for n in keep
            }
        if name in ("log_like", "log_prior", "betas", "blobs"):
            out = self._read(name, None, slice_vals, temp_index)
            if out is None:
                raise AttributeError(f"No {name} stored.")
            return maybe_drop(out)
        raise ValueError(f"Unknown value name: {name}")

    def get_blobs(self, **kwargs):
        if not self._has_blobs:
            return None
        return self.get_value("blobs", **kwargs)

    def get_a_sample(self, it):
        """Reconstruct the State at iteration ``it`` — transfers one step."""
        from ..state import State

        if not self.initialized or self.iteration <= 0:
            raise AttributeError(
                "You must run the sampler with 'store == True' before "
                "accessing the results."
            )
        it = int(it)
        if it < 0:  # support negative indices like a list
            it += self.iteration
        if not 0 <= it < self.iteration:
            raise IndexError(
                f"Sample index {int(it)} out of range for {self.iteration} "
                "stored iterations."
            )
        sl = slice(it, it + 1)
        coords = {}
        inds = {}
        for name in self.branch_names:
            c = self._read("chain", name, sl, None)[0].copy()
            m = self._read("inds", name, sl, None)[0]
            c[~m] = 0.0  # dead leaves were NaN-masked at ingestion
            coords[name] = c
            inds[name] = m
        betas = self._read("betas", None, sl, None)
        blobs = self._read("blobs", None, sl, None)
        return State(
            coords,
            inds=inds,
            log_like=self._read("log_like", None, sl, None)[0],
            log_prior=self._read("log_prior", None, sl, None)[0],
            betas=None if betas is None else betas[0],
            blobs=None if blobs is None else blobs[0],
            random_state=self.random_state,
        )

    # ------------------------------------------------------------------
    # device-side diagnostics
    # ------------------------------------------------------------------
    def get_autocorr_time(
        self,
        discard=0,
        thin=1,
        all_temps=False,
        multiply_thin=True,
        window=50,
        average=True,
        tol=0,
        quiet=True,
        **kwargs,
    ):
        """Per-parameter IACT computed ON DEVICE (the chain never crosses to
        the host — only the tiny tau arrays do).  Matches the host
        estimator (:func:`eryn_tpu.utils.utility.get_integrated_act`, ref
        ``backend.py:616-662``) up to float precision, including the
        ``tol``/``quiet`` chain-length guard (emcee ``integrated_time``
        semantics).  Falls back to the host path when part of the chain has
        been offloaded."""
        if self._host is not None or not self._segs:
            return super().get_autocorr_time(
                discard=discard,
                thin=thin,
                all_temps=all_temps,
                multiply_thin=multiply_thin,
                window=window,
                average=average,
                tol=tol,
                quiet=quiet,
                **kwargs,
            )
        import jax.numpy as jnp

        from ..utils.utility import get_integrated_act_jax

        if not self.initialized or self.iteration <= 0:
            raise AttributeError(
                "You must run the sampler with 'store == True' before "
                "accessing the results."
            )
        sl = slice(discard + thin - 1, self.iteration, thin)
        nsteps = len(range(discard + thin - 1, self.iteration, thin))
        out = {}
        for name in self.branch_names:
            parts = self._seg_arrays("chain", name)
            chain = parts[0] if len(parts) == 1 else jnp.concatenate(parts, 0)
            chain = chain[sl]
            if not all_temps:
                chain = chain[:, 0:1]
            tau = get_integrated_act_jax(
                _pad_steps_to_bucket(chain), window=window, average=average
            )
            out[name] = np.asarray(tau) * (thin if multiply_thin else 1)
        if tol > 0:
            # the raw (pre-thin-multiplication) tau counts stored steps,
            # same as the host estimator's guard
            tau_max = np.nanmax(
                [
                    np.nanmax(np.atleast_1d(t))
                    / (thin if multiply_thin else 1)
                    for t in out.values()
                ]
            )
            if np.isfinite(tau_max) and tau_max * tol > nsteps:
                msg = (
                    f"The chain is shorter than {tol} times the integrated "
                    f"autocorrelation time ({tau_max:.1f})."
                )
                if quiet:
                    import warnings

                    warnings.warn(msg, stacklevel=2)
                else:
                    raise RuntimeError(msg)
        return out

    def _device_field(self, field, branch, discard, thin):
        """Concatenated device view of one field, slice applied."""
        import jax.numpy as jnp

        parts = self._seg_arrays(field, branch)
        if not parts:
            return None
        arr = parts[0] if len(parts) == 1 else jnp.concatenate(parts, 0)
        return arr[slice(discard + thin - 1, self.iteration, thin)]

    def get_evidence_estimate(
        self,
        discard=0,
        thin=1,
        return_error=True,
        method="therodynamic",
        **ss_kwargs,
    ):
        """Thermodynamic-integration evidence with the per-temperature
        mean log-likelihood reduced ON DEVICE — only the ``(ntemps,)``
        means cross to the host (not the MBs of the full logl chain).
        Stepping-stone keeps the host path (its block
        bootstrap needs the per-sample values)."""
        if (
            self._host is not None
            or not self._segs
            or not (method.startswith("thero") or method.startswith("thermo"))
        ):
            return super().get_evidence_estimate(
                discard=discard,
                thin=thin,
                return_error=return_error,
                method=method,
                **ss_kwargs,
            )
        import jax.numpy as jnp

        from ..utils.utility import thermodynamic_integration_log_evidence

        betas_dev = self._device_field("betas", None, discard, thin)
        if betas_dev is None:
            raise ValueError("No betas stored; cannot compute evidence.")
        betas_all = np.asarray(betas_dev)
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
        ll = self._device_field("log_like", None, discard, thin)
        logls = np.asarray(jnp.mean(ll, axis=(0, 2)), dtype=np.float64)
        logZ, dlogZ = thermodynamic_integration_log_evidence(
            betas_all[0], logls
        )
        if return_error:
            return logZ, dlogZ
        return logZ

    def get_gelman_rubin_convergence_diagnostic(
        self, discard=0, thin=1, doprint=True, **kwargs
    ):
        """Per-walker Gelman-Rubin with the per-walker means/variances
        reduced ON DEVICE (NaN-aware over RJ-masked leaves); only the
        ``(nwalkers, ncols)`` summaries cross to the host.  The pooled
        reference mode (``per_walker=False``) needs the full trace and
        falls back to the host path."""
        if (
            self._host is not None
            or not self._segs
            or not kwargs.get("per_walker", True)
        ):
            return super().get_gelman_rubin_convergence_diagnostic(
                discard=discard, thin=thin, doprint=doprint, **kwargs
            )
        import jax.numpy as jnp

        out = {}
        for name in self.branch_names:
            x = self._device_field("chain", name, discard, thin)[:, 0]
            m = self._device_field("inds", name, discard, thin)[:, 0]
            nsteps, nwalkers, nleaves_max, ndim = x.shape
            vals = jnp.where(m[..., None], x, jnp.nan).reshape(
                nsteps, nwalkers, nleaves_max * ndim
            )
            finite = jnp.isfinite(vals)
            cnt = finite.sum(axis=0)  # (nwalkers, ncols)
            safe = jnp.where(finite, vals, 0.0)
            mean = safe.sum(axis=0) / jnp.maximum(cnt, 1)
            var = jnp.where(finite, (vals - mean[None]) ** 2, 0.0).sum(
                axis=0
            ) / jnp.maximum(cnt - 1, 1)
            mean = jnp.where(cnt > 0, mean, jnp.nan)
            var = jnp.where(cnt > 1, var, jnp.nan)
            cnt_h = np.asarray(cnt)
            means = np.asarray(mean, dtype=np.float64)
            variances = np.asarray(var, dtype=np.float64)
            keep = cnt_h.sum(axis=0) > 0
            with np.errstate(invalid="ignore"):
                # same aggregation as utils.utility.psrf(per_walker=True)
                W = np.nanmean(variances[:, keep], axis=0)
                B = nsteps * np.nanvar(means[:, keep], axis=0, ddof=1)
                var_est = (1.0 - 1.0 / nsteps) * W + B / nsteps
                Rhat = np.sqrt(var_est / W)
            out[name] = Rhat
            if doprint:
                print(f"Gelman-Rubin R-hat for {name}: {Rhat}")
        return out

    def _modern_diag_cols(self, name, discard, thin):
        """Cold-chain columns for the modern diagnostics, on device.

        Returns ``(vals, keep)``: the NaN-masked ``(nsteps, nwalkers,
        nleaves_max * ndim)`` device array and the host-side bool mask of
        columns with at least one active sample (the host getters' ``keep``
        selection) — only ``keep`` (a few bytes) crosses to the host here.
        """
        import jax.numpy as jnp

        x = self._device_field("chain", name, discard, thin)[:, 0]
        m = self._device_field("inds", name, discard, thin)[:, 0]
        nsteps, nwalkers, nleaves_max, ndim = x.shape
        vals = jnp.where(m[..., None], x, jnp.nan).reshape(
            nsteps, nwalkers, nleaves_max * ndim
        )
        # match the host getters' column selection exactly: drop only
        # all-NaN columns (a column of infs stays, as on the host)
        keep = np.asarray(~jnp.isnan(vals).all(axis=(0, 1)))
        return vals, keep

    def get_rank_normalized_rhat(
        self, discard=0, thin=1, doprint=False, return_parts=False
    ):
        """Rank-normalized split-R-hat computed ON DEVICE (only the
        per-parameter R-hat arrays cross to the host); same estimator as
        the host backend (:func:`eryn_tpu.utils.utility.rank_normalized_rhat`).
        Falls back to the host path when part of the chain was offloaded."""
        if self._host is not None or not self._segs:
            return super().get_rank_normalized_rhat(
                discard=discard,
                thin=thin,
                doprint=doprint,
                return_parts=return_parts,
            )
        from ..utils.utility import rank_normalized_rhat_jax

        out = {}
        for name in self.branch_names:
            vals, keep = self._modern_diag_cols(name, discard, thin)
            res = rank_normalized_rhat_jax(vals, return_parts=return_parts)
            if return_parts:
                out[name] = tuple(np.asarray(r)[keep] for r in res)
            else:
                out[name] = np.asarray(res)[keep]
            if doprint:
                rhat = out[name][0] if return_parts else out[name]
                print(f"rank-normalized R-hat for {name}: {rhat}")
        return out

    def get_effective_sample_size(
        self, discard=0, thin=1, doprint=False, return_parts=False
    ):
        """Bulk/tail effective sample size computed ON DEVICE (only the
        per-parameter ESS arrays cross to the host); same estimator as the
        host backend (:func:`eryn_tpu.utils.utility.effective_sample_size`).
        Falls back to the host path when part of the chain was offloaded."""
        if self._host is not None or not self._segs:
            return super().get_effective_sample_size(
                discard=discard,
                thin=thin,
                doprint=doprint,
                return_parts=return_parts,
            )
        from ..utils.utility import effective_sample_size_jax

        out = {}
        for name in self.branch_names:
            vals, keep = self._modern_diag_cols(name, discard, thin)
            res = effective_sample_size_jax(vals, return_parts=return_parts)
            if return_parts:
                out[name] = tuple(np.asarray(r)[keep] for r in res)
            else:
                out[name] = np.asarray(res)[keep]
            if doprint:
                ess = out[name][0] if return_parts else out[name]
                print(f"effective sample size for {name}: {ess}")
        return out

    # ------------------------------------------------------------------
    # memory management
    # ------------------------------------------------------------------
    def device_bytes(self):
        """Approximate HBM footprint of the stored segments.  Packed (not
        yet read) segments are counted at their buffer size without forcing
        an unpack."""
        total = 0
        for seg in self._segs:
            if isinstance(seg, _LazySeg) and not seg.unpacked:
                total += seg.packed_nbytes()
                continue
            for holder in (seg["chain"], seg["inds"]):
                for arr in holder.values():
                    total += arr.size * arr.dtype.itemsize
            for field in ("log_like", "log_prior", "betas", "blobs"):
                if seg[field] is not None:
                    total += seg[field].size * seg[field].dtype.itemsize
        return total

    def offload(self):
        """Move everything accumulated on device into host RAM; subsequent
        segments keep landing on device.  Transfers go segment by segment
        and concatenate on the HOST, so the device footprint never grows
        during the offload (this runs exactly when HBM pressure is
        highest)."""
        if not self._segs:
            return

        def pull(field, branch=None):
            parts = [np.asarray(a) for a in self._seg_arrays(field, branch)]
            new = np.concatenate(parts, axis=0) if parts else None
            old = None
            if self._host is not None:
                old = (
                    self._host[field][branch]
                    if branch is not None
                    else self._host[field]
                )
            if old is None:
                return new
            if new is None:
                return old
            return np.concatenate([old, new], axis=0)

        fields = {}
        for field in ("log_like", "log_prior", "betas", "blobs"):
            fields[field] = pull(field)
        for field in ("chain", "inds"):
            fields[field] = {
                name: pull(field, name) for name in self.branch_names
            }
        self._host = fields
        self._segs = []
