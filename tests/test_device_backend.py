"""DeviceBackend: HBM-resident chain storage with lazy per-getter
materialization.  Checks equivalence with the host Backend on an identical
run (same seed), partial reads, offload, resume, and RJ masks."""

import numpy as np
import pytest

import jax.numpy as jnp

from eryn_tpu import (
    Backend,
    DeviceBackend,
    EnsembleSampler,
    ProbDistContainer,
    State,
    uniform_dist,
)

NDIM = 3
NWALKERS = 32
NTEMPS = 4


def log_like(x):
    return -0.5 * jnp.sum(x**2)


@pytest.fixture
def priors():
    return ProbDistContainer({i: uniform_dist(-8, 8) for i in range(NDIM)})


def _run(backend, priors, nsteps=60, seed=7, coords=None):
    ens = EnsembleSampler(
        NWALKERS,
        NDIM,
        log_like,
        priors,
        backend=backend,
        tempering_kwargs=dict(ntemps=NTEMPS),
        seed=seed,
    )
    if coords is None:
        coords = priors.rvs(size=(NTEMPS, NWALKERS))
    ens.run_mcmc(coords, nsteps)
    return ens


def test_device_backend_matches_host_backend(priors):
    """Same seed, same config: the device-resident chain must be identical
    to the host backend's (the storage layer must not change sampling)."""
    coords = priors.rvs(size=(NTEMPS, NWALKERS))
    host = _run(Backend(dtype=np.float32), priors, coords=coords)
    dev = _run(DeviceBackend(dtype=np.float32), priors, coords=coords)

    np.testing.assert_allclose(
        dev.get_chain()["model_0"], host.get_chain()["model_0"], rtol=1e-6
    )
    np.testing.assert_allclose(
        dev.backend.get_log_like(), host.backend.get_log_like(), rtol=1e-6
    )
    np.testing.assert_allclose(
        dev.backend.get_betas(), host.backend.get_betas(), rtol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(dev.backend.accepted), np.asarray(host.backend.accepted)
    )


def test_device_backend_partial_reads(priors):
    ens = _run(DeviceBackend(), priors)
    b = ens.backend
    cold = b.get_chain(temp_index=0)["model_0"]
    assert cold.shape == (60, NWALKERS, 1, NDIM)
    thinned = b.get_log_like(discard=20, thin=2)
    assert thinned.shape == (20, NTEMPS, NWALKERS)
    full = b.get_chain()["model_0"]
    np.testing.assert_array_equal(cold, full[:, 0])
    # get_a_sample transfers one step
    st = b.get_a_sample(10)
    np.testing.assert_allclose(
        np.asarray(st.log_like), b.get_log_like()[10], rtol=1e-6
    )
    last = b.get_last_sample()
    assert np.isfinite(np.asarray(last.log_like)).all()


def test_device_backend_offload_and_resume(priors):
    ens = _run(DeviceBackend(), priors, nsteps=40)
    b = ens.backend
    before = b.get_chain()["model_0"]
    assert b.device_bytes() > 0
    b.offload()
    assert b.device_bytes() == 0
    np.testing.assert_array_equal(before, b.get_chain()["model_0"])
    # keep sampling: reads span the offloaded prefix + live device suffix
    ens.run_mcmc(None, 30)
    assert b.iteration == 70
    mixed = b.get_log_like(discard=20)
    assert mixed.shape == (50, NTEMPS, NWALKERS)
    chain = b.get_chain(temp_index=0)["model_0"]
    assert chain.shape == (70, NWALKERS, 1, NDIM)
    np.testing.assert_array_equal(chain[:40], before[:, 0])


def test_device_backend_auto_offload(priors):
    """max_device_bytes triggers automatic offload during ingestion."""
    ens = _run(DeviceBackend(max_device_bytes=1), priors, nsteps=40)
    b = ens.backend
    assert b._host is not None  # everything spilled
    assert b.get_chain()["model_0"].shape[0] == 40
    ens.run_mcmc(None, 20)
    assert b.iteration == 60
    assert b.get_log_like().shape == (60, NTEMPS, NWALKERS)


def test_device_backend_blobs_and_edge_reads(priors):
    """get_blobs returns stored blobs; empty selections and negative
    get_a_sample indices behave like the host backend."""

    def ll_b(x):
        v = -0.5 * jnp.sum(x**2)
        return v, jnp.stack([v, x[0]])

    ens = EnsembleSampler(
        NWALKERS,
        NDIM,
        ll_b,
        priors,
        backend=DeviceBackend(),
        tempering_kwargs=dict(ntemps=NTEMPS),
        seed=19,
    )
    ens.run_mcmc(priors.rvs(size=(NTEMPS, NWALKERS)), 30)
    b = ens.backend
    blobs = b.get_blobs()
    assert blobs is not None and blobs.shape == (30, NTEMPS, NWALKERS, 2)
    st = b.get_a_sample(-1)
    np.testing.assert_allclose(
        np.asarray(st.log_like), b.get_log_like()[-1], rtol=1e-6
    )
    b.offload()
    ens.run_mcmc(None, 10)
    # empty selection across the host/device boundary
    empty = b.get_log_like(discard=b.iteration)
    assert empty.shape == (0, NTEMPS, NWALKERS)
    assert b.get_blobs().shape == (40, NTEMPS, NWALKERS, 2)


def test_kde_gibbs_masks_raise(priors):
    from eryn_tpu.moves import KDEMove

    mask = np.zeros((1, NDIM), dtype=bool)
    mask[0, 0] = True
    ens = EnsembleSampler(
        NWALKERS,
        NDIM,
        log_like,
        priors,
        moves=KDEMove(gibbs_sampling_setup=("model_0", mask)),
        seed=20,
    )
    with pytest.raises(ValueError, match="Gibbs parameter masks"):
        ens.run_mcmc(priors.rvs(size=(NWALKERS,)), 2)


def test_device_backend_rj_masks(priors):
    """Reversible jump: per-step masks stored, dead leaves NaN-masked."""
    nmax = 2
    ntemps = 2

    def ll(coords, inds):
        contrib = -0.5 * jnp.sum(coords**2, axis=-1)
        return jnp.sum(jnp.where(inds, contrib, 0.0))

    ens = EnsembleSampler(
        NWALKERS,
        NDIM,
        ll,
        priors,
        backend=DeviceBackend(),
        nleaves_max=nmax,
        nleaves_min=0,
        rj_moves=True,
        tempering_kwargs=dict(ntemps=ntemps),
        fill_zero_leaves_val=-1e4,
        seed=3,
    )
    coords = priors.rvs(size=(ntemps, NWALKERS, nmax))
    inds = np.random.default_rng(1).random((ntemps, NWALKERS, nmax)) < 0.5
    ens.run_mcmc(State({"model_0": coords}, inds={"model_0": inds}), 40)
    b = ens.backend
    chain = b.get_chain()["model_0"]
    minds = b.get_inds()["model_0"]
    assert minds.shape == (40, ntemps, NWALKERS, nmax)
    assert minds.any() and not minds.all()
    assert np.isnan(chain[~minds]).all()
    assert np.isfinite(chain[minds]).all()
    nleaves = b.get_nleaves()["model_0"]
    assert nleaves.max() <= nmax


def _reset_device_backend(nbranches=1):
    b = DeviceBackend(dtype=np.float32)
    b.reset(
        NWALKERS,
        {"model_0": NDIM},
        nleaves_max={"model_0": 2},
        ntemps=NTEMPS,
        branch_names=["model_0"],
    )
    return b


def test_device_backend_static_mask_leading_one():
    """Regression: a (1, ntemps, nwalkers, nleaves) inds array on an n-step
    segment is a STATIC mask shared by every step — it must broadcast to the
    segment length, not be stored as a 1-step mask."""
    b = _reset_device_backend()
    n = 5
    coords = {"model_0": jnp.zeros((n, NTEMPS, NWALKERS, 2, NDIM))}
    inds1 = jnp.ones((1, NTEMPS, NWALKERS, 2), bool)
    b.save_segment(
        coords,
        {"model_0": inds1},
        log_like=jnp.zeros((n, NTEMPS, NWALKERS)),
        log_prior=jnp.zeros((n, NTEMPS, NWALKERS)),
        betas=jnp.ones((n, NTEMPS)),
    )
    assert b.iteration == n
    got = b.get_inds()["model_0"]
    assert got.shape == (n, NTEMPS, NWALKERS, 2)
    assert got.all()
    # every step's sample is reachable
    b.get_a_sample(n - 1)


def test_device_backend_get_a_sample_bounds():
    """Regression: out-of-range indices raise IndexError instead of silently
    wrapping via modulo; negative indices work like list indexing."""
    b = _reset_device_backend()
    n = 4
    b.save_segment(
        {"model_0": jnp.arange(n, dtype=jnp.float32)[:, None, None, None, None]
         * jnp.ones((n, NTEMPS, NWALKERS, 2, NDIM), jnp.float32)},
        {"model_0": jnp.ones((NTEMPS, NWALKERS, 2), bool)},
        log_like=jnp.zeros((n, NTEMPS, NWALKERS)),
        log_prior=jnp.zeros((n, NTEMPS, NWALKERS)),
    )
    s_last = b.get_a_sample(-1)
    np.testing.assert_allclose(
        np.asarray(s_last.branches["model_0"].coords), float(n - 1)
    )
    with pytest.raises(IndexError):
        b.get_a_sample(n)
    with pytest.raises(IndexError):
        b.get_a_sample(-n - 1)


def test_device_backend_mixed_blob_presence_across_offload():
    """Regression: blobs present only on one side of the offload boundary
    must raise, not silently drop the stored blobs."""
    b = _reset_device_backend()
    n = 3
    common = dict(
        log_like=jnp.zeros((n, NTEMPS, NWALKERS)),
        log_prior=jnp.zeros((n, NTEMPS, NWALKERS)),
    )
    coords = {"model_0": jnp.zeros((n, NTEMPS, NWALKERS, 2, NDIM))}
    inds = {"model_0": jnp.ones((NTEMPS, NWALKERS, 2), bool)}
    b.save_segment(coords, inds, **common)  # no blobs
    b.offload()
    b.save_segment(
        coords, inds, blobs=jnp.zeros((n, NTEMPS, NWALKERS, 2)), **common
    )
    with pytest.raises(ValueError, match="offloaded prefix"):
        b.get_blobs()


def test_device_backend_honors_slice_order():
    """Regression: unsorted or descending slice_vals must read in the
    REQUESTED order, like the in-memory backend."""
    b = _reset_device_backend()
    for start in (0, 3):
        n = 3
        vals = np.arange(start, start + n, dtype=np.float32)
        b.save_segment(
            {"model_0": jnp.broadcast_to(
                vals[:, None, None, None, None],
                (n, NTEMPS, NWALKERS, 2, NDIM),
            )},
            {"model_0": jnp.ones((NTEMPS, NWALKERS, 2), bool)},
            log_like=jnp.broadcast_to(
                vals[:, None, None], (n, NTEMPS, NWALKERS)
            ),
            log_prior=jnp.zeros((n, NTEMPS, NWALKERS)),
        )
    got = b.get_value("log_like", slice_vals=np.array([4, 1]))
    np.testing.assert_allclose(got[:, 0, 0], [4.0, 1.0])
    rev = b.get_value("log_like", slice_vals=slice(None, None, -1))
    np.testing.assert_allclose(rev[:, 0, 0], [5, 4, 3, 2, 1, 0])
    # across the offload boundary too
    b.offload()
    vals = np.arange(6, 9, dtype=np.float32)
    b.save_segment(
        {"model_0": jnp.broadcast_to(
            vals[:, None, None, None, None], (3, NTEMPS, NWALKERS, 2, NDIM)
        )},
        {"model_0": jnp.ones((NTEMPS, NWALKERS, 2), bool)},
        log_like=jnp.broadcast_to(vals[:, None, None], (3, NTEMPS, NWALKERS)),
        log_prior=jnp.zeros((3, NTEMPS, NWALKERS)),
    )
    mixed = b.get_value("log_like", slice_vals=np.array([7, 2, 8, 0]))
    np.testing.assert_allclose(mixed[:, 0, 0], [7.0, 2.0, 8.0, 0.0])


def test_default_backend_is_device_on_accelerator(priors, monkeypatch):
    """backend=None selects DeviceBackend on accelerator platforms (the
    out-of-the-box stored run must be the fast path) and the host Backend
    on CPU."""
    import jax as _jax

    s_cpu = EnsembleSampler(NWALKERS, NDIM, log_like, priors, seed=0)
    assert type(s_cpu.backend) is Backend

    monkeypatch.setattr(_jax, "default_backend", lambda: "gpu")
    s_gpu = EnsembleSampler(NWALKERS, NDIM, log_like, priors, seed=0)
    assert isinstance(s_gpu.backend, DeviceBackend)
    assert s_gpu.backend.max_device_bytes == 4 << 30
    # explicit backend always wins
    s_exp = EnsembleSampler(
        NWALKERS, NDIM, log_like, priors, backend=Backend(), seed=0
    )
    assert type(s_exp.backend) is Backend


def test_device_iact_matches_host_estimator(priors):
    """The device-side IACT (get_integrated_act_jax) matches the host
    estimator on a real correlated chain, and the lazy device counters
    match a host-backend run with the same seed."""
    coords = priors.rvs(size=(NTEMPS, NWALKERS))
    host = _run(Backend(), priors, nsteps=200, seed=11, coords=coords)
    dev = _run(DeviceBackend(), priors, nsteps=200, seed=11, coords=coords)

    tau_h = host.get_autocorr_time()["model_0"]
    tau_d = dev.get_autocorr_time()["model_0"]
    assert np.all(np.asarray(tau_d) > 0.5)  # real chains correlate
    np.testing.assert_allclose(tau_d, tau_h, rtol=1e-3, atol=1e-5)
    # all_temps + window kwargs agree too
    np.testing.assert_allclose(
        dev.get_autocorr_time(all_temps=True, window=30)["model_0"],
        host.get_autocorr_time(all_temps=True, window=30)["model_0"],
        rtol=1e-3,
        atol=1e-5,
    )
    # after offload the host fallback path serves the same answer
    dev.backend.offload()
    np.testing.assert_allclose(
        dev.get_autocorr_time()["model_0"], tau_h, rtol=1e-3, atol=1e-5
    )
    # lazily-materialized counters equal the host-backend ones
    np.testing.assert_allclose(dev.backend.accepted, host.backend.accepted)
    np.testing.assert_allclose(
        dev.backend.swaps_accepted, host.backend.swaps_accepted
    )


def test_device_evidence_and_gelman_rubin_match_host(priors):
    """Device-reduced TI evidence and per-walker R-hat equal the host
    backend's answers on the same chain (only small summaries cross)."""
    coords = priors.rvs(size=(NTEMPS, NWALKERS))
    host = _run(
        Backend(), priors, nsteps=150, seed=21, coords=coords,
    )
    dev = _run(
        DeviceBackend(), priors, nsteps=150, seed=21, coords=coords,
    )
    # freeze-adaptation requirement: discard the adapting prefix
    # (betas still adapt through the whole short run -> both raise)
    import pytest as _pytest

    with _pytest.raises(ValueError, match="adapting"):
        dev.backend.get_evidence_estimate()
    # compare on a constant-beta tail by monkey-constructing samplers with
    # adaptation off
    ens_h = EnsembleSampler(
        NWALKERS, NDIM, log_like, priors, backend=Backend(),
        tempering_kwargs=dict(ntemps=NTEMPS, adaptive=False), seed=22,
    )
    ens_d = EnsembleSampler(
        NWALKERS, NDIM, log_like, priors, backend=DeviceBackend(),
        tempering_kwargs=dict(ntemps=NTEMPS, adaptive=False), seed=22,
    )
    ens_h.run_mcmc(coords, 150, burn=50)
    ens_d.run_mcmc(coords, 150, burn=50)
    zh, dzh = ens_h.backend.get_evidence_estimate()
    zd, dzd = ens_d.backend.get_evidence_estimate()
    np.testing.assert_allclose(zd, zh, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(dzd, dzh, rtol=1e-4, atol=1e-4)
    # stepping stone falls back to the host path and agrees with itself
    zs_h = ens_h.backend.get_evidence_estimate(method="stepping", seed=3)
    zs_d = ens_d.backend.get_evidence_estimate(method="stepping", seed=3)
    np.testing.assert_allclose(zs_d[0], zs_h[0], rtol=1e-4, atol=1e-4)

    rh_h = ens_h.backend.get_gelman_rubin_convergence_diagnostic(
        doprint=False
    )["model_0"]
    rh_d = ens_d.backend.get_gelman_rubin_convergence_diagnostic(
        doprint=False
    )["model_0"]
    np.testing.assert_allclose(rh_d, rh_h, rtol=1e-4, atol=1e-5)


def test_device_autocorr_tol_guard(priors):
    """The device IACT path honors the emcee tol/quiet chain-length guard
    exactly like the host estimator (kwargs used to be swallowed)."""
    dev = _run(DeviceBackend(), priors, nsteps=60, seed=13)
    with pytest.raises(RuntimeError, match="shorter than"):
        dev.get_autocorr_time(tol=10**6, quiet=False)
    with pytest.warns(UserWarning, match="shorter than"):
        dev.get_autocorr_time(tol=10**6, quiet=True)
    # same semantics after offload (host fallback)
    dev.backend.offload()
    with pytest.raises(RuntimeError, match="shorter than"):
        dev.get_autocorr_time(tol=10**6, quiet=False)


def test_device_iact_bucketing_exact(priors):
    """Chains of different lengths in the same power-of-two bucket give
    taus matching the host estimator exactly (the padding that bounds the
    per-length FFT compiles must not change the estimate)."""
    from eryn_tpu.backends.devicebackend import _pad_steps_to_bucket
    from eryn_tpu.utils.utility import get_integrated_act, get_integrated_act_jax

    rng = np.random.default_rng(21)
    # correlated synthetic chain, non-power-of-two length, with an
    # RJ-style NaN column and an all-NaN column
    n = 150
    x = rng.standard_normal((n, 2, 8, 2, 3)).cumsum(axis=0).astype(np.float32)
    x[:, :, 3, 0, 1] = np.nan  # one all-NaN column
    x[::7, :, 2, 1, 0] = np.nan  # scattered NaNs
    padded = _pad_steps_to_bucket(jnp.asarray(x))
    assert padded.shape[0] == 256
    tau_padded = np.asarray(get_integrated_act_jax(padded))
    tau_raw = np.asarray(get_integrated_act_jax(jnp.asarray(x)))
    np.testing.assert_allclose(tau_padded, tau_raw, rtol=1e-4, atol=1e-4, equal_nan=True)

    # end-to-end: device backend tau == host backend tau at a length that
    # needs padding
    coords = priors.rvs(size=(NTEMPS, NWALKERS))
    host = _run(Backend(), priors, nsteps=150, seed=23, coords=coords)
    dev = _run(DeviceBackend(), priors, nsteps=150, seed=23, coords=coords)
    np.testing.assert_allclose(
        dev.get_autocorr_time()["model_0"],
        host.get_autocorr_time()["model_0"],
        rtol=1e-3,
        atol=1e-5,
    )


def test_device_modern_diagnostics_match_host(priors):
    """Rank-normalized R-hat and bulk/tail ESS agree between the
    device-resident (on-device reduction, only per-parameter arrays cross)
    and host backends on identical chains — including return_parts and the
    host fallback after offload."""
    coords = priors.rvs(size=(NTEMPS, NWALKERS))
    host = _run(Backend(dtype=np.float32), priors, nsteps=80, coords=coords)
    dev = _run(DeviceBackend(dtype=np.float32), priors, nsteps=80, coords=coords)

    r_h = host.backend.get_rank_normalized_rhat()["model_0"]
    r_d = dev.backend.get_rank_normalized_rhat()["model_0"]
    np.testing.assert_allclose(r_d, r_h, rtol=1e-5)

    e_h = host.backend.get_effective_sample_size()["model_0"]
    e_d = dev.backend.get_effective_sample_size()["model_0"]
    np.testing.assert_allclose(e_d, e_h, rtol=1e-5)
    assert np.all(np.isfinite(e_d)) and np.all(e_d > 0)

    # return_parts shapes and values agree component-wise (slightly looser:
    # f32-vs-f64 median folding can re-rank exact-tie pairs straddling the
    # pooled median, a harmless O(1e-5) perturbation of one component)
    parts_h = host.backend.get_rank_normalized_rhat(return_parts=True)["model_0"]
    parts_d = dev.backend.get_rank_normalized_rhat(return_parts=True)["model_0"]
    for a, b in zip(parts_d, parts_h):
        np.testing.assert_allclose(a, b, rtol=2e-4)
    parts_h = host.backend.get_effective_sample_size(return_parts=True)["model_0"]
    parts_d = dev.backend.get_effective_sample_size(return_parts=True)["model_0"]
    for a, b in zip(parts_d, parts_h):
        np.testing.assert_allclose(a, b, rtol=2e-3)

    # after offload the host fallback serves the same answers
    dev.backend.offload()
    np.testing.assert_allclose(
        dev.backend.get_rank_normalized_rhat()["model_0"], r_h, rtol=1e-5
    )
    np.testing.assert_allclose(
        dev.backend.get_effective_sample_size()["model_0"], e_h, rtol=1e-5
    )


def test_modern_diag_jax_rj_masked_columns():
    """The device kernels behind the modern diagnostics reproduce the host
    estimators on RJ-style NaN-masked chains: exact tie ranks (rejected-
    step duplicates), partially- and fully-masked columns."""
    from eryn_tpu.utils.utility import (
        effective_sample_size,
        effective_sample_size_jax,
        rank_normalized_rhat,
        rank_normalized_rhat_jax,
    )

    rng = np.random.default_rng(5)
    n, w, d = 120, 12, 5
    x = np.cumsum(rng.normal(size=(n, w, d)), axis=0) * 0.1 + rng.normal(
        size=(1, w, d)
    )
    dup = rng.random((n, w, d)) < 0.3
    x[1:][dup[1:]] = x[:-1][dup[1:]]  # exact MCMC-rejection ties
    x[rng.random((n, w, d)) < 0.4] = np.nan  # RJ-masked entries
    x[:, :, -1] = np.nan  # an all-masked column
    x32 = x.astype(np.float32)

    r_h = rank_normalized_rhat(x32.astype(np.float64))
    r_d = np.asarray(rank_normalized_rhat_jax(jnp.asarray(x32)))
    np.testing.assert_allclose(r_d[:-1], r_h[:-1], rtol=1e-5)
    assert np.isnan(r_d[-1]) and np.isnan(r_h[-1])

    e_h = effective_sample_size(x32.astype(np.float64))
    e_d = np.asarray(effective_sample_size_jax(jnp.asarray(x32)))
    np.testing.assert_allclose(e_d[:-1], e_h[:-1], rtol=1e-4)
    assert np.isnan(e_d[-1]) and np.isnan(e_h[-1])


def test_modern_diag_jax_short_chains_match_host():
    """Chains too short for the Geyer machinery: the device ESS returns
    NaN exactly where the host estimator does (nsteps 4-7 used to crash
    with an IndexError or return values the host calls NaN)."""
    from eryn_tpu.utils.utility import (
        effective_sample_size,
        effective_sample_size_jax,
        rank_normalized_rhat,
        rank_normalized_rhat_jax,
    )

    rng = np.random.default_rng(9)
    for nsteps in (4, 5, 6, 7, 8, 12):
        x = rng.standard_normal((nsteps, 8, 2)).astype(np.float32)
        e_h = effective_sample_size(x.astype(np.float64))
        e_d = np.asarray(effective_sample_size_jax(jnp.asarray(x)))
        np.testing.assert_array_equal(np.isnan(e_d), np.isnan(e_h), err_msg=str(nsteps))
        if not np.isnan(e_h).any():
            np.testing.assert_allclose(e_d, e_h, rtol=1e-4)
        r_h = rank_normalized_rhat(x.astype(np.float64))
        r_d = np.asarray(rank_normalized_rhat_jax(jnp.asarray(x)))
        # tiny pooled samples: a draw landing exactly on the f32-vs-f64
        # pooled median folds to 0 in one precision and ~1e-8 in the
        # other, shifting a whole rank step — O(1%) at S=32, irrelevant
        # at real chain lengths (see the 1e-5 tolerance tests above)
        np.testing.assert_allclose(r_d, r_h, rtol=0.03)
