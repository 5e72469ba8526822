"""Backends: HDF5 storage schema, checkpoint/resume, diagnostics (config B
analog of `/root/reference/tests/test_eryn.py:154-209`)."""

import os

import numpy as np
import pytest

import jax.numpy as jnp

from eryn_tpu import Backend, EnsembleSampler, ProbDistContainer, uniform_dist
from eryn_tpu.backends import HDFBackend, TempHDFBackend

NDIM = 3
NWALKERS = 32
NTEMPS = 5


def log_like(x):
    return -0.5 * jnp.sum(x**2)


def log_like_rj(coords, inds):
    active = jnp.where(inds[:, None], coords, 0.0)
    return -0.5 * jnp.sum(active**2)


@pytest.fixture
def priors():
    return ProbDistContainer({i: uniform_dist(-8, 8) for i in range(NDIM)})


def test_hdf_backend_roundtrip(priors, tmp_path):
    fn = str(tmp_path / "chain.h5")
    ens = EnsembleSampler(
        NWALKERS,
        NDIM,
        log_like,
        priors,
        backend=HDFBackend(fn),
        tempering_kwargs=dict(ntemps=NTEMPS),
        seed=1,
    )
    coords = priors.rvs(size=(NTEMPS, NWALKERS))
    ens.run_mcmc(coords, 50, burn=20)

    assert os.path.exists(fn)
    chain = ens.get_chain()["model_0"]
    assert chain.shape == (50, NTEMPS, NWALKERS, 1, NDIM)
    betas = ens.get_betas()
    assert betas.shape == (50, NTEMPS)
    assert np.all(betas[:, 0] == 1.0)
    # adaptive ladder actually moved
    assert not np.allclose(betas[0, 1:-1], betas[-1, 1:-1])

    # file schema matches the reference layout
    import h5py

    with h5py.File(fn, "r") as f:
        g = f["mcmc"]
        assert g.attrs["ntemps"] == NTEMPS
        assert g.attrs["nwalkers"] == NWALKERS
        assert g.attrs["iteration"] == 50
        assert "chain" in g and "model_0" in g["chain"]
        assert "inds" in g
        assert g["log_like"].shape == (50, NTEMPS, NWALKERS)
        assert "accepted" in g and "swaps_accepted" in g
        assert "moves" in g


def test_hdf_backend_resume(priors, tmp_path):
    fn = str(tmp_path / "resume.h5")
    ens = EnsembleSampler(
        NWALKERS,
        NDIM,
        log_like,
        priors,
        backend=HDFBackend(fn),
        tempering_kwargs=dict(ntemps=NTEMPS),
        seed=2,
    )
    coords = priors.rvs(size=(NTEMPS, NWALKERS))
    ens.run_mcmc(coords, 30)
    last_ll = ens.get_log_like()[-1]
    del ens

    # brand-new sampler on the same file resumes where it stopped
    ens2 = EnsembleSampler(
        NWALKERS,
        NDIM,
        log_like,
        priors,
        backend=HDFBackend(fn),
        tempering_kwargs=dict(ntemps=NTEMPS),
        seed=99,
    )
    assert ens2.backend.iteration == 30
    state = ens2.backend.get_last_sample()
    np.testing.assert_allclose(np.asarray(state.log_like), last_ll, rtol=1e-6)
    ens2.run_mcmc(None, 20)
    assert ens2.backend.iteration == 50
    ll = ens2.get_log_like()
    assert ll.shape[0] == 50
    assert np.all(np.isfinite(ll))


def test_kernel_states_survive_resume(priors, tmp_path):
    """Tuned proposal state (slice mu, ChEES log_T, dual-averaged eps,
    adaptation clocks) is checkpointed at run end and restored by a
    BRAND-NEW sampler on the same file — without it a resumed run would
    silently re-enter tuning during stored sampling (the reference keeps
    tuning state only on in-memory move objects)."""
    from eryn_tpu.moves import ChEESHMCMove, SliceMove

    fn = str(tmp_path / "ks_resume.h5")

    def build(seed):
        return EnsembleSampler(
            NWALKERS, NDIM, log_like, priors,
            backend=HDFBackend(fn),
            # two moves alternate, so each sees only ~half the proposals:
            # tune_steps=20 guarantees both froze within the 60-step run
            moves=[SliceMove(tune_steps=20), ChEESHMCMove(tune_steps=20)],
            seed=seed,
        )

    ens = build(2)
    ens.run_mcmc(priors.rvs(size=(1, NWALKERS)), 60)
    mu = float(np.asarray(ens._kernel_states[0]["mu"]))
    log_T = float(np.asarray(ens._kernel_states[1]["log_T"]))
    t_slice = int(np.asarray(ens._kernel_states[0]["t"]))
    assert mu != 1.0  # it actually tuned
    del ens

    ens2 = build(99)
    assert ens2.backend.iteration == 60
    ens2.run_mcmc(None, 5)
    # the tuned values were restored (both moves froze well before the
    # 60-step run ended, so they must be bit-identical after the resumed
    # steps)
    assert float(np.asarray(ens2._kernel_states[0]["mu"])) == mu
    assert float(np.asarray(ens2._kernel_states[1]["log_T"])) == log_T
    # the adaptation clock continued rather than restarting (the move
    # schedule alternates, so slice gets some subset of the 5 proposals)
    t2 = int(np.asarray(ens2._kernel_states[0]["t"]))
    assert t_slice <= t2 <= t_slice + 5

    # a changed move configuration degrades gracefully to fresh tuning
    ens3 = EnsembleSampler(
        NWALKERS, NDIM, log_like, priors,
        backend=HDFBackend(fn),
        moves=[SliceMove(tune_steps=20), ChEESHMCMove(tune_steps=20)],
        track_moves=False,
        seed=5,
    )
    stored = ens3.backend.get_kernel_states()
    assert stored is not None
    keys, leaves = stored
    assert keys == ["SliceMove_0", "ChEESHMCMove_0"] and len(leaves) == 2
    # corrupt one leaf's shape to force the validation fallback
    leaves[0][0] = np.zeros((3, 3))
    ens3.backend.save_kernel_states = lambda ks, **kw: None  # keep corruption
    import warnings as _warnings

    ens3.backend.get_kernel_states = lambda: (keys, leaves)
    with _warnings.catch_warnings(record=True) as w:
        _warnings.simplefilter("always")
        ens3.run_mcmc(None, 2)
    assert any("kernel states" in str(x.message) for x in w)


def test_kernel_states_reject_changed_move_keys(priors, tmp_path):
    """A resume with a DIFFERENT move set (track_moves=False, so the
    backend-level move-key validation is off) must not restore another
    move's tuned state just because the structures coincide — the stored
    move keys gate the restore."""
    from eryn_tpu.moves import GaussianMove, SliceMove

    fn = str(tmp_path / "ks_keys.h5")
    ens = EnsembleSampler(
        NWALKERS, NDIM, log_like, priors,
        backend=HDFBackend(fn), moves=[SliceMove(tune_steps=10)],
        track_moves=False, seed=3,
    )
    ens.run_mcmc(priors.rvs(size=(1, NWALKERS)), 20)

    ens2 = EnsembleSampler(
        NWALKERS, NDIM, log_like, priors,
        backend=HDFBackend(fn),
        moves=[GaussianMove({"model_0": 0.5})],
        track_moves=False, seed=4,
    )
    import warnings as _warnings

    with _warnings.catch_warnings(record=True) as w:
        _warnings.simplefilter("always")
        ens2.run_mcmc(None, 2)
    assert any("move keys changed" in str(x.message) for x in w)


def test_kernel_states_saved_from_sample_generator(priors, tmp_path):
    """Driving the sampler with the reference-idiom sample() generator
    (including breaking out early) still checkpoints the tuned kernel
    state."""
    from eryn_tpu.moves import SliceMove

    fn = str(tmp_path / "ks_gen.h5")
    ens = EnsembleSampler(
        NWALKERS, NDIM, log_like, priors,
        backend=HDFBackend(fn), moves=[SliceMove(tune_steps=15)], seed=6,
    )
    start = priors.rvs(size=(1, NWALKERS))
    for i, _state in enumerate(ens.sample(start, iterations=40)):
        if i == 29:
            break  # abandon the generator mid-run
    mu = float(np.asarray(ens._kernel_states[0]["mu"]))
    stored = ens.backend.get_kernel_states()
    assert stored is not None
    np.testing.assert_allclose(np.asarray(stored[1][0][0]), mu)


def test_memory_backend_kernel_states_roundtrip(priors):
    """The in-memory backend checkpoints kernel states too: a continued
    run restores tuned values after _kernel_states is cleared (as a fresh
    process would)."""
    from eryn_tpu.moves import SliceMove

    ens = EnsembleSampler(
        NWALKERS, NDIM, log_like, priors,
        moves=[SliceMove(tune_steps=30)], seed=11,
    )
    ens.run_mcmc(priors.rvs(size=(1, NWALKERS)), 50)
    mu = float(np.asarray(ens._kernel_states[0]["mu"]))
    # simulate a fresh dispatch context losing the in-memory tuple
    ens._kernel_states = None
    ens._step_cache = {}
    ens.run_mcmc(None, 5)
    assert float(np.asarray(ens._kernel_states[0]["mu"])) == mu


def test_temp_hdf_backend(priors):
    with TempHDFBackend() as backend:
        ens = EnsembleSampler(
            NWALKERS, NDIM, log_like, priors, backend=backend, seed=3
        )
        coords = priors.rvs(size=(NWALKERS,))
        ens.run_mcmc(coords, 10)
        assert backend.iteration == 10
        fn = backend.filename
    assert not os.path.exists(fn)


def test_memory_backend_diagnostics(priors):
    ntemps = 14
    ens = EnsembleSampler(
        NWALKERS,
        NDIM,
        log_like,
        priors,
        tempering_kwargs=dict(ntemps=ntemps, stop_adaptation=0, adaptive=False),
        seed=4,
    )
    coords = priors.rvs(size=(ntemps, NWALKERS))
    ens.run_mcmc(coords, 300, burn=100)

    tau = ens.backend.get_autocorr_time()
    # per-parameter taus: (ntemps_kept=1, nleaves_max=1, ndim)
    assert tau["model_0"].shape == (1, 1, NDIM)
    assert np.isfinite(tau["model_0"]).all()

    # analytic: Z = (2*pi)^(3/2) / 16^3  -> log Z ~ 2.757 - 8.317 = -5.56
    expected = 0.5 * NDIM * np.log(2 * np.pi) - NDIM * np.log(16.0)
    # stepping stone is accurate; thermodynamic integration is limited by the
    # geometric ladder coarseness (its own error estimate reflects that)
    logz_ss, dlogz_ss = ens.backend.get_evidence_estimate(
        discard=50, method="stepping_stone"
    )
    assert abs(logz_ss - expected) < 0.3
    logz_ti, dlogz_ti = ens.backend.get_evidence_estimate(discard=50)
    assert abs(logz_ti - expected) < max(2.0 * dlogz_ti, 2.0)

    rhat = ens.backend.get_gelman_rubin_convergence_diagnostic(
        discard=50, doprint=False
    )
    assert np.all(rhat["model_0"] < 1.3)


def test_backend_move_info_and_reset_mirrors(priors, tmp_path):
    """get_move_info / reset_args / reset_kwargs surface
    (ref backend.py:118-127,1005-1012; hdfbackend.py:460-479)."""
    fn = str(tmp_path / "mi.h5")
    for backend in (None, HDFBackend(fn)):
        ens = EnsembleSampler(
            NWALKERS,
            NDIM,
            log_like,
            priors,
            backend=backend,
            tempering_kwargs=dict(ntemps=NTEMPS),
            seed=11,
        )
        coords = priors.rvs(size=(NTEMPS, NWALKERS))
        ens.run_mcmc(coords, 20)
        mi = ens.backend.get_move_info()
        assert mi is not None and len(mi) == len(ens.moves)
        for info in mi.values():
            af = np.asarray(info["acceptance_fraction"])
            assert af.shape == (NTEMPS, NWALKERS)
            assert 0.0 <= af.mean() <= 1.0
        args = ens.backend.reset_args
        assert int(args[0]) == NWALKERS
        kwargs = ens.backend.reset_kwargs
        assert int(kwargs["ntemps"]) == NTEMPS
        assert list(kwargs["branch_names"]) == ["model_0"]
        assert list(kwargs["moves"]) == list(mi.keys())
        assert "info" in kwargs  # ref backend.py:119-127 round-trips info


def test_resume_validation_mismatch(priors, tmp_path):
    """Resuming with a changed move set or prior key order raises
    (ref ensemble.py:605-652)."""
    from eryn_tpu.moves import GaussianMove, StretchMove

    fn = str(tmp_path / "validate.h5")
    ens = EnsembleSampler(
        NWALKERS,
        NDIM,
        log_like,
        priors,
        backend=HDFBackend(fn),
        moves=[StretchMove()],
        seed=5,
    )
    ens.run_mcmc(priors.rvs(size=(NWALKERS,)), 10)
    del ens

    # changed move configuration
    with pytest.raises(ValueError, match="Configuration of moves"):
        EnsembleSampler(
            NWALKERS,
            NDIM,
            log_like,
            priors,
            backend=HDFBackend(fn),
            moves=[GaussianMove({"model_0": 0.5 * np.ones(NDIM)})],
            seed=5,
        )
    # track_moves=False skips the move-key check
    EnsembleSampler(
        NWALKERS,
        NDIM,
        log_like,
        priors,
        backend=HDFBackend(fn),
        moves=[GaussianMove({"model_0": 0.5 * np.ones(NDIM)})],
        track_moves=False,
        seed=5,
    )

    # string key_order persistence + mismatch detection
    fn2 = str(tmp_path / "keyorder.h5")
    named = ProbDistContainer(
        {"a": uniform_dist(-8, 8), "b": uniform_dist(-8, 8), "c": uniform_dist(-8, 8)}
    )
    ens2 = EnsembleSampler(
        NWALKERS, NDIM, log_like, named, backend=HDFBackend(fn2), seed=6
    )
    ens2.run_mcmc(named.rvs(size=(NWALKERS,)), 10)
    assert ens2.backend.key_order == {"model_0": ["a", "b", "c"]}
    del ens2

    reordered = ProbDistContainer(
        {"b": uniform_dist(-8, 8), "a": uniform_dist(-8, 8), "c": uniform_dist(-8, 8)}
    )
    with pytest.raises(ValueError, match="key order"):
        EnsembleSampler(
            NWALKERS, NDIM, log_like, reordered, backend=HDFBackend(fn2), seed=6
        )
    # same order resumes fine
    ens3 = EnsembleSampler(
        NWALKERS, NDIM, log_like, named, backend=HDFBackend(fn2), seed=6
    )
    assert ens3.backend.iteration == 10


def test_read_reference_written_file(priors, tmp_path):
    """A chain file written by the REFERENCE implementation opens with our
    HDFBackend: getters, get_last_sample, and resuming a run all work
    (the schemas match by construction)."""
    import sys
    import types

    from _refpath import REFERENCE_SRC

    sys.path.insert(0, REFERENCE_SRC)
    sys.modules.setdefault("corner", types.ModuleType("corner"))
    try:
        try:
            from eryn.backends import HDFBackend as RefHDFBackend
            from eryn.ensemble import EnsembleSampler as RefSampler
            from eryn.prior import ProbDistContainer as RefContainer
            from eryn.prior import uniform_dist as ref_uniform
        except Exception:
            pytest.skip("reference Eryn not importable")
    finally:
        # do not leave the reference tree shadowing site-packages for the
        # rest of the session
        sys.path.remove(REFERENCE_SRC)

    fn = str(tmp_path / "ref_written.h5")
    np.random.seed(42)

    def ref_ll(x):
        return -0.5 * float(np.sum(np.asarray(x) ** 2))

    ref_priors = RefContainer({i: ref_uniform(-8, 8) for i in range(NDIM)})
    ref = RefSampler(
        NWALKERS,
        NDIM,
        ref_ll,
        ref_priors,
        backend=RefHDFBackend(fn, name="mcmc"),
        tempering_kwargs=dict(ntemps=3),
    )
    coords = ref_priors.rvs(size=(3, NWALKERS))
    ref.run_mcmc(coords, 12, progress=False)

    # --- open with OUR backend -----------------------------------------
    ours = HDFBackend(fn, name="mcmc")
    assert ours.initialized
    assert ours.iteration == 12
    chain = ours.get_chain()["model_0"]
    assert chain.shape == (12, 3, NWALKERS, 1, NDIM)
    np.testing.assert_allclose(
        chain, ref.get_chain()["model_0"], rtol=1e-12
    )
    last = ours.get_last_sample()
    assert np.isfinite(np.asarray(last.log_like)).all()

    # resume the reference's chain with OUR sampler (fresh key: the
    # reference stores a Mersenne state we deliberately ignore); move-key
    # naming matches the reference convention (StretchMove_0), so move
    # tracking survives the crossover
    ens = EnsembleSampler(
        NWALKERS,
        NDIM,
        log_like,
        priors,
        backend=ours,
        tempering_kwargs=dict(ntemps=3),
        seed=9,
    )
    ens.run_mcmc(None, 8)
    assert ours.iteration == 20
    assert np.isfinite(ens.get_log_like()).all()


def _import_reference_eryn():
    """Import the live reference package (skip if unavailable) without
    leaving its tree on sys.path."""
    import sys
    import types

    from _refpath import REFERENCE_SRC

    sys.path.insert(0, REFERENCE_SRC)
    sys.modules.setdefault("corner", types.ModuleType("corner"))
    try:
        try:
            import eryn.backends as rb
            import eryn.ensemble as re_
            import eryn.prior as rp
            from eryn.state import State as RefState
        except Exception:
            pytest.skip("reference Eryn not importable")
    finally:
        sys.path.remove(REFERENCE_SRC)
    return rb.HDFBackend, re_.EnsembleSampler, rp, RefState


def test_reference_reads_our_file(priors, tmp_path):
    """REVERSE interop: a chain file written by eryn_tpu opens under the
    live reference ``HDFBackend`` — every getter agrees numerically — and a
    reference ``EnsembleSampler`` resumes it.

    The resume leg uses a 1-D model: the reference cannot resume ANY
    multi-D file — including its own — because its key_order check compares
    a list against the h5py-returned ndarray (ref ``ensemble.py:620``,
    "truth value ... ambiguous").  ``test_reference_resume_parity`` below
    pins that equivalence so this is provably the reference's own bug, not
    a schema gap in our files.
    """
    RefHDFBackend, RefSampler, rp, _ = _import_reference_eryn()

    # --- part A: write a multi-D chain with eryn_tpu ---------------------
    fn = str(tmp_path / "ours_written.h5")
    ens = EnsembleSampler(
        NWALKERS,
        NDIM,
        log_like,
        priors,
        backend=HDFBackend(fn, name="mcmc"),
        tempering_kwargs=dict(ntemps=3),
        seed=11,
    )
    ens.run_mcmc(priors.rvs(size=(3, NWALKERS)), 16, burn=4)

    theirs = RefHDFBackend(fn, name="mcmc")
    assert theirs.initialized
    assert theirs.iteration == 16
    assert theirs.nwalkers == NWALKERS and theirs.ntemps == 3
    assert theirs.shape == {"model_0": (3, NWALKERS, 1, NDIM)}
    # reference move-configuration check reads these names literally
    assert theirs.move_keys == ["StretchMove_0"]
    # the JAX key must be INVISIBLE to the reference's random_state scan
    # (an attr starting with random_state_ would crash its RandomState
    # restore); None makes it fall back to fresh numpy entropy
    assert theirs.random_state is None

    ours = HDFBackend(fn, name="mcmc")
    np.testing.assert_allclose(
        np.asarray(theirs.get_chain()["model_0"]),
        np.asarray(ours.get_chain()["model_0"]),
        rtol=1e-12,
    )
    np.testing.assert_allclose(
        np.asarray(theirs.get_log_like()),
        np.asarray(ours.get_log_like()),
        rtol=1e-12,
    )
    np.testing.assert_allclose(
        np.asarray(theirs.get_betas()),
        np.asarray(ours.get_betas()),
        rtol=1e-12,
    )
    np.testing.assert_allclose(
        np.asarray(theirs.accepted), np.asarray(ours.accepted)
    )
    last = theirs.get_last_sample()
    assert np.isfinite(np.asarray(last.log_like)).all()
    np.testing.assert_allclose(
        np.asarray(last.log_like),
        np.asarray(ours.get_last_sample().log_like),
        rtol=1e-12,
    )

    # --- part B: the reference sampler RESUMES our file (1-D model) ------
    fn1 = str(tmp_path / "ours_written_1d.h5")
    pri1 = ProbDistContainer({0: uniform_dist(-8, 8)})
    ens1 = EnsembleSampler(
        NWALKERS,
        1,
        log_like,
        pri1,
        backend=HDFBackend(fn1, name="mcmc"),
        tempering_kwargs=dict(ntemps=3),
        seed=12,
    )
    ens1.run_mcmc(pri1.rvs(size=(3, NWALKERS)), 12, burn=4)

    def ref_ll(x):
        return -0.5 * float(np.sum(np.asarray(x) ** 2))

    ref_pri1 = rp.ProbDistContainer({0: rp.uniform_dist(-8, 8)})
    np.random.seed(1234)
    ref_ens = RefSampler(
        NWALKERS,
        1,
        ref_ll,
        ref_pri1,
        backend=RefHDFBackend(fn1, name="mcmc"),
        tempering_kwargs=dict(ntemps=3),
    )
    ref_ens.run_mcmc(None, 6, progress=False)
    assert ref_ens.backend.iteration == 18
    assert np.isfinite(
        np.asarray(ref_ens.get_chain()["model_0"])
    ).all()
    # our steps 0..11 are untouched by the reference's appended leg
    reread = HDFBackend(fn1, name="mcmc")
    # (ens1.get_chain() re-reads the file, which now holds all 18 steps)
    np.testing.assert_allclose(
        np.asarray(reread.get_chain()["model_0"][:12]),
        np.asarray(ens1.get_chain()["model_0"][:12]),
        rtol=1e-12,
    )
    assert reread.iteration == 18


def test_reference_resume_parity(priors, tmp_path):
    """The reference resumes OUR multi-D files exactly as far as it resumes
    ITS OWN: both crash in its key_order comparison (ref ``ensemble.py:620``
    compares a list with an h5py ndarray).  Pinning both sides proves the
    multi-D resume limitation is upstream, not our schema."""
    RefHDFBackend, RefSampler, rp, RefState = _import_reference_eryn()

    def ref_ll(x):
        return -0.5 * float(np.sum(np.asarray(x) ** 2))

    ref_pri = rp.ProbDistContainer(
        {i: rp.uniform_dist(-8, 8) for i in range(NDIM)}
    )

    # reference file, reference resume -> upstream bug
    fn_ref = str(tmp_path / "ref_multid.h5")
    np.random.seed(7)
    r1 = RefSampler(
        NWALKERS,
        NDIM,
        ref_ll,
        ref_pri,
        backend=RefHDFBackend(fn_ref, name="mcmc"),
        tempering_kwargs=dict(ntemps=3),
    )
    r1.run_mcmc(ref_pri.rvs(size=(3, NWALKERS)), 6, progress=False)
    with pytest.raises(ValueError, match="ambiguous"):
        RefSampler(
            NWALKERS,
            NDIM,
            ref_ll,
            ref_pri,
            backend=RefHDFBackend(fn_ref, name="mcmc"),
            tempering_kwargs=dict(ntemps=3),
        )

    # our file, reference resume -> the SAME upstream failure, no earlier
    # schema error (shape/move-key/random_state checks all pass first)
    fn_ours = str(tmp_path / "ours_multid.h5")
    ens = EnsembleSampler(
        NWALKERS,
        NDIM,
        log_like,
        priors,
        backend=HDFBackend(fn_ours, name="mcmc"),
        tempering_kwargs=dict(ntemps=3),
        seed=13,
    )
    ens.run_mcmc(priors.rvs(size=(3, NWALKERS)), 6)
    with pytest.raises(ValueError, match="ambiguous"):
        RefSampler(
            NWALKERS,
            NDIM,
            ref_ll,
            ref_pri,
            backend=RefHDFBackend(fn_ours, name="mcmc"),
            tempering_kwargs=dict(ntemps=3),
        )


def test_tempered_log_posterior_with_temp_index(priors):
    """Regression: get_log_posterior(temper=True, temp_index=...) broadcast
    (betas is 1-D once a temperature is selected)."""
    ens = EnsembleSampler(
        16,
        NDIM,
        log_like,
        priors,
        tempering_kwargs=dict(ntemps=3),
        seed=42,
    )
    ens.run_mcmc(priors.rvs(size=(3, 16)), 10)
    full = ens.backend.get_log_posterior(temper=True)
    cold = ens.backend.get_log_posterior(temper=True, temp_index=0)
    assert cold.shape == (10, 16)
    np.testing.assert_allclose(cold, full[:, 0], rtol=1e-6)


def test_get_a_sample_bounds_after_partial_store(priors):
    """Regression: get_a_sample resolves indices against the STORED range,
    not the preallocated chain length (which is longer after an interrupted
    run)."""
    ens = EnsembleSampler(16, NDIM, log_like, priors, seed=43)
    ens.run_mcmc(priors.rvs(size=(16,)), 5)
    # simulate an interrupted run: grow beyond what was stored
    ens.backend.grow(10, None)
    last = ens.backend.get_a_sample(-1)
    assert np.isfinite(np.asarray(last.log_like)).all()
    with pytest.raises(IndexError):
        ens.backend.get_a_sample(5)


def test_three_backend_getter_equivalence(priors, tmp_path):
    """Fuzz: Backend, HDFBackend, and DeviceBackend must agree on every
    getter for identical runs (same seed), across discard/thin/temp_index/
    slice_vals combinations — including unsorted and descending slices."""
    from eryn_tpu import DeviceBackend

    seeds = dict(seed=77)
    kwargs = dict(
        nleaves_max=2,
        nleaves_min=0,
        rj_moves=True,
        tempering_kwargs=dict(ntemps=3),
        fill_zero_leaves_val=-100.0,
    )

    # one initial state for all three runs (priors.rvs consumes the global
    # NumPy RNG, so drawing per-run would diverge the chains)
    np.random.seed(11)
    coords0 = priors.rvs(size=(3, 16, 2))
    inds0 = np.random.default_rng(5).random((3, 16, 2)) < 0.5

    def run(backend):
        ens = EnsembleSampler(
            16, NDIM, log_like_rj, priors, backend=backend, **kwargs, **seeds
        )
        from eryn_tpu import State

        ens.run_mcmc(
            State({"model_0": coords0}, inds={"model_0": inds0}), 25
        )
        return ens.backend

    host = run(Backend(dtype=np.float32))
    hdf = run(HDFBackend(str(tmp_path / "eq.h5"), dtype=np.float32))
    dev = run(DeviceBackend(dtype=np.float32))

    rng = np.random.default_rng(0)
    cases = [
        dict(),
        dict(discard=5),
        dict(thin=3),
        dict(discard=4, thin=2),
        dict(temp_index=0),
        dict(temp_index=2, thin=2),
        dict(slice_vals=np.array([21, 3, 14, 3])),
        dict(slice_vals=slice(None, None, -1)),
        dict(slice_vals=rng.permutation(25)),
    ]
    for kw in cases:
        for name in ("chain", "inds"):
            a = host.get_value(name, **kw)["model_0"]
            b = hdf.get_value(name, **kw)["model_0"]
            c = dev.get_value(name, **kw)["model_0"]
            np.testing.assert_allclose(b, a, rtol=1e-6, err_msg=f"hdf {name} {kw}")
            np.testing.assert_allclose(c, a, rtol=1e-6, err_msg=f"dev {name} {kw}")
        for name in ("log_like", "log_prior", "betas"):
            a = host.get_value(name, **kw)
            b = hdf.get_value(name, **kw)
            c = dev.get_value(name, **kw)
            np.testing.assert_allclose(b, a, rtol=1e-6, err_msg=f"hdf {name} {kw}")
            np.testing.assert_allclose(c, a, rtol=1e-6, err_msg=f"dev {name} {kw}")
    # sample reconstruction agrees at matching indices
    for it in (0, 12, -1):
        sa = host.get_a_sample(it)
        sb = hdf.get_a_sample(it)
        sc = dev.get_a_sample(it)
        for s2 in (sb, sc):
            np.testing.assert_allclose(
                np.asarray(s2.log_like), np.asarray(sa.log_like), rtol=1e-6
            )
            np.testing.assert_allclose(
                np.asarray(s2.branches["model_0"].coords),
                np.asarray(sa.branches["model_0"].coords),
                rtol=1e-6,
            )
    # scalar slice_vals drop the step axis identically (incl. negatives)
    for sv in (3, -1, np.int64(7)):
        a = host.get_value("log_like", slice_vals=sv)
        np.testing.assert_allclose(
            hdf.get_value("log_like", slice_vals=sv), a, rtol=1e-6
        )
        np.testing.assert_allclose(
            dev.get_value("log_like", slice_vals=sv), a, rtol=1e-6
        )
        assert a.shape == (3, 16)  # (ntemps, nwalkers): step axis dropped

    # after growing beyond the stored range (interrupted run), negative and
    # descending reads still resolve against the STORED range on every
    # backend
    host.grow(10, None)
    hdf.grow(10, None)
    last = host.get_value("log_like", slice_vals=-1)
    np.testing.assert_allclose(
        last, host.get_value("log_like")[-1], rtol=1e-6
    )
    rev = host.get_value("log_like", slice_vals=slice(None, None, -1))
    assert rev.shape[0] == 25 and np.isfinite(rev).all()
    np.testing.assert_allclose(
        hdf.get_value("log_like", slice_vals=slice(None, None, -1)),
        rev,
        rtol=1e-6,
    )

    # diagnostics agree (the device backend computes its taus ON DEVICE in
    # the storage dtype — float32 — so near-zero taus need an atol)
    ta = host.get_autocorr_time()["model_0"]
    tc = dev.get_autocorr_time()["model_0"]
    np.testing.assert_allclose(tc, ta, rtol=1e-3, atol=1e-5, equal_nan=True)


def test_resume_is_bitwise_continuation(priors, tmp_path):
    """A process-restart resume must continue the chain EXACTLY where a
    continuous run would have gone: same stored PRNG key, same restored
    state, and — the piece the kill/resume drill caught missing — the same
    tempering adaptation clock (``TemperatureControl.time``).  Without the
    clock checkpoint the resumed run re-enters early adaptation (vousden
    gain ~ 1/(t + t0)), betas drift off the continuous trajectory, and a
    marginal swap flips a few steps later."""
    deterministic_coords = np.asarray(
        8 * (2 * np.random.default_rng(5).random((NTEMPS, NWALKERS, NDIM)) - 1)
    )

    def fresh(fn, seed=3):
        return EnsembleSampler(
            NWALKERS,
            NDIM,
            log_like,
            priors,
            backend=HDFBackend(fn),
            tempering_kwargs=dict(ntemps=NTEMPS),
            seed=seed,
        )

    # continuous: two runs in ONE sampler object
    fn_a = str(tmp_path / "cont.h5")
    ens = fresh(fn_a)
    ens.run_mcmc(deterministic_coords, 12)
    ens.run_mcmc(None, 12)
    chain_a = ens.get_chain()["model_0"]
    time_a = int(np.asarray(ens.temperature_control.time))
    del ens

    # restart: same two runs, but a BRAND-NEW sampler (new process analog)
    # picks up the file for the second
    fn_b = str(tmp_path / "restart.h5")
    ens1 = fresh(fn_b)
    ens1.run_mcmc(deterministic_coords, 12)
    mid_time = int(np.asarray(ens1.temperature_control.time))
    del ens1
    ens2 = fresh(fn_b, seed=99)  # seed must NOT matter: key comes from file
    assert int(np.asarray(ens2.temperature_control.time)) == mid_time
    ens2.run_mcmc(None, 12)
    chain_b = ens2.get_chain()["model_0"]
    time_b = int(np.asarray(ens2.temperature_control.time))

    assert time_a == time_b
    np.testing.assert_array_equal(chain_a, chain_b)
    betas_a = HDFBackend(fn_a).get_value("betas")
    betas_b = HDFBackend(fn_b).get_value("betas")
    np.testing.assert_array_equal(betas_a, betas_b)
