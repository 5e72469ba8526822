"""Reference-style `vectorize=True` + `provide_groups` likelihood contract
(legacy NumPy callback bridge, `ensemble.py:1305-1406` semantics)."""

import os

import numpy as np
import pytest

from eryn_tpu import EnsembleSampler, ProbDistContainer, State, uniform_dist


def test_vectorized_groups_rj():
    rng = np.random.default_rng(2)
    t = np.linspace(0, 10, 64)
    sigma = 0.4
    data = 3.0 * np.exp(-((t - 5.0) ** 2) / (2 * 0.8**2))
    data = data + sigma * rng.standard_normal(len(t))

    calls = {"n": 0}

    def log_like(x, groups):
        # x: (total_active_leaves, 3); groups: flat walker id per leaf
        calls["n"] += 1
        nwalkers_here = groups.max() + 1 if len(groups) else 0
        templates = np.zeros((nwalkers_here, len(t)))
        for params, g in zip(x, groups):
            a, b, c = params
            templates[g] += a * np.exp(-((t - b) ** 2) / (2 * c**2))
        return -0.5 * np.sum(((templates - data) / sigma) ** 2, axis=-1)

    priors = ProbDistContainer(
        {
            0: uniform_dist(0.5, 5.0),
            1: uniform_dist(0.0, 10.0),
            2: uniform_dist(0.2, 2.0),
        }
    )
    nlmax = 2
    with pytest.warns(UserWarning, match="not JAX-traceable"):
        ens = EnsembleSampler(
            16,
            3,
            log_like,
            priors,
            nleaves_max=nlmax,
            nleaves_min=0,
            rj_moves=True,
            vectorize=True,
            provide_groups=True,
            fill_zero_leaves_val=float(-0.5 * np.sum((data / sigma) ** 2)),
            seed=41,
        )
    coords = priors.rvs(size=(1, 16, nlmax))
    inds = np.random.rand(1, 16, nlmax) < 0.7
    inds[..., 0] = True
    ens.run_mcmc(State({"model_0": coords}, inds={"model_0": inds}), 20, burn=5)
    assert calls["n"] > 0
    ll = ens.get_log_like()
    assert ll.shape == (20, 1, 16)
    assert np.all(np.isfinite(ll))
    # likelihood improves from the prior draw as the pulse is found
    assert ll[-1].max() > ll[0].max() - 1.0


def test_callback_supplementals_and_pool():
    """Legacy NumPy likelihoods receive active-leaf branch supplementals as a
    branch_supps kwarg and fan out through a user pool's .map
    (ref ensemble.py:1408-1481)."""
    from eryn_tpu import BranchSupplemental, State

    ndim, nwalkers = 2, 16
    seen = {"supps": 0}

    def np_ll(x, branch_supps=None):
        # host NumPy likelihood (not traceable: uses np.polyfit)
        assert branch_supps is not None and "model_0" in branch_supps
        tag = branch_supps["model_0"]["tag"]
        assert tag.shape[0] == 1  # active leaves of this walker
        seen["supps"] += 1
        _ = np.polyfit(np.arange(ndim), np.asarray(x, dtype=float), 1)
        return -0.5 * float(np.sum(np.asarray(x) ** 2)) + 0.0 * float(tag[0])

    class CountingPool:
        def __init__(self):
            self.calls = 0

        def map(self, fn, items):
            items = list(items)
            self.calls += 1
            return [fn(it) for it in items]

    pool = CountingPool()
    priors = ProbDistContainer({i: uniform_dist(-5, 5) for i in range(ndim)})
    ens = EnsembleSampler(
        nwalkers,
        ndim,
        np_ll,
        priors,
        provide_supplemental=True,
        pool=pool,
        seed=31,
    )
    # mode decision is deferred until real supps are seen
    assert ens._like_eval.mode is None

    coords = priors.rvs(size=(1, nwalkers, 1))
    supp = BranchSupplemental(
        {"tag": np.arange(nwalkers, dtype=float).reshape(1, nwalkers, 1)},
        base_shape=(1, nwalkers, 1),
    )
    state = State(
        {"model_0": coords}, branch_supplemental={"model_0": supp}
    )
    ens.run_mcmc(state, 10)
    assert seen["supps"] > 0
    assert pool.calls > 0
    assert np.isfinite(ens.get_log_like()).all()
    assert ens._like_eval.mode == "callback"


def test_callback_vectorized_supplementals():
    """vectorize=True on the host bridge passes active-leaf branch
    supplementals as a branch_supps kwarg (ref ensemble.py:1387-1399)."""
    from eryn_tpu import BranchSupplemental, State

    ndim, nwalkers = 2, 16
    seen = {"n": 0}

    def np_ll(x, groups, branch_supps=None):
        assert branch_supps is not None and "tag" in branch_supps
        assert branch_supps["tag"].shape[0] == x.shape[0]
        seen["n"] += 1
        _ = np.polyfit(np.arange(ndim), np.asarray(x[0], dtype=float), 1)
        amp = np.zeros(int(groups.max()) + 1)
        np.add.at(amp, groups, -0.5 * np.sum(np.asarray(x) ** 2, axis=-1))
        return amp

    priors = ProbDistContainer({i: uniform_dist(-5, 5) for i in range(ndim)})
    ens = EnsembleSampler(
        nwalkers,
        ndim,
        np_ll,
        priors,
        vectorize=True,
        provide_groups=True,
        provide_supplemental=True,
        seed=32,
    )
    coords = priors.rvs(size=(1, nwalkers, 1))
    supp = BranchSupplemental(
        {"tag": np.arange(nwalkers, dtype=float).reshape(1, nwalkers, 1)},
        base_shape=(1, nwalkers, 1),
    )
    ens.run_mcmc(
        State({"model_0": coords}, branch_supplemental={"model_0": supp}), 10
    )
    assert seen["n"] > 0
    assert ens._like_eval.mode == "callback"
    assert np.isfinite(ens.get_log_like()).all()


def test_real_multiprocessing_pool(tmp_path, monkeypatch):
    """A REAL ``multiprocessing.Pool`` (spawn) drives the callback path:
    the wrapped likelihood pickles, fans out to worker processes, and the
    chain is identical to a serial run with the same seed (a fake pool
    would never exercise pickling or process boundaries; ref ``ensemble.py:1474-1481,1623-1667``)."""
    import multiprocessing as mp

    from _pool_ll import pool_log_like

    pid_file = tmp_path / "worker_pids.txt"
    monkeypatch.setenv("ERYN_TPU_POOL_PID_FILE", str(pid_file))

    ndim, nwalkers, nsteps = 2, 12, 8
    priors = ProbDistContainer({i: uniform_dist(-5, 5) for i in range(ndim)})
    coords = priors.rvs(size=(1, nwalkers, 1))

    def run(pool):
        ens = EnsembleSampler(
            nwalkers, ndim, pool_log_like, priors, pool=pool, seed=77
        )
        ens.run_mcmc(State({"model_0": coords.copy()}), nsteps)
        return ens.get_chain()["model_0"], ens.get_log_like()

    # spawn (not fork): forking a process with live XLA threads can hang;
    # workers re-import only numpy + the helper module + the package
    ctx = mp.get_context("spawn")
    with ctx.Pool(2) as pool:
        chain_pool, ll_pool = run(pool)

    monkeypatch.delenv("ERYN_TPU_POOL_PID_FILE")
    chain_serial, ll_serial = run(None)

    # the likelihood really ran in OTHER processes (the parent pid also
    # appears: the initial-state evaluation happens in-process)
    worker_pids = {int(p) for p in pid_file.read_text().split()}
    assert worker_pids - {os.getpid()}, (
        "pool workers never evaluated the likelihood"
    )

    # pool fan-out is a pure execution detail: results are bit-identical
    np.testing.assert_array_equal(chain_pool, chain_serial)
    np.testing.assert_array_equal(ll_pool, ll_serial)
    assert np.isfinite(ll_pool).all()
