"""Long-run soak + kill/resume drill on the accelerator.

The checkpoint feature set (HDF5 segment storage + per-segment PRNG key +
run-end kernel states, `eryn_tpu/backends/hdfbackend.py`) is exercised the
way production preemption actually hits it: a sustained device-resident
run is SIGKILLed at a random moment, restarted cold (new process, new
compile), and must finish with a chain statistically indistinguishable
from an identical run that was never killed.  Reference analog: the
reference's HDF checkpointing (`/root/reference/src/eryn/backends/
hdfbackend.py:558-614`) has no such drill; its resume is only exercised
manually in tutorials.

Two process roles:

worker  — owns the sampler.  Builds a heavy RJ+PT pulse-fitting problem
          (RBGS in-model move, so per-move kernel state — the friends
          table — is part of what must survive), attaches an
          ``HDFBackend``, and advances the chain in ``run_mcmc`` chunks
          until the target stored length is reached.  A fresh worker on a
          non-empty file resumes: segment data + PRNG key come from the
          last stored segment, kernel states from the last completed
          chunk (``EnsembleSampler._init_kernel_states``).

drill   — the supervisor.  Calibrates chunk duration, sizes the run to
          ``--minutes`` of device time, then: (1) runs a worker and
          SIGKILLs it at a random point (repeatedly, ``--kills`` times),
          relaunching until it completes; (2) runs an identical control
          worker uninterrupted; (3) compares the two chains — the stored
          prefix up to each kill must be bitwise identical (same seed,
          same hardware, deterministic compiled step), and the full
          post-burn cold chains must agree statistically (tau-corrected
          z-scores on posterior moments, leaf-count distribution).

One process per card: the drill parent never touches JAX while a worker
runs (it polls the HDF5 file's iteration attribute through h5py), and
imports the package only to compare the finished chains.  Workers keep
their compile cache where ``JAX_COMPILATION_CACHE_DIR`` says, else in the
checkout's ``.jax_cache``.

Usage:
    python benchmarks/soak_resume.py drill --minutes 30
    python benchmarks/soak_resume.py drill --minutes 3   # smoke
"""

import argparse
import json
import os
import random
import signal
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np

# ---------------------------------------------------------------- problem

NTEMPS, NWALKERS, NLMAX, NDIM, NPTS = 6, 100, 4, 3, 2048
TRUE_PULSES = [(2.5, 3.1, 0.5), (1.8, 6.4, 0.4)]


def _apply_cpu_shapes():
    """Tiny shapes for the hermetic CPU smoke of the drill machinery."""
    global NTEMPS, NWALKERS, NLMAX, NPTS
    NTEMPS, NWALKERS, NLMAX, NPTS = 4, 32, 3, 128


def build_sampler(fn, seed):
    """Heavy pulse-fit RJ+PT config with an HDF backend on ``fn``."""
    import jax.numpy as jnp

    from eryn_tpu import EnsembleSampler, ProbDistContainer, uniform_dist
    from eryn_tpu.backends import HDFBackend
    from eryn_tpu.moves import RedBlueGroupStretchMove

    rng = np.random.default_rng(100)
    t_np = np.linspace(0.0, 10.0, NPTS)
    sigma = 0.4
    data_np = sum(
        a * np.exp(-((t_np - b) ** 2) / (2 * c**2)) for a, b, c in TRUE_PULSES
    )
    data_np = data_np + sigma * rng.standard_normal(NPTS)
    t = jnp.asarray(t_np, jnp.float32)
    data = jnp.asarray(data_np, jnp.float32)

    def ll(coords, inds):
        a, b, c = coords[:, 0], coords[:, 1], coords[:, 2]
        p = a[:, None] * jnp.exp(
            -((t[None] - b[:, None]) ** 2) / (2 * c[:, None] ** 2)
        )
        tmpl = jnp.sum(jnp.where(inds[:, None], p, 0.0), axis=0)
        return -0.5 * jnp.sum(((tmpl - data) / sigma) ** 2)

    pr = ProbDistContainer(
        {
            0: uniform_dist(0.5, 5.0),
            1: uniform_dist(0.0, 10.0),
            2: uniform_dist(0.1, 2.0),
        }
    )
    fill = float(-0.5 * np.sum((data_np / sigma) ** 2))
    ens = EnsembleSampler(
        NWALKERS,
        NDIM,
        ll,
        pr,
        nleaves_max=NLMAX,
        nleaves_min=0,
        moves=RedBlueGroupStretchMove(),
        rj_moves=True,
        tempering_kwargs=dict(ntemps=NTEMPS),
        fill_zero_leaves_val=fill,
        backend=HDFBackend(fn),
        seed=seed,
    )
    return ens, pr


def worker(args):
    """Advance the chain to ``--total-steps`` stored steps in chunks."""
    import jax

    from eryn_tpu.compile_cache import use_compile_cache

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
        _apply_cpu_shapes()
    # a killed-and-relaunched worker should not pay full recompiles
    use_compile_cache(ROOT)

    ens, pr = build_sampler(args.file, args.seed)
    it = int(ens.backend.iteration) if ens.backend.initialized else 0
    if it == 0:
        # deterministic initial state: killed and control runs must start
        # bitwise identical for the prefix check to mean anything
        rng0 = np.random.default_rng(args.seed)
        lo = np.array([0.5, 0.0, 0.1])
        hi = np.array([5.0, 10.0, 2.0])
        coords = {
            "model_0": lo
            + (hi - lo) * rng0.random((NTEMPS, NWALKERS, NLMAX, NDIM))
        }
        inds = {"model_0": rng0.random((NTEMPS, NWALKERS, NLMAX)) < 0.5}
        from eryn_tpu import State

        start = ens._setup_state(State(coords, inds=inds))
        resumed = False
    else:
        start = None
        resumed = True
    print(
        f"WORKER start iteration={it}/{args.total_steps} resumed={resumed}",
        flush=True,
    )
    while it < args.total_steps:
        n = min(args.chunk_steps, args.total_steps - it)
        t0 = time.perf_counter()
        ens.run_mcmc(start, n, thin_by=args.thin, progress=False)
        start = None
        it = int(ens.backend.iteration)
        print(
            f"CHUNK it={it}/{args.total_steps} "
            f"dt={time.perf_counter() - t0:.1f}s",
            flush=True,
        )
    print("WORKER done", flush=True)
    return 0


# ----------------------------------------------------------------- drill


def _spawn_worker(fn, seed, total_steps, chunk_steps, thin, log, cpu=False):
    return subprocess.Popen(
        [
            sys.executable,
            os.path.abspath(__file__),
            "worker",
            "--file",
            fn,
            "--seed",
            str(seed),
            "--total-steps",
            str(total_steps),
            "--chunk-steps",
            str(chunk_steps),
            "--thin",
            str(thin),
        ]
        + (["--cpu"] if cpu else []),
        stdout=log,
        stderr=subprocess.STDOUT,
        cwd=ROOT,
    )


def _run_to_completion(
    fn, seed, total, chunk, thin, logpath, kills, rng, cpu=False,
    min_kill_delay=5.0,
):
    """Run a worker to completion, SIGKILLing it ``kills`` times at random
    moments.  Returns (kill_iterations, wall_seconds, n_launches).  A
    worker that exits is finished only when it reached ``total`` with
    rc=0; any other death raises."""
    kill_its = []
    launches = 0
    t0 = time.perf_counter()
    remaining_kills = kills
    probe_window = max(1.0, min(5.0, _CHUNK_SECONDS or 1.0))
    while True:
        with open(logpath, "a") as log:
            p = _spawn_worker(fn, seed, total, chunk, thin, log, cpu)
            launches += 1
            killed = False
            kill_deadline = None
            probe_it = probe_t = None
            base_it = _iteration(fn)
            while p.poll() is None:
                time.sleep(min(2.0, max(0.2, (_CHUNK_SECONDS or 2.0) / 2.0)))
                now = time.perf_counter()
                it = _iteration(fn)
                if kill_deadline is not None:
                    if now >= kill_deadline:
                        p.send_signal(signal.SIGKILL)
                        p.wait()
                        killed = True
                elif remaining_kills > 0 and it > base_it:
                    # arm the kill only after at least one NEW chunk landed
                    # in the file (a kill before any stored progress would
                    # make the bitwise-prefix check vacuous); estimate the
                    # remaining duration from the live progress rate, then
                    # fire at a random 20-60% of it
                    if probe_it is None:
                        probe_it, probe_t = it, now
                    elif it > probe_it and now - probe_t >= probe_window:
                        remaining = (total - it) * (now - probe_t) / (it - probe_it)
                        delay = rng.uniform(0.2, 0.6) * remaining
                        kill_deadline = now + max(min_kill_delay, delay)
        it = _iteration(fn)
        if killed:
            kill_its.append(it)
            print(f"DRILL killed worker at iteration={it}", flush=True)
            remaining_kills -= 1
            continue
        if p.returncode == 0 and it >= total:
            break
        raise RuntimeError(
            f"worker exited rc={p.returncode} at iteration={it}/{total}; "
            f"see {logpath}"
        )
    return kill_its, time.perf_counter() - t0, launches


_CHUNK_SECONDS = None


def _iteration(fn):
    if not os.path.exists(fn):
        return 0
    import h5py

    for _ in range(10):
        try:
            # locking=False: the worker holds the HDF5 write lock for the
            # whole run; the supervisor only peeks at a single attr
            with h5py.File(fn, "r", locking=False) as f:
                return int(f["mcmc"].attrs["iteration"])
        except (BlockingIOError, OSError, KeyError):
            time.sleep(0.2)
    return 0


def _cold_chain(fn):
    from eryn_tpu.backends import HDFBackend

    b = HDFBackend(fn)
    chain = b.get_chain()["model_0"]  # (n, nt, nw, nl, nd)
    inds = b.get_inds()["model_0"]
    ll = b.get_log_like()
    return chain, inds, ll


def compare(fn_a, fn_b, kill_its):
    """Bitwise prefix + statistical full-run comparison.  Returns a result
    dict; raises AssertionError on a real mismatch."""
    ch_a, in_a, ll_a = _cold_chain(fn_a)
    ch_b, in_b, ll_b = _cold_chain(fn_b)
    assert ch_a.shape == ch_b.shape, (ch_a.shape, ch_b.shape)
    n = ch_a.shape[0]

    # (1) bitwise prefix: everything stored before the FIRST kill comes
    # from identical (seeded, deterministic) compiled steps on the same
    # card — any drift there is a checkpoint bug, not statistics.
    # equal_nan: dormant RJ slots legitimately hold NaN in both runs.
    first_kill = min(kill_its) if kill_its else n
    prefix_bitwise = bool(
        np.array_equal(ch_a[:first_kill], ch_b[:first_kill], equal_nan=True)
        and np.array_equal(in_a[:first_kill], in_b[:first_kill])
    )
    full_bitwise = bool(
        np.array_equal(ch_a, ch_b, equal_nan=True)
        and np.array_equal(in_a, in_b)
    )

    # (2) statistical comparison of the post-burn cold chains
    burn = n // 4
    res = {
        "stored_steps": int(n),
        "kill_iterations": [int(k) for k in kill_its],
        "prefix_bitwise_identical": prefix_bitwise,
        "full_bitwise_identical": full_bitwise,
    }

    from eryn_tpu.utils.utility import get_integrated_act

    # active cold-chain leaf parameters, pooled over walkers/leaves
    stats = {}
    for tag, ch, ins, ll in (
        ("killed", ch_a, in_a, ll_a),
        ("control", ch_b, in_b, ll_b),
    ):
        cold = ch[burn:, 0]
        act = ins[burn:, 0].astype(bool)
        vals = cold[act]  # (nsel, nd)
        taus = []
        # tau from the pooled per-walker log-like (well-defined scalar
        # series per walker)
        series = ll[burn:, 0]  # (n, nw)
        tau = float(
            np.max(get_integrated_act(series[:, :, None], average=True))
        )
        nleaves = act.sum(-1)
        stats[tag] = {
            "mean": vals.mean(0),
            "std": vals.std(0),
            "nsel": len(vals),
            "tau": tau,
            "ess": series.size / max(tau, 1.0),
            "leaf_hist": np.bincount(nleaves.ravel(), minlength=NLMAX + 1)
            / nleaves.size,
        }
    za, zb = stats["killed"], stats["control"]
    ess = min(za["ess"], zb["ess"])
    sem = np.sqrt(za["std"] ** 2 + zb["std"] ** 2) / np.sqrt(ess)
    z = np.abs(za["mean"] - zb["mean"]) / np.maximum(sem, 1e-12)
    zmax = float(z.max())
    leaf_l1 = float(np.abs(za["leaf_hist"] - zb["leaf_hist"]).sum())
    res.update(
        {
            "tau_killed": za["tau"],
            "tau_control": zb["tau"],
            "ess_min": float(ess),
            "posterior_mean_zmax": zmax,
            "leaf_hist_L1": leaf_l1,
            "mean_killed": [float(v) for v in za["mean"]],
            "mean_control": [float(v) for v in zb["mean"]],
        }
    )
    assert prefix_bitwise, "pre-kill stored prefix differs — checkpoint bug"
    assert zmax < 5.0, f"posterior moments diverged: zmax={zmax}"
    assert leaf_l1 < 0.1, f"leaf-count posterior diverged: L1={leaf_l1}"
    return res


def drill(args):
    if args.cpu:
        _apply_cpu_shapes()
    os.makedirs(args.outdir, exist_ok=True)
    fn_k = os.path.join(args.outdir, "soak_killed.h5")
    fn_c = os.path.join(args.outdir, "soak_control.h5")
    for f in (fn_k, fn_c):
        if os.path.exists(f):
            os.remove(f)
    rng = random.Random(args.drill_seed)

    # calibrate: run the control's first TWO chunks and time the second
    # (the first folds in the cold compile), then size the run so the
    # KILLED run alone holds the device for ~args.minutes
    cal_log = os.path.join(args.outdir, "calibrate.log")
    _run_to_completion(
        fn_c, args.seed, 2 * args.chunk_steps, args.chunk_steps,
        args.thin, cal_log, 0, rng, args.cpu,
    )
    global _CHUNK_SECONDS
    dts = [
        float(line.rsplit("dt=", 1)[1].rstrip("s\n"))
        for line in open(cal_log)
        if "dt=" in line
    ]
    _CHUNK_SECONDS = max(dts[-1], 0.05)
    nchunks = max(args.min_chunks, int(args.minutes * 60 / _CHUNK_SECONDS))
    total = nchunks * args.chunk_steps
    print(
        f"DRILL calibrated: chunk={_CHUNK_SECONDS:.0f}s -> {nchunks} chunks "
        f"({total} stored steps, thin={args.thin}, "
        f"{total * args.thin} proposals)",
        flush=True,
    )

    kill_its, wall_k, launches = _run_to_completion(
        fn_k, args.seed, total, args.chunk_steps, args.thin,
        os.path.join(args.outdir, "killed.log"), args.kills, rng, args.cpu,
        min_kill_delay=args.min_kill_delay,
    )
    _, wall_c, _ = _run_to_completion(
        fn_c, args.seed, total, args.chunk_steps, args.thin,
        os.path.join(args.outdir, "control.log"), 0, rng, args.cpu,
    )
    res = compare(fn_k, fn_c, kill_its)
    res.update(
        {
            "config": dict(
                ntemps=NTEMPS, nwalkers=NWALKERS, nleaves_max=NLMAX,
                ndim=NDIM, npts=NPTS, thin=args.thin,
            ),
            "proposals": total * args.thin,
            "killed_wall_seconds": round(wall_k, 1),
            "control_wall_seconds": round(wall_c, 1),
            "worker_launches": launches,
            "kills": len(kill_its),
        }
    )
    out = os.path.join(args.outdir, "soak_result.json")
    with open(out, "w") as f:
        json.dump(res, f, indent=1)
    print("DRILL result:", json.dumps(res), flush=True)
    print(f"DRILL OK -> {out}", flush=True)


def main():
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    w = sub.add_parser("worker")
    w.add_argument("--file", required=True)
    w.add_argument("--seed", type=int, default=7)
    w.add_argument("--total-steps", type=int, required=True)
    w.add_argument("--chunk-steps", type=int, default=64)
    w.add_argument("--thin", type=int, default=256)
    w.add_argument("--cpu", action="store_true")
    d = sub.add_parser("drill")
    d.add_argument("--cpu", action="store_true")
    d.add_argument("--minutes", type=float, default=30.0)
    d.add_argument("--outdir", default=os.path.join(ROOT, "chiprun_out", "soak"))
    d.add_argument("--seed", type=int, default=7)
    d.add_argument("--drill-seed", type=int, default=1234)
    d.add_argument("--chunk-steps", type=int, default=64)
    d.add_argument("--thin", type=int, default=256)
    d.add_argument("--kills", type=int, default=2)
    d.add_argument("--min-kill-delay", type=float, default=5.0)
    d.add_argument("--min-chunks", type=int, default=4)
    args = ap.parse_args()
    if args.cmd == "worker":
        sys.exit(worker(args))
    drill(args)


if __name__ == "__main__":
    main()
