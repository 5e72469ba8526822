"""Per-step device metrics of the compiled sampler step, from a profiler trace.

For each cell, runs ``nsteps`` store-free steps untraced (steps/s), then
the same number under ``jax.profiler.trace`` and reduces the trace to:

- ``kernels_per_step`` and ``device_busy_us_per_step`` over all kernels;
- the same two numbers for the kernels of one named scope (``--scope``,
  default ``pt_swap``: the tempering swap phase) and that scope's share of
  device busy time;
- ``device_idle_share`` of the traced window.

Cells: ``north_star`` (PT 10 x 100, 5-D Gaussian, StretchMove), the same at
256 and 512 walkers, and ``config_e`` (PT 20 x 1000, 8-leaf RJ +
GroupStretchMove, 128-point templates).  ``--xla-cascade`` also traces
each cell with the XLA rung loop in place of the swap-cascade kernel;
``--cascade-ab PAIRS`` times the two against each other, alternating, and
checks both for run-to-run and cross-variant bitwise agreement.  Needs a
GPU.

Usage: ``python benchmarks/step_trace.py [--cells ...] [--nsteps N]
[--xla-cascade] [--cascade-ab PAIRS] [--out DIR]``.  Prints one JSON line
per measurement; ``--out`` also receives every kernel of each cell with
its time and scope, and the compiled HLO, for reading by hand.
"""

from __future__ import annotations

import argparse
import functools
import glob
import json
import os
import re
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402


def _north_star(seed=0, nwalkers=100):
    import jax.numpy as jnp

    from eryn_tpu import EnsembleSampler, ProbDistContainer, uniform_dist

    def log_like(x):
        return -0.5 * jnp.sum(x * x)

    priors = ProbDistContainer({i: uniform_dist(-5.0, 5.0) for i in range(5)})
    s = EnsembleSampler(
        nwalkers, 5, log_like, priors, tempering_kwargs=dict(ntemps=10), seed=seed
    )
    return s, s._setup_state(priors.rvs(size=(10, nwalkers)))


def _config_e(seed=0):
    import jax.numpy as jnp

    from eryn_tpu import EnsembleSampler, ProbDistContainer, State, uniform_dist
    from eryn_tpu.moves import GroupStretchMove

    t = jnp.linspace(0.0, 10.0, 128)

    def log_like(coords, inds):
        a, b, c = coords[:, 0], coords[:, 1], coords[:, 2]
        p = a[:, None] * jnp.exp(-((t[None] - b[:, None]) ** 2) / (2 * c[:, None] ** 2))
        return -0.5 * jnp.sum(jnp.sum(jnp.where(inds[:, None], p, 0.0), axis=0) ** 2)

    pr = ProbDistContainer(
        {0: uniform_dist(0.5, 5.0), 1: uniform_dist(0.0, 10.0), 2: uniform_dist(0.1, 2.0)}
    )
    nt, nw, nl = 20, 1000, 8
    s = EnsembleSampler(
        nw,
        3,
        log_like,
        pr,
        nleaves_max=nl,
        nleaves_min=0,
        moves=[GroupStretchMove(n_iter_update=3)],
        rj_moves=True,
        tempering_kwargs=dict(ntemps=nt),
        fill_zero_leaves_val=-1e4,
        seed=seed,
    )
    coords = pr.rvs(size=(nt, nw, nl))
    inds = np.random.default_rng(seed).random((nt, nw, nl)) < 0.4
    return s, s._setup_state(State({"model_0": coords}, inds={"model_0": inds}))


CELLS = {"north_star": _north_star, "config_e": _config_e}
# the north-star target at wider ensembles: where the single-launch swap
# cascade stops paying (moves/tempering.py CASCADE_KERNEL_MAX_WALKERS)
for _nw in (256, 512):
    CELLS[f"north_star_w{_nw}"] = functools.partial(_north_star, nwalkers=_nw)

_COPY_PREFIXES = ("memcpy", "memset", "Memcpy", "Memset")


def _union_ns(intervals):
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


_INSTR = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=")
_OP_NAME = re.compile(r'op_name="([^"]*)"')


def scope_ops(hlo_text, scope):
    """Names (as kernels are named in a trace: dots made underscores) of
    the instructions of a compiled HLO module whose ``op_name`` metadata
    carries the ``jax.named_scope``.  A fusion carries the metadata of its
    root, so a fusion that ends in another scope's op (the swap's state
    gather fused into the next likelihood, say) counts for that scope."""
    names = set()
    for line in hlo_text.splitlines():
        instr = _INSTR.match(line)
        op = _OP_NAME.search(line)
        if instr and op and scope in op.group(1):
            names.add(instr.group(1).replace(".", "_"))
    return names


def _in_scope(kernel_name, names, scope):
    # hand-written kernels are named for their scope; one HLO op may
    # launch several kernels: "<op>_<k>"
    if scope in kernel_name or kernel_name in names:
        return True
    base, _, tail = kernel_name.rpartition("_")
    return tail.isdigit() and base in names


def reduce_trace(xplane_path, scope, scope_names):
    """Kernel events of the first GPU device plane of one trace file.

    Returns ``(metrics, kernels)``: totals over the traced window and the
    per-kernel list ``[(name, start_ns, duration_ns, in_scope)]``.  A
    kernel is in ``scope`` when its name is one of ``scope_names``
    (:func:`scope_ops`) or names the scope itself."""
    import jax

    pd = jax.profiler.ProfileData.from_file(xplane_path)
    planes = [p for p in pd.planes if p.name.startswith("/device:GPU")]
    if not planes:
        raise RuntimeError(f"no GPU device plane in {xplane_path}")
    plane = sorted(planes, key=lambda p: p.name)[0]
    kernels, copies, lines = [], [], {}
    for line in plane.lines:
        events = list(line.events)
        lines[line.name] = len(events)
        if not line.name.startswith("Stream"):
            continue  # derived lines (XLA Modules/Ops) repeat the kernels
        for ev in events:
            start = int(ev.start_ns)
            dur = int(ev.duration_ns)
            if ev.name.startswith(_COPY_PREFIXES):
                copies.append((start, start + dur))
            else:
                hit = _in_scope(ev.name, scope_names, scope)
                kernels.append((ev.name, start, dur, hit))
    if not kernels:
        raise RuntimeError(f"no kernel events on {plane.name}: lines {lines}")
    spans = [(s, s + d) for _, s, d, _ in kernels] + copies
    window = max(e for _, e in spans) - min(s for s, _ in spans)
    scope_spans = [(s, s + d) for _, s, d, h in kernels if h]
    metrics = {
        "plane": plane.name,
        "lines": lines,
        "kernels": len(kernels),
        "copies": len(copies),
        "busy_ns": _union_ns(spans),
        "window_ns": window,
        "scope_kernels": len(scope_spans),
        "scope_busy_ns": _union_ns(scope_spans),
    }
    return metrics, kernels


def _build_and_warm(name, nsteps, cascade_kernel=True):
    """A cell's sampler after one compiled store-free segment.  With
    ``cascade_kernel=False`` its step is traced with the XLA rung loop in
    place of the single-launch cascade kernel."""
    import jax

    from eryn_tpu.moves import tempering

    np.random.seed(0)
    sampler, state = CELLS[name]()
    use = tempering._use_cascade_kernel
    if not cascade_kernel:
        tempering._use_cascade_kernel = lambda logl: False
    try:  # the choice is made while the step is traced
        t0 = time.perf_counter()
        st, _ = sampler._run_bulk(state, 1, nsteps, store=False)
        jax.block_until_ready(st.log_like)
    finally:
        tempering._use_cascade_kernel = use
    return sampler, st, time.perf_counter() - t0


def run_cell(name, nsteps, scope, out_dir, cascade_kernel=True):
    import jax
    import jax.numpy as jnp

    sampler, st, warm_s = _build_and_warm(name, nsteps, cascade_kernel)

    # the compiled module of the very program traced below
    tc = sampler.temperature_control
    hlo = (
        sampler._get_bulk_fn(1, nsteps, False, False)
        .lower(
            sampler._key,
            st,
            jnp.asarray(tc.time, dtype=jnp.int32),
            *sampler._counters_dev,
            sampler._kernel_states,
        )
        .compile()
        .as_text()
    )
    names = scope_ops(hlo, scope)

    t0 = time.perf_counter()
    st, _ = sampler._run_bulk(st, 1, nsteps, store=False)
    jax.block_until_ready(st.log_like)
    steps_per_s = nsteps / (time.perf_counter() - t0)

    with tempfile.TemporaryDirectory() as trace_dir:
        with jax.profiler.trace(trace_dir):
            st, _ = sampler._run_bulk(st, 1, nsteps, store=False)
            jax.block_until_ready(st.log_like)
        path = glob.glob(os.path.join(trace_dir, "plugins/profile/*/*.xplane.pb"))[0]
        m, kernels = reduce_trace(path, scope, names)

    # every kernel, summed by name, for reading the trace by hand
    by_name = {}
    for kname, _, dur, hit in kernels:
        e = by_name.setdefault(kname, [kname, 0, 0, hit])
        e[1] += dur
        e[2] += 1
    tag = name if cascade_kernel else f"{name}_xla_cascade"
    with open(os.path.join(out_dir, f"kernels_{tag}.json"), "w") as f:
        json.dump(
            {
                "metrics": m,
                "columns": ["kernel", "total_ns", "launches", "in_scope"],
                "kernels": sorted(by_name.values(), key=lambda e: -e[1]),
            },
            f,
            indent=1,
        )

    dev = jax.devices()[0]
    return {
        "cell": name,
        "cascade": "kernel" if cascade_kernel else "xla_loop",
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "nsteps": nsteps,
        "compile_and_first_run_s": warm_s,
        "steps_per_s": steps_per_s,
        "kernels_per_step": m["kernels"] / nsteps,
        "device_busy_us_per_step": m["busy_ns"] / nsteps / 1e3,
        "device_idle_share": 1.0 - m["busy_ns"] / m["window_ns"],
        "scope": scope,
        "scope_kernels_per_step": m["scope_kernels"] / nsteps,
        "scope_busy_us_per_step": m["scope_busy_ns"] / nsteps / 1e3,
        "scope_share_of_busy": m["scope_busy_ns"] / m["busy_ns"],
    }


def _same(a, b):
    import jax

    return all(
        np.array_equal(np.asarray(x), np.asarray(y), equal_nan=True)
        for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b))
    )


def cascade_ab(name, nsteps, pairs):
    """End-to-end steps/s with the single-launch cascade kernel against the
    XLA rung loop, on one card, alternating (off, on, on, off, ...).

    Every sampler starts from the same state and key.  Two samplers of one
    variant agree bit for bit when the step is deterministic run to run;
    the kernel is bitwise the XLA cascade, so then the variants agree too."""
    import jax

    runs = {k: _build_and_warm(name, nsteps, k)[:2] for k in (False, True)}
    twins = {k: _build_and_warm(name, nsteps, k)[1] for k in (False, True)}
    same = {
        "xla_loop_twice": _same(runs[False][1], twins[False]),
        "kernel_twice": _same(runs[True][1], twins[True]),
        "kernel_vs_xla_loop": _same(runs[True][1], runs[False][1]),
    }
    rates = {False: [], True: []}
    for k in range(pairs):
        for kernel in ((False, True) if k % 2 == 0 else (True, False)):
            sampler, st = runs[kernel]
            t0 = time.perf_counter()
            st, _ = sampler._run_bulk(st, 1, nsteps, store=False)
            jax.block_until_ready(st.log_like)
            rates[kernel].append(nsteps / (time.perf_counter() - t0))
            runs[kernel] = (sampler, st)
    wins = sum(on > off for on, off in zip(rates[True], rates[False]))
    return {
        "cell": name,
        "cascade_ab": True,
        "nsteps": nsteps,
        "bitwise_equal_after_first_segment": same,
        "steps_per_s_xla_loop": rates[False],
        "steps_per_s_kernel": rates[True],
        "median_xla_loop": float(np.median(rates[False])),
        "median_kernel": float(np.median(rates[True])),
        "kernel_wins": f"{wins}/{pairs}",
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nsteps", type=int, default=200)
    ap.add_argument("--scope", default="pt_swap")
    ap.add_argument("--cells", nargs="*", default=list(CELLS))
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "step_trace"))
    ap.add_argument(
        "--xla-cascade",
        action="store_true",
        help="also trace each cell with the XLA rung loop for the cascade",
    )
    ap.add_argument(
        "--cascade-ab",
        type=int,
        default=0,
        metavar="PAIRS",
        help="also time the cascade kernel against the XLA rung loop",
    )
    args = ap.parse_args(argv)

    import jax

    if jax.devices()[0].platform != "gpu":
        print("step_trace: no GPU; nothing measured", file=sys.stderr)
        return 1
    from eryn_tpu.compile_cache import use_compile_cache

    use_compile_cache(ROOT)
    os.makedirs(args.out, exist_ok=True)
    for name in args.cells:
        for kernel in (True, False) if args.xla_cascade else (True,):
            res = run_cell(name, args.nsteps, args.scope, args.out, kernel)
            print(json.dumps(res), flush=True)
        if args.cascade_ab:
            print(json.dumps(cascade_ab(name, 10 * args.nsteps, args.cascade_ab)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
