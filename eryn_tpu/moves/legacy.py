"""Host-bridge execution of reference-style custom moves.

Reference users extend the proposal zoo by subclassing and implementing
host-side NumPy hooks:

* ``RedBlueMove``/``StretchMove`` subclasses implement
  ``get_proposal(s_all, c_all, random, gibbs_ndim=None)``
  (ref ``/root/reference/src/eryn/moves/red_blue.py:16-87``);
* ``MHMove`` subclasses implement
  ``get_proposal(branches_coords, random, branches_inds=None, ...)``
  (ref ``moves/mh.py:16-60``);
* ``GroupMove``/``GroupStretchMove`` subclasses implement ``setup_friends``
  / ``find_friends`` / ``fix_friends``
  (ref ``moves/group.py:50-96``, exercised by the reference's own test
  suite, ``/root/reference/tests/test_eryn.py:813-907``).

The compiled kernels use different (traced) signatures, so these classes
cannot run inside the compiled segment.  This module executes the
reference's *host protocol* for them — NumPy arrays, ``model.random``,
mutable supplemental holders — one proposal at a time, between device
dispatches.  The sampler detects a move with ``host_move = True`` and runs
the whole chain in host-step mode (see
``EnsembleSampler._run_host_segment``): correct and reference-compatible,
but orders of magnitude slower than the compiled path.  Porting the hook to
the ``*_kernel`` API (see ``docs/migration.md``) recovers full speed.

Implementation note: protocols are re-derived from the reference's
documented behavior (file:line cited per function), not transcribed; all
bookkeeping here is vectorized NumPy on host copies of the state.
"""

from __future__ import annotations

import numpy as np

__all__ = ["host_propose", "is_legacy_move"]


def is_legacy_move(move):
    return bool(getattr(move, "host_move", False))


# ----------------------------------------------------------------------
# host views of state containers
# ----------------------------------------------------------------------
class _HostSupp:
    """NumPy-backed supplemental holder with the reference
    ``BranchSupplemental`` indexing surface (ref ``state.py:176-208``):
    hooks mutate it in place; the bridge converts back at the end."""

    def __init__(self, holder, base_shape):
        # np.array, not asarray: buffers backed by device memory are
        # read-only views, and hooks mutate these in place
        self.holder = {k: np.array(v) for k, v in holder.items()}
        self.base_shape = tuple(base_shape)

    def __getitem__(self, key):
        if isinstance(key, str):
            return self.holder[key]
        return {name: value[key] for name, value in self.holder.items()}

    def __setitem__(self, key, value):
        if isinstance(key, str):
            self.holder[key] = np.asarray(value)
            return
        if not isinstance(value, dict):
            raise ValueError(
                "Setting with an index requires a dict of per-name values."
            )
        for name, val in value.items():
            self.holder[name][key] = val

    def __contains__(self, name):
        return name in self.holder

    @property
    def contained_objects(self):
        return list(self.holder.keys())

    def take_along_axis(self, indices, axis, skip_names=()):
        return {
            name: np.take_along_axis(
                value,
                indices.reshape(
                    indices.shape + (1,) * (value.ndim - indices.ndim)
                ),
                axis=axis,
            )
            for name, value in self.holder.items()
            if name not in skip_names
        }

    def copy(self):
        return _HostSupp(
            {k: v.copy() for k, v in self.holder.items()}, self.base_shape
        )


class _HostBranch:
    """Duck-typed ``Branch`` view handed to legacy hooks: NumPy coords/inds
    (hooks do in-place writes like ``self.friends[:] = ...``) plus the
    reference's ``branch_supplemental`` attribute name."""

    def __init__(self, coords, inds, branch_supplemental=None):
        self.coords = coords
        self.inds = inds
        self.branch_supplemental = branch_supplemental

    @property
    def supplemental(self):
        return self.branch_supplemental

    @property
    def shape(self):
        return self.coords.shape

    @property
    def nleaves(self):
        return self.inds.sum(axis=-1)


def _host_snapshot(state):
    """Mutable host copy of a :class:`eryn_tpu.state.State`."""
    hs = {
        "coords": {
            n: np.array(c) for n, c in state.branches_coords.items()
        },
        "inds": {n: np.array(v) for n, v in state.branches_inds.items()},
        "log_like": np.array(state.log_like),
        "log_prior": np.array(state.log_prior),
        "blobs": None if state.blobs is None else np.array(state.blobs),
        "betas": None if state.betas is None else np.array(state.betas),
    }
    supp = state.supplemental
    hs["supp"] = (
        _HostSupp(supp.holder, supp.base_shape)
        if supp is not None and supp.holder
        else None
    )
    hs["branch_supps"] = {}
    for name, bs in state.branches_supplemental.items():
        hs["branch_supps"][name] = (
            _HostSupp(bs.holder, bs.base_shape)
            if bs is not None and bs.holder
            else None
        )
    return hs


def _branches_view(hs):
    return {
        name: _HostBranch(
            hs["coords"][name],
            hs["inds"][name],
            branch_supplemental=hs["branch_supps"].get(name),
        )
        for name in hs["coords"]
    }


def _host_to_state(hs):
    from ..state import BranchSupplemental, State

    branch_supplemental = {}
    any_bs = False
    for name in hs["coords"]:
        bs = hs["branch_supps"].get(name)
        if bs is not None:
            branch_supplemental[name] = BranchSupplemental(
                bs.holder, base_shape=bs.base_shape
            )
            any_bs = True
        else:
            branch_supplemental[name] = None
    supp = None
    if hs["supp"] is not None:
        supp = BranchSupplemental(
            hs["supp"].holder, base_shape=hs["supp"].base_shape
        )
    return State(
        hs["coords"],
        inds=hs["inds"],
        log_like=hs["log_like"],
        log_prior=hs["log_prior"],
        blobs=hs["blobs"],
        betas=hs["betas"],
        supplemental=supp,
        branch_supplemental=branch_supplemental if any_bs else None,
    )


# ----------------------------------------------------------------------
# shared protocol machinery (host semantics of ref move.py:113-402)
# ----------------------------------------------------------------------
def _gibbs_iterator(move, all_branch_names):
    """Yield ``(branch_names_run, inds_run)`` reference-style lists from the
    move's parsed Gibbs schedule (ref ``move.py:223-246``)."""
    splits = getattr(move, "gibbs_iterations", None) or [None]
    for split in splits:
        if split is None:
            yield list(all_branch_names), [None] * len(all_branch_names)
        else:
            names = [n for n, _ in split if n in all_branch_names]
            masks = [
                None if m is None else np.asarray(m)
                for n, m in split
                if n in all_branch_names
            ]
            yield names, masks


def _setup_proposals(branch_names_run, inds_run, coords, inds):
    """Gibbs-aware proposal inputs (ref ``move.py:248-295``)."""
    inds_go = {}
    coords_go = {}
    at_least_one = False
    for bnr, ir in zip(branch_names_run, inds_run):
        if ir is not None:
            tmp = np.zeros_like(inds[bnr], dtype=bool)
            ir_keep = ir.astype(int).sum(axis=-1).astype(bool)
            tmp[:, :, ir_keep] = True
            tmp[~inds[bnr]] = False
            inds_go[bnr] = tmp
        else:
            inds_go[bnr] = inds[bnr]
        if np.any(inds_go[bnr]):
            at_least_one = True
        coords_go[bnr] = coords[bnr]
    return coords_go, inds_go, at_least_one


def _cleanup_proposals_gibbs(branch_names_run, inds_run, q, coords):
    """Restore parameters fixed this Gibbs round; fill in untouched branches
    (ref ``move.py:297-336``)."""
    for bnr, ir in zip(branch_names_run, inds_run):
        if ir is not None:
            q[bnr][:, :, ~ir] = np.asarray(coords[bnr])[:, :, ~ir]
    for key, value in coords.items():
        if key not in q:
            q[key] = np.array(value)


def _fix_logp_gibbs(branch_names_run, inds_run, logp, inds):
    """Zero-change walkers get ``-inf``; empty models get 0
    (ref ``move.py:368-402``)."""
    total = np.zeros_like(logp, dtype=int)
    total_here = np.zeros_like(logp, dtype=int)
    for bnr, ir in zip(branch_names_run, inds_run):
        if ir is not None:
            tmp = np.zeros_like(inds[bnr], dtype=bool)
            ir_keep = ir.astype(int).sum(axis=-1).astype(bool)
            tmp[:, :, ir_keep] = True
            tmp[~inds[bnr]] = False
        else:
            tmp = inds[bnr]
        total += tmp.sum(axis=-1)
        total_here += tmp.sum(axis=-1)
    for name, iv in inds.items():
        if name not in branch_names_run:
            total += np.asarray(iv).sum(axis=-1)
    logp[(total != 0) & (total_here == 0)] = -np.inf
    logp[(total == 0) & (total_here == 0)] = 0.0


def _compute_log_posterior(move, logl, logp):
    tc = move.temperature_control
    if tc is not None:
        return np.asarray(
            tc.compute_log_posterior_tempered(np.asarray(logl), np.asarray(logp))
        )
    return np.asarray(logl) + np.asarray(logp)


def _merge_accept(hs, q, logl, logp, blobs, accepted, subset=None, new_inds=None):
    """Merge accepted walkers into the host state (semantics of ref
    ``move.py:472-703``).  ``subset`` is an ``(ntemps, Ns)`` walker-index
    array when ``q``/``logl`` cover only a red/blue half; ``accepted`` is
    always full ``(ntemps, nwalkers)``.  ``new_inds`` merges leaf-mask
    flips for trans-dimensional proposals."""
    if subset is None:
        acc = accepted
        for n in hs["coords"]:
            hs["coords"][n][acc] = np.asarray(q[n])[acc]
            if new_inds is not None and n in new_inds:
                hs["inds"][n][acc] = np.asarray(new_inds[n])[acc]
        hs["log_like"][acc] = np.asarray(logl)[acc]
        hs["log_prior"][acc] = np.asarray(logp)[acc]
        if blobs is not None and hs["blobs"] is not None:
            hs["blobs"][acc] = np.asarray(blobs)[acc]
        return
    keep = np.take_along_axis(accepted, subset, axis=1)  # (ntemps, Ns)
    t_idx, s_idx = np.nonzero(keep)
    w_idx = subset[t_idx, s_idx]
    for n in hs["coords"]:
        hs["coords"][n][t_idx, w_idx] = np.asarray(q[n])[t_idx, s_idx]
    hs["log_like"][t_idx, w_idx] = np.asarray(logl)[t_idx, s_idx]
    hs["log_prior"][t_idx, w_idx] = np.asarray(logp)[t_idx, s_idx]
    if blobs is not None and hs["blobs"] is not None:
        hs["blobs"][t_idx, w_idx] = np.asarray(blobs)[t_idx, s_idx]


def _finish(move, model, hs, accepted):
    """Book accepted counters, run the tempering epilogue, return the new
    state (shared tail of every family protocol)."""
    state = _host_to_state(hs)
    if move.accepted is None:
        move.accepted = np.zeros_like(accepted, dtype=float)
    move.accepted = move.accepted + accepted
    move.num_proposals += 1
    tc = model.temperature_control
    if tc is not None and not move.prevent_swaps and state.log_like.shape[0] > 1:
        state = tc.temper_comps(state, adapt=move.adapt_temps)
    return state, accepted


# ----------------------------------------------------------------------
# family protocols
# ----------------------------------------------------------------------
def _propose_mh(move, model, state):
    """Reference MH host protocol (ref ``mh.py:56-193``)."""
    hs = _host_snapshot(state)
    names = list(hs["coords"].keys())
    ntemps, nwalkers = hs["log_like"].shape
    accepted = np.zeros((ntemps, nwalkers), dtype=bool)
    move.setup(hs["coords"])

    for branch_names_run, inds_run in _gibbs_iterator(move, names):
        coords_go, inds_go, any_prop = _setup_proposals(
            branch_names_run, inds_run, hs["coords"], hs["inds"]
        )
        if not any_prop:
            continue
        move.current_model = model
        move.current_state = state
        q, factors = move.get_proposal(
            coords_go,
            model.random,
            branches_inds=inds_go,
            supps=hs["supp"],
            branch_supps=hs["branch_supps"],
        )
        q = {n: np.array(v) for n, v in q.items()}
        _cleanup_proposals_gibbs(branch_names_run, inds_run, q, hs["coords"])
        q = {n: q[n] for n in names}

        mt_ll = move.__dict__.pop("mt_ll", None)
        mt_lp = move.__dict__.pop("mt_lp", None)
        if mt_ll is not None and mt_lp is not None:
            # multiple-try moves already evaluated the chosen points
            # (ref mh.py:133-155); no fix_logp_gibbs on this path, as in
            # the reference
            logl, logp, new_blobs = np.array(mt_ll), np.array(mt_lp), None
        else:
            logp = np.array(model.compute_log_prior_fn(q, inds=hs["inds"]))
            _fix_logp_gibbs(branch_names_run, inds_run, logp, hs["inds"])
            logl, new_blobs = model.compute_log_like_fn(
                q, inds=hs["inds"], logp=logp
            )
            logl = np.array(logl)
        logP = _compute_log_posterior(move, logl, logp)
        prev_logP = _compute_log_posterior(
            move, hs["log_like"], hs["log_prior"]
        )
        lnpdiff = np.asarray(factors) + logP - prev_logP
        acc = lnpdiff > np.log(model.random.rand(ntemps, nwalkers))
        _merge_accept(hs, q, logl, logp, new_blobs, acc)
        accepted |= acc

    return _finish(move, model, hs, accepted)


def _propose_redblue(move, model, state):
    """Reference red/blue host protocol (ref ``red_blue.py:89-333``)."""
    hs = _host_snapshot(state)
    names = list(hs["coords"].keys())
    ntemps, nwalkers = hs["log_like"].shape

    ndim_total = sum(
        int(np.prod(hs["coords"][n].shape[-2:])) for n in names
    )
    if nwalkers < 2 * ndim_total and not move.live_dangerously:
        raise RuntimeError(
            "It is unadvisable to use a red-blue move with fewer walkers "
            "than twice the number of dimensions. Set live_dangerously=True "
            "to override."
        )
    move.setup(_branches_view(hs))

    accepted = np.zeros((ntemps, nwalkers), dtype=bool)
    all_inds = np.tile(np.arange(nwalkers), (ntemps, 1))
    split_ids = all_inds % move.nsplits
    if move.randomize_split:
        for row in split_ids:
            model.random.shuffle(row)

    for branch_names_run, inds_run in _gibbs_iterator(move, names):
        coords_go, inds_go, any_prop = _setup_proposals(
            branch_names_run, inds_run, hs["coords"], hs["inds"]
        )
        if not any_prop:
            continue
        accepted_here = np.zeros((ntemps, nwalkers), dtype=bool)
        for split in range(move.nsplits):
            S1 = split_ids == split
            nw_here = int(S1[0].sum())
            subset = all_inds[S1].reshape(ntemps, nw_here)

            new_inds = {
                n: np.take_along_axis(hs["inds"][n], subset[:, :, None], axis=1)
                for n in names
            }
            real_inds_subset = {
                n: np.take_along_axis(inds_go[n], subset[:, :, None], axis=1)
                for n in branch_names_run
            }
            subset_coords = {
                n: np.take_along_axis(
                    hs["coords"][n], subset[:, :, None, None], axis=1
                )
                for n in names
            }
            # s/c sets per branch: this split vs the other splits
            sets = {
                n: [
                    np.take_along_axis(
                        hs["coords"][n],
                        all_inds[split_ids == j].reshape(ntemps, -1)[
                            :, :, None, None
                        ],
                        axis=1,
                    )
                    for j in range(move.nsplits)
                ]
                for n in branch_names_run
            }
            s = {n: sets[n][split] for n in sets}
            c = {n: sets[n][:split] + sets[n][split + 1 :] for n in sets}

            gibbs_ndim = 0
            for bnr, ir in zip(branch_names_run, inds_run):
                if ir is not None:
                    gibbs_ndim += ir.sum()
                else:
                    gibbs_ndim += int(np.prod(hs["coords"][bnr].shape[-2:]))

            move.current_model = model
            move.current_state = state
            q, factors = move.get_proposal(
                s, c, model.random, gibbs_ndim=gibbs_ndim
            )
            q = {n: np.array(v) for n, v in q.items()}
            _cleanup_proposals_gibbs(
                branch_names_run, inds_run, q, subset_coords
            )
            for n in names:
                if n not in q:
                    q[n] = subset_coords[n].copy()
            q = {n: q[n] for n in names}

            logp = np.array(model.compute_log_prior_fn(q, inds=new_inds))
            _fix_logp_gibbs(branch_names_run, inds_run, logp, real_inds_subset)
            logl, new_blobs = model.compute_log_like_fn(
                q, inds=new_inds, logp=logp
            )
            logl = np.array(logl)
            if np.any(np.isnan(logl)):
                logl[np.isnan(logl)] = -1e300

            logP = _compute_log_posterior(move, logl, logp)
            prev_logl = np.take_along_axis(hs["log_like"], subset, axis=1)
            prev_logp = np.take_along_axis(hs["log_prior"], subset, axis=1)
            prev_logP = _compute_log_posterior(move, prev_logl, prev_logp)
            lnpdiff = np.asarray(factors) + logP - prev_logP
            keep = lnpdiff > np.log(model.random.rand(ntemps, nw_here))

            np.put_along_axis(accepted_here, subset, keep, axis=1)
            accepted |= accepted_here
            _merge_accept(
                hs, q, logl, logp, new_blobs, accepted_here, subset=subset
            )

    return _finish(move, model, hs, accepted)


def _propose_group(move, model, state):
    """Reference group-move host protocol (ref ``group.py:126-281``):
    stationary friends refreshed every ``n_iter_update`` iterations from the
    pre-refresh ensemble (detailed balance), ``fix_friends`` mid-window."""
    import copy as _copy

    hs = _host_snapshot(state)
    names = list(hs["coords"].keys())
    ntemps, nwalkers = hs["log_like"].shape
    if move.nfriends is None:
        move.nfriends = nwalkers

    branches = _branches_view(hs)
    move.setup(branches)

    it = getattr(move, "iter", 0)
    if it == 0 or it % move.n_iter_update == 0:
        move.setup_friends(branches)
    old_branches = None
    if it != 0 and it % move.n_iter_update == 0:
        old_branches = {
            n: _HostBranch(
                b.coords.copy(),
                b.inds.copy(),
                branch_supplemental=(
                    None
                    if b.branch_supplemental is None
                    else b.branch_supplemental.copy()
                ),
            )
            for n, b in branches.items()
        }
    if it != 0 and it % move.n_iter_update != 0:
        move.fix_friends(branches)

    accepted = np.zeros((ntemps, nwalkers), dtype=bool)
    for branch_names_run, inds_run in _gibbs_iterator(move, names):
        coords_go, inds_go, any_prop = _setup_proposals(
            branch_names_run, inds_run, hs["coords"], hs["inds"]
        )
        if not any_prop:
            continue
        new_branch_supps = {
            n: (None if bs is None else bs.copy())
            for n, bs in hs["branch_supps"].items()
        }
        gibbs_ndim = 0
        for bnr, ir in zip(branch_names_run, inds_run):
            if ir is not None:
                gibbs_ndim += ir.sum()
            else:
                gibbs_ndim += int(np.prod(hs["coords"][bnr].shape[-2:]))

        move.current_model = model
        move.current_state = state
        q, factors = move.get_proposal(
            {n: coords_go[n] for n in branch_names_run},
            model.random,
            gibbs_ndim=gibbs_ndim,
            s_inds_all={n: inds_go[n] for n in branch_names_run},
            branch_supps=new_branch_supps,
        )
        q = {n: np.array(v) for n, v in q.items()}
        _cleanup_proposals_gibbs(branch_names_run, inds_run, q, hs["coords"])
        q = {n: q[n] for n in names}

        logp = np.array(model.compute_log_prior_fn(q, inds=hs["inds"]))
        _fix_logp_gibbs(branch_names_run, inds_run, logp, hs["inds"])
        logl, new_blobs = model.compute_log_like_fn(
            q, inds=hs["inds"], logp=logp
        )
        logl = np.array(logl)
        logP = _compute_log_posterior(move, logl, logp)
        prev_logP = _compute_log_posterior(move, hs["log_like"], hs["log_prior"])
        lnpdiff = np.asarray(factors) + logP - prev_logP
        acc = lnpdiff > np.log(model.random.rand(ntemps, nwalkers))
        _merge_accept(hs, q, logl, logp, new_blobs, acc)
        # accepted supplemental values follow their walkers
        for n, bs in new_branch_supps.items():
            old_bs = hs["branch_supps"].get(n)
            if bs is None or old_bs is None:
                continue
            for k in bs.holder:
                old_bs.holder[k][acc] = bs.holder[k][acc]
        accepted |= acc

    state_out, accepted = _finish(move, model, hs, accepted)

    if old_branches is not None:
        # refresh bookkeeping uses pre-refresh values (detailed balance,
        # ref group.py:152-157, 275-279)
        move.setup_friends(old_branches)
    move.iter = it + 1
    return state_out, accepted


def _adjust_factors(factors, ndims_old, ndims_new):
    """Gibbs dimension correction of stretch factors
    (ref ``stretch.py:55-72``), returning the adjusted array."""
    logzz = factors / (np.asarray(ndims_old) - 1.0)
    return logzz * (np.asarray(ndims_new) - 1.0)


def groupstretch_get_proposal(
    move, s_all, random, gibbs_ndim=None, s_inds_all=None, branch_supps=None
):
    """Framework-provided ``get_proposal`` for legacy group-stretch
    subclasses (ref ``groupstretch.py:34-155``): stretch math against the
    complement chosen by the user's ``find_friends``."""
    newpos = {}
    zz = None
    ndim = 0
    for i, name in enumerate(s_all):
        s = np.asarray(s_all[name])
        ntemps, nwalkers, nleaves_max, ndim_here = s.shape
        ndim += nleaves_max * ndim_here
        s_inds = None if s_inds_all is None else np.asarray(s_inds_all[name])
        c = np.asarray(
            move.find_friends(name, s, s_inds=s_inds, branch_supps=branch_supps)
        )
        if i == 0:
            zz = (
                (move.a - 1.0) * random.rand(ntemps, nwalkers) + 1.0
            ) ** 2.0 / move.a
        if move.periodic is not None:
            diff = np.asarray(
                move.periodic.distance(
                    {name: s.reshape(ntemps * nwalkers, nleaves_max, ndim_here)},
                    {name: c.reshape(ntemps * nwalkers, nleaves_max, ndim_here)},
                )[name]
            ).reshape(ntemps, nwalkers, nleaves_max, ndim_here)
        else:
            diff = c - s
        temp = c - diff * zz[:, :, None, None]
        if move.periodic is not None:
            temp = np.asarray(
                move.periodic.wrap(
                    {
                        name: temp.reshape(
                            ntemps * nwalkers, nleaves_max, ndim_here
                        )
                    },
                )[name]
            ).reshape(ntemps, nwalkers, nleaves_max, ndim_here)
        newpos[name] = temp

    factors = (ndim - 1.0) * np.log(zz)
    if gibbs_ndim is not None:
        factors = _adjust_factors(factors, ndim, gibbs_ndim)
    return newpos, factors


def stretch_get_proposal(move, s_all, c_all, random, gibbs_ndim=None):
    """Framework-provided ``get_proposal`` for legacy red/blue stretch
    subclasses (ref ``stretch.py:160-231``): complement drawn uniformly
    from the concatenated other-split sets."""
    newpos = {}
    zz = None
    ndim = 0
    for i, name in enumerate(s_all):
        s = np.asarray(s_all[name])
        c = np.concatenate([np.asarray(x) for x in c_all[name]], axis=1)
        ntemps, Ns, nleaves_max, ndim_here = s.shape
        Nc = c.shape[1]
        ndim += nleaves_max * ndim_here
        rint = random.randint(Nc, size=(ntemps, Ns))
        c_temp = np.take_along_axis(c, rint[:, :, None, None], axis=1)
        if i == 0:
            u = random.rand(ntemps, Ns)
            if getattr(move, "use_log_proposal", False):
                # ptemcee scaling density g(z) ∝ 1/z (see stretch.py)
                zz = np.exp((2.0 * u - 1.0) * np.log(move.a))
            else:
                zz = ((move.a - 1.0) * u + 1.0) ** 2.0 / move.a
        if move.periodic is not None:
            diff = np.asarray(
                move.periodic.distance(
                    {name: s.reshape(ntemps * Ns, nleaves_max, ndim_here)},
                    {name: c_temp.reshape(ntemps * Ns, nleaves_max, ndim_here)},
                )[name]
            ).reshape(ntemps, Ns, nleaves_max, ndim_here)
        else:
            diff = c_temp - s
        temp = c_temp - diff * zz[:, :, None, None]
        if move.periodic is not None:
            temp = np.asarray(
                move.periodic.wrap(
                    {name: temp.reshape(ntemps * Ns, nleaves_max, ndim_here)},
                )[name]
            ).reshape(ntemps, Ns, nleaves_max, ndim_here)
        newpos[name] = temp

    # g(z) ∝ 1/z needs exponent N, the GW density N-1 (see stretch.py);
    # under Gibbs the exponent uses the updated dimension count
    # (ref stretch.py:55-72)
    shift = 0.0 if getattr(move, "use_log_proposal", False) else 1.0
    n_eff = ndim if gibbs_ndim is None else np.asarray(gibbs_ndim)
    factors = (n_eff - shift) * np.log(zz)
    return newpos, factors


def _propose_rj(move, model, state):
    """Reference RJ host protocol (ref ``rj.py:145-388``): branch-level
    Gibbs splits, ``get_proposal -> (q, new_inds, factors)``, k-range edge
    factors, multiple-try readouts, mask-aware accept-merge, and the
    no-adaptation tempering epilogue."""
    hs = _host_snapshot(state)
    names = list(hs["coords"].keys())
    ntemps, nwalkers = hs["log_like"].shape
    accepted = np.zeros((ntemps, nwalkers), dtype=bool)
    move.setup(_branches_view(hs))

    for branch_names_run, inds_run in _gibbs_iterator(move, names):
        run = [n for n in branch_names_run if n in move.nleaves_max]
        if not run:
            raise ValueError(
                "No models are getting a reversible jump proposal. Check "
                "nleaves_min and nleaves_max or do not use an rj proposal."
            )
        coords_in = {k: hs["coords"][k] for k in run}
        inds_in = {k: hs["inds"][k] for k in run}
        nlmax = {k: move.nleaves_max[k] for k in run}
        nlmin = {k: move.nleaves_min.get(k, 0) for k in run}

        move.current_model = model
        move.current_state = state
        q, new_inds, factors = move.get_proposal(
            coords_in,
            inds_in,
            nlmin,
            nlmax,
            model.random,
            branch_supps=hs["branch_supps"],
            supps=hs["supp"],
        )
        q = {n: np.array(v) for n, v in q.items()}
        new_inds = {n: np.array(v, dtype=bool) for n, v in new_inds.items()}
        _cleanup_proposals_gibbs(branch_names_run, inds_run, q, hs["coords"])
        for n in names:
            if n not in q:
                q[n] = np.array(hs["coords"][n])
            if n not in new_inds:
                new_inds[n] = np.array(hs["inds"][n])
        q = {n: q[n] for n in names}
        new_inds = {n: new_inds[n] for n in names}

        # k-range edge factors (ref rj.py:228-271)
        edge = np.zeros((ntemps, nwalkers))
        log_half = np.log(0.5)
        for n in run:
            nmax, nmin = nlmax[n], nlmin[n]
            if nmin > nmax:
                raise ValueError(
                    "nleaves_min cannot be greater than nleaves_max."
                )
            if nmin == nmax or nmin + 1 == nmax:
                continue
            old_n = hs["inds"][n].sum(axis=-1)
            new_n = new_inds[n].sum(axis=-1)
            edge += np.where(old_n == nmin, log_half, 0.0)
            edge += np.where(old_n == nmax, log_half, 0.0)
            edge -= np.where(new_n == nmin, log_half, 0.0)
            edge -= np.where(new_n == nmax, log_half, 0.0)
        factors = np.asarray(factors, dtype=float) + edge

        # multiple-try readouts supersede recomputation (ref rj.py:297-315)
        mt_lp = move.__dict__.pop("mt_lp", None)
        mt_ll = move.__dict__.pop("mt_ll", None)
        if mt_lp is not None:
            logp = np.array(mt_lp).reshape(ntemps, nwalkers)
        else:
            logp = np.array(model.compute_log_prior_fn(q, inds=new_inds))
        _fix_logp_gibbs(branch_names_run, inds_run, logp, new_inds)
        if mt_ll is not None:
            logl, new_blobs = np.array(mt_ll).reshape(ntemps, nwalkers), None
        else:
            logl, new_blobs = model.compute_log_like_fn(
                q, inds=new_inds, logp=logp
            )
            logl = np.array(logl)

        logP = _compute_log_posterior(move, logl, logp)
        prev_logP = _compute_log_posterior(
            move, hs["log_like"], hs["log_prior"]
        )
        lnpdiff = factors + logP - prev_logP
        acc = lnpdiff > np.log(model.random.rand(ntemps, nwalkers))
        _merge_accept(hs, q, logl, logp, new_blobs, acc, new_inds=new_inds)
        accepted |= acc

    return _finish(move, model, hs, accepted)


_FAMILIES = {
    "mh": _propose_mh,
    "redblue": _propose_redblue,
    "group": _propose_group,
    "rj": _propose_rj,
}


def host_propose(move, model, state):
    """Dispatch a legacy move's host proposal by family."""
    family = getattr(move, "_legacy_family", None)
    if family not in _FAMILIES:
        raise RuntimeError(
            f"Move {type(move).__name__} is flagged host_move but has no "
            f"recognized legacy family ({family!r})."
        )
    return _FAMILIES[family](move, model, state)
