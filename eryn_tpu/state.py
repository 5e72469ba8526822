"""Ensemble state containers as JAX pytrees.

JAX re-design of the reference state layer
(``/root/reference/src/eryn/state.py:16-775``).  The reference keeps mutable
NumPy/CuPy arrays inside plain Python objects; here every container is a
registered, immutable pytree of fixed-shape ``jax.Array`` leaves so a whole
:class:`State` can flow through ``jit``/``lax.scan``/``shard_map`` unchanged.

Shape conventions (identical to the reference, ``state.py:330-385``):

* ``coords``: ``(ntemps, nwalkers, nleaves_max, ndim)`` per branch
* ``inds``:   ``(ntemps, nwalkers, nleaves_max)`` boolean leaf-activation mask
* ``log_like`` / ``log_prior``: ``(ntemps, nwalkers)``
* ``betas``: ``(ntemps,)``

Reversible-jump dimensionality changes are represented purely as flips of the
``inds`` mask over the static ``nleaves_max`` axis — the XLA-friendly
"static max shape + activation mask" representation the reference already
uses (``state.py:338-345``).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax import tree_util

__all__ = ["Branch", "BranchSupplemental", "State", "ParaState"]


def _coerce_coords(coords, ndim_spec=None):
    """Coerce 1D/2D/3D coords input to canonical 4D, mirroring
    ``/root/reference/src/eryn/state.py:472-485``."""
    coords = jnp.asarray(coords)
    if coords.ndim == 1:
        # (ndim,) -> (1, 1, 1, ndim)
        coords = coords[None, None, None, :]
    elif coords.ndim == 2:
        # (nwalkers, ndim) -> (1, nwalkers, 1, ndim)
        coords = coords[None, :, None, :]
    elif coords.ndim == 3:
        # (ntemps, nwalkers, ndim) -> (ntemps, nwalkers, 1, ndim)
        coords = coords[:, :, None, :]
    elif coords.ndim != 4:
        raise ValueError(
            "coords must be 1, 2, 3 or 4 dimensional; got shape "
            f"{coords.shape}."
        )
    return coords


@tree_util.register_pytree_node_class
class Branch:
    """One model type in the ensemble: padded leaf coordinates + activation mask.

    Mirrors ``/root/reference/src/eryn/state.py:330-384``.
    """

    def __init__(self, coords, inds=None, branch_supplemental=None):
        coords = _coerce_coords(coords)
        ntemps, nwalkers, nleaves_max, ndim = coords.shape
        if inds is None:
            inds = jnp.ones((ntemps, nwalkers, nleaves_max), dtype=bool)
        else:
            inds = jnp.asarray(inds)
            if inds.dtype != jnp.bool_:
                inds = inds.astype(bool)
            if inds.shape != (ntemps, nwalkers, nleaves_max):
                raise ValueError(
                    f"inds shape {inds.shape} incompatible with coords shape "
                    f"{coords.shape}."
                )
        self.coords = coords
        self.inds = inds
        self.supplemental = branch_supplemental

    # --- shape info -----------------------------------------------------
    @property
    def branch_supplemental(self):
        """Reference attribute name (ref ``state.py:330-384`` exposes the
        per-branch supplemental as ``branch_supplemental``)."""
        return self.supplemental

    @branch_supplemental.setter
    def branch_supplemental(self, value):
        self.supplemental = value

    @property
    def shape(self):
        return self.coords.shape

    @property
    def ntemps(self):
        return self.coords.shape[0]

    @property
    def nwalkers(self):
        return self.coords.shape[1]

    @property
    def nleaves_max(self):
        return self.coords.shape[2]

    @property
    def ndim(self):
        return self.coords.shape[3]

    @property
    def nleaves(self):
        """Leaf count per (temp, walker) (``state.py:379-384``)."""
        return self.inds.sum(axis=-1)

    # --- pytree protocol ------------------------------------------------
    def tree_flatten(self):
        return (self.coords, self.inds, self.supplemental), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = cls.__new__(cls)
        obj.coords, obj.inds, obj.supplemental = children
        return obj

    def __repr__(self):
        return f"Branch(shape={tuple(self.coords.shape)})"


def _as_object_array(value):
    """Return ``value`` as a NumPy object array if it is object-like
    (object dtype, or not coercible to a numeric array), else ``None``."""
    if isinstance(value, np.ndarray) and value.dtype == object:
        return value
    if isinstance(value, (list, tuple)):
        try:
            probe = np.asarray(value)
        except Exception:
            probe = np.empty(len(value), dtype=object)
            probe[:] = value
        if probe.dtype == object:
            return probe
    return None


@tree_util.register_pytree_node_class
class BranchSupplemental:
    """Dict-of-arrays side-car indexed like the ensemble.

    Mirrors ``/root/reference/src/eryn/state.py:16-327``.  Numeric entries
    are device arrays (pytree leaves) that ride the compiled step — the swap
    cascade permutes them with the coordinates.  Object-dtype entries (ref
    ``state.py:84-96``) are held host-side in ``host_holder``: they never
    enter traced computation, but the sampler tracks the composed
    temperature-swap permutation per segment and reorders them exactly at
    segment boundaries (see ``EnsembleSampler._sync_bulk``), so they follow
    their walkers like the reference's object holders do.
    """

    def __init__(self, obj_info: dict, base_shape=None, copy=False):
        holder = {}
        host_holder = {}
        for name, value in obj_info.items():
            obj = _as_object_array(value)
            if obj is not None:
                if base_shape is not None and obj.shape[
                    : len(base_shape)
                ] != tuple(base_shape):
                    raise ValueError(
                        f"Supplemental entry '{name}' with shape {obj.shape} "
                        f"does not lead with base_shape {tuple(base_shape)}."
                    )
                host_holder[name] = obj.copy() if copy else obj
                continue
            arr = jnp.asarray(value)
            if base_shape is not None and arr.shape[: len(base_shape)] != tuple(
                base_shape
            ):
                raise ValueError(
                    f"Supplemental entry '{name}' with shape {arr.shape} does "
                    f"not lead with base_shape {tuple(base_shape)}."
                )
            holder[name] = arr
        self.holder = holder
        self.host_holder = host_holder
        self.base_shape = (
            tuple(base_shape) if base_shape is not None else self._infer_base_shape()
        )

    def _infer_base_shape(self):
        for source in (self.holder, self.host_holder):
            if source:
                first = next(iter(source.values()))
                return tuple(first.shape[:2])
        return ()

    def __getitem__(self, key):
        if isinstance(key, str):
            if key in self.holder:
                return self.holder[key]
            return self.host_holder[key]
        # array-style indexing applies to every entry
        out = {name: value[key] for name, value in self.holder.items()}
        out.update(
            {name: value[key] for name, value in self.host_holder.items()}
        )
        return out

    def __setitem__(self, key, value):
        # functional update: mutate the python dict (host-side API only)
        if isinstance(key, str):
            obj = _as_object_array(value)
            if obj is not None:
                self.holder.pop(key, None)
                self.host_holder[key] = obj
            else:
                self.host_holder.pop(key, None)
                self.holder[key] = jnp.asarray(value)
        else:
            if not isinstance(value, dict):
                raise ValueError(
                    "Setting with an index requires a dict of per-name values."
                )
            for name, val in value.items():
                if name in self.host_holder:
                    self.host_holder[name][key] = val
                elif name in self.holder:
                    self.holder[name] = self.holder[name].at[key].set(val)
                # names not already stored are ignored (ref state.py:196-208)

    def __contains__(self, name):
        return name in self.holder or name in self.host_holder

    # --- holder management (ref ``state.py:63-170``) ---------------------
    def add_objects(self, obj_info: dict, copy=False):
        """Add entries to the holder (ref ``state.py:63-141``).

        Values must lead with ``base_shape``; trailing dims are free.
        Object-dtype values go to the host-side holder.
        """
        for name, value in obj_info.items():
            obj = _as_object_array(value)
            if obj is not None:
                if self.base_shape and obj.shape[
                    : len(self.base_shape)
                ] != tuple(self.base_shape):
                    raise ValueError(
                        f"Supplemental entry '{name}' with shape {obj.shape} "
                        f"does not lead with base_shape "
                        f"{tuple(self.base_shape)}."
                    )
                self.host_holder[name] = obj.copy() if copy else obj
                continue
            arr = jnp.asarray(value)
            if self.base_shape and arr.shape[: len(self.base_shape)] != tuple(
                self.base_shape
            ):
                raise ValueError(
                    f"Supplemental entry '{name}' with shape {arr.shape} does "
                    f"not lead with base_shape {tuple(self.base_shape)}."
                )
            self.holder[name] = arr

    def remove_objects(self, names):
        """Remove entries from the holder (ref ``state.py:143-166``)."""
        if isinstance(names, str):
            names = [names]
        if not isinstance(names, list):
            raise ValueError("names must be a string or list of strings.")
        for name in names:
            if name in self.host_holder:
                del self.host_holder[name]
            else:
                del self.holder[name]

    @property
    def contained_objects(self):
        """Keys of contained entries (ref ``state.py:168-170``)."""
        return list(self.holder.keys()) + list(self.host_holder.keys())

    def take_along_axis(self, indices, axis: int, skip_names=()):
        """Gather each entry along ``axis`` (ref ``state.py:210-257``).

        ``indices`` must match the dimension of ``base_shape``; trailing
        entry dims broadcast.
        """
        out = {}
        indices = jnp.asarray(indices)
        for name, values in self.holder.items():
            if name in skip_names:
                continue
            idx = indices
            for _ in range(values.ndim - idx.ndim):
                idx = idx[..., None]
            out[name] = jnp.take_along_axis(values, idx, axis=axis)
        idx_np = np.asarray(indices)
        for name, values in self.host_holder.items():
            if name in skip_names:
                continue
            idx = idx_np
            for _ in range(values.ndim - idx.ndim):
                idx = idx[..., None]
            out[name] = np.take_along_axis(values, idx, axis=axis)
        return out

    def put_along_axis(self, indices, values_in: dict, axis: int):
        """Scatter values into entries along ``axis`` (ref
        ``state.py:259-310``; functional ``.at[].set`` here since leaves are
        immutable ``jax.Array``\\ s)."""
        indices = jnp.asarray(indices)
        for name, values in self.holder.items():
            if name not in values_in:
                continue
            idx = indices
            target = self.holder[name]
            for _ in range(target.ndim - idx.ndim):
                idx = idx[..., None]
            new_vals = jnp.broadcast_to(
                jnp.asarray(values_in[name]),
                jnp.take_along_axis(target, idx, axis=axis).shape,
            )
            dim_idx = [
                jnp.arange(n).reshape(
                    (1,) * d + (-1,) + (1,) * (target.ndim - d - 1)
                )
                for d, n in enumerate(target.shape)
            ]
            dim_idx[axis] = idx
            self.holder[name] = target.at[tuple(dim_idx)].set(new_vals)
        idx_np = np.asarray(indices)
        for name, target in self.host_holder.items():
            if name not in values_in:
                continue
            idx = idx_np
            for _ in range(target.ndim - idx.ndim):
                idx = idx[..., None]
            np.put_along_axis(
                target,
                np.broadcast_to(idx, np.take_along_axis(target, idx, axis=axis).shape),
                values_in[name],
                axis=axis,
            )

    @property
    def flat(self):
        """Flatten the ensemble dims (``state.py:310-327``)."""
        nbase = len(self.base_shape)
        out = {
            name: value.reshape((-1,) + value.shape[nbase:])
            for name, value in self.holder.items()
        }
        out.update(
            {
                name: value.reshape((-1,) + value.shape[nbase:])
                for name, value in self.host_holder.items()
            }
        )
        return out

    def copy(self):
        """Independent copy: fresh dicts, host object arrays deep-copied.
        Traced (``jax.Array``) leaves are immutable and safely shared."""
        import copy as _copy

        new = BranchSupplemental.__new__(BranchSupplemental)
        new.holder = dict(self.holder)
        new.host_holder = {
            k: _copy.deepcopy(v) for k, v in self.host_holder.items()
        }
        new.base_shape = self.base_shape
        return new

    def tree_flatten(self):
        # host (object-dtype) entries are NOT leaves: they never enter traced
        # computation; the sampler re-attaches them at segment boundaries
        names = tuple(sorted(self.holder))
        children = tuple(self.holder[n] for n in names)
        return children, (names, self.base_shape)

    @classmethod
    def tree_unflatten(cls, aux, children):
        names, base_shape = aux
        obj = cls.__new__(cls)
        obj.holder = dict(zip(names, children))
        obj.host_holder = {}
        obj.base_shape = base_shape
        return obj

    def __repr__(self):
        return (
            f"BranchSupplemental({list(self.holder)}"
            + (f", host={list(self.host_holder)}" if self.host_holder else "")
            + ")"
        )


@tree_util.register_pytree_node_class
class State:
    """Full ensemble snapshot.

    Mirrors the public surface of ``/root/reference/src/eryn/state.py:387-585``
    (``branches``, ``log_like``, ``log_prior``, ``blobs``, ``betas``,
    ``supplemental``, ``random_state``) while being a registered pytree so the
    whole snapshot is a valid ``jit`` argument / ``lax.scan`` carry.

    ``random_state`` holds a JAX PRNG key (the reference stores the NumPy
    Mersenne tuple, ``state.py:387``).
    """

    def __init__(
        self,
        coords,
        inds=None,
        log_like=None,
        log_prior=None,
        blobs=None,
        betas=None,
        supplemental=None,
        branch_supplemental=None,
        random_state=None,
        copy=False,
    ):
        if isinstance(coords, State):
            other = coords
            if copy:
                # fresh Branch/BranchSupplemental objects so mutating the
                # copy's supplementals cannot corrupt the original (the
                # reference deep-copies on copy=True, ref state.py:428-447;
                # traced arrays are immutable and safely shared)
                self.branches = {
                    name: Branch(
                        b.coords,
                        inds=b.inds,
                        branch_supplemental=(
                            b.supplemental.copy()
                            if b.supplemental is not None
                            else None
                        ),
                    )
                    for name, b in other.branches.items()
                }
                self.supplemental = (
                    other.supplemental.copy()
                    if other.supplemental is not None
                    else None
                )
            else:
                self.branches = dict(other.branches)
                self.supplemental = other.supplemental
            self.log_like = other.log_like
            self.log_prior = other.log_prior
            self.blobs = other.blobs
            self.betas = other.betas
            self.random_state = other.random_state
            return

        if isinstance(coords, Branch):
            coords = {"model_0": coords.coords}

        if not isinstance(coords, dict):
            coords = {"model_0": coords}

        if inds is not None and not isinstance(inds, dict):
            inds = {"model_0": inds}
        if branch_supplemental is not None and not isinstance(
            branch_supplemental, dict
        ):
            branch_supplemental = {"model_0": branch_supplemental}

        self.branches = {}
        for name, c in coords.items():
            branch_inds = None if inds is None else inds.get(name)
            branch_supp = (
                None
                if branch_supplemental is None
                else branch_supplemental.get(name)
            )
            if isinstance(branch_supp, dict):
                branch_supp = BranchSupplemental(branch_supp)
            self.branches[name] = (
                c
                if isinstance(c, Branch)
                else Branch(c, inds=branch_inds, branch_supplemental=branch_supp)
            )

        self.log_like = None if log_like is None else jnp.asarray(log_like)
        self.log_prior = None if log_prior is None else jnp.asarray(log_prior)
        self.blobs = None if blobs is None else jnp.asarray(blobs)
        self.betas = None if betas is None else jnp.asarray(betas)
        self.supplemental = supplemental
        self._branch_supplemental_in = branch_supplemental
        self.random_state = random_state

        # coerce 1D (ntemps, nwalkers) style inputs
        if self.log_like is not None and self.log_like.ndim == 1:
            self.log_like = self.log_like[None, :]
        if self.log_prior is not None and self.log_prior.ndim == 1:
            self.log_prior = self.log_prior[None, :]

    # --- convenience views (match reference property names) -------------
    @property
    def branch_names(self):
        return list(self.branches.keys())

    @property
    def branches_coords(self):
        return {name: b.coords for name, b in self.branches.items()}

    @property
    def branches_inds(self):
        return {name: b.inds for name, b in self.branches.items()}

    @property
    def branches_supplemental(self):
        return {name: b.supplemental for name, b in self.branches.items()}

    @property
    def ntemps(self):
        return next(iter(self.branches.values())).ntemps

    @property
    def nwalkers(self):
        return next(iter(self.branches.values())).nwalkers

    def copy_into_self(self, state_to_copy: "State"):
        """Overwrite this state's fields with another's (ref
        ``state.py:541-543``)."""
        self.branches = dict(state_to_copy.branches)
        self.log_like = state_to_copy.log_like
        self.log_prior = state_to_copy.log_prior
        self.blobs = state_to_copy.blobs
        self.betas = state_to_copy.betas
        self.supplemental = state_to_copy.supplemental
        self.random_state = state_to_copy.random_state

    def get_log_posterior(self, temper: bool = False):
        """Tempered or untempered log posterior (``state.py:545-585``)."""
        if temper and self.betas is not None:
            betas = self.betas[:, None]
        else:
            betas = 1.0
        return betas * self.log_like + self.log_prior

    def get_betas(self):
        return self.betas

    # --- functional update helper ---------------------------------------
    def replace(self, **updates) -> "State":
        """Return a copy of this state with the given fields replaced."""
        new = State.__new__(State)
        new.branches = updates.pop("branches", dict(self.branches))
        new.log_like = updates.pop("log_like", self.log_like)
        new.log_prior = updates.pop("log_prior", self.log_prior)
        new.blobs = updates.pop("blobs", self.blobs)
        new.betas = updates.pop("betas", self.betas)
        new.supplemental = updates.pop("supplemental", self.supplemental)
        new.random_state = updates.pop("random_state", self.random_state)
        if "coords" in updates or "inds" in updates or "branch_supplemental" in updates:
            coords = updates.pop("coords", self.branches_coords)
            inds = updates.pop("inds", self.branches_inds)
            branch_supps = updates.pop(
                "branch_supplemental", self.branches_supplemental
            )
            # canonicalize to THIS state's branch order: jax.tree_map
            # rebuilds plain dicts with SORTED keys, so an updates dict that
            # passed through a tree_map (e.g. the tempering gather) would
            # otherwise reorder the branches — changing the State's pytree
            # structure mid-scan for non-alphabetical branch names
            order = [n for n in self.branches if n in coords]
            order += [n for n in coords if n not in self.branches]
            new.branches = {
                name: Branch(
                    coords[name],
                    inds=inds[name],
                    branch_supplemental=branch_supps.get(name),
                )
                for name in order
            }
        if updates:
            raise TypeError(f"Unknown State fields: {list(updates)}")
        return new

    # --- pytree protocol -------------------------------------------------
    def tree_flatten(self):
        names = tuple(self.branches.keys())
        children = (
            tuple(self.branches[n] for n in names),
            self.log_like,
            self.log_prior,
            self.blobs,
            self.betas,
            self.supplemental,
            self.random_state,
        )
        return children, names

    @classmethod
    def tree_unflatten(cls, names, children):
        obj = cls.__new__(cls)
        branches, log_like, log_prior, blobs, betas, supplemental, rs = children
        obj.branches = dict(zip(names, branches))
        obj.log_like = log_like
        obj.log_prior = log_prior
        obj.blobs = blobs
        obj.betas = betas
        obj.supplemental = supplemental
        obj.random_state = rs
        return obj

    def __repr__(self):
        shapes = {n: tuple(b.coords.shape) for n, b in self.branches.items()}
        return f"State(branches={shapes})"


@tree_util.register_pytree_node_class
class ParaState(State):
    """State variant carrying ``groups_running`` for batched independent
    sub-ensembles (``state.py:588-775``).

    Accepts group-batched 5D coordinates
    ``(ngroups, ntemps, nwalkers, nleaves_max, ndim)``; the group and
    temperature axes are stored folded together (``ngroups * ntemps``
    leading dim) with ``ngroups`` kept for unstacking via
    :meth:`group_view`.
    """

    def __init__(self, coords, groups_running=None, ngroups=None, **kwargs):
        if isinstance(coords, dict):
            first = next(iter(coords.values()))
            arr = first.coords if isinstance(first, Branch) else jnp.asarray(first)
            if arr.ndim == 5:
                ngroups = arr.shape[0] if ngroups is None else ngroups

                def fold(x):
                    x = jnp.asarray(x)
                    return x.reshape((x.shape[0] * x.shape[1],) + x.shape[2:])

                coords = {n: fold(c) for n, c in coords.items()}
                if kwargs.get("inds") is not None:
                    kwargs["inds"] = {
                        # group-batched 4D (ngroups, ntemps, nw, nl) masks
                        # fold; already-folded 3D input passes through
                        n: fold(v) if jnp.asarray(v).ndim == 4 else jnp.asarray(v)
                        for n, v in kwargs["inds"].items()
                    }
                for field in ("log_like", "log_prior"):
                    if kwargs.get(field) is not None:
                        arr = jnp.asarray(kwargs[field])
                        # only group-batched 3D (ngroups, ntemps, nwalkers)
                        # input folds; already-folded 2D passes through
                        kwargs[field] = fold(arr) if arr.ndim == 3 else arr
                if kwargs.get("betas") is not None:
                    b = jnp.asarray(kwargs["betas"])
                    if b.ndim == 2:
                        kwargs["betas"] = b.reshape(-1)
        super().__init__(coords, **kwargs)
        self.ngroups = ngroups
        self.groups_running = (
            None if groups_running is None else jnp.asarray(groups_running)
        )

    def group_view(self, field_dict):
        """Unfold ``(ngroups * ntemps, ...)`` arrays back to group-batched."""
        if self.ngroups is None:
            return field_dict
        ng = self.ngroups

        def unfold(x):
            return x.reshape((ng, x.shape[0] // ng) + x.shape[1:])

        return tree_util.tree_map(unfold, field_dict)

    def tree_flatten(self):
        children, names = super().tree_flatten()
        return children + (self.groups_running,), (names, self.ngroups)

    @classmethod
    def tree_unflatten(cls, aux, children):
        names, ngroups = aux
        obj = super().tree_unflatten(names, children[:-1])
        obj.__class__ = cls
        obj.groups_running = children[-1]
        obj.ngroups = ngroups
        return obj
