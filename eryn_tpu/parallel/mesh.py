"""Multi-device scaling for the ensemble sampler.

The reference's parallelism is ``pool.map`` likelihood fan-out plus a single
CuPy device (``/root/reference/src/eryn/ensemble.py:119-122,1474-1481``).  The
answer here: shard the ``(ntemps, nwalkers)`` ensemble axes of the whole
``State`` pytree over a ``jax.sharding.Mesh`` and jit the identical step
function — XLA inserts the collectives (the temperature-swap cascade becomes
collective-permute traffic between devices; red/blue complement gathers
become all-to-alls over the walker axis).
"""

from __future__ import annotations

import numpy as np

import jax
from jax.experimental import mesh_utils
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = [
    "make_mesh",
    "make_group_mesh",
    "shard_state",
    "sharding_for_state",
    "constrain_state",
    "mesh_of_state",
]

TEMP_AXIS = "temp"
WALKER_AXIS = "walker"
GROUP_AXIS = "group"


def make_group_mesh(n_devices=None):
    """1-D mesh over the independent-ensemble ``group`` axis — the
    multi-slice/DCN scaling analog (SURVEY §5): groups never communicate,
    so this axis tolerates slow links and maps naturally onto separate
    slices.  Used by :class:`eryn_tpu.parallel.ParaEnsembleSampler`."""
    devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    if len(devices) < n_devices:
        raise ValueError(
            f"Requested mesh over {n_devices} devices but only "
            f"{len(devices)} available."
        )
    mesh_devices = mesh_utils.create_device_mesh(
        (n_devices,), devices=devices[:n_devices]
    )
    return Mesh(mesh_devices, (GROUP_AXIS,))


def make_mesh(n_devices=None, temp_parallel=None):
    """Build a 2D (temp, walker) device mesh.

    Args:
        n_devices: number of devices (default: all).
        temp_parallel: size of the temperature axis of the mesh (default:
            2 when ``n_devices`` is even and > 2, else 1 — walker sharding is
            the primary data-parallel axis since ``nwalkers >> ntemps``).
    """
    devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    if len(devices) < n_devices:
        raise ValueError(
            f"Requested mesh over {n_devices} devices but only "
            f"{len(devices)} available."
        )
    if temp_parallel is None:
        temp_parallel = 2 if (n_devices % 2 == 0 and n_devices > 2) else 1
    if n_devices % temp_parallel != 0:
        raise ValueError("n_devices must be divisible by temp_parallel.")
    shape = (temp_parallel, n_devices // temp_parallel)
    mesh_devices = mesh_utils.create_device_mesh(
        shape, devices=devices[:n_devices]
    )
    return Mesh(mesh_devices, (TEMP_AXIS, WALKER_AXIS))


def _spec_for_leaf(x, ntemps, nwalkers):
    """Partition rule: shard leading (ntemps, nwalkers) dims; replicate
    everything else (betas, keys, scalars)."""
    shape = getattr(x, "shape", ())
    if len(shape) >= 2 and shape[0] == ntemps and shape[1] == nwalkers:
        return P(TEMP_AXIS, WALKER_AXIS, *(None,) * (len(shape) - 2))
    return P()


def sharding_for_state(state, mesh):
    """NamedSharding pytree matching a :class:`~eryn_tpu.state.State`."""
    if state.log_like is not None:
        ntemps, nwalkers = state.log_like.shape
    else:
        # pre-evaluation State (no log_like yet): the ensemble dims are the
        # leading dims of any coords leaf
        first = next(iter(state.branches.values()))
        ntemps, nwalkers = first.coords.shape[:2]
    return jax.tree_util.tree_map(
        lambda x: NamedSharding(mesh, _spec_for_leaf(x, ntemps, nwalkers)),
        state,
    )


def shard_state(state, mesh):
    """Place a State on the mesh with (temp, walker) sharding."""
    return jax.device_put(state, sharding_for_state(state, mesh))


def mesh_of_state(state):
    """The NamedSharding mesh a concrete State is distributed over, or None
    when unsharded / single-device / not NamedSharding-placed."""
    sh = getattr(state.log_like, "sharding", None)
    if sh is None or not isinstance(sh, NamedSharding):
        return None
    if len(sh.device_set) <= 1:
        return None
    return sh.mesh


def constrain_state(state, mesh):
    """Anchor the (ntemps, nwalkers)-leading leaves of a (traced) State with
    ``with_sharding_constraint`` so XLA cannot silently reshard the scan
    carry mid-graph."""
    ntemps, nwalkers = state.log_like.shape

    def anchor(x):
        return jax.lax.with_sharding_constraint(
            x, NamedSharding(mesh, _spec_for_leaf(x, ntemps, nwalkers))
        )

    return jax.tree_util.tree_map(anchor, state)
