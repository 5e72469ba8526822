"""Test configuration: run hermetically on CPU with 8 virtual devices so
multi-device sharding paths are exercised without GPUs.  The platform is
also pinned with ``jax.config.update`` in case jax was imported before
this file set ``JAX_PLATFORMS``.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax

jax.config.update("jax_platforms", "cpu")

from eryn_tpu.compile_cache import use_compile_cache  # noqa: E402

use_compile_cache(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import pytest


@pytest.fixture(autouse=True)
def _seed_numpy():
    np.random.seed(42)
    yield
