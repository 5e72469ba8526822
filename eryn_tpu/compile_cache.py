"""Where the repository's entry points keep JAX's persistent compile cache.

Importing :mod:`eryn_tpu` configures nothing; scripts call
:func:`use_compile_cache` once, before their first compile.
"""

from __future__ import annotations

import os

__all__ = ["use_compile_cache"]


def use_compile_cache(root):
    """Use ``JAX_COMPILATION_CACHE_DIR`` when it is set (JAX reads it
    itself, so nothing is configured), else ``<root>/.jax_cache``.

    The cache key includes the directory, so the default is one fixed
    path inside the checkout rather than a per-user or temporary one.

    Returns:
        The cache directory in use.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    path = os.path.join(os.path.abspath(root), ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
