"""The compile-cache rule: ``JAX_COMPILATION_CACHE_DIR`` when set, else
one fixed directory in the checkout, and nothing at import time."""

import os
import subprocess
import sys

import jax

from eryn_tpu.compile_cache import use_compile_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_env_var_is_honoured_and_nothing_set(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    assert use_compile_cache(ROOT) == str(tmp_path / "c")
    assert jax.config.jax_compilation_cache_dir == before


def test_default_is_fixed_path_in_checkout(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        path = use_compile_cache(ROOT)
        assert path == os.path.join(ROOT, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_import_configures_no_cache():
    env = {
        k: v
        for k, v in os.environ.items()
        if k not in ("JAX_COMPILATION_CACHE_DIR", "PYTHONPATH")
    }
    env["JAX_PLATFORMS"] = "cpu"
    code = (
        "import jax, eryn_tpu, eryn_tpu.moves, eryn_tpu.utils; "
        "print(jax.config.jax_compilation_cache_dir)"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code],
        cwd=ROOT,
        env=env,
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "None"
