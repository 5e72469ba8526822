"""``chip_smoke.py``: every phase at a tiny size on CPU, the sharded
comparison on four virtual CPU devices, and the refusal to run (or to
print a result) without a GPU."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke as cs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name,phase", cs.PHASES, ids=[n for n, _ in cs.PHASES])
def test_phase_passes_at_tiny_size(name, phase):
    np.random.seed(cs.SEED)
    info, steps = phase(cs.TINY)
    assert isinstance(info, dict) and steps >= 0


def test_four_device_phase_matches_unsharded():
    np.random.seed(cs.SEED)
    info, _ = cs.phase_four(cs.TINY)
    assert info["mesh"] == {"temp": 2, "walker": 2}
    assert info["north_star_sharded_vs_unsharded_max_rel_diff"] <= cs.SHARDED_RTOL
    assert info["config_e_sharded_vs_unsharded_max_rel_diff"] <= cs.SHARDED_RTOL
    assert info["stored_buffers_span_devices"] == {"packed": [4], "unpacked": [4]}


@pytest.mark.parametrize("alone", [False, True], ids=["in_repo", "alone"])
def test_exits_nonzero_without_gpu(alone, tmp_path):
    script = os.path.join(ROOT, "chip_smoke.py")
    cwd = ROOT
    if alone:
        cwd = str(tmp_path)
        shutil.copy(script, cwd)
        script = os.path.join(cwd, "chip_smoke.py")
    env = {
        k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "XLA_FLAGS")
    }
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [sys.executable, script],
        cwd=cwd,
        env=env,
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
