"""The benchmarks' peak table: keyed by device kind, sourced, and an
error (not a default) for a device it does not hold."""

import pytest

from benchmarks.peaks import PEAKS, peak


def test_h100_published_dense_rates():
    kind = "NVIDIA H100 80GB HBM3"
    assert peak(kind) == 989e12
    assert peak(kind, "hbm_bytes_per_s") == 3.35e12
    assert "data sheet" in PEAKS[kind]["source"]


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA H200", "NVIDIA A100-SXM4-80GB"])
def test_unknown_device_raises(kind):
    with pytest.raises(KeyError, match="no published peak"):
        peak(kind)
