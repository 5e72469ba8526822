"""Published peak rates of the cards the benchmarks report against, keyed by
``jax.devices()[0].device_kind``.

Source: NVIDIA H100 Tensor Core GPU data sheet, SXM part: dense tensor-core
rates without sparsity, at the full 700 W power limit.  A card set below
that limit (``nvidia-smi --query-gpu=power.limit``) cannot hold its top
clock under matrix-heavy load, so every share computed against these
numbers is reported with the card's power limit beside it.

A device that is not in the table is an error, not a default.
"""

from __future__ import annotations

__all__ = ["PEAKS", "peak"]

_H100_SXM = {
    "bf16_flops_per_s": 989e12,
    "tf32_flops_per_s": 495e12,
    "f32_flops_per_s": 67e12,
    "hbm_bytes_per_s": 3.35e12,
    "source": "NVIDIA H100 Tensor Core GPU data sheet (SXM, dense)",
}

PEAKS = {
    "NVIDIA H100 80GB HBM3": _H100_SXM,
}


def peak(device_kind, rate="bf16_flops_per_s"):
    """The published ``rate`` of ``device_kind``; raises ``KeyError`` for a
    device or rate the table does not hold."""
    if device_kind not in PEAKS:
        raise KeyError(
            f"no published peak for device {device_kind!r}; add it to "
            "benchmarks/peaks.py with its source"
        )
    return PEAKS[device_kind][rate]
