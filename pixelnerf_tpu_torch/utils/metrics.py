"""Image quality metrics.

Counterpart of the `psnr` of `pixelnerf_tpu/utils/metrics.py` (reference
src/util/util.py:474-481). SSIM and LPIPS are not ported yet.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["psnr"]


def psnr(pred, target) -> float:
    """PSNR in dB between arrays in [0, 1]."""
    pred = np.asarray(pred, dtype=np.float64)
    target = np.asarray(target, dtype=np.float64)
    mse = float(np.mean((pred - target) ** 2))
    if mse <= 0:
        return float("inf")
    return -10.0 * math.log10(mse)
