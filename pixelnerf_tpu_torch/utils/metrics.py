"""Image quality metrics: PSNR and SSIM (skimage-compatible).

Counterpart of `pixelnerf_tpu/utils/metrics.py` (`psnr`, `psnr_np`,
`ssim_np`; reference src/util/util.py:474-481). SSIM follows Wang et al.
2004 with the defaults of `skimage.measure.compare_ssim(...,
multichannel=True, data_range=1)` that the reference uses
(eval/calc_metrics.py:188-191, eval/eval_approx.py:143-148):
gaussian_weights=False, a uniform 7x7 window, K1=0.01, K2=0.03,
use_sample_covariance=True. LPIPS is not ported: the JAX package has it
only with weights that are absent offline, where it reports NaN, and so
does the port's `eval/calc_metrics.py` (ROADMAP queue 1).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

__all__ = ["psnr", "psnr_np", "ssim_np"]


def psnr(pred, target) -> float:
    """PSNR in dB between arrays in [0, 1]."""
    pred = np.asarray(pred, dtype=np.float64)
    target = np.asarray(target, dtype=np.float64)
    mse = float(np.mean((pred - target) ** 2))
    if mse <= 0:
        return float("inf")
    return -10.0 * math.log10(mse)


# skimage.compare_psnr(data_range=1) is the same formula
psnr_np = psnr


def _uniform_filter(img: np.ndarray, size: int) -> np.ndarray:
    """Separable box filter with scipy.ndimage.uniform_filter's default
    'reflect' border, which skimage uses before cropping the margin."""
    pad = size // 2
    out = img.astype(np.float64)
    for axis in (0, 1):
        n = out.shape[axis]
        padded = np.concatenate(
            (np.flip(out.take(range(pad), axis=axis), axis=axis), out,
             np.flip(out.take(range(n - pad, n), axis=axis), axis=axis)),
            axis=axis,
        )
        csum = np.cumsum(padded, axis=axis)
        csum = np.concatenate((np.zeros_like(csum.take(range(1), axis=axis)), csum), axis=axis)
        hi = csum.take(range(size, csum.shape[axis]), axis=axis)
        lo = csum.take(range(0, csum.shape[axis] - size), axis=axis)
        out = (hi - lo) / size
    return out


def _ssim_single(x: np.ndarray, y: np.ndarray, data_range: float, win_size: int) -> float:
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    npix = win_size**2
    cov_norm = npix / (npix - 1)  # sample covariance (skimage's default)
    ux, uy = _uniform_filter(x, win_size), _uniform_filter(y, win_size)
    uxx = _uniform_filter(x * x, win_size)
    uyy = _uniform_filter(y * y, win_size)
    uxy = _uniform_filter(x * y, win_size)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / ((ux**2 + uy**2 + c1) * (vx + vy + c2))
    pad = (win_size - 1) // 2
    return float(np.mean(s[pad:-pad, pad:-pad]))


def ssim_np(
    img1: np.ndarray, img2: np.ndarray, data_range: float = 1.0, win_size: int = 7,
    multichannel: Optional[bool] = None,
) -> float:
    """Structural similarity with skimage compare_ssim's defaults; an
    (H, W, C) image is the mean over its channels."""
    img1 = np.asarray(img1, dtype=np.float64)
    img2 = np.asarray(img2, dtype=np.float64)
    if multichannel is None:
        multichannel = img1.ndim == 3
    if multichannel:
        return float(np.mean([_ssim_single(img1[..., c], img2[..., c], data_range, win_size)
                              for c in range(img1.shape[-1])]))
    return _ssim_single(img1, img2, data_range, win_size)
