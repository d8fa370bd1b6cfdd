"""Separable bilinear resize of NHWC maps.

Counterpart of `pixelnerf_tpu/ops/interpolate.py:resize_bilinear`: the
same dense 1-D interpolation matrices (torch `F.interpolate` semantics),
applied as two small products over the H and W axes.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

__all__ = ["resize_bilinear", "interp_matrix"]


@functools.lru_cache(maxsize=64)
def _interp_matrix_np(out_size: int, in_size: int, align_corners: bool) -> np.ndarray:
    """Dense 1-D linear interpolation matrix M (out, in): y = M @ x."""
    M = np.zeros((out_size, in_size), dtype=np.float32)
    if in_size == 1:
        M[:, 0] = 1.0
        return M
    for i in range(out_size):
        if align_corners:
            src = i * (in_size - 1) / (out_size - 1) if out_size > 1 else 0.0
        else:
            src = (i + 0.5) * in_size / out_size - 0.5
            src = min(max(src, 0.0), in_size - 1)
        lo = int(np.floor(src))
        hi = min(lo + 1, in_size - 1)
        w = src - lo
        M[i, lo] += 1.0 - w
        M[i, hi] += w
    return M


def interp_matrix(
    out_size: int, in_size: int, align_corners: bool = True, device=None,
    dtype=torch.float32,
) -> torch.Tensor:
    return torch.from_numpy(
        _interp_matrix_np(out_size, in_size, align_corners)
    ).to(device=device, dtype=dtype)


def resize_bilinear(
    x: torch.Tensor, out_hw: Tuple[int, int], align_corners: bool = True
) -> torch.Tensor:
    """Bilinear resize of (..., H, W, C) to (..., H', W', C)."""
    H, W = x.shape[-3], x.shape[-2]
    Ho, Wo = out_hw
    if (H, W) == (Ho, Wo):
        return x
    Mh = interp_matrix(Ho, H, align_corners, x.device, x.dtype)
    Mw = interp_matrix(Wo, W, align_corners, x.device, x.dtype)
    x = torch.einsum("ih,...hwc->...iwc", Mh, x)
    return torch.einsum("jw,...iwc->...ijc", Mw, x)
