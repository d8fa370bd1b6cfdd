"""Separable bilinear, nearest and area resize of NHWC maps.

Counterpart of `pixelnerf_tpu/ops/interpolate.py:resize_bilinear`,
`resize_nearest` and `resize_area`: the same dense 1-D interpolation,
selection and averaging matrices
(torch `F.interpolate` semantics), applied as two small products over the
H and W axes. As products, their gradients are the transposed products,
which round where the JAX einsums' transposes round (an index-based
nearest resize would accumulate its backward in the map's dtype).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

__all__ = ["resize_bilinear", "resize_nearest", "resize_area", "interp_matrix"]


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


@functools.lru_cache(maxsize=64)
def _nearest_matrix_np(out_size: int, in_size: int) -> np.ndarray:
    """1-D selection matrix of torch F.interpolate(mode='nearest'): output
    index i reads input floor(i * in / out)."""
    M = np.zeros((out_size, in_size), dtype=np.float32)
    for i in range(out_size):
        M[i, (i * in_size) // out_size] = 1.0
    return M


def resize_nearest(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Nearest resize of (..., H, W, C) to (..., H', W', C)."""
    H, W = x.shape[-3], x.shape[-2]
    Ho, Wo = out_hw
    if (H, W) == (Ho, Wo):
        return x
    Mh = torch.from_numpy(_nearest_matrix_np(Ho, H)).to(device=x.device, dtype=x.dtype)
    Mw = torch.from_numpy(_nearest_matrix_np(Wo, W)).to(device=x.device, dtype=x.dtype)
    x = torch.einsum("ih,...hwc->...iwc", Mh, x)
    return torch.einsum("jw,...iwc->...ijc", Mw, x)


@functools.lru_cache(maxsize=64)
def _area_matrix_np(out_size: int, in_size: int) -> np.ndarray:
    """1-D averaging matrix of torch F.interpolate(mode='area') (adaptive
    average pooling): output i averages the input pixels
    [floor(i * in / out), ceil((i + 1) * in / out))."""
    M = np.zeros((out_size, in_size), dtype=np.float32)
    for i in range(out_size):
        j0 = (i * in_size) // out_size
        j1 = -((-(i + 1) * in_size) // out_size)
        M[i, j0:j1] = 1.0 / (j1 - j0)
    return M


def resize_area(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Area (average) resize of (..., H, W, C) to (..., H', W', C)."""
    H, W = x.shape[-3], x.shape[-2]
    Ho, Wo = out_hw
    if (H, W) == (Ho, Wo):
        return x
    Mh = torch.from_numpy(_area_matrix_np(Ho, H)).to(device=x.device, dtype=x.dtype)
    Mw = torch.from_numpy(_area_matrix_np(Wo, W)).to(device=x.device, dtype=x.dtype)
    x = torch.einsum("ih,...hwc->...iwc", Mh, x)
    return torch.einsum("jw,...iwc->...ijc", Mw, x)
