"""Pixel-aligned feature lookup: bilinear, border padding, align_corners.

Counterpart of `pixelnerf_tpu/ops/grid_sample.py:grid_sample_2d` for the
case the flagship config uses. Layouts are the JAX package's: features
NHWC, normalized points (B, N, 2) as [x, y] in [-1, 1].
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["grid_sample_2d"]


def grid_sample_2d(
    feat: torch.Tensor,
    uv: torch.Tensor,
    padding_mode: str = "border",
    align_corners: bool = True,
    mode: str = "bilinear",
) -> torch.Tensor:
    """Sample `feat` (B, H, W, C) at normalized points `uv` (B, N, 2).

    Returns (B, N, C) in `feat`'s dtype. The lookup runs in float32, so
    bf16 coordinates never round a sample position.
    """
    out = F.grid_sample(
        feat.permute(0, 3, 1, 2).float(),
        uv[:, None].float(),
        mode=mode,
        padding_mode=padding_mode,
        align_corners=align_corners,
    )  # (B, C, 1, N)
    return out[:, :, 0].permute(0, 2, 1).to(feat.dtype)
