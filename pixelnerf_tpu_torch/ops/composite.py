"""Volume-rendering alpha compositing in float32.

Counterpart of `pixelnerf_tpu/ops/composite.py`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["alpha_composite", "composite_deltas"]


def composite_deltas(z_samp: torch.Tensor, rays: torch.Tensor) -> torch.Tensor:
    """Inter-sample distances; the last delta is far - z_last (not 1e10)."""
    deltas = z_samp[..., 1:] - z_samp[..., :-1]
    delta_inf = rays[..., -1:] - z_samp[..., -1:]
    return torch.cat([deltas, delta_inf], dim=-1)


def alpha_composite(
    rgbs: torch.Tensor,
    sigmas: torch.Tensor,
    z_samp: torch.Tensor,
    rays: torch.Tensor,
    white_bkgd: bool = False,
    noise_std: float = 0.0,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Composite per-sample radiance into per-ray color and depth.

    :param rgbs (B, K, 3) sigmoided color
    :param sigmas (B, K) density (ReLU applied here)
    :param z_samp (B, K) sorted sample depths
    :param rays (B, 8) for the far bound
    :return (weights (B, K), rgb (B, 3), depth (B,))
    """
    deltas = composite_deltas(z_samp, rays)
    if noise_std > 0.0:
        sigmas = sigmas + torch.randn(
            sigmas.shape, generator=generator, device=sigmas.device
        ) * noise_std
    alphas = 1.0 - torch.exp(-deltas * torch.relu(sigmas))
    # exclusive cumprod of (1 - alpha + eps): T_k = prod_{j<k} (1 - a_j)
    alphas_shifted = torch.cat(
        [torch.ones_like(alphas[..., :1]), 1.0 - alphas + 1e-10], dim=-1
    )
    T = torch.cumprod(alphas_shifted, dim=-1)
    weights = alphas * T[..., :-1]
    rgb_final = (weights[..., None] * rgbs).sum(dim=-2)
    depth_final = (weights * z_samp).sum(dim=-1)
    if white_bkgd:
        rgb_final = rgb_final + (1.0 - weights.sum(dim=-1))[..., None]
    return weights, rgb_final, depth_final
