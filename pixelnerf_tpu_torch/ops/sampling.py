"""Ray-sampling ops: stratified coarse, inverse-CDF fine, depth-targeted.

Counterpart of `pixelnerf_tpu/ops/sampling.py`. Random draws come from an
explicit `torch.Generator`; each sampler also takes its draws directly
(`jitter`, `u`/`bin_jitter`, `noise`), so a caller can hand both this
package and the JAX one the same numbers.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["sample_coarse", "sample_fine", "sample_fine_depth"]


def _z_from_steps(rays: torch.Tensor, z_steps: torch.Tensor, lindisp: bool) -> torch.Tensor:
    near, far = rays[..., -2:-1], rays[..., -1:]
    if not lindisp:
        return near * (1 - z_steps) + far * z_steps
    return 1.0 / (1.0 / near * (1 - z_steps) + 1.0 / far * z_steps)


def sample_coarse(
    rays: torch.Tensor,
    n_coarse: int,
    lindisp: bool = False,
    perturb: float = 1.0,
    generator: Optional[torch.Generator] = None,
    jitter: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Stratified samples over [near, far], (B, Kc). `jitter` (B, Kc) in
    [0, 1) is drawn from `generator` when not given; perturb=0 takes bin
    midpoints and draws nothing."""
    B = rays.shape[0]
    step = 1.0 / n_coarse
    z_steps = torch.linspace(
        0.0, 1.0 - step, n_coarse, dtype=torch.float32, device=rays.device
    )[None]
    if perturb == 0.0:
        z_steps = z_steps + 0.5 * step
    else:
        if jitter is None:
            jitter = torch.rand(
                (B, n_coarse), generator=generator, device=rays.device
            )
        z_steps = z_steps + (0.5 + perturb * (jitter - 0.5)) * step
    return _z_from_steps(rays, z_steps, lindisp)


def sample_fine(
    rays: torch.Tensor,
    weights: torch.Tensor,
    n_fine: int,
    lindisp: bool = False,
    perturb: float = 1.0,
    generator: Optional[torch.Generator] = None,
    u: Optional[torch.Tensor] = None,
    bin_jitter: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Importance samples from the (detached) coarse weights, (B, Kf),
    by inverse CDF over the Kc equal coarse bins."""
    B, Kc = weights.shape
    weights = weights.detach() + 1e-5
    pdf = weights / weights.sum(dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=-1)  # (B, Kc+1)

    if perturb == 0.0:
        u = (
            torch.arange(n_fine, dtype=torch.float32, device=rays.device)[None] + 0.5
        ) / n_fine
        u = u.expand(B, n_fine)
        bin_jitter = torch.full(
            (B, n_fine), 0.5, dtype=torch.float32, device=rays.device
        )
    else:
        if u is None:
            u = torch.rand((B, n_fine), generator=generator, device=rays.device)
        if bin_jitter is None:
            bin_jitter = torch.rand(
                (B, n_fine), generator=generator, device=rays.device
            )
    # searchsorted(cdf, u, right=True) - 1, as a count of cdf entries <= u
    inds = (cdf[:, None, :] <= u[:, :, None]).float().sum(dim=-1) - 1.0
    inds = inds.clamp_min(0.0)
    z_steps = (inds + bin_jitter) / Kc
    return _z_from_steps(rays, z_steps, lindisp)


def sample_fine_depth(
    rays: torch.Tensor,
    depth: torch.Tensor,
    n_fine_depth: int,
    depth_std: float = 0.01,
    perturb: float = 1.0,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Gaussian samples around the expected coarse depth, clamped into
    [near, far], (B, Kfd). `noise` is standard normal."""
    B = depth.shape[0]
    if perturb == 0.0:
        z_samp = depth[:, None].expand(B, n_fine_depth)
    else:
        if noise is None:
            noise = torch.randn(
                (B, n_fine_depth), generator=generator, device=rays.device
            )
        z_samp = depth[:, None] + noise * (depth_std * perturb)
    return torch.minimum(torch.maximum(z_samp, rays[..., -2:-1]), rays[..., -1:])
