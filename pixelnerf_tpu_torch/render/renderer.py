"""NeRF volume renderer, coarse then fine.

Counterpart of `pixelnerf_tpu/render/renderer.py` (`RendererConfig` and
the plain branch of `render_rays`): the fine pass merges the importance
and depth samples with the coarse z, sorts them, and queries the fine
field at the sorted samples. Random draws come from a `torch.Generator`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from pixelnerf_tpu_torch.ops.composite import alpha_composite
from pixelnerf_tpu_torch.ops.sampling import (
    sample_coarse, sample_fine, sample_fine_depth,
)

__all__ = ["RendererConfig", "render_rays"]

# query_fn(xyz (SB, B, 3), viewdirs (SB, B, 3) | None, coarse: bool) -> (SB, B, 4)
QueryFn = Callable[[torch.Tensor, Optional[torch.Tensor], bool], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class RendererConfig:
    """Renderer hyperparameters."""

    n_coarse: int = 128
    n_fine: int = 0
    n_fine_depth: int = 0
    noise_std: float = 0.0
    depth_std: float = 0.01
    # in-bin jitter scale of every sampler: 1.0 full stratified jitter,
    # 0.0 deterministic (bin midpoints, fixed CDF quantiles)
    perturb: float = 1.0
    white_bkgd: bool = False
    lindisp: bool = False

    @property
    def using_fine(self) -> bool:
        return self.n_fine > 0

    def replace(self, **kw) -> "RendererConfig":
        return dataclasses.replace(self, **kw)

    @classmethod
    def from_conf(
        cls, conf, white_bkgd: bool = False, lindisp: bool = False
    ) -> "RendererConfig":
        return cls(
            n_coarse=conf.get_int("n_coarse", 128),
            n_fine=conf.get_int("n_fine", 0),
            n_fine_depth=conf.get_int("n_fine_depth", 0),
            noise_std=conf.get_float("noise_std", 0.0),
            depth_std=conf.get_float("depth_std", 0.01),
            white_bkgd=bool(conf.get_float("white_bkgd", white_bkgd)),
            lindisp=lindisp,
            perturb=conf.get_float("perturb", 1.0),
        )


def _sample_points(rays_flat, z_samp, superbatch, use_viewdirs):
    """World points (SB, B'*K, 3) and ray directions at the z samples."""
    B, K = z_samp.shape
    points = (
        rays_flat[:, None, :3] + z_samp[..., None] * rays_flat[:, None, 3:6]
    ).reshape(superbatch, -1, 3)
    viewdirs = None
    if use_viewdirs:
        viewdirs = rays_flat[:, None, 3:6].expand(B, K, 3).reshape(superbatch, -1, 3)
    return points, viewdirs


def _composite(query_fn, rays_flat, z_samp, cfg, superbatch, coarse,
               use_viewdirs, generator, train):
    """Evaluate the field at the samples and alpha-composite."""
    B, K = z_samp.shape
    points, viewdirs = _sample_points(rays_flat, z_samp, superbatch, use_viewdirs)
    out = query_fn(points, viewdirs, coarse).reshape(B, K, -1)
    return alpha_composite(
        out[..., :3], out[..., 3], z_samp, rays_flat,
        white_bkgd=cfg.white_bkgd,
        noise_std=cfg.noise_std if train else 0.0,
        generator=generator,
    )


def render_rays(
    query_fn: QueryFn,
    rays: torch.Tensor,
    cfg: RendererConfig,
    generator: Optional[torch.Generator] = None,
    want_weights: bool = False,
    use_viewdirs: bool = True,
    train: bool = False,
) -> Dict[str, Dict[str, torch.Tensor]]:
    """Render a ray batch coarse (+fine).

    :param rays (SB, B, 8) [origin, dir, near, far]
    :param generator source of every random draw (none when perturb=0
        and noise_std=0)
    :return {'coarse': {'rgb' (SB,B,3), 'depth' (SB,B), 'weights'?},
        'fine': ...}
    """
    if rays.ndim != 3:
        raise ValueError(f"rays must be (SB, B, 8), got {tuple(rays.shape)}")
    superbatch = rays.shape[0]
    rays_flat = rays.reshape(-1, 8)

    z_coarse = sample_coarse(
        rays_flat, cfg.n_coarse, cfg.lindisp, perturb=cfg.perturb,
        generator=generator,
    )
    weights_c, rgb_c, depth_c = _composite(
        query_fn, rays_flat, z_coarse, cfg, superbatch, True, use_viewdirs,
        generator, train,
    )

    def fmt(weights, rgb, depth, K):
        out = {
            "rgb": rgb.reshape(superbatch, -1, 3),
            "depth": depth.reshape(superbatch, -1),
        }
        if want_weights:
            out["weights"] = weights.reshape(superbatch, -1, K)
        return out

    outputs = {"coarse": fmt(weights_c, rgb_c, depth_c, cfg.n_coarse)}
    if cfg.using_fine:
        new_samps = []
        if cfg.n_fine - cfg.n_fine_depth > 0:
            new_samps.append(
                sample_fine(
                    rays_flat, weights_c, cfg.n_fine - cfg.n_fine_depth,
                    cfg.lindisp, perturb=cfg.perturb, generator=generator,
                )
            )
        if cfg.n_fine_depth > 0:
            new_samps.append(
                sample_fine_depth(
                    rays_flat, depth_c.detach(), cfg.n_fine_depth,
                    cfg.depth_std, perturb=cfg.perturb, generator=generator,
                )
            )
        z_combine = torch.cat([z_coarse] + new_samps, dim=-1)
        z_sorted = torch.sort(z_combine, dim=-1).values
        weights_f, rgb_f, depth_f = _composite(
            query_fn, rays_flat, z_sorted, cfg, superbatch, False,
            use_viewdirs, generator, train,
        )
        outputs["fine"] = fmt(weights_f, rgb_f, depth_f, z_combine.shape[-1])
    return outputs
