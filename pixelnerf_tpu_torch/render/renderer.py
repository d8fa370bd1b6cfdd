"""NeRF volume renderer, coarse then fine.

Counterpart of `pixelnerf_tpu/render/renderer.py` (`RendererConfig` and
`render_rays`): the fine pass merges the importance and depth samples with
the coarse z, sorts them, and queries the fine field at the sorted
samples; with `query_cache` it queries the fine field at the cached coarse
samples and the new ones unsorted, then sorts z and gathers the four output
channels into composite order (the JAX package's one-hot permute exists
only because a TPU has no fast gather). Random draws come from a
`torch.Generator`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from pixelnerf_tpu_torch.ops.composite import alpha_composite
from pixelnerf_tpu_torch.ops.sampling import (
    sample_coarse, sample_fine, sample_fine_depth,
)
from pixelnerf_tpu_torch.utils.spans import span

__all__ = ["RendererConfig", "render_rays"]

# query_fn(xyz (SB, B, 3), viewdirs (SB, B, 3) | None, coarse: bool) -> (SB, B, 4)
# With query_cache=True the renderer calls the extended contract
# query_fn(xyz, viewdirs, coarse, want_cache: int, cache) (see
# models.pixelnerf.QueryCache)
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
    # sample-count schedule (iters, n_coarse list, n_fine list)
    sched: tuple = ()

    @property
    def using_fine(self) -> bool:
        return self.n_fine > 0

    def at_iteration(self, it: int) -> "RendererConfig":
        """The counts of the last schedule stage that starts at or before
        iteration `it` (reference nerf.py:318-338)."""
        if not self.sched:
            return self
        iters, coarse_list, fine_list = self.sched
        n_coarse, n_fine = self.n_coarse, self.n_fine
        for i, start in enumerate(iters):
            if it >= start:
                n_coarse, n_fine = coarse_list[i], fine_list[i]
        return self.replace(n_coarse=int(n_coarse), n_fine=int(n_fine))

    def replace(self, **kw) -> "RendererConfig":
        return dataclasses.replace(self, **kw)

    @classmethod
    def from_conf(
        cls, conf, white_bkgd: bool = False, lindisp: bool = False
    ) -> "RendererConfig":
        sched = conf.get_list("sched", None) or ()
        return cls(
            n_coarse=conf.get_int("n_coarse", 128),
            n_fine=conf.get_int("n_fine", 0),
            n_fine_depth=conf.get_int("n_fine_depth", 0),
            noise_std=conf.get_float("noise_std", 0.0),
            depth_std=conf.get_float("depth_std", 0.01),
            white_bkgd=bool(conf.get_float("white_bkgd", white_bkgd)),
            lindisp=lindisp,
            perturb=conf.get_float("perturb", 1.0),
            sched=tuple(tuple(s) for s in sched),
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
               use_viewdirs, generator, train, want_cache: int = 0):
    """Evaluate the field at the samples and alpha-composite; with
    want_cache, also return the query's cache."""
    B, K = z_samp.shape
    points, viewdirs = _sample_points(rays_flat, z_samp, superbatch, use_viewdirs)
    cache = None
    if want_cache:
        out, cache = query_fn(points, viewdirs, coarse, want_cache, None)
    else:
        out = query_fn(points, viewdirs, coarse)
    out = out.reshape(B, K, -1)
    with span("pnt.composite"):
        res = alpha_composite(
            out[..., :3], out[..., 3], z_samp, rays_flat,
            white_bkgd=cfg.white_bkgd,
            noise_std=cfg.noise_std if train else 0.0,
            generator=generator,
        )
    return res + (cache,) if want_cache else res


def render_rays(
    query_fn: QueryFn,
    rays: torch.Tensor,
    cfg: RendererConfig,
    generator: Optional[torch.Generator] = None,
    want_weights: bool = False,
    use_viewdirs: bool = True,
    train: bool = False,
    query_cache: bool = False,
) -> Dict[str, Dict[str, torch.Tensor]]:
    """Render a ray batch coarse (+fine).

    :param rays (SB, B, 8) [origin, dir, near, far]
    :param generator source of every random draw (none when perturb=0
        and noise_std=0)
    :param query_cache dedup the fine pass's coarse samples: their
        projection, gather and positional code come from the coarse pass
        (query_fn must take the extended contract); the field is pointwise,
        so the per-sample outputs, and the sorted z, equal the plain path's
    :return {'coarse': {'rgb' (SB,B,3), 'depth' (SB,B), 'weights'?},
        'fine': ...}
    """
    if rays.ndim != 3:
        raise ValueError(f"rays must be (SB, B, 8), got {tuple(rays.shape)}")
    with span("pnt.render"):
        return _render(query_fn, rays, cfg, generator, want_weights, use_viewdirs, train,
                       query_cache)


def _render(query_fn, rays, cfg, generator, want_weights, use_viewdirs, train, query_cache):
    superbatch = rays.shape[0]
    rays_flat = rays.reshape(-1, 8)

    want_cache = cfg.n_coarse if (query_cache and cfg.using_fine) else 0
    with span("pnt.sample"):
        z_coarse = sample_coarse(
            rays_flat, cfg.n_coarse, cfg.lindisp, perturb=cfg.perturb,
            generator=generator,
        )
    res = _composite(
        query_fn, rays_flat, z_coarse, cfg, superbatch, True, use_viewdirs,
        generator, train, want_cache=want_cache,
    )
    weights_c, rgb_c, depth_c = res[:3]

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
        with span("pnt.sample"):
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
        if want_cache and new_samps:
            z_new = torch.cat(new_samps, dim=-1)
            points_new, viewdirs_new = _sample_points(
                rays_flat, z_new, superbatch, use_viewdirs
            )
            out = query_fn(points_new, viewdirs_new, False, 0, res[3])
            out = out.reshape(z_combine.shape[0], z_combine.shape[1], -1)
            with span("pnt.sample"):
                z_sorted, idx = torch.sort(z_combine, dim=-1, stable=True)
            with span("pnt.composite"):
                out = torch.gather(out, 1, idx[..., None].expand(-1, -1, out.shape[-1]))
                weights_f, rgb_f, depth_f = alpha_composite(
                    out[..., :3], out[..., 3], z_sorted, rays_flat,
                    white_bkgd=cfg.white_bkgd,
                    noise_std=cfg.noise_std if train else 0.0,
                    generator=generator,
                )
        else:
            with span("pnt.sample"):
                z_sorted = torch.sort(z_combine, dim=-1).values
            weights_f, rgb_f, depth_f = _composite(
                query_fn, rays_flat, z_sorted, cfg, superbatch, False,
                use_viewdirs, generator, train,
            )
        outputs["fine"] = fmt(weights_f, rgb_f, depth_f, z_combine.shape[-1])
    return outputs
