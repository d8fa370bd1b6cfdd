"""Pixel-aligned spatial encoder and the feature lookup.

Counterpart of `pixelnerf_tpu/models/encoder.py`: `SpatialEncoder`,
`latent_scaling_for`, `pack_pyramid_levels`, `compose_pyramid` and
`index_features`, which looks native levels up with the pyramid kernels
(ops/pyramid.py) and a single bf16 map with the bilerp kernels
(ops/scatter.py) under the JAX package's predicates, and composes the
upsampled map for every other lookup. Layout is NHWC.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
from torch import nn

from pixelnerf_tpu_torch.models.resnet import ResNetTrunk
from pixelnerf_tpu_torch.ops.grid_sample import grid_sample_2d
from pixelnerf_tpu_torch.ops.interpolate import resize_bilinear, resize_nearest
from pixelnerf_tpu_torch.ops.pyramid import (
    pyramid_index_train, pyramid_index_train_dual, pyramid_supported,
)
from pixelnerf_tpu_torch.ops.scatter import fused_supported, grid_sample_border_train

__all__ = [
    "SpatialEncoder",
    "latent_scaling_for",
    "pack_pyramid_levels",
    "compose_pyramid",
    "index_features",
    "pyramid_fused_ok",
]

# latent channel count by num_layers for resnet18/34
_LATENT_SIZES = [0, 64, 128, 256, 512, 1024]


def latent_scaling_for(latent_hw: Tuple[int, int], device=None) -> torch.Tensor:
    """(2,) [sx, sy] pixel-to-grid scaling s/(s-1)*2 of a (H, W) latent."""
    Hl, Wl = latent_hw
    s = np.array([Wl, Hl], dtype=np.float32)
    return torch.from_numpy(s / (s - 1.0) * 2.0).to(device)


def pyramid_fused_ok(
    levels, index_interp: str, index_padding: str, upsample_interp: str = "bilinear"
) -> bool:
    """True when the native levels feed the pyramid kernels (ops/pyramid.py)
    and the fused field kernel (ops/field.py): bilinear upsample and lookup
    with border padding, bf16 levels, a fine grid of at most 8192 pixels.
    Otherwise `encode` composes the upsampled pyramid once."""
    return (
        index_interp == "bilinear"
        and index_padding == "border"
        and upsample_interp == "bilinear"
        and all(l.dtype == torch.bfloat16 for l in levels)
        and pyramid_supported(tuple(levels[0].shape[1:3]))
    )


def _resize_levels(levels, target_hw, upsample_interp, index_interp):
    """Resize levels to `target_hw` with `upsample_interp`. The bilinear
    align_corners choice keys on index_interp == "nearest " WITH the
    trailing space, as the reference compares it."""
    if upsample_interp.startswith("nearest"):
        return [resize_nearest(l, target_hw) for l in levels]
    align = None if index_interp == "nearest " else True
    return [resize_bilinear(l, target_hw, align_corners=bool(align)) for l in levels]


def compose_pyramid(
    levels, upsample_interp: str = "bilinear", index_interp: str = "bilinear"
) -> torch.Tensor:
    """The upsampled feature pyramid: every level resized to level 0's
    resolution, then channel-concatenated."""
    return torch.cat(
        _resize_levels(levels, levels[0].shape[1:3], upsample_interp, index_interp),
        dim=-1,
    )


def pack_pyramid_levels(
    levels: Sequence[torch.Tensor],
    upsample_interp: str = "bilinear",
    index_interp: str = "bilinear",
    lane_width: int = 128,
):
    """Merge adjacent levels, left to right, while a group's channel total
    stays <= `lane_width`: each group's coarser members are upsampled to
    its finest resolution and channel-concatenated. The concatenated
    channel order is unchanged."""
    levels = list(levels)
    groups = [[levels[0]]]
    for l in levels[1:]:
        if sum(g.shape[-1] for g in groups[-1]) + l.shape[-1] <= lane_width:
            groups[-1].append(l)
        else:
            groups.append([l])
    if all(len(g) == 1 for g in groups):
        return tuple(levels)
    out = []
    for g in groups:
        if len(g) == 1:
            out.append(g[0])
            continue
        ups = [g[0]] + _resize_levels(
            g[1:], g[0].shape[1:3], upsample_interp, index_interp
        )
        out.append(torch.cat(ups, dim=-1))
    return tuple(out)


def index_features(
    latent,
    latent_scaling: torch.Tensor,
    uv: torch.Tensor,
    image_size: torch.Tensor,
    index_interp: str = "bilinear",
    index_padding: str = "border",
    upsample_interp: str = "bilinear",
    dual: bool = False,
):
    """Pixel-aligned lookup of (B, N, 2) image points (x, y) in input-pixel
    coordinates in a (B, Hl, Wl, C) map, or in a tuple of native levels.

    Native levels that `pyramid_fused_ok` accepts go through the pyramid
    kernels (gradient for the levels, none for uv); other levels are
    composed first. A bf16 map of at most 8192 pixels under a bilinear,
    border lookup goes through the bilerp kernels (`grid_sample_border_train`:
    gradient for the map, none for uv); any other map through
    `grid_sample_2d`.

    :param dual return the latent twice, for two consumers (the coarse MLP
        and the fine pass's query cache); on the pyramid path the two
        cotangents are summed inside the scatter kernel, elsewhere autograd
        adds them
    :return (B, N, C); with dual, a pair of (B, N, C)
    """
    grid = uv * (latent_scaling / image_size) - 1.0
    if isinstance(latent, (tuple, list)):
        levels = tuple(latent)
        if pyramid_fused_ok(levels, index_interp, index_padding, upsample_interp):
            if dual:
                return pyramid_index_train_dual(levels, grid)
            return pyramid_index_train(levels, grid)
        latent = compose_pyramid(levels, upsample_interp, index_interp)
    if (
        index_interp == "bilinear"
        and index_padding == "border"
        and latent.dtype == torch.bfloat16
        and fused_supported(latent.shape[1], latent.shape[2])
    ):
        out = grid_sample_border_train(latent, grid)
        return (out, out) if dual else out
    out = grid_sample_2d(
        latent, grid, padding_mode=index_padding, align_corners=True,
        mode=index_interp,
    )
    return (out, out) if dual else out


class SpatialEncoder(nn.Module):
    """Pixel-aligned feature pyramid encoder on a ResNet trunk.

    Returns the channel-packed native levels, finest first, and the
    pixel-to-grid scaling of level 0.
    """

    def __init__(
        self,
        backbone: str = "resnet34",
        num_layers: int = 4,
        index_interp: str = "bilinear",
        index_padding: str = "border",
        upsample_interp: str = "bilinear",
        feature_scale: float = 1.0,
        use_first_pool: bool = True,
        norm_type: str = "batch",
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        if backbone not in ("resnet18", "resnet34"):
            raise NotImplementedError(f"backbone {backbone} is not ported yet")
        if feature_scale != 1.0 or norm_type != "batch":
            raise NotImplementedError(
                "feature_scale != 1 and non-batch norms are not ported yet"
            )
        self.num_layers = num_layers
        self.index_interp = index_interp
        self.index_padding = index_padding
        self.upsample_interp = upsample_interp
        self.model = ResNetTrunk(
            backbone=backbone, num_stages=num_layers - 1,
            use_first_pool=use_first_pool, dtype=dtype,
        )

    @property
    def latent_size(self) -> int:
        return _LATENT_SIZES[self.num_layers]

    def forward(self, x: torch.Tensor):
        """:param x images (B, H, W, 3) in [-1, 1]
        :return (levels tuple of (B, H_l, W_l, C_l), latent_scaling (2,))"""
        latents = pack_pyramid_levels(
            self.model(x), self.upsample_interp, self.index_interp
        )
        latents = tuple(l.contiguous() for l in latents)
        return latents, latent_scaling_for(latents[0].shape[1:3], x.device)

    @classmethod
    def from_conf(cls, conf, **kwargs) -> "SpatialEncoder":
        return cls(
            backbone=conf.get_string("backbone"),
            num_layers=conf.get_int("num_layers", 4),
            index_interp=conf.get_string("index_interp", "bilinear"),
            index_padding=conf.get_string("index_padding", "border"),
            upsample_interp=conf.get_string("upsample_interp", "bilinear"),
            feature_scale=conf.get_float("feature_scale", 1.0),
            use_first_pool=conf.get_bool("use_first_pool", True),
            **kwargs,
        )
