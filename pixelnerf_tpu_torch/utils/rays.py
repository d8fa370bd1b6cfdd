"""Ray generation and multi-view tensor helpers.

Counterpart of `pixelnerf_tpu/utils/rays.py` (`unproj_map`, `gen_rays`,
`bbox_sample`, `masked_sample_np`, `repeat_interleave`,
`combine_interleaved`, `homogeneous`); layouts are the JAX package's:
rays are (..., 8) [origin(3), dir(3), near, far], images NHWC. Random
draws come from a `torch.Generator` (`bbox_sample`) or a numpy one
(`masked_sample_np`, as in JAX).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "unproj_map", "gen_rays", "bbox_sample", "masked_sample_np", "repeat_interleave",
    "combine_interleaved", "homogeneous",
]


def _as_fc_pair(v, device, default: Optional[Tuple[float, float]] = None) -> torch.Tensor:
    """Normalize focal/principal point to a length-2 [x, y] tensor."""
    if v is None:
        return torch.tensor(default, dtype=torch.float32, device=device)
    v = torch.as_tensor(v, dtype=torch.float32, device=device).reshape(-1)
    if v.shape[0] != 2:
        v = (v[:2] if v.shape[0] >= 2 else v).expand(2)
    return v


def unproj_map(width: int, height: int, f, c=None, device=None) -> torch.Tensor:
    """Per-pixel unit camera-ray directions, (H, W, 3).

    Pixel (y, x) maps to normalize([(x-cx)/fx, -(y-cy)/fy, -1]).
    """
    c = _as_fc_pair(c, device, default=(width * 0.5, height * 0.5))
    f = _as_fc_pair(f, device)
    Y = torch.arange(height, dtype=torch.float32, device=device)[:, None] - c[1]
    X = torch.arange(width, dtype=torch.float32, device=device)[None, :] - c[0]
    X = (X / f[0]).expand(height, width)
    Y = (Y / f[1]).expand(height, width)
    Z = torch.ones_like(X)
    unproj = torch.stack((X, -Y, -Z), dim=-1)
    return unproj / torch.linalg.norm(unproj, dim=-1, keepdim=True)


def gen_rays(
    poses: torch.Tensor, width: int, height: int, focal, z_near, z_far, c=None
) -> torch.Tensor:
    """Camera rays [origin, dir, near, far] for camera-to-world `poses`
    (N, 4, 4): (N, H, W, 8)."""
    poses = torch.as_tensor(poses, dtype=torch.float32)
    device = poses.device
    n = poses.shape[0]
    cam_unproj = unproj_map(width, height, focal, c=c, device=device)
    centers = poses[:, None, None, :3, 3].expand(n, height, width, 3)
    dirs = torch.einsum("nij,hwj->nhwi", poses[:, :3, :3], cam_unproj)
    near = torch.as_tensor(z_near, dtype=torch.float32, device=device)
    far = torch.as_tensor(z_far, dtype=torch.float32, device=device)
    nears = near.reshape(-1, 1, 1, 1).expand(n, height, width, 1)
    fars = far.reshape(-1, 1, 1, 1).expand(n, height, width, 1)
    return torch.cat((centers, dirs, nears, fars), dim=-1)


def bbox_sample(
    bboxes: torch.Tensor, num_pix: int, generator: Optional[torch.Generator] = None,
    draws: Optional[Dict[str, torch.Tensor]] = None,
) -> torch.Tensor:
    """Sample pixel coords uniformly inside per-view bounding boxes
    (reference src/util/util.py:220-235).

    :param bboxes (NV, 4) [x0, y0, x1, y1] inclusive
    :param draws the random draws, given instead of drawn: `vid` (num_pix,)
        in [0, NV), `ux`, `uy` (num_pix,) in [0, 1)
    :return (num_pix, 3) int32 [view_id, y, x]
    """
    draws = draws or {}
    dev = bboxes.device
    vid = draws.get("vid")
    if vid is None:
        vid = torch.randint(0, bboxes.shape[0], (num_pix,), generator=generator, device=dev)
    ux, uy = draws.get("ux"), draws.get("uy")
    if ux is None:
        ux = torch.rand((num_pix,), generator=generator, device=dev)
    if uy is None:
        uy = torch.rand((num_pix,), generator=generator, device=dev)
    boxes = bboxes[vid.long()].float()
    x = (ux * (boxes[:, 2] + 1 - boxes[:, 0]) + boxes[:, 0]).to(torch.int32)
    y = (uy * (boxes[:, 3] + 1 - boxes[:, 1]) + boxes[:, 1]).to(torch.int32)
    return torch.stack((vid.to(torch.int32), y, x), dim=-1)


def masked_sample_np(
    rng: np.random.Generator, masks: np.ndarray, num_pix: int, prop_inside: float,
    thresh: float = 0.5,
) -> np.ndarray:
    """Host-side masked pixel sampler (reference src/util/util.py:205-217):
    a `prop_inside` share of the pixels drawn where masks >= thresh, the
    rest where below.

    :param masks (NV, H, W) float
    :return (num_pix, 3) [view_id, y, x]
    """
    num_inside = int(num_pix * prop_inside + 0.5)
    inside = np.argwhere(masks >= thresh)
    outside = np.argwhere(masks < thresh)
    pix_inside = inside[rng.integers(0, inside.shape[0], num_inside)]
    pix_outside = outside[rng.integers(0, outside.shape[0], num_pix - num_inside)]
    return np.concatenate((pix_inside, pix_outside), axis=0)


def repeat_interleave(x: torch.Tensor, repeats: int) -> torch.Tensor:
    """Repeat along dim 0: [a, b] -> [a, a, b, b] for repeats=2."""
    if repeats == 1:
        return x
    return torch.repeat_interleave(x, repeats, dim=0)


def combine_interleaved(
    t: torch.Tensor, inner_dims: Tuple[int, ...] = (1,), agg_type: str = "average"
) -> torch.Tensor:
    """Reduce (N*inner..., F) over the interleaved view dimension (dim 1 of
    (N, *inner_dims, F))."""
    if len(inner_dims) == 1 and inner_dims[0] == 1:
        return t
    t = t.reshape((-1,) + tuple(inner_dims) + tuple(t.shape[1:]))
    if agg_type == "average":
        return t.mean(dim=1)
    if agg_type == "max":
        return t.amax(dim=1)
    raise NotImplementedError(f"Unsupported combine type {agg_type}")


def homogeneous(points: torch.Tensor) -> torch.Tensor:
    """Append 1 to the last axis (reference src/util/util.py:84-90)."""
    return torch.cat((points, torch.ones(points.shape[:-1] + (1,), dtype=points.dtype,
                                         device=points.device)), dim=-1)
