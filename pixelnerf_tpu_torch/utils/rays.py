"""Ray generation and multi-view tensor helpers.

Counterpart of `pixelnerf_tpu/utils/rays.py` (`unproj_map`, `gen_rays`,
`repeat_interleave`, `combine_interleaved`); layouts are the JAX
package's: rays are (..., 8) [origin(3), dir(3), near, far], images NHWC.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["unproj_map", "gen_rays", "repeat_interleave", "combine_interleaved"]


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
