"""3D reconstruction: sigma-grid evaluation, iso-surface, mesh writers.

Counterpart of `pixelnerf_tpu/utils/recon.py` (the reference's
src/util/recon.py:12-106 and the fork's STL path, eval/eval.py:90-110):

* `eval_sigma_grid`: the model's density on a regular 3D grid, built on
  the query's device and queried in chunks of `eval_batch_size` points
  (the last chunk padded with points at the origin, as the JAX package
  pads it); the volume comes back to the host for the iso-surface.
* `marching_cubes`: the grid, then `native/isosurface.cpp` (marching
  tetrahedra, `native/isosurface.py`), scaled back to world coordinates.
* `save_obj` (optional vertex colors) and a binary `save_stl`.
"""

from __future__ import annotations

import struct
import warnings
from typing import Callable, Optional, Tuple

import numpy as np
import torch

__all__ = ["eval_sigma_grid", "marching_cubes", "save_obj", "save_stl"]


def eval_sigma_grid(
    query_sigma: Callable[[torch.Tensor], torch.Tensor],
    reso: Tuple[int, int, int],
    c1=(-1.0, -1.0, -1.0),
    c2=(1.0, 1.0, 1.0),
    eval_batch_size: int = 65536,
    device=None,
) -> np.ndarray:
    """Sigma on an (rx, ry, rz) grid spanning the [c1, c2] box.

    :param query_sigma (N, 3) float32 world points on `device` -> (N,)
        densities (a closure over a model and a scene encoding)
    :param device where the grid is built and queried (the model's)
    :return (rx, ry, rz) float32 volume on the host
    """
    # the axes as the JAX package computes them (numpy's float32 linspace)
    axes = [torch.from_numpy(np.linspace(lo, hi, n, dtype=np.float32))
            for lo, hi, n in zip(c1, c2, reso)]
    grid = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1).reshape(-1, 3).to(device)
    n = grid.shape[0]
    chunk = min(eval_batch_size, n)
    pad = (-n) % chunk
    if pad:
        grid = torch.cat([grid, grid.new_zeros((pad, 3))])
    sigmas = [query_sigma(grid[start : start + chunk]) for start in range(0, grid.shape[0], chunk)]
    vol = torch.cat(sigmas)[:n].float().cpu().numpy()
    return vol.reshape(reso)


def marching_cubes(
    query_sigma: Callable[[torch.Tensor], torch.Tensor],
    c1=(-1.0, -1.0, -1.0),
    c2=(1.0, 1.0, 1.0),
    reso: Tuple[int, int, int] = (128, 128, 128),
    isosurface: float = 50.0,
    eval_batch_size: int = 65536,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """An iso-surface mesh of the density field: (verts (V, 3) world
    coordinates float32, tris (T, 3) int32), the reference's contract
    (recon.py:12-79). Models trained with view directions get an all-zero
    view direction during the grid's query (recon.py:38-41)."""
    warnings.warn(
        "Note: marching cubes is only supported with viewdirs off (uses a fake zero viewdir "
        "otherwise)"
    )
    vol = eval_sigma_grid(query_sigma, reso, c1, c2, eval_batch_size=eval_batch_size, device=device)
    from pixelnerf_tpu_torch.native.isosurface import load_isosurface

    verts, tris = load_isosurface()(vol, float(isosurface))
    c1 = np.asarray(c1, dtype=np.float32)
    c2 = np.asarray(c2, dtype=np.float32)
    scale = (c2 - c1) / (np.asarray(reso, dtype=np.float32) - 1)
    verts = verts * scale[None] + c1[None]
    return verts.astype(np.float32), tris.astype(np.int32)


def save_obj(vertices: np.ndarray, triangles: np.ndarray, path: str,
             vert_rgb: Optional[np.ndarray] = None) -> None:
    """An OBJ with 1-indexed faces and optional per-vertex colors on each
    `v` line (reference recon.py:81-106)."""
    with open(path, "w") as f:
        for i, v in enumerate(vertices):
            if vert_rgb is not None:
                c = vert_rgb[i]
                f.write(f"v {v[0]:f} {v[1]:f} {v[2]:f} {c[0]:f} {c[1]:f} {c[2]:f}\n")
            else:
                f.write(f"v {v[0]:f} {v[1]:f} {v[2]:f}\n")
        for t in triangles:
            f.write(f"f {t[0] + 1} {t[1] + 1} {t[2] + 1}\n")


def save_stl(vertices: np.ndarray, triangles: np.ndarray, path: str) -> None:
    """A binary STL (the fork exports STL through trimesh,
    eval/eval.py:106-108)."""
    tris = np.asarray(triangles, dtype=np.int64)
    verts = np.asarray(vertices, dtype=np.float32)
    v0, v1, v2 = verts[tris[:, 0]], verts[tris[:, 1]], verts[tris[:, 2]]
    n = np.cross(v1 - v0, v2 - v0)
    norm = np.linalg.norm(n, axis=-1, keepdims=True)
    n = np.where(norm > 0, n / np.maximum(norm, 1e-12), 0.0).astype(np.float32)
    rec = np.zeros(len(tris), dtype=np.dtype([("n", "<3f4"), ("v0", "<3f4"), ("v1", "<3f4"),
                                              ("v2", "<3f4"), ("attr", "<u2")]))
    rec["n"], rec["v0"], rec["v1"], rec["v2"] = n, v0, v1, v2
    with open(path, "wb") as f:
        f.write(b"\0" * 80)
        f.write(struct.pack("<I", len(tris)))
        f.write(rec.tobytes())
