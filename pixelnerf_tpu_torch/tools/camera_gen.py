"""Offline dataset-generator camera sampling + metadata writers.

Ports the renderer-independent ~60% of the reference's Blender/VTK dataset
generators — the pose math and metadata formats — behind a plain-numpy
interface so any renderer callback (Blender's bpy where available, the
analytic tracer of make_synthetic_dataset here) can drive them:

* `hemisphere_poses` / `archimedes_spiral_poses`: the train / val-test
  camera distributions of scripts/render_shapenet.py:492-501 (binned
  hemisphere yaw sweep with bounded pitch noise; Archimedes spiral
  "introduced by SRN" for eval).
* `fibonacci_sphere`: Blender_cli.py:204-215 (the pollen generator's
  even sphere covering).
* `write_transforms_json`: the NeRF-synthetic metadata writer of
  render_shapenet.py:517-522 (frames with `transform_matrix` +
  `file_path`, `camera_angle_x`, `model_ids`), loadable by
  data/multi_obj.py.
* `write_dvr_cameras`: cameras.npz in the NMR-ShapeNet convention that
  data/dvr.py (reference DVRDataset.py:182-202) decodes — world_mat_inv_i
  extrinsics + camera_mat_i NDC intrinsics — inverted through the
  loader's fixed world/camera coordinate transforms so a desired OpenGL
  c2w round-trips exactly.
* `write_srn_intrinsics`: the 4-line SRN intrinsics.txt format
  (Blender_cli.py:79-101).
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence

import numpy as np

from pixelnerf_tpu_torch.utils.cameras import look_at

__all__ = [
    "fibonacci_sphere",
    "hemisphere_poses",
    "archimedes_spiral_poses",
    "write_transforms_json",
    "write_dvr_cameras",
    "write_dtu_cameras",
    "write_srn_intrinsics",
]


def fibonacci_sphere(n: int, radius: float) -> np.ndarray:
    """Evenly distributed sphere positions (reference Blender_cli.py:204-215)."""
    pts = []
    phi = np.pi * (3.0 - np.sqrt(5.0))
    for i in range(n):
        y = 1 - (i / float(n - 1)) * 2
        r = np.sqrt(max(1 - y * y, 0.0))
        theta = phi * i
        pts.append((np.cos(theta) * r, y, np.sin(theta) * r))
    return np.asarray(pts, dtype=np.float32) * radius


def _spherical_position(yaw: float, pitch: float, radius: float) -> np.ndarray:
    """Camera position for the Blender track-to construction: start on the
    +up axis at `radius`, tilt toward the equator by `pitch`, spin by `yaw`
    (render_shapenet.py rotates the tracking empty by euler (pitch, 0, yaw)
    with the camera at local +Z * dist). Up axis is y (standard coords)."""
    cy, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    # pitch 0 -> overhead; pitch 90deg -> equator
    v = np.array([sp * cy, cp, sp * sy], dtype=np.float32)
    return v * radius


def hemisphere_poses(
    n_views: int,
    radius: float,
    rng: np.random.Generator,
    pitch_range=(0.0, np.deg2rad(80)),
    target=(0.0, 0.0, 0.0),
) -> np.ndarray:
    """Training-view distribution (reference render_shapenet.py:492-497):
    binned uniform yaws around the hemisphere (3 revolutions: 6*pi*i/n)
    with bounded random yaw noise U(0, pi/n), pitch drawn uniformly from
    `pitch_range`. Returns (n, 4, 4) OpenGL camera-to-world matrices
    looking at `target`.
    """
    yaws = 6 * np.pi * np.arange(n_views) / n_views
    yaws = yaws + rng.uniform(0, np.pi / n_views, size=(n_views,))
    pitches = rng.uniform(pitch_range[0], pitch_range[1], size=(n_views,))
    target = np.asarray(target, dtype=np.float32)
    return np.stack(
        [
            look_at(_spherical_position(y, p, radius) + target, target)
            for y, p in zip(yaws, pitches)
        ]
    )


def archimedes_spiral_poses(
    n_views: int,
    radius: float,
    pitch_range=(0.0, np.deg2rad(80)),
    target=(0.0, 0.0, 0.0),
) -> np.ndarray:
    """Val/test-view distribution (reference render_shapenet.py:498-501):
    the SRN Archimedes spiral — pitch sweeps `pitch_range` linearly while
    the yaw makes 3 revolutions (6*pi*i/n). Returns (n, 4, 4) OpenGL c2w.
    """
    yaws = 6 * np.pi * np.arange(n_views) / n_views
    pitches = (
        np.arange(n_views) / n_views * (pitch_range[1] - pitch_range[0])
        + pitch_range[0]
    )
    target = np.asarray(target, dtype=np.float32)
    return np.stack(
        [
            look_at(_spherical_position(y, p, radius) + target, target)
            for y, p in zip(yaws, pitches)
        ]
    )


def write_transforms_json(
    out_dir: str,
    poses: np.ndarray,
    camera_angle_x: float,
    file_paths: Sequence[str],
    model_ids: Optional[Sequence[str]] = None,
) -> str:
    """NeRF-synthetic transforms.json (reference render_shapenet.py:503-522):
    one frame per view with the c2w `transform_matrix` and the image
    `file_path` (extension stripped by loaders). Returns the written path.
    """
    frames = [
        {"transform_matrix": np.asarray(p, dtype=float).tolist(), "file_path": fp}
        for p, fp in zip(poses, file_paths)
    ]
    data = {
        "frames": frames,
        "model_ids": list(model_ids) if model_ids is not None else [],
        "camera_angle_x": float(camera_angle_x),
    }
    path = os.path.join(out_dir, "transforms.json")
    with open(path, "w") as f:
        json.dump(data, f, indent=1, separators=(",", ":"))
    return path


# data/dvr.py applies pose = TRANS_WORLD @ world_mat_inv @ TRANS_CAM
# (reference DVRDataset.py:80-97,182-218); write the inverse-transformed
# extrinsics so the loader recovers exactly the OpenGL c2w we rendered with.
_TRANS_WORLD_SHAPENET = np.array(
    [[1, 0, 0, 0], [0, 0, -1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], dtype=np.float64
)
_TRANS_CAM_SHAPENET = np.diag([1.0, -1.0, -1.0, 1.0])


def write_dvr_cameras(
    obj_dir: str, poses: np.ndarray, focal_px: float, size: int
) -> str:
    """cameras.npz in the NMR-ShapeNet layout (reference DVRDataset.py:182-202):
    `world_mat_inv_i` (plus consistent `world_mat_i`) and `camera_mat_i`
    with fx == fy in NDC units (focal is rescaled by W/2 at load time under
    scale_focal). `poses` are OpenGL c2w; `focal_px` in pixels for a
    `size`-wide image.
    """
    fx_ndc = focal_px / (size / 2.0)
    cams = {}
    K = np.diag([fx_ndc, fx_ndc, 1.0, 1.0])
    tw_inv = np.linalg.inv(_TRANS_WORLD_SHAPENET)
    tc_inv = np.linalg.inv(_TRANS_CAM_SHAPENET)
    for i, pose in enumerate(np.asarray(poses, dtype=np.float64)):
        wmat_inv = tw_inv @ pose @ tc_inv
        cams[f"world_mat_inv_{i}"] = wmat_inv.astype(np.float32)
        cams[f"world_mat_{i}"] = np.linalg.inv(wmat_inv).astype(np.float32)
        cams[f"camera_mat_{i}"] = K.astype(np.float32)
    path = os.path.join(obj_dir, "cameras.npz")
    np.savez(path, **cams)
    return path


def write_dtu_cameras(
    obj_dir: str, poses: np.ndarray, focal_px: float, size: int
) -> str:
    """cameras.npz in the DTU layout: `world_mat_i` is the full 4x4
    projection P = K @ [R | t] in PIXEL units (reference DVRDataset.py
    dtu branch decomposes it with cv2.decomposeProjectionMatrix at
    :157-171). Derivation inverts the loader exactly: it builds
    pose_dec = [R^T | center] from the decomposition and returns
    T @ pose_dec @ T with T = diag(1,-1,-1,1), so for OpenGL c2w `poses`
    we write P from pose_dec = T @ pose @ T. No scale_mat (identity
    normalization)."""
    T = np.diag([1.0, -1.0, -1.0, 1.0])
    K = np.array(
        [
            [focal_px, 0.0, size / 2.0],
            [0.0, focal_px, size / 2.0],
            [0.0, 0.0, 1.0],
        ]
    )
    cams = {}
    for i, pose in enumerate(np.asarray(poses, dtype=np.float64)):
        pose_dec = T @ pose @ T
        R = pose_dec[:3, :3].T  # world->cam rotation
        center = pose_dec[:3, 3]
        w2c = np.concatenate([R, -(R @ center)[:, None]], axis=1)  # (3,4)
        P = np.eye(4)
        P[:3] = K @ w2c
        cams[f"world_mat_{i}"] = P.astype(np.float32)
    path = os.path.join(obj_dir, "cameras.npz")
    np.savez(path, **cams)
    return path


def write_srn_intrinsics(
    obj_dir: str, focal: float, size: int, cx: Optional[float] = None,
    cy: Optional[float] = None,
) -> str:
    """4-line SRN intrinsics.txt (reference Blender_cli.py:79-101)."""
    cx = size / 2.0 if cx is None else cx
    cy = size / 2.0 if cy is None else cy
    path = os.path.join(obj_dir, "intrinsics.txt")
    with open(path, "w") as f:
        f.write(f"{focal} {cx} {cy} 0.\n0. 0. 0.\n1.\n{size} {size}\n")
    return path
