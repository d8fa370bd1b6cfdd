"""Camera pose utilities (host-side numpy).

A copy of `pixelnerf_tpu/utils/cameras.py`, which imports no JAX (the port
keeps its own copy of what it needs): the camera math of the reference's
src/util/util.py (coord transforms 146-171, look_at 174-190, spherical
orbit poses 279-323, quaternion conversions 484-528) with the same
conventions: standard coordinate system is x-right, y-up, z-out (towards
viewer); poses are 4x4 camera-to-world matrices.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "coord_from_blender",
    "coord_to_blender",
    "look_at",
    "pose_spherical",
    "quat_to_rot",
    "rot_to_quat",
    "invert_pose",
]


def coord_from_blender(dtype=np.float32) -> np.ndarray:
    """Blender (x-right y-in z-up) -> standard (x-right y-up z-out).

    Reference: src/util/util.py:146-157.
    """
    return np.array(
        [[1, 0, 0, 0], [0, 0, 1, 0], [0, -1, 0, 0], [0, 0, 0, 1]], dtype=dtype
    )


def coord_to_blender(dtype=np.float32) -> np.ndarray:
    """Standard -> Blender coordinate transform. Reference: util.py:160-171."""
    return np.array(
        [[1, 0, 0, 0], [0, 0, -1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], dtype=dtype
    )


def look_at(origin, target, world_up=None) -> np.ndarray:
    """Camera-to-world matrix for a camera at `origin` looking at `target`.

    Reference: src/util/util.py:174-190 (same right/up/back construction).
    """
    origin = np.asarray(origin, dtype=np.float32)
    target = np.asarray(target, dtype=np.float32)
    if world_up is None:
        world_up = np.array([0, 1, 0], dtype=np.float32)
    back = origin - target
    back = back / np.linalg.norm(back)
    if abs(float(np.dot(world_up, back))) > 1.0 - 1e-6:
        # camera directly above/below target: fall back to z-up
        world_up = np.array([0, 0, 1], dtype=np.float32)
    right = np.cross(world_up, back)
    right = right / np.linalg.norm(right)
    up = np.cross(back, right)

    cam_to_world = np.empty((4, 4), dtype=np.float32)
    cam_to_world[:3, 0] = right
    cam_to_world[:3, 1] = up
    cam_to_world[:3, 2] = back
    cam_to_world[:3, 3] = origin
    cam_to_world[3, :] = [0, 0, 0, 1]
    return cam_to_world


def _trans_t(t: float) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[2, 3] = t
    return m


def _rot_phi(phi: float) -> np.ndarray:
    c, s = np.cos(phi), np.sin(phi)
    return np.array(
        [[1, 0, 0, 0], [0, c, -s, 0], [0, s, c, 0], [0, 0, 0, 1]], dtype=np.float32
    )


def _rot_theta(th: float) -> np.ndarray:
    c, s = np.cos(th), np.sin(th)
    return np.array(
        [[c, 0, -s, 0], [0, 1, 0, 0], [s, 0, c, 0], [0, 0, 0, 1]], dtype=np.float32
    )


def pose_spherical(theta: float, phi: float, radius: float) -> np.ndarray:
    """NeRF-style spherical orbit pose (degrees). Reference: util.py:309-323."""
    c2w = _trans_t(radius)
    c2w = _rot_phi(phi / 180.0 * np.pi) @ c2w
    c2w = _rot_theta(theta / 180.0 * np.pi) @ c2w
    flip = np.array(
        [[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], dtype=np.float32
    )
    return flip @ c2w


def quat_to_rot(q: np.ndarray) -> np.ndarray:
    """Batched quaternion (wxyz) -> rotation matrix. Reference: util.py:484-504."""
    q = np.asarray(q, dtype=np.float64)
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    qr, qi, qj, qk = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = np.empty(q.shape[:-1] + (3, 3), dtype=np.float64)
    R[..., 0, 0] = 1 - 2 * (qj**2 + qk**2)
    R[..., 0, 1] = 2 * (qj * qi - qk * qr)
    R[..., 0, 2] = 2 * (qi * qk + qr * qj)
    R[..., 1, 0] = 2 * (qj * qi + qk * qr)
    R[..., 1, 1] = 1 - 2 * (qi**2 + qk**2)
    R[..., 1, 2] = 2 * (qj * qk - qi * qr)
    R[..., 2, 0] = 2 * (qk * qi - qj * qr)
    R[..., 2, 1] = 2 * (qj * qk + qi * qr)
    R[..., 2, 2] = 1 - 2 * (qi**2 + qj**2)
    return R.astype(np.float32)


def rot_to_quat(R: np.ndarray) -> np.ndarray:
    """Batched rotation matrix -> quaternion (wxyz). Reference: util.py:507-528."""
    R = np.asarray(R, dtype=np.float64)
    q = np.empty(R.shape[:-2] + (4,), dtype=np.float64)
    q[..., 0] = np.sqrt(np.maximum(1.0 + R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2], 0)) / 2
    q[..., 1] = (R[..., 2, 1] - R[..., 1, 2]) / (4 * q[..., 0])
    q[..., 2] = (R[..., 0, 2] - R[..., 2, 0]) / (4 * q[..., 0])
    q[..., 3] = (R[..., 1, 0] - R[..., 0, 1]) / (4 * q[..., 0])
    return q.astype(np.float32)


def invert_pose(pose: np.ndarray) -> np.ndarray:
    """Invert a rigid 4x4 camera-to-world matrix -> world-to-camera."""
    R = pose[..., :3, :3]
    t = pose[..., :3, 3:]
    Rt = np.swapaxes(R, -1, -2)
    out = np.zeros_like(pose)
    out[..., :3, :3] = Rt
    out[..., :3, 3:] = -Rt @ t
    out[..., 3, 3] = 1.0
    return out
