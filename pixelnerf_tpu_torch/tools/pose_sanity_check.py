"""Camera-pose sanity checker + check2-class camera diagnostics.

Re-implements the fork's pose_sanit_check.py: loads a dataset split, checks
every sampled pose is a valid SE(3) matrix (orthonormal R, det=+1, bottom
row [0,0,0,1]), round-trips the camera center through the world-to-camera
transform, and optionally plots the camera rig (matplotlib, saved to file —
no display assumed).

`--diagnostics` adds the fork's check2.py battery (reference
check2.py:57-118): per-view forward·to-origin alignment dots, camera
z-range, closest-camera-pair distance (duplicate rig check), field of view
from the intrinsics, per-view mean RGB intensity, and the dataset's
near/far bounds; the rig plot gains view-direction quivers.

Run:
    python -m pixelnerf_tpu_torch.tools.pose_sanity_check --datadir /data/pollen \
        -F srn --num_objects 3 --plot rig.png --diagnostics
"""

from __future__ import annotations

import argparse

import numpy as np


def compute_camera_center(M: np.ndarray) -> np.ndarray:
    """Camera center C from world-to-camera M: C = -R^T t
    (reference pose_sanit_check.py:15-19)."""
    R = M[:3, :3]
    t = M[:3, 3]
    return -R.T @ t


def is_valid_pose_matrix(M: np.ndarray):
    """(orthonormal?, bottom row ok?, det) — reference :28-36."""
    R = M[:3, :3]
    det_R = float(np.linalg.det(R))
    is_orthonormal = np.allclose(R.T @ R, np.eye(3), atol=1e-4)
    is_bottom_ok = np.allclose(M[3, :], [0, 0, 0, 1], atol=1e-5)
    return is_orthonormal, is_bottom_ok, det_R


def check_poses(poses: np.ndarray, c2w: bool = True, verbose: bool = True):
    """Validate a (V, 4, 4) pose stack; returns number of failures."""
    failures = 0
    for j, M in enumerate(poses):
        ortho, bottom, det = is_valid_pose_matrix(M)
        ok = ortho and bottom and det > 0.99
        if verbose:
            center = M[:3, 3] if c2w else compute_camera_center(M)
            print(
                f"  view {j}: ortho={ortho} bottom={bottom} det={det:.5f} "
                f"center={np.round(center, 4)}"
            )
        if not ok:
            failures += 1
        if not c2w:
            # M @ [C;1] must land at the origin
            C = compute_camera_center(M)
            origin = M @ np.concatenate([C, [1.0]])
            if not np.allclose(origin[:3], 0, atol=1e-4):
                failures += 1
    return failures


def camera_diagnostics(item: dict, num_views: int = 0) -> dict:
    """check2-class diagnostics over one dataset object dict.

    Reference check2.py:57-118: view-direction alignment (forward = -Z
    column of the c2w rotation, dotted with the unit vector toward the
    origin), camera z-range, closest camera pair, FOV from focal, and
    per-view mean RGB of the [0,1]-scaled images.
    """
    poses = np.asarray(item["poses"], dtype=np.float64)
    K = poses.shape[0] if num_views <= 0 else min(num_views, poses.shape[0])
    poses = poses[:K]
    centers = poses[:, :3, 3]

    forwards = -poses[:, :3, 2]  # camera looks down -Z (check2.py:59)
    to_origin = -centers
    norms = np.linalg.norm(to_origin, axis=-1, keepdims=True)
    norms = np.where(norms == 0, 1.0, norms)
    align = np.einsum("vi,vi->v", forwards, to_origin / norms)

    # closest camera pair without scipy.pdist (check2.py:91-93)
    d2 = np.sum((centers[:, None] - centers[None]) ** 2, axis=-1)
    np.fill_diagonal(d2, np.inf)
    min_dist = float(np.sqrt(d2.min())) if K > 1 else float("inf")

    images = np.asarray(item["images"])  # (V, H, W, 3) in [-1, 1]
    H, W = images.shape[1:3]
    focal = float(np.asarray(item["focal"]).reshape(-1)[0])
    fov_deg = float(2 * np.arctan(W / (2 * focal)) * 180 / np.pi)
    mean_rgb = (images[:K] * 0.5 + 0.5).mean(axis=(1, 2, 3))

    return {
        "alignment": align,
        "z_range": (float(centers[:, 2].min()), float(centers[:, 2].max())),
        "min_camera_dist": min_dist,
        "fov_deg": fov_deg,
        "mean_rgb": mean_rgb,
        "forwards": forwards,
        "centers": centers,
    }


def main(argv=None):
    from pixelnerf_tpu_torch.data import get_split_dataset

    parser = argparse.ArgumentParser()
    parser.add_argument("--datadir", type=str, required=True)
    parser.add_argument("--dataset_format", "-F", type=str, default="srn")
    parser.add_argument("--stage", type=str, default="train")
    parser.add_argument("--num_objects", type=int, default=5)
    parser.add_argument("--num_views", type=int, default=10)
    parser.add_argument("--plot", type=str, default="", help="Output PNG path")
    parser.add_argument(
        "--diagnostics", action="store_true",
        help="check2-class battery: alignment dots, FOV, near/far, "
        "duplicate-camera and intensity checks (reference check2.py:57-118)",
    )
    parser.add_argument(
        "--min_alignment", type=float, default=0.9,
        help="fail a view when forward.to-origin alignment drops below this",
    )
    args = parser.parse_args(argv)

    dataset = get_split_dataset(
        args.dataset_format, args.datadir, want_split=args.stage, training=False
    )
    N = min(args.num_objects, len(dataset))
    print(f"Sampling {N} objects from {len(dataset)} total.")

    centers_all = []
    forwards_all = []
    total_failures = 0
    for i in range(N):
        item = dataset[i]
        poses = np.asarray(item["poses"])
        K = min(args.num_views, poses.shape[0])
        print(f"\nObject {i} ({item['path']}): {poses.shape[0]} views, checking {K}")
        total_failures += check_poses(poses[:K])
        centers_all.append(poses[:K, :3, 3])

        if args.diagnostics:
            d = camera_diagnostics(item, K)
            forwards_all.append(d["forwards"])
            print("  === View Direction Checks (check2.py:57-66) ===")
            for j, a in enumerate(d["alignment"]):
                flag = "" if a >= args.min_alignment else "  <-- MISALIGNED"
                print(f"  [{j}] alignment (forward . to-origin): {a:.3f}{flag}")
            total_failures += int((d["alignment"] < args.min_alignment).sum())
            zmin, zmax = d["z_range"]
            print(f"  z-positions: min={zmin:.2f}, max={zmax:.2f}")
            print(f"  closest two cameras: {d['min_camera_dist']:.6f} units apart")
            if d["min_camera_dist"] < 1e-6:
                print("  WARNING: duplicate cameras")
                total_failures += 1
            print(f"  field of view: {d['fov_deg']:.2f} degrees")
            for j, m in enumerate(d["mean_rgb"]):
                print(f"  [{j}] mean RGB: {m:.3f}")

    if args.diagnostics:
        print(
            f"\nDataset z bounds: near={dataset.z_near:.3f} "
            f"far={dataset.z_far:.3f} lindisp={dataset.lindisp}"
        )

    if args.plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig = plt.figure()
        ax = fig.add_subplot(projection="3d")
        for i, centers in enumerate(centers_all):
            ax.scatter(centers[:, 0], centers[:, 1], centers[:, 2], label=f"obj{i}")
            if args.diagnostics and i < len(forwards_all):
                f = forwards_all[i]
                ax.quiver(
                    centers[:, 0], centers[:, 1], centers[:, 2],
                    f[:, 0], f[:, 1], f[:, 2],
                    length=0.3, color="k", linewidth=0.5,
                )
        ax.scatter([0], [0], [0], c="k", marker="x", s=60, label="origin")
        ax.legend()
        fig.savefig(args.plot, dpi=120)
        print("Wrote", args.plot)

    print(
        f"\n{'OK: all poses valid' if total_failures == 0 else f'FAIL: {total_failures} bad poses'}"
    )
    return total_failures


if __name__ == "__main__":
    raise SystemExit(main())
