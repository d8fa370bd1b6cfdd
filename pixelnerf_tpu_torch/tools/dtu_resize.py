"""DTU 4x downscale preprocessing (images + cameras).

Re-implements the reference's rs_dtu_4/ tools (resize_cams.py, resize_imgs.py,
check_same.py): scales cameras.npz intrinsics and P-matrix rows for a factor-S
downscale, regenerates the *_inv entries, area-resizes images/masks, and can
verify two camera archives match.

Run:
    python -m pixelnerf_tpu_torch.tools.dtu_resize --data_dir /data/rs_dtu_4 --scale 4
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np


def resize_cameras(cam_path: str, scale_fact: int) -> None:
    """Scale camera_mat intrinsics up and world_mat (P) rows down by S,
    then refresh inverse entries (reference rs_dtu_4/resize_cams.py:20-51)."""
    z = dict(np.load(cam_path))
    for k in z:
        if k.startswith("camera_mat_inv_") or k.startswith("world_mat_inv_"):
            continue
        if k.startswith("camera_mat_"):
            z[k][:3, :3] = z[k][:3, :3] * scale_fact
        elif k.startswith("world_mat_"):
            z[k][:2] = z[k][:2] / scale_fact
    for k in list(z):
        if k.startswith("camera_mat_inv_"):
            z[k] = np.linalg.inv(z["camera_mat_" + k[k.rindex("_") + 1 :]])
        elif k.startswith("world_mat_inv_"):
            z[k] = np.linalg.inv(z["world_mat_" + k[k.rindex("_") + 1 :]])
    np.savez(cam_path, **z)


def resize_images(obj_dir: str, scale_fact: int) -> int:
    """Area-downscale image/ and mask/ contents in place."""
    from pixelnerf_tpu_torch.utils.visualize import read_image, write_png

    from pixelnerf_tpu_torch.data.common import resize_area_np

    n = 0
    for sub in ("image", "mask"):
        for p in sorted(glob.glob(os.path.join(obj_dir, sub, "*"))):
            if not p.lower().endswith((".png", ".jpg")):
                continue
            img = np.asarray(read_image(p))
            squeeze = img.ndim == 2
            if squeeze:
                img = img[..., None]
            Ho, Wo = img.shape[0] // scale_fact, img.shape[1] // scale_fact
            out = resize_area_np(img[None].astype(np.float32), (Ho, Wo))[0]
            out = np.clip(out, 0, 255).astype(img.dtype)
            if squeeze:
                out = out[..., 0]
            write_png(p, out)
            n += 1
    return n


def check_same(path_a: str, path_b: str, atol: float = 1e-5) -> bool:
    """Assert two cameras.npz archives are equal
    (reference rs_dtu_4/check_same.py:12-17)."""
    za, zb = dict(np.load(path_a)), dict(np.load(path_b))
    if set(za) != set(zb):
        return False
    return all(np.allclose(za[k], zb[k], atol=atol) for k in za)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_dir", type=str, required=True)
    parser.add_argument("--scale", type=int, default=4)
    parser.add_argument(
        "--cams_only", action="store_true", help="Skip image resizing"
    )
    args = parser.parse_args(argv)

    obj_dirs = [
        d
        for d in sorted(glob.glob(os.path.join(args.data_dir, "*")))
        if os.path.isdir(d)
    ]
    for obj_dir in obj_dirs:
        cam_path = os.path.join(obj_dir, "cameras.npz")
        if not os.path.exists(cam_path):
            continue
        resize_cameras(cam_path, args.scale)
        if not args.cams_only:
            n = resize_images(obj_dir, args.scale)
            print(f"{obj_dir}: cameras + {n} images rescaled by 1/{args.scale}")
        else:
            print(f"{obj_dir}: cameras rescaled by 1/{args.scale}")


if __name__ == "__main__":
    main()
