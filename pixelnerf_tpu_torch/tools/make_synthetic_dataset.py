"""Offline synthetic dataset generator (dependency-free, four layouts).

Capability counterpart of the reference's Blender/VTK dataset generators —
the renderer-independent pose math and metadata writers live in
`pixelnerf_tpu_torch.tools.camera_gen`; this tool drives them with a tiny numpy
ray tracer (analytically shaded spheres) instead of Blender/VTK (neither is a
dependency of this package; bpy would plug in as the same
render-callback shape).

Layouts (--format):
* ``srn`` (default) — per-object dirs with intrinsics.txt (SRN 4-line
  format, Blender_cli.py:79-101), rgb/*.png, pose/*.txt c2w matrices,
  optional near_far.txt (Blender_cli.py:104-111), 8:1:1 split by index
  mod 10 (Blender_cli.py:219-221), Fibonacci-sphere cameras
  (Blender_cli.py:204-215). Loadable by data/srn.py (formats srn/pollen).
* ``multi_obj`` — NeRF-synthetic: <stage>/<obj>/view_###_obj.png (RGBA)
  + transforms.json with camera_angle_x (render_shapenet.py:503-522);
  hemisphere train views + Archimedes-spiral val/test views
  (render_shapenet.py:492-501). Loadable by data/multi_obj.py.
* ``dvr`` — NMR-ShapeNet: <cat>/<obj>/{image/,mask/,cameras.npz} +
  softras_<stage>.lst split lists (DVRDataset.py:44-62,182-202); same
  hemisphere/spiral camera distributions. Loadable by data/dvr.py
  (formats dvr / sn64-style configs).
* ``dtu`` — DTU layout: scan<N>/{image/,mask/,cameras.npz} with
  world_mat P = K[R|t] projection matrices + new_<stage>.lst lists
  (DVRDataset.py dtu branch: cv2/RQ decomposition, diag(1,-1,-1,1)
  conjugation). Loadable by data/dvr.py format dvr_dtu.

Run:
    python -m pixelnerf_tpu_torch.tools.make_synthetic_dataset --out /tmp/synth \
        --name shapes --format dvr --n_objs 50 --n_views 24 --size 64
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from pixelnerf_tpu_torch.tools.camera_gen import (
    archimedes_spiral_poses,
    fibonacci_sphere,
    hemisphere_poses,
    write_dtu_cameras,
    write_dvr_cameras,
    write_srn_intrinsics,
    write_transforms_json,
)
from pixelnerf_tpu_torch.utils.cameras import look_at

# format-canonical camera radii: srn matches the pollen generator; dvr and
# multi_obj sit mid-way in their loaders' fixed z ranges (dvr.py z 1.2-4.0,
# multi_obj.py z 4-9)
_RADIUS = {"srn": 1.3, "dvr": 2.6, "multi_obj": 6.5, "dtu": 2.5}
# scene radius (sphere centers + radii) scales with the camera distance
_SCENE_SCALE = {"srn": 1.0, "dvr": 2.0, "multi_obj": 4.0, "dtu": 2.0}


def render_scene(
    pose, focal, size, spheres, background=1.0, table=None, room=None
):
    """Minimal numpy ray tracer: lambertian spheres on a constant background,
    optionally above a finite checkerboard tabletop inside a textured room.

    :param background background gray level in [0, 1] (1.0 = white; black
        suits renderer configs with white_bkgd=False, e.g. the DTU regime,
        whose reference data are photos composited over their own scene —
        a white-bg dataset under a black-compositing renderer trains
        toward "white fog" instead of carving the object)
    :param table (y0, half_extent) checkerboard ground plane at y = y0,
        |x|,|z| <= half_extent
    :param room radius of an enclosing textured sphere viewed from inside
        (cameras must sit within it). Together with the table this gives
        every ray a finite-depth textured termination, like a photograph:
        under white_bkgd=False compositing a mostly-empty constant
        background collapses the density field — the black-sky pixels'
        "zero density everywhere" pull relu-kills sigma within ~20 steps
        (observed r3, both white and black empty backgrounds) before the
        object can form. Real DTU photos never have empty pixels; neither
        should DTU-layout synthetic data.
    :return (rgb (H,W,3) uint8, alpha (H,W) uint8 OBJECT hit mask — table
        and room are scene background, not object)
    """
    H = W = size
    c = size / 2.0
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    dirs = np.stack(
        [(xs - c) / focal, -(ys - c) / focal, -np.ones_like(xs)], axis=-1
    )
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    dirs = dirs @ pose[:3, :3].T
    origin = pose[:3, 3]

    img = np.full((H, W, 3), float(background), dtype=np.float32)
    depth = np.full((H, W), np.inf, dtype=np.float32)
    obj_depth = np.full((H, W), np.inf, dtype=np.float32)
    light = np.array([0.4, 0.8, 0.45])
    light = light / np.linalg.norm(light)

    if room is not None:
        # inside view of a sphere centered at the origin: far root
        b = np.einsum("hwc,c->hw", dirs, origin)
        disc = b * b - (origin @ origin - room * room)
        t = -b + np.sqrt(np.maximum(disc, 0.0))
        pt = origin + t[..., None] * dirs
        u = np.arctan2(pt[..., 2], pt[..., 0])
        v = np.arccos(np.clip(pt[..., 1] / room, -1.0, 1.0))
        checker = (np.floor(u / 0.45) + np.floor(v / 0.45)).astype(
            np.int64
        ) % 2
        # scene mean must sit ABOVE the init-time render (~0.5 gray):
        # under white_bkgd=False the first gradient otherwise pushes sigma
        # DOWN toward the darker target, and every sample whose pre-relu
        # crosses zero freezes (relu grad 0) — a one-way ratchet that
        # blacked out the field within ~30 steps in two r3 runs. Bright
        # scenes make the initial pressure "more density", which is the
        # same asymmetry that keeps white_bkgd=True configs healthy.
        tone = np.where(checker > 0, 0.82, 0.6)[..., None]
        wall_rgb = tone * np.array([0.8, 0.88, 1.0])
        img = np.where(t[..., None] > 0, wall_rgb, img)
        depth = np.where(t > 0, t, depth)

    if table is not None:
        y0, half = table
        dy = dirs[..., 1]
        with np.errstate(divide="ignore", invalid="ignore"):
            t = (y0 - origin[1]) / dy
        pt = origin + t[..., None] * dirs
        hit = (
            (np.abs(dy) > 1e-6)
            & (t > 0)
            & (np.abs(pt[..., 0]) <= half)
            & (np.abs(pt[..., 2]) <= half)
        )
        checker = (
            np.floor(pt[..., 0] / (0.25 * half))
            + np.floor(pt[..., 2] / (0.25 * half))
        ).astype(np.int64) % 2
        tone = np.where(checker > 0, 0.88, 0.62)[..., None]
        table_rgb = tone * np.array([1.0, 0.94, 0.82])
        img = np.where(hit[..., None], table_rgb, img)
        depth = np.where(hit, t, depth)

    for center, radius, color in spheres:
        oc = origin - center
        b = np.einsum("hwc,c->hw", dirs, oc)
        disc = b * b - (oc @ oc - radius * radius)
        hit = disc > 0
        t = -b - np.sqrt(np.maximum(disc, 0))
        hit &= (t > 0) & (t < depth)
        pt = origin + t[..., None] * dirs
        normal = (pt - center) / radius
        shade = np.clip(np.einsum("hwc,c->hw", normal, light), 0.1, 1.0)
        img = np.where(hit[..., None], color[None, None] * shade[..., None], img)
        depth = np.where(hit, t, depth)
        obj_depth = np.where(hit, t, obj_depth)
    rgb = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    alpha = (np.isfinite(obj_depth) * 255).astype(np.uint8)
    return rgb, alpha


def sample_spheres(rng, scale=1.0):
    """Random compound object: 2-4 lambertian spheres within `0.55 * scale`."""
    n_spheres = int(rng.integers(2, 5))
    spheres = []
    for _ in range(n_spheres):
        spheres.append(
            (
                rng.uniform(-0.25 * scale, 0.25 * scale, 3).astype(np.float32),
                float(rng.uniform(0.12 * scale, 0.3 * scale)),
                rng.uniform(0.15, 0.95, 3).astype(np.float32),
            )
        )
    return spheres


def _poses_for_split(split, n_views, radius, rng):
    """Train: binned hemisphere; val/test: Archimedes spiral
    (reference render_shapenet.py:492-501)."""
    if split == "train":
        return hemisphere_poses(n_views, radius, rng)
    return archimedes_spiral_poses(n_views, radius)


def main(argv=None):
    from pixelnerf_tpu_torch.utils.visualize import write_png

    parser = argparse.ArgumentParser()
    parser.add_argument("--out", type=str, required=True)
    parser.add_argument("--name", type=str, default="shapes")
    parser.add_argument(
        "--format", choices=("srn", "multi_obj", "dvr", "dtu"), default="srn"
    )
    parser.add_argument("--n_objs", type=int, default=10)
    parser.add_argument("--n_views", type=int, default=50)
    parser.add_argument("--size", type=int, default=128)
    parser.add_argument("--radius", type=float, default=None)
    parser.add_argument("--z_near", type=float, default=0.8)
    parser.add_argument("--z_far", type=float, default=1.8)
    parser.add_argument("--near_far", action="store_true")
    parser.add_argument(
        "--table", choices=["auto", "on", "off"], default="auto",
        help="checkerboard tabletop under the object (auto: on for the "
        "dtu format — see render_scene)",
    )
    parser.add_argument(
        "--background", type=float, default=1.0,
        help="background gray level in [0,1]; use 0 for white_bkgd=False "
        "renderer configs (DTU)",
    )
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    rng = np.random.default_rng(args.seed)
    scale = _SCENE_SCALE[args.format]
    radius = args.radius if args.radius is not None else _RADIUS[args.format]
    if args.format == "srn":
        focal = float(args.size)
    else:
        # fit the scene (radius 0.55*scale) in frame with ~20% margin
        scene_r = 0.55 * scale
        focal = (args.size / 2.0) * (radius - scene_r) / (1.2 * scene_r)
    datadir = os.path.join(args.out, args.name)
    stage = ("train",) * 8 + ("val", "test")
    dvr_splits = {"train": [], "val": [], "test": []}

    for obj in range(args.n_objs):
        # 8:1:1 split by index (Blender_cli.py:219-221)
        split = stage[obj % 10]
        spheres = sample_spheres(rng, scale)
        dtu_like = args.table == "on" or (
            args.table == "auto" and args.format == "dtu"
        )
        table = (-0.6 * scale, 0.8 * scale) if dtu_like else None
        # room wall just beyond the camera shell; see render_scene
        room = 1.25 * radius if dtu_like else None

        if args.format == "srn":
            obj_dir = os.path.join(
                datadir, f"{args.name}_{split}", f"obj{obj:04d}"
            )
            os.makedirs(os.path.join(obj_dir, "rgb"), exist_ok=True)
            os.makedirs(os.path.join(obj_dir, "pose"), exist_ok=True)
            write_srn_intrinsics(obj_dir, focal, args.size)
            if args.near_far:
                with open(os.path.join(obj_dir, "near_far.txt"), "w") as f:
                    f.write(f"{args.z_near} {args.z_far}\n")
            positions = fibonacci_sphere(args.n_views, radius)
            for v, origin in enumerate(positions):
                pose = look_at(origin, np.zeros(3))
                img, _ = render_scene(
                    pose, focal, args.size, spheres, args.background,
                    table, room,
                )
                write_png(
                    os.path.join(obj_dir, "rgb", f"{v:06d}.png"), img
                )
                # SRN pose files store c2w PRE-flipped by diag(1,-1,-1,1)
                # (reference Blender_cli.py:224-227) so the loader's flip
                # (SRNDataset.py:56-58,97) restores the OpenGL pose the
                # image was rendered with
                np.savetxt(
                    os.path.join(obj_dir, "pose", f"{v:06d}.txt"),
                    (pose @ np.diag([1.0, -1.0, -1.0, 1.0])).reshape(1, 16),
                )

        elif args.format == "multi_obj":
            obj_dir = os.path.join(datadir, split, f"obj{obj:04d}")
            os.makedirs(obj_dir, exist_ok=True)
            poses = _poses_for_split(split, args.n_views, radius, rng)
            file_paths = []
            for v, pose in enumerate(poses):
                img, alpha = render_scene(
                    pose, focal, args.size, spheres, args.background,
                    table, room,
                )
                rgba = np.concatenate(
                    [
                        # zero RGB where transparent: loaders derive the
                        # bbox from any-nonzero pixels (multi_obj.py:77-90)
                        np.where(alpha[..., None] > 0, img, 0).astype(np.uint8),
                        alpha[..., None],
                    ],
                    axis=-1,
                )
                name = f"view_{v:03d}"
                write_png(
                    os.path.join(obj_dir, name + "_obj.png"), rgba
                )
                file_paths.append(name)
            camera_angle_x = 2.0 * np.arctan(args.size / (2.0 * focal))
            write_transforms_json(
                obj_dir, poses, camera_angle_x, file_paths,
                model_ids=[f"obj{obj:04d}"],
            )

        else:  # dvr (NMR-ShapeNet) or dtu — same dir layout, different
            # cameras.npz convention and split-list prefix
            obj_name = (
                f"scan{obj:d}" if args.format == "dtu" else f"obj{obj:04d}"
            )
            obj_dir = os.path.join(datadir, "synth", obj_name)
            os.makedirs(os.path.join(obj_dir, "image"), exist_ok=True)
            os.makedirs(os.path.join(obj_dir, "mask"), exist_ok=True)
            poses = _poses_for_split(split, args.n_views, radius, rng)
            for v, pose in enumerate(poses):
                img, alpha = render_scene(
                    pose, focal, args.size, spheres, args.background,
                    table, room,
                )
                write_png(
                    os.path.join(obj_dir, "image", f"{v:04d}.png"), img
                )
                write_png(
                    os.path.join(obj_dir, "mask", f"{v:04d}.png"), alpha
                )
            if args.format == "dtu":
                write_dtu_cameras(obj_dir, poses, focal, args.size)
            else:
                write_dvr_cameras(obj_dir, poses, focal, args.size)
            dvr_splits[split].append(obj_name)

        print(f"obj {obj} ({split}): {args.n_views} views")

    if args.format in ("dvr", "dtu"):
        # dvr_dtu's factory flags select list_prefix="new_" (data/__init__.py)
        prefix = "new_" if args.format == "dtu" else "softras_"
        cat_dir = os.path.join(datadir, "synth")
        for split, names in dvr_splits.items():
            with open(
                os.path.join(cat_dir, f"{prefix}{split}.lst"), "w"
            ) as f:
                f.write("\n".join(names) + ("\n" if names else ""))
    print("Wrote dataset to", datadir)


if __name__ == "__main__":
    main()
