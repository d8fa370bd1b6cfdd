"""STL mesh -> SRN/pollen dataset renderer (no Blender, no VTK).

Capability counterpart of the reference's STL-based generators:
``Blender_cli.py`` (STL import -> Fibonacci-sphere cameras ->
SRN-format pollen dataset: intrinsics.txt 4-line format
Blender_cli.py:79-101, near_far.txt :104-111, 8:1:1 split by index mod
10 :219-221, pre-flipped c2w pose files :224-227) and
``src/data/pollen_image_gen.py`` (same pipeline via VTK offscreen
rendering, pollen_image_gen.py:14-41). Neither bpy nor vtk is a
dependency of this package, so the renderer here is a small vectorized numpy ray
caster (Moller-Trumbore over pixel x triangle-chunk) with flat
Lambertian shading — the camera math, file formats, and split logic are
the reference's, and the output loads through ``data/srn.py`` with
``--dataset_format pollen`` exactly like a Blender/VTK-rendered set.

Run:
    python -m pixelnerf_tpu_torch.tools.stl_render_dataset \
        --stl meshes/*.stl --out /tmp/pollen --name pollen \
        --n_views 50 --size 128
"""

from __future__ import annotations

import argparse
import os
import struct

import numpy as np

from pixelnerf_tpu_torch.tools.camera_gen import fibonacci_sphere, write_srn_intrinsics
from pixelnerf_tpu_torch.utils.cameras import look_at


def read_stl(path):
    """Read a binary or ASCII STL into (N, 3, 3) float32 vertices.

    Normals are recomputed from winding (many STL writers emit junk
    normal records; the reference pipelines let Blender/VTK do the same).
    """
    with open(path, "rb") as f:
        head = f.read(80)
        rest = f.read()
    # An ASCII STL starts with 'solid' AND parses as text; binary files
    # may also start with 'solid', so verify the triangle count instead.
    if len(rest) >= 4:
        (n_bin,) = struct.unpack("<I", rest[:4])
        if len(rest) == 4 + 50 * n_bin:
            raw = np.frombuffer(rest[4:], dtype=np.uint8)
            tri = raw.reshape(n_bin, 50)[:, :48].copy().view("<f4")
            return tri.reshape(n_bin, 4, 3)[:, 1:].astype(np.float32)
    if not head.lstrip().lower().startswith(b"solid"):
        raise ValueError(f"{path}: neither valid binary nor ASCII STL")
    verts = []
    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.split()
            if parts[:1] == ["vertex"]:
                verts.append([float(x) for x in parts[1:4]])
    tris = np.asarray(verts, dtype=np.float32)
    if tris.size == 0 or len(tris) % 3:
        raise ValueError(f"{path}: malformed ASCII STL")
    return tris.reshape(-1, 3, 3)


def normalize_mesh(tris, scene_radius=0.55):
    """Center at the origin and scale the bounding radius to scene_radius
    (the Blender pipeline sizes pollen grains to the camera rig the same
    way; keeps every mesh inside the srn-format near/far shell)."""
    lo = tris.reshape(-1, 3).min(0)
    hi = tris.reshape(-1, 3).max(0)
    center = (lo + hi) / 2.0
    radius = float(np.linalg.norm(tris.reshape(-1, 3) - center, axis=-1).max())
    return (tris - center) * (scene_radius / max(radius, 1e-12))


def render_mesh(pose, focal, size, tris, base_color, tri_chunk=512):
    """Vectorized Moller-Trumbore ray caster, flat Lambertian shading.

    All pixel rays share one origin, so the q-vector (cross(tvec, e1))
    and the hit-distance numerator (q . e2) are per-triangle constants;
    only the p-vector (cross(dir, e2)) is pixel x triangle.

    :param pose (4,4) OpenGL c2w
    :param tris (N,3,3) world-space triangle vertices
    :return (rgb (H,W,3) uint8 white-bkgd, alpha (H,W) uint8 hit mask)
    """
    H = W = size
    c = size / 2.0
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    dirs = np.stack(
        [(xs - c) / focal, -(ys - c) / focal, -np.ones_like(xs)], axis=-1
    )
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    dirs = (dirs @ pose[:3, :3].T).reshape(-1, 3).astype(np.float32)
    origin = pose[:3, 3].astype(np.float32)

    depth = np.full(H * W, np.inf, dtype=np.float32)
    shade = np.zeros(H * W, dtype=np.float32)
    light = np.array([0.4, 0.8, 0.45], dtype=np.float32)
    light /= np.linalg.norm(light)

    for s in range(0, len(tris), tri_chunk):
        t3 = tris[s : s + tri_chunk]  # (T,3,3)
        e1 = t3[:, 1] - t3[:, 0]  # (T,3)
        e2 = t3[:, 2] - t3[:, 0]
        n = np.cross(e1, e2)  # (T,3) unnormalized
        tvec = origin[None, :] - t3[:, 0]  # (T,3)
        qv = np.cross(tvec, e1)  # (T,3)
        tnum = np.einsum("tc,tc->t", qv, e2)  # (T,)
        pv = np.cross(dirs[:, None, :], e2[None, :, :])  # (P,T,3)
        det = np.einsum("ptc,tc->pt", pv, e1)
        inv_det = 1.0 / np.where(det == 0, np.inf, det)
        u = np.einsum("ptc,tc->pt", pv, tvec) * inv_det
        v = (dirs @ qv.T) * inv_det
        tt = tnum[None, :] * inv_det
        hit = (u >= 0) & (v >= 0) & (u + v <= 1) & (tt > 1e-4)
        tt = np.where(hit, tt, np.inf)
        j = np.argmin(tt, axis=1)  # nearest triangle in chunk per pixel
        tbest = tt[np.arange(len(tt)), j]
        closer = tbest < depth
        nrm = n[j]
        nrm = nrm / np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-12)
        # two-sided flat shading: headlight-independent fixed light
        lam = np.clip(np.abs(nrm @ light), 0.15, 1.0)
        depth = np.where(closer, tbest, depth)
        shade = np.where(closer, lam, shade)

    hit = np.isfinite(depth)
    img = np.ones((H * W, 3), dtype=np.float32)
    img[hit] = base_color[None, :] * shade[hit, None]
    rgb = (np.clip(img, 0, 1) * 255).astype(np.uint8).reshape(H, W, 3)
    alpha = (hit.reshape(H, W) * 255).astype(np.uint8)
    return rgb, alpha


def main(argv=None):
    from pixelnerf_tpu_torch.utils.visualize import write_png

    parser = argparse.ArgumentParser()
    parser.add_argument("--stl", nargs="+", required=True, help="STL files")
    parser.add_argument("--out", type=str, required=True)
    parser.add_argument("--name", type=str, default="pollen")
    parser.add_argument("--n_views", type=int, default=50)
    parser.add_argument("--size", type=int, default=128)
    parser.add_argument("--radius", type=float, default=1.3)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    rng = np.random.default_rng(args.seed)
    focal = float(args.size)  # SRN convention, matches make_synthetic_dataset
    datadir = os.path.join(args.out, args.name)
    stage = ("train",) * 8 + ("val", "test")
    scene_r = 0.55
    # near/far from the rig geometry (Blender_cli.py:104-111 computes the
    # same camera-distance +- object-radius shell)
    z_near = max(args.radius - 0.65, 0.05)
    z_far = args.radius + 0.65

    for obj, stl_path in enumerate(args.stl):
        split = stage[obj % 10]  # 8:1:1 by index (Blender_cli.py:219-221)
        tris = normalize_mesh(read_stl(stl_path), scene_r)
        color = rng.uniform(0.3, 0.95, 3).astype(np.float32)
        base = os.path.splitext(os.path.basename(stl_path))[0]
        obj_dir = os.path.join(datadir, f"{args.name}_{split}", base)
        os.makedirs(os.path.join(obj_dir, "rgb"), exist_ok=True)
        os.makedirs(os.path.join(obj_dir, "pose"), exist_ok=True)
        write_srn_intrinsics(obj_dir, focal, args.size)
        with open(os.path.join(obj_dir, "near_far.txt"), "w") as f:
            f.write(f"{z_near} {z_far}\n")
        for v, origin in enumerate(fibonacci_sphere(args.n_views, args.radius)):
            pose = look_at(origin, np.zeros(3))
            img, _ = render_mesh(pose, focal, args.size, tris, color)
            write_png(os.path.join(obj_dir, "rgb", f"{v:06d}.png"), img)
            # pose files pre-flipped by diag(1,-1,-1,1) (Blender_cli.py:224-227)
            np.savetxt(
                os.path.join(obj_dir, "pose", f"{v:06d}.txt"),
                (pose @ np.diag([1.0, -1.0, -1.0, 1.0])).reshape(1, 16),
            )
        print(f"{base} ({split}): {args.n_views} views, {len(tris)} tris")
    print("Wrote dataset to", datadir)


if __name__ == "__main__":
    main()
