"""Procedural pollen-grain STL generator.

The reference's pollen pipeline (``Blender_cli.py``,
``src/data/pollen_image_gen.py``) consumes a directory of scanned
pollen-grain STL meshes that this repository does not ship. This tool
synthesizes stand-in grains — displaced icospheres with the echinate
(spiky) and low-frequency lobed structure of real grains — as binary STL
files that feed ``tools/stl_render_dataset.py`` exactly like the scans
feed Blender/VTK (Blender_cli.py:40-52 globs ``*.stl`` the same way).

Run:
    python -m pixelnerf_tpu_torch.tools.make_pollen_meshes \
        --out /tmp/pollen_meshes --n_meshes 30 --subdiv 3
"""

from __future__ import annotations

import argparse
import os
import struct

import numpy as np


def icosphere(subdiv=3):
    """Unit icosphere as (V, 3) vertices + (F, 3) int faces.

    Midpoint subdivision of the icosahedron; every level quadruples the
    face count (subdiv=3 -> 1280 faces).
    """
    p = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            [-1, p, 0], [1, p, 0], [-1, -p, 0], [1, -p, 0],
            [0, -1, p], [0, 1, p], [0, -1, -p], [0, 1, -p],
            [p, 0, -1], [p, 0, 1], [-p, 0, -1], [-p, 0, 1],
        ],
        dtype=np.float64,
    )
    verts /= np.linalg.norm(verts, axis=-1, keepdims=True)
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        dtype=np.int64,
    )
    for _ in range(subdiv):
        verts_list = list(verts)
        midpoint = {}

        def mid(a, b):
            key = (min(a, b), max(a, b))
            if key not in midpoint:
                v = verts_list[a] + verts_list[b]
                v = v / np.linalg.norm(v)
                midpoint[key] = len(verts_list)
                verts_list.append(v)
            return midpoint[key]

        new_faces = []
        for a, b, c in faces:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            new_faces += [[a, ab, ca], [ab, b, bc], [ca, bc, c], [ab, bc, ca]]
        verts = np.asarray(verts_list)
        faces = np.asarray(new_faces, dtype=np.int64)
    return verts, faces


def pollen_radius(verts, rng):
    """Radial displacement field r(direction): lobes + echinate spikes."""
    r = np.ones(len(verts))
    # low-frequency lobes: a few random cosine plane waves
    for _ in range(rng.integers(2, 5)):
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        freq = rng.uniform(1.0, 3.0)
        amp = rng.uniform(0.04, 0.12)
        r += amp * np.cos(freq * np.pi * (verts @ axis))
    # echinate spikes: sharp gaussian bumps at random surface directions
    n_spikes = int(rng.integers(12, 40))
    centers = rng.normal(size=(n_spikes, 3))
    centers /= np.linalg.norm(centers, axis=-1, keepdims=True)
    width = rng.uniform(0.06, 0.15)
    amp = rng.uniform(0.10, 0.30)
    # angular distance via dot product; exp falloff
    d2 = 2.0 * (1.0 - verts @ centers.T)  # chord^2 to each spike center
    r += amp * np.exp(-d2 / (2.0 * width * width)).max(axis=-1)
    return r


def write_binary_stl(path, tris):
    """(N, 3, 3) float triangles -> binary STL with recomputed normals."""
    tris = np.asarray(tris, dtype=np.float32)
    n = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
    rec = np.zeros((len(tris), 50), dtype=np.uint8)
    rec[:, :48] = (
        np.concatenate([n[:, None, :], tris], axis=1)
        .astype("<f4")
        .reshape(len(tris), 48 // 4)
        .view(np.uint8)
        .reshape(len(tris), 48)
    )
    with open(path, "wb") as f:
        f.write(b"pixelnerf_tpu procedural pollen grain".ljust(80, b"\0"))
        f.write(struct.pack("<I", len(tris)))
        f.write(rec.tobytes())


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", type=str, required=True)
    parser.add_argument("--n_meshes", type=int, default=30)
    parser.add_argument("--subdiv", type=int, default=3)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    base_verts, faces = icosphere(args.subdiv)
    for i in range(args.n_meshes):
        rng = np.random.default_rng(args.seed * 100003 + i)
        verts = base_verts * pollen_radius(base_verts, rng)[:, None]
        write_binary_stl(
            os.path.join(args.out, f"grain{i:04d}.stl"),
            verts[faces],
        )
    print(f"Wrote {args.n_meshes} meshes to {args.out}")


if __name__ == "__main__":
    main()
