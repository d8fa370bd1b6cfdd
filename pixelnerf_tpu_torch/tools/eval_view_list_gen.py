"""Generate evaluation view-pair lists at a target angular separation.

Re-implements the fork's eval_view_list_gen.py: cameras on an Archimedean
spherical spiral (matching the Blender dataset generators), greedily paired
at ~90 degrees apart, written one pair per line.

Run:
    python -m pixelnerf_tpu_torch.tools.eval_view_list_gen --num_views 250 \
        --target_angle 90 --out viewlist/pollen_eval_view_list.txt
"""

from __future__ import annotations

import argparse
import math
import os

import numpy as np


def get_archimedean_spiral(sphere_radius: float, num_steps: int = 250) -> np.ndarray:
    """Spherical spiral camera positions (reference eval_view_list_gen.py:5-24)."""
    a = 40
    r = sphere_radius
    translations = []
    i = a / 2
    while i < a:
        theta = i / a * math.pi
        x = r * math.sin(theta) * math.cos(-i)
        z = r * math.sin(-theta + math.pi) * math.sin(-i)
        y = r * -math.cos(theta)
        translations.append((x, y, z))
        i += a / (2 * num_steps)
    return np.array(translations)


def compute_angle(v1: np.ndarray, v2: np.ndarray) -> float:
    u1 = v1 / np.linalg.norm(v1)
    u2 = v2 / np.linalg.norm(v2)
    return math.degrees(math.acos(float(np.clip(np.dot(u1, u2), -1.0, 1.0))))


def generate_eval_pairs(
    num_views: int = 250, target_angle: float = 90.0, tolerance: float = 5.0,
    sphere_radius: float = 2.0,
):
    """Greedy matching of view pairs ~target_angle apart
    (reference eval_view_list_gen.py:33-57)."""
    cam_positions = get_archimedean_spiral(sphere_radius, num_steps=num_views)
    used = set()
    pairs = []
    for i, cam_i in enumerate(cam_positions):
        if i in used:
            continue
        best_j, best_diff = -1, 999.0
        for j in range(i + 1, len(cam_positions)):
            if j in used:
                continue
            diff = abs(compute_angle(cam_i, cam_positions[j]) - target_angle)
            if diff < best_diff and diff <= tolerance:
                best_j, best_diff = j, diff
        if best_j >= 0:
            pairs.append((i, best_j))
            used.add(i)
            used.add(best_j)
    return pairs


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--num_views", type=int, default=250)
    parser.add_argument("--target_angle", type=float, default=90.0)
    parser.add_argument("--tolerance", type=float, default=5.0)
    parser.add_argument("--sphere_radius", type=float, default=2.0)
    parser.add_argument(
        "--out", type=str, default="viewlist/eval_view_list.txt"
    )
    args = parser.parse_args(argv)

    pairs = generate_eval_pairs(
        args.num_views, args.target_angle, args.tolerance, args.sphere_radius
    )
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        for i, j in pairs:
            f.write(f"{i} {j}\n")
    print(f"Wrote {len(pairs)} view pairs to {args.out}")
    return pairs


if __name__ == "__main__":
    main()
