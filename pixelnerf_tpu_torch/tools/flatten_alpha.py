"""Flatten RGBA PNGs onto a white background, in place or to a copy.

Counterpart of the reference's dataset-repair scripts
``data/flatt_white.py`` (walks pollen_{train,val,test}/*/rgb and
composites RGBA over white in place) and ``input/normales.py``
(single-file transparent->white conversion): one CLI covers both —
pass a dataset root to walk every rgb/ dir, or explicit files with
--out for a non-destructive copy. Alpha semantics match the loaders'
own compositing (data/srn.py white-background rule): out = a*rgb +
(1-a)*white.

Run:
    python -m pixelnerf_tpu_torch.tools.flatten_alpha --root data/pollen
    python -m pixelnerf_tpu_torch.tools.flatten_alpha in.png --out out.png
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np


def flatten_rgba(img: np.ndarray) -> np.ndarray:
    """(H, W, 4) uint8 -> (H, W, 3) uint8 composited over white."""
    rgb = img[..., :3].astype(np.float32)
    a = img[..., 3:4].astype(np.float32) / 255.0
    return np.rint(rgb * a + 255.0 * (1.0 - a)).clip(0, 255).astype(np.uint8)


def flatten_file(path: str, out_path: str | None = None) -> bool:
    """Flatten one PNG; returns True if it had an alpha channel."""
    from pixelnerf_tpu_torch.utils.visualize import read_image, write_png

    img = np.asarray(read_image(path))
    if img.ndim != 3 or img.shape[-1] != 4:
        return False
    write_png(out_path or path, flatten_rgba(img))
    return True


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("files", nargs="*", help="explicit PNG files")
    parser.add_argument(
        "--root", type=str, default=None,
        help="dataset root: flatten every */rgb/*.png under it in place",
    )
    parser.add_argument(
        "--out", type=str, default=None,
        help="output path (single explicit file only; default: in place)",
    )
    args = parser.parse_args(argv)

    paths = list(args.files)
    if args.root:
        paths += sorted(
            glob.glob(os.path.join(args.root, "**", "rgb", "*.png"),
                      recursive=True)
        )
    if args.out and len(paths) != 1:
        parser.error("--out requires exactly one input file")
    n = sum(flatten_file(p, args.out) for p in paths)
    print(f"flattened {n}/{len(paths)} images")
    return n


if __name__ == "__main__":
    main()
