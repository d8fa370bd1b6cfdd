"""Visualization helpers: colormaps, image grids and PNG output.

Counterpart of `pixelnerf_tpu/utils/visualize.py`: numpy equivalents of
the reference's util.cmap / image_float_to_uint8 (src/util/util.py:13-30)
used by vis_step (train/train.py:294-437), and `write_png` (Pillow).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "image_float_to_uint8", "cmap", "hstack_images", "vstack_images", "write_png", "write_image",
    "read_image",
]


def image_float_to_uint8(img: np.ndarray) -> np.ndarray:
    """Min-max normalize a float image to uint8 (reference util.py:13-23)."""
    vmin = np.min(img)
    vmax = np.max(img)
    if vmax - vmin < 1e-10:
        vmax += 1e-10
    img = (img - vmin) / (vmax - vmin) * 255.0
    return img.astype(np.uint8)


def cmap(img: np.ndarray, color_map: int = None) -> np.ndarray:
    """Apply a HOT colormap to a float image -> (H, W, 3) uint8 RGB."""
    try:
        import cv2

        cm = cv2.COLORMAP_HOT if color_map is None else color_map
        bgr = cv2.applyColorMap(image_float_to_uint8(img), cm)
        return bgr[..., ::-1]  # BGR -> RGB
    except Exception:
        # grayscale fallback
        g = image_float_to_uint8(img)
        return np.stack([g, g, g], axis=-1)


def hstack_images(images, pad: int = 0) -> np.ndarray:
    """Horizontally stack same-height (H, W, 3) float images in [0, 1]."""
    images = [np.asarray(im, dtype=np.float32) for im in images]
    if pad:
        spacer = np.ones((images[0].shape[0], pad, 3), dtype=np.float32)
        out = []
        for i, im in enumerate(images):
            if i:
                out.append(spacer)
            out.append(im)
        return np.concatenate(out, axis=1)
    return np.concatenate(images, axis=1)


def vstack_images(images, pad: int = 0) -> np.ndarray:
    images = [np.asarray(im, dtype=np.float32) for im in images]
    if pad:
        spacer = np.ones((pad, images[0].shape[1], 3), dtype=np.float32)
        out = []
        for i, im in enumerate(images):
            if i:
                out.append(spacer)
            out.append(im)
        return np.concatenate(out, axis=0)
    return np.concatenate(images, axis=0)


def write_png(path: str, img: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 image as a PNG file."""
    from PIL import Image

    Image.fromarray(np.ascontiguousarray(img, dtype=np.uint8)).save(path, format="PNG")


def write_image(path: str, img: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 image in the format its extension names
    (PNG, JPEG, ...), through Pillow."""
    from PIL import Image

    Image.fromarray(np.ascontiguousarray(img, dtype=np.uint8)).save(path)


def read_image(path: str) -> np.ndarray:
    """An image file as a uint8 array (H, W, C) through Pillow, as
    imageio's Pillow plugin reads it."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im)
