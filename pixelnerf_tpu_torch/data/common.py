"""Host-side dataset helpers: image IO, resize, normalization, bboxes.

Counterpart of `pixelnerf_tpu/data/common.py`. All images are
channels-last float32 numpy arrays. Files are decoded by the native
threaded decoder (native/imagecodec.py) where it builds, else by Pillow;
PNG is lossless, so both give the same pixels.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np

from pixelnerf_tpu_torch.native import imagecodec

__all__ = [
    "load_image",
    "load_images",
    "image_to_balanced",
    "mask_from_white_bkgd",
    "bbox_from_mask",
    "resize_area_np",
]


def _canon_channels(img: np.ndarray) -> np.ndarray:
    """Grayscale expands to RGB (gray + alpha to RGBA), so callers always
    see >= 3 channels whichever decoder ran."""
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=-1)
    if img.shape[-1] == 1:
        return np.repeat(img, 3, axis=-1)
    if img.shape[-1] == 2:  # gray + alpha
        return np.concatenate([np.repeat(img[..., :1], 3, axis=-1), img[..., 1:]], axis=-1)
    return img


def _read_pillow(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        if im.mode == "P":
            im = im.convert("RGBA" if "transparency" in im.info else "RGB")
        elif im.mode not in ("L", "LA", "RGB", "RGBA"):
            im = im.convert("RGB")
        return np.asarray(im)


def load_image(path: str) -> np.ndarray:
    """Read an image file -> (H, W, 3|4) uint8 (gray expanded to RGB)."""
    out = imagecodec.decode_batch([path], num_threads=1)
    img = out[0] if out else _read_pillow(path)
    return _canon_channels(img)


def load_images(paths) -> list:
    """Read a batch of image files -> list of (H, W, 3|4) uint8: the
    native decoder takes them across its thread pool in one call."""
    out = imagecodec.decode_batch(list(paths))
    if out is not None:
        return [_canon_channels(im) for im in out]
    return [load_image(p) for p in paths]


def image_to_balanced(img: np.ndarray) -> np.ndarray:
    """uint8 (H, W, 3) -> float32 in [-1, 1] (ToTensor + Normalize(0.5, 0.5))."""
    return img.astype(np.float32) / 255.0 * 2.0 - 1.0


def mask_from_white_bkgd(img: np.ndarray) -> np.ndarray:
    """(H, W, 1) float32 foreground mask: every pixel but pure white."""
    mask = (img != 255).any(axis=-1)
    return mask[..., None].astype(np.float32)


def bbox_from_mask(mask: np.ndarray) -> np.ndarray:
    """[cmin, rmin, cmax, rmax] of a (H, W, ...) mask; raises on an empty one."""
    m = np.asarray(mask)
    if m.ndim == 3:
        m = m[..., 0]
    rnz = np.where(np.any(m > 0, axis=1))[0]
    cnz = np.where(np.any(m > 0, axis=0))[0]
    if len(rnz) == 0:
        raise RuntimeError("Bad image: empty mask")
    rmin, rmax = rnz[[0, -1]]
    cmin, cmax = cnz[[0, -1]]
    return np.array([cmin, rmin, cmax, rmax], dtype=np.float32)


@functools.lru_cache(maxsize=64)
def _area_matrix(out_size: int, in_size: int) -> np.ndarray:
    """torch mode='area' (adaptive average pooling) as a matrix."""
    M = np.zeros((out_size, in_size), dtype=np.float32)
    for i in range(out_size):
        j0 = (i * in_size) // out_size
        j1 = -((-(i + 1) * in_size) // out_size)
        M[i, j0:j1] = 1.0 / (j1 - j0)
    return M


def resize_area_np(x: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """Area resize of (..., H, W, C) float arrays."""
    H, W = x.shape[-3], x.shape[-2]
    Ho, Wo = out_hw
    if (H, W) == (Ho, Wo):
        return x
    x = np.einsum("ih,...hwc->...iwc", _area_matrix(Ho, H), x)
    x = np.einsum("jw,...iwc->...ijc", _area_matrix(Wo, W), x)
    return x.astype(np.float32)
