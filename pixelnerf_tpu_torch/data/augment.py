"""Train-time augmentation: same-jitter-per-object color jitter.

Counterpart of `pixelnerf_tpu/data/augment.py`, the reference's
ColorJitterDataset (src/data/data_util.py:14-56) without torchvision, on a
numpy generator: the same hue/saturation/contrast/brightness factors are
applied to every view of an object so multi-view consistency is preserved.
The individual adjustments match torchvision.transforms.functional semantics
(grayscale weights 0.299/0.587/0.114, blend + clamp to [0,1], HSV hue shift).
"""

from __future__ import annotations

import numpy as np

__all__ = ["ColorJitterDataset", "apply_color_jitter"]

_GRAY_W = np.array([0.299, 0.587, 0.114], dtype=np.float32)


def _blend(img1: np.ndarray, img2: np.ndarray, ratio: float) -> np.ndarray:
    return np.clip(ratio * img1 + (1.0 - ratio) * img2, 0.0, 1.0)


def adjust_brightness(img: np.ndarray, factor: float) -> np.ndarray:
    return _blend(img, np.zeros_like(img), factor)


def adjust_contrast(img: np.ndarray, factor: float) -> np.ndarray:
    mean = (img @ _GRAY_W).mean(dtype=np.float32)
    return _blend(img, np.full_like(img, mean), factor)


def adjust_saturation(img: np.ndarray, factor: float) -> np.ndarray:
    gray = (img @ _GRAY_W)[..., None]
    return _blend(img, np.broadcast_to(gray, img.shape), factor)


def adjust_hue(img: np.ndarray, factor: float) -> np.ndarray:
    """Shift hue by factor (in [-0.5, 0.5] turns) via RGB->HSV->RGB."""
    if factor == 0.0:
        return img
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    maxc = img.max(-1)
    minc = img.min(-1)
    v = maxc
    delta = maxc - minc
    s = np.where(maxc > 0, delta / np.maximum(maxc, 1e-12), 0.0)

    dz = np.maximum(delta, 1e-12)
    rc = (maxc - r) / dz
    gc = (maxc - g) / dz
    bc = (maxc - b) / dz
    h = np.where(r == maxc, bc - gc, np.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = (h / 6.0) % 1.0
    h = np.where(delta == 0, 0.0, h)

    h = (h + factor) % 1.0

    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.astype(np.int32) % 6

    r2 = np.choose(i, [v, q, p, p, t, v])
    g2 = np.choose(i, [t, v, v, q, p, p])
    b2 = np.choose(i, [p, p, t, v, v, q])
    return np.stack([r2, g2, b2], axis=-1).astype(np.float32)


def apply_color_jitter(
    images: np.ndarray,
    rng: np.random.Generator,
    hue_range: float = 0.1,
    saturation_range: float = 0.1,
    brightness_range: float = 0.1,
    contrast_range: float = 0.1,
) -> np.ndarray:
    """Apply ONE sampled jitter to all views (NV, H, W, 3) in [-1, 1].

    Adjustment order matches the reference (data_util.py:40-48):
    saturation, hue, contrast, brightness.
    """
    hue = rng.uniform(-hue_range, hue_range)
    sat = rng.uniform(1 - saturation_range, 1 + saturation_range)
    bri = rng.uniform(1 - brightness_range, 1 + brightness_range)
    con = rng.uniform(1 - contrast_range, 1 + contrast_range)

    out = []
    for img in images:
        tmp = (img + 1.0) * 0.5
        tmp = adjust_saturation(tmp, sat)
        tmp = adjust_hue(tmp, hue)
        tmp = adjust_contrast(tmp, con)
        tmp = adjust_brightness(tmp, bri)
        out.append(tmp * 2.0 - 1.0)
    return np.stack(out).astype(np.float32)


class ColorJitterDataset:
    """Wraps a base dataset, jittering all views of each object identically."""

    def __init__(
        self,
        base_dset,
        hue_range: float = 0.1,
        saturation_range: float = 0.1,
        brightness_range: float = 0.1,
        contrast_range: float = 0.1,
        extra_inherit_attrs=(),
        seed: int = 0,
    ):
        self.base_dset = base_dset
        self.hue_range = hue_range
        self.saturation_range = saturation_range
        self.brightness_range = brightness_range
        self.contrast_range = contrast_range
        self._rng = np.random.default_rng(seed)
        inherit = ["z_near", "z_far", "lindisp", "base_path"]
        inherit.extend(extra_inherit_attrs)
        for attr in inherit:
            if hasattr(base_dset, attr):
                setattr(self, attr, getattr(base_dset, attr))

    def __len__(self) -> int:
        return len(self.base_dset)

    def __getitem__(self, idx: int) -> dict:
        data = dict(self.base_dset[idx])
        data["images"] = apply_color_jitter(
            data["images"],
            self._rng,
            self.hue_range,
            self.saturation_range,
            self.brightness_range,
            self.contrast_range,
        )
        return data
