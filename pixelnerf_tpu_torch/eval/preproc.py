"""Real-image preprocessing: segment the object, crop, white-composite.

Counterpart of `pixelnerf_tpu/eval/preproc.py`, a copy of it: it runs on
the host (OpenCV and numpy), needs `cv2`, which it imports inside the
functions that use it, and reads and writes images with Pillow
(`utils/visualize.py`). Re-implements the reference's scripts/preproc.py:106-303: instance
segmentation of the foreground object, square crop around the mask with
margin, white background compositing, resize, and `*_normalize.png` output
for eval_real.

The reference uses detectron2 PointRend (vendored configs under
scripts/detectron2/). detectron2 and its weights are unavailable offline,
so segmentation is pluggable:

* `PointRendWrapper` — used when detectron2 is importable (same interface
  as the reference's scripts/preproc.py:40-104 wrapper).
* `grabcut_segment` — cv2 GrabCut fallback initialized from a centered
  rectangle; adequate for centered single-object photos.

Run:
    python -m pixelnerf_tpu_torch.eval.preproc --input ./input --size 128
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np


class PointRendWrapper:
    """detectron2 PointRend instance segmentation (gated on availability)."""

    def __init__(self, filter_class: int = 2):
        import detectron2  # noqa: F401
        from detectron2 import config as d2config
        from detectron2.engine import DefaultPredictor

        self.filter_class = filter_class  # 2 = car in COCO
        cfg = d2config.get_cfg()
        from detectron2.projects import point_rend

        point_rend.add_pointrend_config(cfg)
        cfg.merge_from_file(
            point_rend.__path__[0]
            + "/configs/InstanceSegmentation/pointrend_rcnn_R_50_FPN_3x_coco.yaml"
        )
        cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.5
        self.predictor = DefaultPredictor(cfg)

    def segment(self, im: np.ndarray) -> np.ndarray:
        """:return (H, W) float mask of the best matching instance."""
        outputs = self.predictor(im[..., ::-1])  # BGR
        insts = outputs["instances"]
        if self.filter_class >= 0:
            keep = insts.pred_classes == self.filter_class
            insts = insts[keep]
        if len(insts) == 0:
            return np.zeros(im.shape[:2], dtype=np.float32)
        best = int(insts.scores.argmax())
        return insts.pred_masks[best].cpu().numpy().astype(np.float32)


def grabcut_segment(im: np.ndarray, iters: int = 5) -> np.ndarray:
    """cv2 GrabCut fallback: foreground from a centered rect prior."""
    import cv2

    H, W = im.shape[:2]
    mask = np.zeros((H, W), np.uint8)
    rect = (int(W * 0.05), int(H * 0.05), int(W * 0.9), int(H * 0.9))
    bgd = np.zeros((1, 65), np.float64)
    fgd = np.zeros((1, 65), np.float64)
    cv2.grabCut(im[..., :3], mask, rect, bgd, fgd, iters, cv2.GC_INIT_WITH_RECT)
    return ((mask == cv2.GC_FGD) | (mask == cv2.GC_PR_FGD)).astype(np.float32)


def normalize_image(
    im: np.ndarray,
    mask: np.ndarray,
    size: int = 128,
    scale: float = 4.37,
    major_scale: float = 0.8,
) -> np.ndarray:
    """Ellipse-fit square crop, white-composite, resize.

    Matches the reference's framing semantics (scripts/preproc.py:240-287):
    fit an ellipse to the largest external contour of the mask, center the
    square crop at the ellipse center with radius
    ``max(minor_axis * scale, major_axis * major_scale) / 2`` (reference
    defaults -S 4.37 -M 0.8), composite outside-mask pixels to white, and
    resize to ``size`` with bilinear interpolation. Falls back to a
    bbox-centered crop when the contour is too small to fit an ellipse
    (< 5 points).
    """
    import cv2

    ys, xs = np.where(mask > 0.5)
    if len(ys) == 0:
        raise ValueError("Empty segmentation mask")

    mask_u8 = (mask > 0.5).astype(np.uint8) * 255
    cnt, _ = cv2.findContours(
        mask_u8, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE
    )
    cnt = max(cnt, key=cv2.contourArea) if cnt else None
    if cnt is not None and len(cnt) >= 5:
        ellipse = cv2.fitEllipse(cnt)
        (ecx, ecy), (ax0, ax1) = ellipse[0], ellipse[1]
        min_ax, max_ax = min(ax0, ax1), max(ax0, ax1)
        cx, cy = int(round(ecx)), int(round(ecy))
        half = int(np.ceil(max(min_ax * scale, max_ax * major_scale) * 0.5))
    else:  # degenerate contour: bbox center, bbox-extent radius
        cy = int(round((ys.min() + ys.max()) / 2))
        cx = int(round((xs.min() + xs.max()) / 2))
        half = int(
            np.ceil(max(ys.max() - ys.min(), xs.max() - xs.min()) * 0.5)
        ) + 1

    comp = im[..., :3].astype(np.float32) * mask[..., None] + 255.0 * (
        1.0 - mask[..., None]
    )
    # pad so the square crop always fits (outside-photo area is white,
    # same as the reference's replicate-pad + zero-padded-mask composite)
    pad = half + 1
    comp = np.pad(
        comp, ((pad, pad), (pad, pad), (0, 0)), constant_values=255.0
    )
    crop = comp[cy + pad - half : cy + pad + half, cx + pad - half : cx + pad + half]
    out = cv2.resize(
        crop, (size, size), interpolation=cv2.INTER_LINEAR
    )
    return np.clip(out, 0, 255).astype(np.uint8)


def main(argv=None):
    """Writes `<image>_normalize.png` beside each input image; returns
    their paths."""
    from pixelnerf_tpu_torch.utils.visualize import read_image, write_png

    parser = argparse.ArgumentParser()
    parser.add_argument("--input", "-I", type=str, default="input")
    parser.add_argument("--size", type=int, default=128)
    parser.add_argument(
        "--filter_class", type=int, default=2, help="COCO class id (2 = car)"
    )
    parser.add_argument(
        "--segmenter", type=str, default="auto",
        help="auto | pointrend | grabcut",
    )
    args = parser.parse_args(argv)

    seg = None
    if args.segmenter in ("auto", "pointrend"):
        try:
            seg = PointRendWrapper(args.filter_class)
            print("Using PointRend segmentation")
        except Exception as e:
            if args.segmenter == "pointrend":
                raise
            print("detectron2 unavailable (%s); using GrabCut fallback" % e)

    paths = [
        p
        for p in sorted(glob.glob(os.path.join(args.input, "*")))
        if p.lower().endswith((".png", ".jpg", ".jpeg"))
        and not p.endswith("_normalize.png")
    ]
    written = []
    for p in paths:
        im = np.asarray(read_image(p))[..., :3]
        mask = seg.segment(im) if seg is not None else grabcut_segment(im)
        try:
            out = normalize_image(im, mask, size=args.size)
        except ValueError:
            print("WARN: empty mask for", p, "— skipped")
            continue
        out_path = os.path.splitext(p)[0] + "_normalize.png"
        write_png(out_path, out)
        written.append(out_path)
        print("Wrote", out_path)
    return written


if __name__ == "__main__":
    main()
