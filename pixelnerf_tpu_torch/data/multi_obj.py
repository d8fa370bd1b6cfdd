"""NeRF-synthetic multi-object dataset (transforms.json format).

Counterpart of `pixelnerf_tpu/data/multi_obj.py`, the reference's
MultiObjectDataset (src/data/MultiObjectDataset.py:14-117): walks for transforms.json files,
loads <frame>_obj.png RGBA images, white-composites via the alpha channel,
derives bboxes, and computes focal from camera_angle_x.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Optional

import numpy as np

from pixelnerf_tpu_torch.data.common import image_to_balanced, load_images, resize_area_np

__all__ = ["MultiObjectDataset"]


class MultiObjectDataset:
    def __init__(
        self,
        path: str,
        stage: str = "train",
        z_near: float = 4.0,
        z_far: float = 9.0,
        n_views: Optional[int] = None,
        image_size: Optional[tuple] = None,
    ):
        self.base_path = os.path.join(path, stage)
        trans_files = []
        for root, _dirs, filenames in os.walk(self.base_path):
            if "transforms.json" in filenames:
                trans_files.append(os.path.join(root, "transforms.json"))
        self.trans_files = sorted(trans_files)
        self.z_near = z_near
        self.z_far = z_far
        self.lindisp = False
        self.n_views = n_views
        # optional area-resize (focal needs no explicit rescale: it is
        # derived from camera_angle_x and the POST-resize width below)
        self.image_size = tuple(image_size) if image_size else None

    def __len__(self) -> int:
        return len(self.trans_files)

    def _check_valid(self, index: int) -> bool:
        if self.n_views is None:
            return True
        trans_file = self.trans_files[index]
        dir_path = os.path.dirname(trans_file)
        try:
            with open(trans_file) as f:
                transform = json.load(f)
        except Exception:
            return False
        if len(transform["frames"]) != self.n_views:
            return False
        if len(glob.glob(os.path.join(dir_path, "*.png"))) != self.n_views:
            return False
        return True

    def __getitem__(self, index: int) -> dict:
        if not self._check_valid(index):
            return {}

        trans_file = self.trans_files[index]
        dir_path = os.path.dirname(trans_file)
        with open(trans_file) as f:
            transform = json.load(f)

        obj_paths = [
            os.path.join(
                dir_path,
                os.path.splitext(os.path.basename(fr["file_path"]))[0] + "_obj.png",
            )
            for fr in transform["frames"]
        ]
        raws = load_images(obj_paths)  # RGBA, one threaded call
        imgs, bboxes, masks, poses = [], [], [], []
        for frame, raw in zip(transform["frames"], raws):
            mask = (raw[..., 3:4].astype(np.float32)) / 255.0  # (H, W, 1)

            # bbox from any-nonzero rows/cols of the raw image
            # (reference MultiObjectDataset.py:77-90: empty -> full image)
            nz = raw.any(axis=-1)
            rows = np.any(nz, axis=1)
            cols = np.any(nz, axis=0)
            rnz = np.where(rows)[0]
            cnz = np.where(cols)[0]
            if len(rnz) == 0:
                cmin = rmin = 0
                rmax, cmax = mask.shape[0], mask.shape[1]
            else:
                rmin, rmax = rnz[[0, -1]]
                cmin, cmax = cnz[[0, -1]]
            bboxes.append(np.array([cmin, rmin, cmax, rmax], dtype=np.float32))

            img = image_to_balanced(raw[..., :3])
            img = img * mask + (1.0 - mask)  # white where transparent
            imgs.append(img.astype(np.float32))
            masks.append(mask.astype(np.float32))
            poses.append(np.asarray(frame["transform_matrix"], dtype=np.float32))

        images = np.stack(imgs)
        masks_arr = np.stack(masks)
        bboxes_arr = np.stack(bboxes)
        if self.image_size is not None and images.shape[1:3] != self.image_size:
            sy = self.image_size[0] / images.shape[1]
            sx = self.image_size[1] / images.shape[2]
            images = resize_area_np(images, self.image_size)
            masks_arr = resize_area_np(masks_arr, self.image_size)
            # bbox is (cmin, rmin, cmax, rmax): x-coords scale with W, y with H
            bboxes_arr = bboxes_arr * np.array(
                [sx, sy, sx, sy], dtype=np.float32
            )
        H, W = images.shape[1:3]
        focal = 0.5 * W / np.tan(0.5 * float(transform["camera_angle_x"]))

        return {
            "path": dir_path,
            "img_id": index,
            "focal": np.float32(focal),
            "images": images,
            "masks": masks_arr,
            "bbox": bboxes_arr,
            "poses": np.stack(poses),
        }
