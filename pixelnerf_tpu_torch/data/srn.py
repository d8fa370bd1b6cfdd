"""SRN-format dataset (Sitzmann et al. 2020 ShapeNet renders) + pollen variant.

Counterpart of `pixelnerf_tpu/data/srn.py`, the reference's SRNDataset
(src/data/SRNDataset.py:10-146) and the fork's pollen-flavoured
orgSRNDataset (src/data/orgSRNDataset.py):

* per-object dirs under <datadir>/<name>_<stage>/ with intrinsics.txt
  (4-line SRN format), rgb/*.png, pose/*.txt
* poses post-multiplied by diag(1,-1,-1,1) (camera-convention flip,
  SRNDataset.py:56-58,97)
* white-background foreground masks + bboxes
* area-resize with focal/principal-point rescale (SRNDataset.py:121-129)
* pollen extensions: split .lst files or directory listing
  (orgSRNDataset.py:61-72), per-dataset near_far.txt override
  (orgSRNDataset.py:96-105), RGBA -> white composite (168-176), lindisp

Output contract per object (numpy, channels-last):
  images (NV, H, W, 3) f32 [-1,1] | poses (NV, 4, 4) | focal () | c (2,)
  masks (NV, H, W, 1) | bbox (NV, 4)
"""

from __future__ import annotations

import glob
import os
from typing import Tuple

import numpy as np

from pixelnerf_tpu_torch.data.common import (
    bbox_from_mask,
    image_to_balanced,
    load_images,
    mask_from_white_bkgd,
    resize_area_np,
)

__all__ = ["SRNDataset"]

_COORD_TRANS = np.diag(np.array([1, -1, -1, 1], dtype=np.float32))


class SRNDataset:
    """:param stage train | val | test
    :param image_size output (H, W); resizes with area interpolation
    :param world_scale scales focal + camera translations
    :param use_near_far read per-dataset near_far.txt when present (pollen)
    :param lindisp sample linearly in disparity (pollen uses True)
    """

    def __init__(
        self,
        datadir: str,
        stage: str = "train",
        image_size: Tuple[int, int] = (128, 128),
        world_scale: float = 1.0,
        z_near: float = 0.01,
        z_far: float = 4.0,
        use_near_far: bool = False,
        lindisp: bool = False,
    ):
        self.path = datadir
        self.stage = stage
        self.image_size = tuple(image_size)
        self.world_scale = world_scale

        # category prefix = datadir basename (SRNDataset.py:31-37)
        self.list_prefix = os.path.basename(datadir.rstrip("/"))
        self.dataset_name = self.list_prefix
        self.base_path = os.path.join(self.path, f"{self.list_prefix}_{self.stage}")
        if not os.path.isdir(self.base_path):
            raise FileNotFoundError(
                f"SRN dataset base path not found: {self.base_path}"
            )

        # optional split list file (orgSRNDataset.py:61-72)
        list_path = os.path.join(
            self.path, f"{self.list_prefix}_{self.stage}.lst"
        )
        if os.path.exists(list_path):
            with open(list_path) as f:
                ids = sorted(x.strip() for x in f if x.strip())
            self.intrins = [
                os.path.join(self.base_path, i, "intrinsics.txt") for i in ids
            ]
        else:
            self.intrins = sorted(
                glob.glob(os.path.join(self.base_path, "*", "intrinsics.txt"))
            )
        if not self.intrins:
            raise ValueError(f"No objects found under {self.base_path}")

        # fork hardcodes wide bounds (SRNDataset.py:59-66); overridable
        self.z_near = z_near
        self.z_far = z_far
        self.lindisp = lindisp

        if use_near_far:
            nf_path = os.path.join(
                os.path.dirname(self.intrins[0]), "near_far.txt"
            )
            if os.path.exists(nf_path):
                with open(nf_path) as f:
                    self.z_near, self.z_far = (
                        float(x) for x in f.readline().split()
                    )

    def __len__(self) -> int:
        return len(self.intrins)

    def __getitem__(self, index: int) -> dict:
        intrin_path = self.intrins[index]
        dir_path = os.path.dirname(intrin_path)
        rgb_paths = sorted(glob.glob(os.path.join(dir_path, "rgb", "*")))
        pose_paths = sorted(glob.glob(os.path.join(dir_path, "pose", "*")))
        assert len(rgb_paths) == len(pose_paths)

        with open(intrin_path) as f:
            lines = f.readlines()
            focal, cx, cy, _ = map(float, lines[0].split())

        raws = load_images(rgb_paths)  # all views in one threaded call
        imgs, poses, masks, bboxes = [], [], [], []
        for raw, pose_path in zip(raws, pose_paths):
            if raw.shape[-1] == 4:
                # RGBA -> white composite (orgSRNDataset.py:168-176)
                alpha = raw[..., 3:4].astype(np.float32) / 255.0
                rgb = raw[..., :3].astype(np.float32)
                raw = (rgb * alpha + 255.0 * (1 - alpha)).astype(np.uint8)
            else:
                raw = raw[..., :3]

            mask = mask_from_white_bkgd(raw)
            pose = np.loadtxt(pose_path, dtype=np.float32).reshape(4, 4)
            pose = pose @ _COORD_TRANS

            bboxes.append(bbox_from_mask(mask))
            imgs.append(image_to_balanced(raw))
            masks.append(mask)
            poses.append(pose)

        images = np.stack(imgs)  # (NV, H, W, 3)
        poses = np.stack(poses)
        masks = np.stack(masks)
        bboxes = np.stack(bboxes)

        if images.shape[1:3] != self.image_size:
            scale = self.image_size[0] / images.shape[1]
            focal *= scale
            cx *= scale
            cy *= scale
            bboxes *= scale
            images = resize_area_np(images, self.image_size)
            masks = resize_area_np(masks, self.image_size)

        if self.world_scale != 1.0:
            focal *= self.world_scale
            poses[:, :3, 3] *= self.world_scale

        return {
            "path": dir_path,
            "img_id": index,
            "focal": np.float32(focal),
            "c": np.array([cx, cy], dtype=np.float32),
            "images": images,
            "masks": masks,
            "bbox": bboxes,
            "poses": poses.astype(np.float32),
        }
