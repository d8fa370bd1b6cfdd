"""DVR-format dataset (Niemeyer et al. 2020): NMR ShapeNet 64x64 and DTU.

Counterpart of `pixelnerf_tpu/data/dvr.py`, the reference's DVRDataset
(src/data/DVRDataset.py:11-274):

* category dirs each with <list_prefix>{train,val,test}.lst split files
* cameras.npz per object:
  - ShapeNet path: world_mat_inv_i (or inverted world_mat_i) extrinsics +
    camera_mat_i intrinsics with fx == fy (DVRDataset.py:182-202)
  - DTU path: P-matrix decomposition via cv2.decomposeProjectionMatrix,
    scale_mat normalization, intrinsics averaged over views
    (DVRDataset.py:157-181, 231-238)
* per-sub-format world/camera coordinate transforms (DVRDataset.py:80-97)
* scale_focal: intrinsics given for a side-2 image in [-1,1] coords
* max_imgs random view subsampling (DTU train uses 49)
"""

from __future__ import annotations

import glob
import os
from typing import Optional, Tuple

import numpy as np

from pixelnerf_tpu_torch.data.common import (
    bbox_from_mask,
    image_to_balanced,
    load_images,
    resize_area_np,
)

__all__ = ["DVRDataset"]

_TRANS_WORLD_SHAPENET = np.array(
    [[1, 0, 0, 0], [0, 0, -1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], dtype=np.float32
)
_TRANS_CAM_SHAPENET = np.array(
    [[1, 0, 0, 0], [0, -1, 0, 0], [0, 0, -1, 0], [0, 0, 0, 1]], dtype=np.float32
)
_TRANS_DTU = np.array(
    [[1, 0, 0, 0], [0, -1, 0, 0], [0, 0, -1, 0], [0, 0, 0, 1]], dtype=np.float32
)


def decompose_projection(P: np.ndarray):
    """Decompose a 3x4 projection matrix into (K, R, t) like
    cv2.decomposeProjectionMatrix (used at DVRDataset.py:163); uses cv2 when
    available, else an RQ-decomposition fallback."""
    try:
        import cv2

        K, R, t = cv2.decomposeProjectionMatrix(P)[:3]
        return K, R, t
    except Exception:
        # RQ decomposition of the left 3x3
        M = P[:, :3]
        # Build RQ from QR of reversed matrix
        rev = np.flipud(np.fliplr(M.T))
        q, r = np.linalg.qr(rev)
        K = np.flipud(np.fliplr(r.T))
        R = np.flipud(np.fliplr(q.T))
        # enforce positive diagonal of K
        signs = np.sign(np.diag(K))
        K = K * signs[None, :]
        R = R * signs[:, None]
        # camera center: solve P c = 0 (homogeneous)
        _, _, vh = np.linalg.svd(np.vstack([P, [0, 0, 0, 1]])[:3])
        c = vh[-1]
        return K, R, c[:, None] if c.ndim == 1 else c


class DVRDataset:
    def __init__(
        self,
        path: str,
        stage: str = "train",
        list_prefix: str = "softras_",
        image_size: Optional[Tuple[int, int]] = None,
        sub_format: str = "shapenet",
        scale_focal: bool = True,
        max_imgs: int = 100000,
        z_near: float = 1.2,
        z_far: float = 4.0,
        seed: int = 1234,
    ):
        self.base_path = path
        assert os.path.exists(self.base_path)

        cats = [x for x in glob.glob(os.path.join(path, "*")) if os.path.isdir(x)]
        file_lists = [os.path.join(x, f"{list_prefix}{stage}.lst") for x in cats]

        all_objs = []
        for file_list in file_lists:
            if not os.path.exists(file_list):
                continue
            base_dir = os.path.dirname(file_list)
            cat = os.path.basename(base_dir)
            with open(file_list) as f:
                all_objs.extend(
                    (cat, os.path.join(base_dir, x.strip()))
                    for x in f
                    if x.strip()
                )

        self.all_objs = all_objs
        self.stage = stage
        self.image_size = tuple(image_size) if image_size else None
        self.sub_format = sub_format
        self.scale_focal = scale_focal
        self.max_imgs = max_imgs
        self.z_near = z_near
        self.z_far = z_far
        self.lindisp = False
        self._rng = np.random.default_rng(seed)

        if sub_format == "dtu":
            self._trans_world = _TRANS_DTU
            self._trans_cam = _TRANS_DTU
        else:
            self._trans_world = _TRANS_WORLD_SHAPENET
            self._trans_cam = _TRANS_CAM_SHAPENET

    def __len__(self) -> int:
        return len(self.all_objs)

    def __getitem__(self, index: int) -> dict:
        cat, root_dir = self.all_objs[index]

        rgb_paths = sorted(
            x
            for x in glob.glob(os.path.join(root_dir, "image", "*"))
            if x.endswith((".jpg", ".png"))
        )
        mask_paths = sorted(glob.glob(os.path.join(root_dir, "mask", "*.png")))
        if len(mask_paths) == 0:
            mask_paths = [None] * len(rgb_paths)

        if len(rgb_paths) <= self.max_imgs:
            sel_indices = np.arange(len(rgb_paths))
        else:
            sel_indices = self._rng.choice(
                len(rgb_paths), self.max_imgs, replace=False
            )
            rgb_paths = [rgb_paths[i] for i in sel_indices]
            mask_paths = [mask_paths[i] for i in sel_indices]

        all_cam = np.load(os.path.join(root_dir, "cameras.npz"))

        # decode all views in one threaded native call
        raw_imgs = load_images(rgb_paths)
        raw_masks = (
            load_images([m for m in mask_paths if m is not None])
            if any(m is not None for m in mask_paths)
            else []
        )
        mask_iter = iter(raw_masks)

        imgs, poses, masks, bboxes = [], [], [], []
        focal = None
        fx = fy = cx = cy = 0.0
        have_masks = False

        for idx, (rgb_path, mask_path) in enumerate(zip(rgb_paths, mask_paths)):
            i = sel_indices[idx]
            img = raw_imgs[idx][..., :3]
            if self.scale_focal:
                x_scale = img.shape[1] / 2.0
                y_scale = img.shape[0] / 2.0
                xy_delta = 1.0
            else:
                x_scale = y_scale = 1.0
                xy_delta = 0.0

            if self.sub_format == "dtu":
                P = all_cam[f"world_mat_{i}"][:3]
                K, R, t = decompose_projection(P)
                K = K / K[2, 2]

                pose = np.eye(4, dtype=np.float32)
                pose[:3, :3] = R.T
                pose[:3, 3] = (t[:3] / t[3])[:, 0]

                scale_mtx = all_cam.get(f"scale_mat_{i}")
                if scale_mtx is not None:
                    norm_trans = scale_mtx[:3, 3:]
                    norm_scale = np.diagonal(scale_mtx[:3, :3])[..., None]
                    pose[:3, 3:] -= norm_trans
                    pose[:3, 3:] /= norm_scale

                fx += K[0, 0] * x_scale
                fy += K[1, 1] * y_scale
                cx += (K[0, 2] + xy_delta) * x_scale
                cy += (K[1, 2] + xy_delta) * y_scale
            else:
                wmat_inv_key = f"world_mat_inv_{i}"
                if wmat_inv_key in all_cam:
                    extr_inv = all_cam[wmat_inv_key]
                else:
                    extr = all_cam[f"world_mat_{i}"]
                    if extr.shape[0] == 3:
                        extr = np.vstack([extr, [0, 0, 0, 1]])
                    extr_inv = np.linalg.inv(extr)
                intr = all_cam[f"camera_mat_{i}"]
                fxi, fyi = intr[0, 0], intr[1, 1]
                assert abs(fxi - fyi) < 1e-9
                fxi = fxi * x_scale
                if focal is None:
                    focal = fxi
                else:
                    assert abs(fxi - focal) < 1e-5
                pose = extr_inv

            pose = (
                self._trans_world
                @ pose.astype(np.float32)
                @ self._trans_cam
            )

            if mask_path is not None:
                have_masks = True
                mask = next(mask_iter)[..., :1]
                masks.append((mask > 0).astype(np.float32))
                bboxes.append(bbox_from_mask(mask))

            imgs.append(image_to_balanced(img))
            poses.append(pose)

        images = np.stack(imgs)
        poses = np.stack(poses).astype(np.float32)

        c = None
        if self.sub_format != "shapenet":
            n = len(rgb_paths)
            focal = np.array([fx / n, fy / n], dtype=np.float32)
            c = np.array([cx / n, cy / n], dtype=np.float32)
            bboxes = None
        elif have_masks:
            bboxes = np.stack(bboxes)
        else:
            bboxes = None
        masks_arr = np.stack(masks) if have_masks else None
        focal = np.asarray(focal, dtype=np.float32)

        if self.image_size is not None and images.shape[1:3] != self.image_size:
            scale = self.image_size[0] / images.shape[1]
            focal = focal * scale
            if c is not None:
                c = c * scale
            if bboxes is not None:
                bboxes = bboxes * scale
            images = resize_area_np(images, self.image_size)
            if masks_arr is not None:
                masks_arr = resize_area_np(masks_arr, self.image_size)

        result = {
            "path": root_dir,
            "img_id": index,
            "focal": focal,
            "images": images,
            "poses": poses,
        }
        if masks_arr is not None:
            result["masks"] = masks_arr
        if c is not None:
            result["c"] = c
        elif bboxes is not None:
            result["bbox"] = bboxes
        return result
