"""Shared eval plumbing.

Counterpart of `pixelnerf_tpu/eval/common.py:encode_views`.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["encode_views"]


def encode_views(model, images, poses, focal, c=None):
    """Encode (NS, H, W, 3) source views into a SceneEncoding (SB=1) on
    the model's device."""
    device = model.device
    focal = np.asarray(focal, dtype=np.float32).reshape(-1)
    focal = torch.from_numpy(focal[:1] if focal.size == 1 else focal[None])
    c_t = None
    if c is not None:
        c_t = torch.from_numpy(np.asarray(c, dtype=np.float32))[None]
    with torch.inference_mode():
        return model.encode(
            torch.as_tensor(images, device=device)[None],
            torch.as_tensor(poses, device=device)[None],
            focal,
            c_t,
        )
