"""Video writing.

Counterpart of `pixelnerf_tpu/utils/video.py`: imageio's mp4 writer where
imageio and its ffmpeg plugin are installed; otherwise a GIF written with
Pillow under the caller's basename, and a line saying so, as the JAX
writer falls back to a GIF when its mp4 plugin is missing.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np

__all__ = ["write_video"]


def _write_gif(path: str, frames: np.ndarray, fps: int) -> str:
    """Frames (T, H, W, 3) uint8 as a looping GIF through Pillow."""
    from PIL import Image

    images = [Image.fromarray(np.ascontiguousarray(f)) for f in frames]
    images[0].save(path, format="GIF", save_all=True, append_images=images[1:],
                   duration=max(1, round(1000 / fps)), loop=0)
    return path


def write_video(path: str, frames: Sequence[np.ndarray], fps: int = 30, quality: int = 8) -> str:
    """Write frames (T, H, W, 3) uint8; returns the path actually written
    (the same basename with `.gif` where no mp4 writer is available)."""
    frames = np.asarray(frames)
    if path.endswith(".gif"):
        return _write_gif(path, frames, fps)
    try:
        import imageio.v2 as imageio

        imageio.mimwrite(path, frames, fps=fps, quality=quality)
        return path
    except Exception as e:  # no imageio, or no ffmpeg plugin for it
        gif_path = os.path.splitext(path)[0] + ".gif"
        _write_gif(gif_path, frames, fps)
        print(f"WARN: mp4 writer unavailable ({type(e).__name__}); wrote {gif_path} instead")
        return gif_path
