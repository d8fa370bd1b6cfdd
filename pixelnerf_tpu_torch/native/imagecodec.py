"""Multi-threaded PNG/JPEG decoding on the host: the repository's
`native/imagecodec.cpp`, built with `g++` and bound with `ctypes`.

Counterpart of `pixelnerf_tpu/native/{build,imagecodec}.py`. The library
is compiled at first use into `build/pixelnerf_tpu_torch/native/` at the
repository root, named by a hash of its source; it needs libpng and
libjpeg. Where it cannot be built or loaded, `decode_batch` returns None
and the callers (`data/common.py`) read with Pillow. `decoder()` says
which one ran, and why the library is missing, so the choice is never
silent.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

__all__ = ["available", "decode_batch", "decoder"]

_ROOT = Path(__file__).resolve().parents[2]
_SRC = _ROOT / "native" / "imagecodec.cpp"
_BUILD_DIR = _ROOT / "build" / "pixelnerf_tpu_torch" / "native"

_lock = threading.Lock()
_state = {"lib": None, "error": None}


def _build() -> ctypes.CDLL:
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    out = _BUILD_DIR / f"libimagecodec_{digest}.so"
    if not out.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-o", str(tmp), str(_SRC),
               "-lpng", "-ljpeg", "-pthread"]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed: {proc.stderr.strip().splitlines()[:1]}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    lib.img_decode_batch.restype = ctypes.c_int
    lib.img_decode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_ubyte)),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    lib.img_free.restype = None
    lib.img_free.argtypes = [ctypes.c_void_p]
    return lib


def _get_lib() -> Optional[ctypes.CDLL]:
    with _lock:
        if _state["lib"] is None and _state["error"] is None:
            try:
                _state["lib"] = _build()
            except (OSError, RuntimeError) as e:
                _state["error"] = f"{type(e).__name__}: {e}"
        return _state["lib"]


def available() -> bool:
    return _get_lib() is not None


def decoder() -> str:
    """'native', or 'pillow' with the reason the library is missing."""
    if available():
        return "native"
    return f"pillow (native/imagecodec.cpp not built: {_state['error']})"


def decode_batch(paths: List[str], num_threads: int = 0) -> Optional[List[np.ndarray]]:
    """Decode files concurrently to (H, W, C) uint8 arrays: C is 4 where
    the source had alpha (RGBA or gray + alpha), else 3. None when the
    library is missing or any file failed: the caller reads with Pillow."""
    lib = _get_lib()
    if lib is None or not paths:
        return None
    n = len(paths)
    c_paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    outs = (ctypes.POINTER(ctypes.c_ubyte) * n)()
    ws, hs, chs = ((ctypes.c_int * n)() for _ in range(3))
    failures = lib.img_decode_batch(c_paths, n, num_threads, outs, ws, hs, chs)
    try:
        if failures:
            return None
        result = []
        for i in range(n):
            rgba = np.ctypeslib.as_array(outs[i], shape=(hs[i], ws[i], 4))
            # keep a real alpha channel (2 = gray + alpha, 4 = RGBA), drop
            # the opaque one the decoder adds
            result.append(rgba.copy() if chs[i] in (2, 4) else rgba[..., :3].copy())
        return result
    finally:
        for i in range(n):
            if outs[i]:
                lib.img_free(outs[i])
