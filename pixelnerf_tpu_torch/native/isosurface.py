"""Iso-surface extraction on the host: the repository's
`native/isosurface.cpp` (marching tetrahedra with vertex dedup), built
with `g++` and bound with `ctypes`.

Counterpart of `pixelnerf_tpu/native/build.py:load_isosurface`. The
library is compiled at first use into `build/pixelnerf_tpu_torch/native/`
at the repository root, named by a hash of its source; it needs only the
C++ standard library. A failed build raises: there is no substitute.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Callable, Tuple

import numpy as np

__all__ = ["load_isosurface"]

_ROOT = Path(__file__).resolve().parents[2]
_SRC = _ROOT / "native" / "isosurface.cpp"
_BUILD_DIR = _ROOT / "build" / "pixelnerf_tpu_torch" / "native"


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    out = _BUILD_DIR / f"libisosurface_{digest}.so"
    if not out.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-o", str(tmp), str(_SRC)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"building {_SRC.name} failed:\n{proc.stderr.strip()}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    lib.mt_extract.restype = ctypes.c_int
    lib.mt_extract.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)), ctypes.POINTER(ctypes.c_longlong),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int)), ctypes.POINTER(ctypes.c_longlong),
    ]
    lib.mt_free.restype = None
    lib.mt_free.argtypes = [ctypes.c_void_p]
    return lib


def load_isosurface() -> Callable[[np.ndarray, float], Tuple[np.ndarray, np.ndarray]]:
    """extract(volume (nx, ny, nz) float32, iso) -> (verts (V, 3) float32
    in grid coordinates, tris (T, 3) int32)."""
    lib = _library()

    def extract(volume: np.ndarray, iso: float):
        vol = np.ascontiguousarray(volume, dtype=np.float32)
        if vol.ndim != 3:
            raise ValueError(f"volume must be (nx, ny, nz), got {vol.shape}")
        vp, tp = ctypes.POINTER(ctypes.c_float)(), ctypes.POINTER(ctypes.c_int)()
        nv, nt = ctypes.c_longlong(), ctypes.c_longlong()
        rc = lib.mt_extract(vol.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), *vol.shape,
                            ctypes.c_float(iso), ctypes.byref(vp), ctypes.byref(nv),
                            ctypes.byref(tp), ctypes.byref(nt))
        if rc != 0:
            raise RuntimeError(f"mt_extract failed with code {rc}")
        try:
            verts = (np.ctypeslib.as_array(vp, shape=(nv.value, 3)).copy() if nv.value
                     else np.zeros((0, 3), np.float32))
            tris = (np.ctypeslib.as_array(tp, shape=(nt.value, 3)).copy() if nt.value
                    else np.zeros((0, 3), np.int32))
        finally:
            lib.mt_free(vp)
            lib.mt_free(tp)
        return verts, tris

    return extract
