"""Build and load the package's CUDA sources.

Each `csrc/<name>.cu` has a plain C interface and is compiled by `nvcc`
for `sm_90a` into a shared library under `build/pixelnerf_tpu_torch/` at
the repository root, named by a hash of its source, at first use; the
library is loaded with `ctypes`. Nothing is built when a module is
imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["build_library", "load_library"]

_PKG = Path(__file__).resolve().parents[1]
_SRC_DIR = _PKG / "csrc"
_BUILD_DIR = _PKG.parent / "build" / "pixelnerf_tpu_torch"


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home and (Path(cuda_home) / "bin" / "nvcc").exists():
        return str(Path(cuda_home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _lib_path(name: str) -> Path:
    src = (_SRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src).hexdigest()[:16]
    return _BUILD_DIR / f"lib{name}_{digest}.so"


def _command(name: str, out: Path) -> list:
    return [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
        "-o", str(out), str(_SRC_DIR / f"{name}.cu"),
    ]


def build_library(name: str) -> str:
    """Compile `csrc/<name>.cu` unless its library is current. Returns the
    compiler's output (register and shared-memory use from `-Xptxas -v`),
    empty when nothing was built."""
    out = _lib_path(name)
    if out.exists():
        return ""
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        _command(name, tmp), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}")
    os.replace(tmp, out)
    return proc.stdout


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    build_library(name)
    return ctypes.CDLL(str(_lib_path(name)))
