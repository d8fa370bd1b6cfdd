"""Build and load the package's CUDA sources.

Each `csrc/<name>.cu` has a plain C interface and is compiled by `nvcc`
for `sm_90a` into a shared library under `build/pixelnerf_tpu_torch/` at
the repository root, named by a hash of its source, of the shared
headers (`csrc/*.cuh`) and of `SMEM_LIMIT` (which the headers read as
`PNT_SMEM_LIMIT`), at first use; the library is loaded with `ctypes`.
`build_libraries` starts one `nvcc` per source, all at once. Nothing is
built when a module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["build_libraries", "load_library", "nvcc_command", "SOURCES", "SMEM_LIMIT"]

_PKG = Path(__file__).resolve().parents[1]
_SRC_DIR = _PKG / "csrc"
_BUILD_DIR = _PKG.parent / "build" / "pixelnerf_tpu_torch"
SOURCES = ("bilerp", "field_fwd", "posenc", "pyramid", "resnetfc_fwd", "resnetfc_bwd")
SMEM_LIMIT = 232448  # dynamic shared memory one Hopper block may use


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
    h = hashlib.sha256((_SRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(_SRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(str(SMEM_LIMIT).encode())
    digest = h.hexdigest()[:16]
    return _BUILD_DIR / f"lib{name}_{digest}.so"


def nvcc_command(source: Path, out: Path) -> list:
    """The nvcc command that builds one source into a shared library."""
    return [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", f"-DPNT_SMEM_LIMIT={SMEM_LIMIT}",
        "-o", str(out), str(source),
    ]


def build_libraries(names) -> dict:
    """Compile each `csrc/<name>.cu` whose library is not current, one
    `nvcc` per source, all started together. Returns each name's compiler
    output (register and shared-memory use from `-Xptxas -v`), empty when
    nothing was built; raises if any build failed."""
    started = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            nvcc_command(_SRC_DIR / f"{name}.cu", tmp), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        started[name] = (proc, tmp, out)
    logs, failed = {name: "" for name in names}, []
    for name, (proc, tmp, out) in started.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{logs[name]}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    build_libraries([name])
    return ctypes.CDLL(str(_lib_path(name)))
