"""Checkpoint I/O with latest/backup/init semantics, in torch.

Counterpart of `pixelnerf_tpu/utils/checkpoint.py`, with the reference's
crash-safe layout under checkpoints/<exp>/ (reference
src/model/models.py:268-316, train/trainlib/trainer.py:67-114, 202-215):

* pixel_nerf_latest  - the model's state_dict() (parameters and BatchNorm
  buffers)
* pixel_nerf_init    - optional warm-start checkpoint, read when not resuming
* pixel_nerf_backup  - the previous latest, copied before each overwrite
* _optim             - the optimizer's state_dict()
* _iter.json         - {"iter": step, "epoch": epoch} (train/trainer.py)

Files are written with `torch.save` to a `.tmp` file and moved into place
with `os.replace`, and read with `map_location` set to the model's device,
so a checkpoint written on the card loads on the CPU.

The JAX package writes flax msgpack files under the same names
(`pixelnerf_tpu/utils/checkpoint.py:35-44`), and its bf16 artifacts
(`artifacts/*.ckpt`, `pixelnerf_tpu/tools/export_checkpoint.py`) are the
same format with bf16 leaves. `read_flax_msgpack` decodes them without
flax, msgpack or ml_dtypes: a small msgpack reader of its own for maps,
arrays, strings, binaries, ints, floats and flax's ndarray ext records
(ext code 1: a packed (shape, dtype name, raw bytes); 3, a numpy scalar),
and flax's chunked arrays. A bfloat16 leaf becomes float32 by shifting its
uint16 bits into the top half of a uint32, which is exact. `load_state`
returns such a file's tree of numpy arrays, and `load_model_weights`
loads a JAX checkpoint of the model (`{"params", "batch_stats"}`) through
`convert.state_dict_from_jax`, so a live f32 `pixel_nerf_latest` and a
bf16 artifact both load directly.
"""

from __future__ import annotations

import os
import struct
import zipfile
from shutil import copyfile
from typing import Any, Optional

import numpy as np
import torch

__all__ = [
    "is_flax_checkpoint",
    "read_flax_msgpack",
    "save_state",
    "load_state",
    "load_weights_file",
    "save_model_weights",
    "load_model_weights",
]

# first bytes of a msgpack map (fixmap, map16, map32): a flax checkpoint
_MSGPACK_MAP = set(range(0x80, 0x90)) | {0xDE, 0xDF}
# flax's msgpack ext codes (flax/serialization.py:_MsgpackExtType)
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


class _Reader:
    """A msgpack decoder over one bytes object (the subset flax writes)."""

    def __init__(self, data: bytes):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        fixed = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in fixed:
            return fixed[b]
        sized = {  # lead byte: (size format, what follows)
            0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
            0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
            0xDC: (">H", "array"), 0xDD: (">I", "array"),
            0xDE: (">H", "map"), 0xDF: (">I", "map"),
            0xC7: (">B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext"),
        }
        if b in sized:
            fmt, kind = sized[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return str(self.take(n), "utf-8")
            if kind == "array":
                return self.array(n)
            if kind == "map":
                return self.map(n)
            return self.ext(n)
        if 0xD4 <= b <= 0xD8:  # fixext 1, 2, 4, 8, 16
            return self.ext(1 << (b - 0xD4))
        scalars = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in scalars:
            return self.unpack(scalars[b])
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        data = bytes(self.take(n))
        if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
            arr = _ndarray(data)
            return arr[()] if code == _EXT_NPSCALAR else arr
        if code == _EXT_COMPLEX:
            re, im = _Reader(data).value()
            return complex(re, im)
        raise ValueError(f"unsupported msgpack ext code {code}")


def _ndarray(data: bytes) -> np.ndarray:
    """One flax ndarray record: msgpack (shape, dtype name, C-order bytes);
    bfloat16 as float32, exactly."""
    shape, name, raw = _Reader(data).value()
    if isinstance(name, bytes):
        name = name.decode()
    if name == "bfloat16":
        bits = np.frombuffer(raw, dtype="<u2").astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(raw, dtype=np.dtype(name).newbyteorder("<")).reshape(shape).copy()


def _unchunk(tree):
    """flax's chunked array leaves (`_chunk`) back into arrays."""
    if not isinstance(tree, dict):
        return tree
    if "__msgpack_chunked_array__" in tree:
        as_tuple = lambda d: tuple(d[str(i)] for i in range(len(d)))
        return np.concatenate(as_tuple(tree["chunks"])).reshape(as_tuple(tree["shape"]))
    return {k: _unchunk(v) for k, v in tree.items()}


def read_flax_msgpack(path: str) -> Any:
    """The tree of a flax msgpack file (`flax.serialization.to_bytes` /
    `msgpack_serialize`): nested dicts of numpy arrays and Python values,
    as `flax.serialization.msgpack_restore` gives it, bfloat16 leaves as
    float32."""
    with open(path, "rb") as f:
        reader = _Reader(f.read())
    tree = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError(f"{path}: trailing bytes after the msgpack tree")
    return _unchunk(tree)


def is_flax_checkpoint(path: str) -> bool:
    """Is `path` a flax msgpack file (a map), not a torch zip?"""
    if zipfile.is_zipfile(path):
        return False
    with open(path, "rb") as f:
        head = f.read(1)
    return bool(head) and head[0] in _MSGPACK_MAP


def save_state(path: str, obj: Any) -> None:
    """torch.save `obj` to `path` through a `.tmp` file and os.replace."""
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def load_state(path: str, device=None) -> Any:
    """torch.load a file `save_state` wrote, tensors mapped to `device`; a
    flax msgpack file of the JAX package gives its tree of numpy arrays
    (`read_flax_msgpack`)."""
    if is_flax_checkpoint(path):
        return read_flax_msgpack(path)
    if not zipfile.is_zipfile(path):
        raise ValueError(f"{path} is neither a torch nor a flax msgpack checkpoint")
    return torch.load(path, map_location=device, weights_only=True)


def load_weights_file(model: torch.nn.Module, path: str) -> None:
    """Load one weights file into `model`: a torch state_dict, or a JAX
    checkpoint's `{"params", "batch_stats"}` (f32 or a bf16 artifact)
    through `convert.state_dict_from_jax`, which checks every key and
    shape against the model."""
    from pixelnerf_tpu_torch.convert import state_dict_from_jax

    device = next(model.parameters()).device
    state = load_state(path, device)
    if is_flax_checkpoint(path):
        state = state_dict_from_jax(state, model)
    model.load_state_dict(state)


def _ckpt_paths(checkpoints_path: str, name: str, opt_init: bool):
    ckpt_name = "pixel_nerf_init" if opt_init else "pixel_nerf_latest"
    backup_name = "pixel_nerf_init_backup" if opt_init else "pixel_nerf_backup"
    d = os.path.join(checkpoints_path, name)
    return os.path.join(d, ckpt_name), os.path.join(d, backup_name)


def save_model_weights(
    model: torch.nn.Module, checkpoints_path: str, name: str, opt_init: bool = False
) -> str:
    """Save the model's state_dict, backing up the previous checkpoint
    first (reference models.py:300-316)."""
    ckpt_path, backup_path = _ckpt_paths(checkpoints_path, name, opt_init)
    os.makedirs(os.path.dirname(ckpt_path), exist_ok=True)
    if os.path.exists(ckpt_path):
        copyfile(ckpt_path, backup_path)
    save_state(ckpt_path, model.state_dict())
    return ckpt_path


def load_model_weights(
    model: torch.nn.Module,
    checkpoints_path: str,
    name: str,
    resume: bool = False,
    opt_init: bool = False,
) -> Optional[str]:
    """Load weights into `model` by the reference's rules (models.py:
    268-298): the init checkpoint when not resuming (if present), else the
    latest, a torch or a JAX file (`load_weights_file`). Returns the path
    loaded, or None (the model keeps its weights)."""
    if opt_init and not resume:
        return None
    ckpt_name = "pixel_nerf_init" if (opt_init or not resume) else "pixel_nerf_latest"
    path = os.path.join(checkpoints_path, name, ckpt_name)
    if os.path.exists(path):
        print("Load", path)
        load_weights_file(model, path)
        return path
    if not opt_init and resume:
        import warnings

        warnings.warn(
            f"WARNING: {path} does not exist, not loaded!! Model will be re-initialized."
        )
    return None
