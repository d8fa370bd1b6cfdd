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
so a checkpoint written on the card loads on the CPU. The JAX package
writes flax msgpack files under the same names; reading those is not
ported yet (ROADMAP queue 1 item 3), and such a file raises
`JaxCheckpointError` rather than loading as something else.
"""

from __future__ import annotations

import os
import zipfile
from shutil import copyfile
from typing import Any, Optional

import torch

__all__ = [
    "JaxCheckpointError",
    "save_state",
    "load_state",
    "save_model_weights",
    "load_model_weights",
]

# first bytes of a msgpack map (fixmap, map16, map32): a flax checkpoint
_MSGPACK_MAP = set(range(0x80, 0x90)) | {0xDE, 0xDF}


class JaxCheckpointError(ValueError):
    """A checkpoint of the JAX package (flax msgpack) met where a torch one
    was expected."""


def save_state(path: str, obj: Any) -> None:
    """torch.save `obj` to `path` through a `.tmp` file and os.replace."""
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def load_state(path: str, device=None) -> Any:
    """torch.load a file `save_state` wrote, tensors mapped to `device`."""
    if not zipfile.is_zipfile(path):
        with open(path, "rb") as f:
            head = f.read(1)
        if head and head[0] in _MSGPACK_MAP:
            raise JaxCheckpointError(
                f"{path} is a flax msgpack checkpoint of the JAX package; reading those is "
                "not ported yet (ROADMAP queue 1 item 3)"
            )
        raise ValueError(f"{path} is not a torch checkpoint")
    return torch.load(path, map_location=device, weights_only=True)


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
    latest. Returns the path loaded, or None (the model keeps its weights)."""
    if opt_init and not resume:
        return None
    ckpt_name = "pixel_nerf_init" if (opt_init or not resume) else "pixel_nerf_latest"
    path = os.path.join(checkpoints_path, name, ckpt_name)
    if os.path.exists(path):
        print("Load", path)
        device = next(model.parameters()).device
        model.load_state_dict(load_state(path, device))
        return path
    if not opt_init and resume:
        import warnings

        warnings.warn(
            f"WARNING: {path} does not exist, not loaded!! Model will be re-initialized."
        )
    return None
