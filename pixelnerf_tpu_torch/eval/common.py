"""Shared eval plumbing: the model, its weights and the dataset from the
CLI's arguments, and the encoding of source views.

Counterpart of `pixelnerf_tpu/eval/common.py` (`load_model_and_dataset`,
`encode_views`).
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from pixelnerf_tpu_torch.device import resolve_device

__all__ = ["load_model_and_dataset", "encode_views", "without_fine"]


def load_model_and_dataset(args, conf, want_split: str, device=None):
    """(model, dataset, RendererConfig): the model from `conf` on `device`
    (CUDA unless the caller names one) in eval mode, with the latest
    checkpoint of `args.name` loaded (a torch file or a JAX one, bf16
    artifacts included; missing, the model keeps its seeded weights with a
    warning, as the JAX CLIs keep their init), and the split opened at
    `args.image_size` where given. Mirrors the preamble every reference
    eval script repeats (e.g. eval/gen_video.py:66-110)."""
    from pixelnerf_tpu_torch.data import get_split_dataset
    from pixelnerf_tpu_torch.models.pixelnerf import make_model
    from pixelnerf_tpu_torch.render.renderer import RendererConfig
    from pixelnerf_tpu_torch.utils import checkpoint as ckpt_io

    device = resolve_device(device)
    size_kw = {"image_size": tuple(args.image_size)} if getattr(args, "image_size", None) else {}
    dset = get_split_dataset(args.dataset_format, args.datadir, want_split=want_split,
                             training=False, **size_kw)
    model = make_model(conf["model"], device=device)
    ckpt_io.load_model_weights(model, args.checkpoints_path, args.name, resume=True)
    rcfg = RendererConfig.from_conf(conf["renderer"], lindisp=dset.lindisp)
    return model, dset, rcfg


def without_fine(model):
    """A shallow copy of `model` sharing every parameter, without its fine
    head: fine queries then take the coarse head (the JAX package's
    `model.clone(mlp_fine=None)`)."""
    out = copy.copy(model)
    out._modules = dict(model._modules)
    out.mlp_fine = None
    return out


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
