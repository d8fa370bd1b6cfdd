"""Port torchvision ImageNet ResNet weights into a checkpoint of the port.

Counterpart of `pixelnerf_tpu/tools/port_encoder_weights.py`: reproduces
the reference's `pretrained=True` encoder initialization (reference
src/model/encoder.py:62-68, torchvision resnet18/34 with ImageNet
weights) from a local weights file, since nothing is downloaded. Given a
torchvision state_dict (``.pth``/``.pt``, or an ``.npz`` with the same
keys) it converts the trunk the encoder runs (the stem and `num_stages`
residual stages) and writes it into an experiment checkpoint, in place of
the randomly initialized trunk at `encoder.model`, or to a standalone
``.npz`` in the JAX tool's layout (`params/...` and `batch_stats/...`
keys). The checkpoint may be the port's torch file or a flax msgpack one
(the JAX package's); each is written back in its own format.

Usage:
    python -m pixelnerf_tpu_torch.tools.port_encoder_weights \\
        --weights resnet34-imagenet.pth --backbone resnet34 \\
        --checkpoint checkpoints/srn_car/pixel_nerf_latest
    python -m pixelnerf_tpu_torch.tools.port_encoder_weights \\
        --weights resnet34-imagenet.pth --backbone resnet34 --out enc.npz
"""

from __future__ import annotations

import argparse
from typing import Any, Dict

import numpy as np

from pixelnerf_tpu_torch.models.resnet import STAGE_BLOCKS


def _load_state_dict(path: str) -> Dict[str, np.ndarray]:
    if path.endswith(".npz"):
        return dict(np.load(path))
    import torch

    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return sd


def port_torchvision_resnet(state_dict, backbone: str = "resnet34", num_stages: int = 3):
    """(params, batch_stats) of the trunk in the JAX layout (HWIO kernels,
    BatchNorm scale/bias and mean/var) for a torchvision ResNet state_dict
    of numpy arrays or tensors; the JAX package's function of the same
    name."""

    def to_np(v):
        return np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach") else v)

    def conv_kernel(key):
        return np.transpose(to_np(state_dict[key]), (2, 3, 1, 0))  # OIHW -> HWIO

    def bn(prefix):
        return ({"scale": to_np(state_dict[prefix + ".weight"]),
                 "bias": to_np(state_dict[prefix + ".bias"])},
                {"mean": to_np(state_dict[prefix + ".running_mean"]),
                 "var": to_np(state_dict[prefix + ".running_var"])})

    params: Dict[str, Any] = {"conv1": {"kernel": conv_kernel("conv1.weight")}}
    stats: Dict[str, Any] = {}
    params["bn1"], stats["bn1"] = bn("bn1")
    for stage in range(num_stages):
        for blk in range(STAGE_BLOCKS[backbone][stage]):
            src, dst = f"layer{stage + 1}.{blk}", f"layer{stage + 1}_{blk}"
            p = {"conv1": {"kernel": conv_kernel(src + ".conv1.weight")},
                 "conv2": {"kernel": conv_kernel(src + ".conv2.weight")}}
            s: Dict[str, Any] = {}
            p["bn1"], s["bn1"] = bn(src + ".bn1")
            p["bn2"], s["bn2"] = bn(src + ".bn2")
            if src + ".downsample.0.weight" in state_dict:
                p["downsample_conv"] = {"kernel": conv_kernel(src + ".downsample.0.weight")}
                p["downsample_bn"], s["downsample_bn"] = bn(src + ".downsample.1")
            params[dst], stats[dst] = p, s
    return params, stats


def _flat(tree, prefix=""):
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat(v, key)
        else:
            yield key, np.asarray(v)


def update_checkpoint(path: str, params, stats) -> None:
    """Put the trunk at `encoder/model` (`encoder.model.*`) of the
    checkpoint at `path`, in the file's own format."""
    from pixelnerf_tpu_torch.utils import checkpoint as ckpt

    if ckpt.is_flax_checkpoint(path):
        tree = ckpt.read_flax_msgpack(path)
        tree["params"]["encoder"]["model"] = params
        tree.setdefault("batch_stats", {}).setdefault("encoder", {})["model"] = stats
        ckpt.write_flax_msgpack(path, tree, sort_keys=False)  # as the JAX package's writer
        return
    from pixelnerf_tpu_torch.convert import state_dict_from_jax

    sd = ckpt.load_state(path, "cpu")
    trunk = state_dict_from_jax({"params": params, "batch_stats": stats})
    for k, v in trunk.items():
        name = "encoder.model." + k
        if name not in sd or tuple(sd[name].shape) != tuple(v.shape):
            raise ValueError(f"{path}: no trunk entry {name} of shape {tuple(v.shape)}")
        sd[name] = v
    ckpt.save_state(path, sd)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--weights", required=True, help=".pth/.pt/.npz state_dict")
    parser.add_argument("--backbone", default="resnet34", choices=("resnet18", "resnet34"))
    parser.add_argument("--num_stages", type=int, default=3, help="encoder num_layers - 1")
    parser.add_argument("--checkpoint", default=None,
                        help="experiment checkpoint to update in place")
    parser.add_argument("--out", default=None, help="standalone .npz output")
    args = parser.parse_args(argv)
    if not args.checkpoint and not args.out:
        parser.error("give --checkpoint and/or --out")

    params, stats = port_torchvision_resnet(
        _load_state_dict(args.weights), backbone=args.backbone, num_stages=args.num_stages
    )
    n = sum(v.size for _, v in _flat(params))
    print(f"ported {n/1e6:.2f}M params ({args.backbone}, {args.num_stages} stages)")
    if args.checkpoint:
        update_checkpoint(args.checkpoint, params, stats)
        print(f"updated encoder trunk in {args.checkpoint}")
    if args.out:
        np.savez(args.out, **dict(_flat(params, "params")), **dict(_flat(stats, "batch_stats")))
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
