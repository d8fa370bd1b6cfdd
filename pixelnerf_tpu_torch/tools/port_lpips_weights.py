"""Port torch LPIPS(VGG) weights to the metric's .npz format.

Mirrors tools/port_encoder_weights.py: given torch state-dict files (or
.npz re-dumps of them), emit the parameter file `utils/lpips.py` loads
(the same file, byte for byte, as the JAX package's tool writes), so
`calc_metrics` produces LPIPS (reference eval/calc_metrics.py:150-156) the
moment weights exist.

Usage:
    # torchvision vgg16 + the lpips package's lin heads (vgg.pth from
    # lpips/weights/v0.1/vgg.pth)
    python -m pixelnerf_tpu_torch.tools.port_lpips_weights \
        --vgg vgg16-imagenet.pth --lins vgg.pth --out lpips_vgg.npz
    # or one full lpips.LPIPS state dict (contains both)
    python -m pixelnerf_tpu_torch.tools.port_lpips_weights \
        --vgg lpips_full.pth --out lpips_vgg.npz

Default --out is the metric's search path
($PIXELNERF_LPIPS_WEIGHTS, else checkpoints/lpips_vgg.npz in the
repository).
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from pixelnerf_tpu_torch.utils.lpips import (
    VGG_CFG,
    default_weights_path,
    params_from_state_dicts,
)


def _load_state_dict(path: str):
    if path.endswith(".npz"):
        return dict(np.load(path))
    import torch

    sd = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return {k: v.numpy() for k, v in sd.items()}


def save_params(params, out: str) -> None:
    arrays = {}
    for i, (w, b) in enumerate(params["convs"]):
        arrays[f"conv{i}_w"] = w
        arrays[f"conv{i}_b"] = b
    for i, lin in enumerate(params["lins"]):
        arrays[f"lin{i}"] = lin
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    np.savez(out, **arrays)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument(
        "--vgg", required=True,
        help="torchvision vgg16 state dict, or a full lpips.LPIPS one",
    )
    parser.add_argument(
        "--lins", default=None,
        help="lpips lin-head state dict (weights/v0.1/vgg.pth) when not "
        "inside --vgg",
    )
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)

    vgg_sd = _load_state_dict(args.vgg)
    lin_sd = _load_state_dict(args.lins) if args.lins else None
    params = params_from_state_dicts(vgg_sd, lin_sd)
    out = args.out or default_weights_path()
    save_params(params, out)
    print(
        f"ported {len(VGG_CFG)} convs + 5 lin heads -> {out}"
    )


if __name__ == "__main__":
    main()
