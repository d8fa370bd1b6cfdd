"""LPIPS (VGG16) perceptual distance in torch.

Counterpart of `pixelnerf_tpu/utils/lpips_jax.py`: the `lpips` package's
metric (v0.1, net='vgg', spatial=False; the reference's
eval/calc_metrics.py:150-156) computed natively, from the same parameter
tree:

1. scale the [-1, 1] inputs, (x - shift) / scale per channel (the
   package's ScalingLayer buffers),
2. VGG16 feature taps after relu1_2, relu2_2, relu3_3, relu4_3, relu5_3,
3. unit-normalize each tap over its channels (x / sqrt(sum_c x^2 + 1e-10)),
4. squared difference of the normalized taps,
5. a non-negative 1x1 linear head to 1 channel a tap ("lin" layers),
6. the spatial mean, summed over the 5 taps.

The convolutions are cuDNN's `conv2d` on the card: the JAX module
computes them in XLA, outside any Pallas kernel.

Parameters are the JAX module's plain tree {"convs": [(w (kh, kw, ci,
co), b (co,)) x 13], "lins": [w (c,) x 5]} of numpy arrays. They load
from the `.npz` that `pixelnerf_tpu/tools/port_lpips_weights.py` writes
(`load_params`), or from the torch state dicts it reads (a torchvision
vgg16 or full lpips.LPIPS one, and the lin heads; `load_state_dicts`).
Nothing is downloaded: without a weight file the metric is absent and
its callers report NaN.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "VGG_CFG",
    "TAPS",
    "random_params",
    "lpips_distance",
    "make_lpips",
    "params_from_state_dicts",
    "load_params",
    "load_state_dicts",
    "default_weights_path",
]

# VGG16 convolution plan: (out_channels, maxpool_before) per conv, in order
VGG_CFG = [
    (64, False), (64, False),
    (128, True), (128, False),
    (256, True), (256, False), (256, False),
    (512, True), (512, False), (512, False),
    (512, True), (512, False), (512, False),
]
# feature taps after the relu of these convs: relu1_2 ... relu5_3
TAPS = (1, 3, 6, 9, 12)
_TAP_CHANNELS = (64, 128, 256, 512, 512)
# lpips.ScalingLayer buffers (inputs already in [-1, 1])
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def default_weights_path() -> str:
    """$PIXELNERF_LPIPS_WEIGHTS, else checkpoints/lpips_vgg.npz in the
    repository."""
    env = os.environ.get("PIXELNERF_LPIPS_WEIGHTS")
    if env:
        return env
    root = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
    return os.path.join(root, "checkpoints", "lpips_vgg.npz")


def random_params(seed: int = 0) -> Dict:
    """Random weights in the JAX module's draw order (tests; not a
    perceptual metric)."""
    rng = np.random.default_rng(seed)
    convs = []
    cin = 3
    for cout, _pool in VGG_CFG:
        w = rng.normal(0, (2.0 / (9 * cin)) ** 0.5, (3, 3, cin, cout))
        b = rng.normal(0, 0.01, (cout,))
        convs.append((w.astype(np.float32), b.astype(np.float32)))
        cin = cout
    lins = [np.abs(rng.normal(0, 0.05, (c,))).astype(np.float32) for c in _TAP_CHANNELS]
    return {"convs": convs, "lins": lins}


def _torch_params(params: Dict, device) -> Dict:
    """The tree as float32 tensors on `device`, conv weights OIHW."""
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32, device=device)
    return {
        "convs": [(t(np.transpose(w, (3, 2, 0, 1))), t(b)) for w, b in params["convs"]],
        "lins": [t(lin).view(1, -1, 1, 1) for lin in params["lins"]],
    }


def lpips_distance(params: Dict, im1: torch.Tensor, im2: torch.Tensor) -> torch.Tensor:
    """LPIPS distance of [-1, 1] NHWC image pairs -> (N,), on their device.

    :param params the parameter tree (numpy) or `_torch_params` of it
    """
    if not torch.is_tensor(params["lins"][0]):
        params = _torch_params(params, im1.device)
    shift = torch.tensor(_SHIFT, device=im1.device).view(1, 3, 1, 1)
    scale = torch.tensor(_SCALE, device=im1.device).view(1, 3, 1, 1)

    def taps(x):
        x = (x.permute(0, 3, 1, 2).float() - shift) / scale
        feats = []
        for i, ((w, b), (_cout, pool)) in enumerate(zip(params["convs"], VGG_CFG)):
            if pool:
                x = F.max_pool2d(x, 2, 2)
            x = F.relu(F.conv2d(x, w, b, padding=1))
            if i in TAPS:
                feats.append(x)
        return feats

    def unit(x):
        return x * torch.rsqrt((x * x).sum(dim=1, keepdim=True) + 1e-10)

    total = 0.0
    for a, b, lin in zip(taps(im1), taps(im2), params["lins"]):
        total = total + ((unit(a) - unit(b)) ** 2 * lin).sum(dim=1).mean(dim=(1, 2))
    return total


def make_lpips(params: Dict, device):
    """(im1, im2 numpy NCHW in [-1, 1]) -> float, the mean over the batch
    (the signature of lpips.LPIPS as calc_metrics calls it)."""
    tparams = _torch_params(params, device)

    @torch.no_grad()
    def fn(im1: np.ndarray, im2: np.ndarray) -> float:
        a, b = (torch.as_tensor(np.asarray(im, np.float32), device=device).permute(0, 2, 3, 1)
                for im in (im1, im2))
        return float(lpips_distance(tparams, a, b).mean())

    return fn


def _sorted_conv_items(sd: Dict[str, np.ndarray]) -> List[tuple]:
    """The 13 VGG conv (weight HWIO, bias) pairs of a state dict in layer
    order: torchvision's `features.<i>.*` or lpips' `net.slice<k>.<i>.*`
    (lpips keeps torchvision's indices when it slices)."""
    ws, bs = {}, {}
    for k, v in sd.items():
        parts = k.split(".")
        if parts[-1] not in ("weight", "bias") or "lin" in k:
            continue
        v = np.asarray(v)
        if parts[-1] == "weight" and v.ndim != 4:
            continue
        try:
            idx = int(parts[-2])
        except ValueError:
            continue
        (ws if parts[-1] == "weight" else bs)[idx] = v
    order = sorted(ws)
    if len(order) != len(VGG_CFG):
        raise ValueError(f"expected {len(VGG_CFG)} VGG convs, found {len(order)}")
    return [(np.transpose(ws[i], (2, 3, 1, 0)).astype(np.float32), bs[i].astype(np.float32))
            for i in order]


def _lin_vectors(sd: Dict[str, np.ndarray]) -> List[np.ndarray]:
    """lin<k>.model.1.weight (1, C, 1, 1) -> (C,) vectors, k = 0..4."""
    lins = {}
    for k, v in sd.items():
        head = k.split(".")[0]
        if "lin" in k and k.endswith("weight") and head.startswith("lin"):
            lins[int(head[3:])] = np.asarray(v).reshape(-1).astype(np.float32)
    if sorted(lins) != list(range(5)):
        raise ValueError(f"expected lin0..lin4 heads, found {sorted(lins)}")
    return [lins[i] for i in range(5)]


def params_from_state_dicts(vgg_sd: Dict, lin_sd: Optional[Dict] = None) -> Dict:
    """The parameter tree of torch state dicts (numpy arrays or tensors).

    :param vgg_sd torchvision vgg16 (features.*) or a full lpips.LPIPS
        state dict (net.slice*), which may hold the lin heads too
    :param lin_sd the lpips lin-head state dict (lin*.model.1.weight) when
        vgg_sd lacks them
    """
    as_np = lambda sd: {k: v.detach().cpu().numpy() if torch.is_tensor(v) else v
                        for k, v in sd.items()}
    convs = _sorted_conv_items(as_np(vgg_sd))
    lins = _lin_vectors(as_np(lin_sd if lin_sd is not None else vgg_sd))
    for lin, c in zip(lins, _TAP_CHANNELS):
        if lin.shape[0] != c:
            raise ValueError(f"lin head size {lin.shape[0]} != {c}")
    return {"convs": convs, "lins": lins}


def load_params(path: Optional[str] = None) -> Optional[Dict]:
    """The tree of a ported `.npz` (port_lpips_weights); None if absent."""
    path = path or default_weights_path()
    if not os.path.exists(path):
        return None
    z = np.load(path)
    convs = [(z[f"conv{i}_w"], z[f"conv{i}_b"]) for i in range(len(VGG_CFG))]
    return {"convs": convs, "lins": [z[f"lin{i}"] for i in range(5)]}


def load_state_dicts(vgg_path: str, lin_path: Optional[str] = None) -> Dict:
    """The tree of torch state-dict files: a torchvision vgg16 or full
    lpips.LPIPS one, and the lin heads' (lpips' weights/v0.1/vgg.pth)."""
    load = lambda p: torch.load(p, map_location="cpu", weights_only=True)
    return params_from_state_dicts(load(vgg_path), load(lin_path) if lin_path else None)
