"""Single-map bilinear lookup for training: gather and scatter-add.

Replaces the TPU kernels `pixelnerf_tpu/ops/scatter_pallas.py:
bilerp_gather` (`_gather_kernel`) and `bilerp_scatter_add`
(`_scatter_kernel`), the two halves of `grid_sample_border_train`, by the
CUDA C++ kernels of `csrc/bilerp.cu`, whose header note gives the bound on
the H100 (bytes: the gathered (N, C) bf16 latent and its cotangent
dominate) and the design.

The lookup is bilinear, border padding, align_corners, on a (B, hl, wl, C)
map at normalized [-1, 1] points. The arithmetic follows the JAX route the
map's size stands in for, with no knob (`_taps`):

- a map of at most 8,192 pixels (`fused_supported`, the JAX package's
  limit for the TPU kernels) takes the TPU kernel's cast points
  (`_onehot_w`, `scatter_pallas.py:55-96`): the axis weights stay
  float32, their 2x2 products round to bf16 once, a tap at the map's far
  edge is dropped, the features are bf16, the products sum in float32 and
  the gather casts to the map's dtype; the scatter rounds the cotangent
  to bf16 and accumulates `w * g` in float32. This is not the pyramid's
  rounding (ops/pyramid.py rounds each axis weight first);
- a larger map, which the JAX package samples with `grid_sample_2d`,
  takes `grid_sample_2d`'s float32 tap weights, unrounded: the bf16
  features made exact in float32, a float32 sum in its tap order, one cast
  of the output to bf16; the scatter adds `w * g` with the same weights.

`grid_sample_border_train` is the entry point: a `torch.autograd.Function`
whose forward is the gather for a bf16 map and `grid_sample_2d` for a
float32 one (`_fwd_gather`, `scatter_pallas.py:219-227`), and whose
backward is the scatter, cast to the map's dtype, with a zero gradient for
the points (`scatter_pallas.py:250-254`). `bilerp_gather` and
`bilerp_scatter_add` launch their kernels on CUDA tensors and count each
launch (`.launches`, and `.wide_launches` for the maps past 8,192
pixels); CPU tensors take the plain versions. Both kernels' units are
planned on the host (`ops/gather_plan.py`, `ops/scatter_plan.py`, shared
with the pyramid's); `.plan` holds each one's last launch's plan.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pixelnerf_tpu_torch.ops.cuda_build import load_library
from pixelnerf_tpu_torch.ops.gather_plan import plan_gather
from pixelnerf_tpu_torch.ops.grid_sample import grid_sample_2d
from pixelnerf_tpu_torch.ops.scatter_plan import aligned, device_sms, plan_scatter
from pixelnerf_tpu_torch.utils.spans import span

__all__ = [
    "bilerp_gather",
    "bilerp_gather_plain",
    "bilerp_scatter_add",
    "bilerp_scatter_add_plain",
    "grid_sample_border_train",
    "fused_supported",
]

_MAX_PIXELS = 8192  # the JAX package's limit for this path
LANES, ROWS = 32, 2  # csrc/bilerp.cu: BIL_LANES, BIL_ROWS


def fused_supported(hl: int, wl: int) -> bool:
    """Maps the JAX package sends through this path: those whose taps keep
    `_onehot_w`'s bf16 rounding (on the CPU, the only maps routed here)."""
    return hl * wl <= _MAX_PIXELS


def _taps(uv: torch.Tensor, hl: int, wl: int):
    """The 2x2 taps of each point: flat pixel indices (B, N, 4) clipped
    into the map, and float32 weights (B, N, 4), zero for a dropped tap:
    rounded as `_onehot_w` on a map of at most 8,192 pixels, else
    `grid_sample_2d`'s unrounded products."""
    x = ((uv[..., 0] + 1.0) * 0.5 * (wl - 1)).clamp(0.0, wl - 1.0)
    y = ((uv[..., 1] + 1.0) * 0.5 * (hl - 1)).clamp(0.0, hl - 1.0)
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    ax = torch.stack([1.0 - fx, fx], dim=-1)  # (B, N, 2)
    ay = torch.stack([1.0 - fy, fy], dim=-1)
    w = ay[..., :, None] * ax[..., None, :]  # (B, N, 2y, 2x)
    if fused_supported(hl, wl):
        w = w.to(torch.bfloat16).float()
    off = torch.arange(2, device=uv.device)
    ix = x0.long()[..., None] + off
    iy = y0.long()[..., None] + off
    valid = (iy < hl)[..., :, None] & (ix < wl)[..., None, :]
    w = torch.where(valid, w, torch.zeros_like(w))
    idx = iy.clamp(max=hl - 1)[..., :, None] * wl + ix.clamp(max=wl - 1)[..., None, :]
    return idx.flatten(-2), w.flatten(-2)


def bilerp_gather_plain(feat: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """The plain version of the gather; same signature and result."""
    b, hl, wl, c = feat.shape
    idx, w = _taps(uv.float(), hl, wl)
    flat = feat.reshape(b, hl * wl, c).to(torch.bfloat16)
    bidx = torch.arange(b, device=uv.device)[:, None]
    acc = torch.zeros(uv.shape[:2] + (c,), dtype=torch.float32, device=uv.device)
    for t in range(idx.shape[-1]):
        acc += w[..., t, None] * flat[bidx, idx[..., t]].float()
    return acc.to(feat.dtype)


def bilerp_scatter_add_plain(uv: torch.Tensor, dz: torch.Tensor, hl: int, wl: int) -> torch.Tensor:
    """The plain version of the scatter; same signature and result."""
    b, n, c = dz.shape
    idx, w = _taps(uv.float(), hl, wl)
    g = dz.to(torch.bfloat16).float()
    acc = torch.zeros((b * hl * wl, c), dtype=torch.float32, device=uv.device)
    rows = torch.arange(b, device=uv.device)[:, None] * (hl * wl)
    for t in range(idx.shape[-1]):
        acc.index_add_(0, (rows + idx[..., t]).reshape(-1), (w[..., t, None] * g).reshape(-1, c))
    return acc.reshape(b, hl, wl, c)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built `csrc/bilerp.cu`, its C signatures bound once."""
    lib = load_library("bilerp")
    lib.pnt_error_string.restype = ctypes.c_char_p
    lib.pnt_error_string.argtypes = [ctypes.c_int]
    tail = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.pnt_bilerp_gather.restype = lib.pnt_bilerp_scatter.restype = ctypes.c_int
    lib.pnt_bilerp_gather.argtypes = lib.pnt_bilerp_scatter.argtypes = [
        ctypes.POINTER(ctypes.c_int)
    ] + tail
    return lib


def _device_of(uv: torch.Tensor, what: str) -> str:
    if uv.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on CUDA or CPU tensors, got {uv.device}")
    return uv.device.type


def _cuda_checks(uv, t, c):
    if uv.dtype != torch.float32 or not uv.is_contiguous():
        raise TypeError("uv must be contiguous float32")
    if t.device != uv.device or t.dtype != torch.bfloat16 or not t.is_contiguous():
        raise ValueError(f"bilerp kernels take contiguous bf16 tensors on {uv.device}")
    if c % 2:
        raise ValueError("the channel count must be even")


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: {_library().pnt_error_string(err).decode()}")


def bilerp_gather(feat: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Sample feat (B, hl, wl, C) at normalized uv (B, N, 2): (B, N, C) in
    feat's dtype (the CUDA kernel takes bf16 maps)."""
    if feat.ndim != 4 or uv.ndim != 3 or uv.shape[0] != feat.shape[0] or uv.shape[2] != 2:
        raise ValueError(f"feat (B, H, W, C) and uv (B, N, 2), got {tuple(feat.shape)}, {tuple(uv.shape)}")
    if _device_of(uv, "bilerp_gather") == "cpu":
        return bilerp_gather_plain(feat, uv)
    b, hl, wl, c = feat.shape
    n = uv.shape[1]
    _cuda_checks(uv, feat, c)
    uv = aligned(uv, 8)
    out = torch.empty((b, n, c), dtype=torch.bfloat16, device=uv.device)
    plan = plan_gather([(hl, wl, c)], b, n, device_sms(uv.device), LANES, ROWS,
                       feat.data_ptr() % 16 == 0)
    bilerp_gather.plan = plan
    if plan.units == 0:
        return out
    ints = plan.as_ints()
    wide = not fused_supported(hl, wl)
    err = _library().pnt_bilerp_gather(
        (ctypes.c_int * len(ints))(*ints), feat.data_ptr(), uv.data_ptr(), out.data_ptr(), b, n,
        hl, wl, c, int(wide), torch.cuda.current_stream(uv.device).cuda_stream,
    )
    _raise_on(err, "bilerp_gather")
    bilerp_gather.launches += 1
    bilerp_gather.wide_launches += wide
    return out


bilerp_gather.launches = 0
bilerp_gather.wide_launches = 0
bilerp_gather.plan = None


def bilerp_scatter_add(uv: torch.Tensor, dz: torch.Tensor, hl: int, wl: int) -> torch.Tensor:
    """Scatter the per-point cotangents dz (B, N, C), rounded to bf16, back
    onto the (hl, wl) grid: d_feat (B, hl, wl, C) float32."""
    if dz.ndim != 3 or uv.ndim != 3 or dz.shape[:2] != uv.shape[:2] or uv.shape[2] != 2:
        raise ValueError(f"uv (B, N, 2) and dz (B, N, C), got {tuple(uv.shape)}, {tuple(dz.shape)}")
    if _device_of(uv, "bilerp_scatter_add") == "cpu":
        return bilerp_scatter_add_plain(uv, dz, hl, wl)
    b, n, c = dz.shape
    dz = aligned(dz.to(torch.bfloat16).contiguous(), 4)
    _cuda_checks(uv, dz, c)
    uv = aligned(uv, 8)
    grad = torch.zeros((b, hl, wl, c), dtype=torch.float32, device=uv.device)
    plan = plan_scatter(
        [(hl, wl, c)], b, n, [dz.data_ptr() % 8 == 0], device_sms(uv.device), 2
    )
    bilerp_scatter_add.plan = plan
    if plan.units == 0:
        return grad
    ints = plan.as_ints()
    wide = not fused_supported(hl, wl)
    err = _library().pnt_bilerp_scatter(
        (ctypes.c_int * len(ints))(*ints), uv.data_ptr(), dz.data_ptr(), grad.data_ptr(), b, n,
        int(hl), int(wl), c, int(wide), torch.cuda.current_stream(uv.device).cuda_stream,
    )
    _raise_on(err, "bilerp_scatter_add")
    bilerp_scatter_add.launches += 1
    bilerp_scatter_add.wide_launches += wide
    return grad


bilerp_scatter_add.launches = 0
bilerp_scatter_add.wide_launches = 0
bilerp_scatter_add.plan = None


class _GridSampleBorderTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feat, uv):
        ctx.save_for_backward(uv)
        ctx.hw_dtype = (feat.shape[1], feat.shape[2], feat.dtype)
        if feat.dtype == torch.bfloat16:
            return bilerp_gather(feat, uv)
        return grid_sample_2d(feat, uv, padding_mode="border", align_corners=True, mode="bilinear")

    @staticmethod
    def backward(ctx, g):
        (uv,) = ctx.saved_tensors
        hl, wl, dtype = ctx.hw_dtype
        with span("pnt.lookup.bwd"):
            return bilerp_scatter_add(uv, g, hl, wl).to(dtype), torch.zeros_like(uv)


def grid_sample_border_train(feat: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """grid_sample (bilinear, border, align_corners) of feat (B, hl, wl, C)
    at normalized uv (B, N, 2) for the training path: the gather forward
    (bf16 maps), the scatter backward, and a zero gradient for uv."""
    return _GridSampleBorderTrain.apply(feat, uv.contiguous())
