"""Native-resolution pyramid lookup for training: gather and scatter-add.

Replaces the TPU kernels `pixelnerf_tpu/ops/pyramid_pallas.py:
pyramid_gather` (`_gather_kernel`) and `pyramid_scatter_add`
(`_scatter_kernel`, with `dual`) by the CUDA C++ kernels of
`csrc/pyramid.cu`, whose header note gives the bound on the H100 (bytes:
the gathered (N, sum C) bf16 latent and its cotangent dominate) and the
design.

Bilinear upsampling (align_corners) followed by border bilinear sampling
is, per native level, a separable lookup of at most 3x3 native taps with
composed weights (`pyramid_pallas.py:_axis_pairs`; coincident taps add).
The cast points are the TPU kernel's: each axis weight and their product
round to the feature dtype (its one-hot matrices are in that dtype), the
products with the features sum in float32, and the gathered latent is cast
to the feature dtype. The scatter takes the cotangent in the feature
dtype (a dual cotangent is the sum of two, rounded to that dtype),
accumulates `w * g` in float32, and the autograd functions cast each level
gradient to its level's dtype. The gradient for uv is zero by contract
(`pyramid_pallas.py:381-395, 425-435`).

`pyramid_gather` and `pyramid_scatter_add` launch their kernels on CUDA
tensors and count each launch (`.launches`); CPU tensors take the plain
versions `pyramid_gather_plain` and `pyramid_scatter_add_plain`. Both
kernels' units are planned on the host (`ops/gather_plan.py`,
`ops/scatter_plan.py`); `.plan` holds each one's last launch's plan.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Sequence, Tuple

import torch

from pixelnerf_tpu_torch.ops.cuda_build import load_library
from pixelnerf_tpu_torch.ops.gather_plan import plan_gather
from pixelnerf_tpu_torch.ops.scatter_plan import aligned, device_sms, plan_scatter
from pixelnerf_tpu_torch.utils.spans import span

__all__ = [
    "pyramid_gather",
    "pyramid_gather_plain",
    "pyramid_scatter_add",
    "pyramid_scatter_add_plain",
    "pyramid_index_train",
    "pyramid_index_train_dual",
    "pyramid_supported",
]

_MAX_FINE_PIXELS = 8192  # the JAX package's limit for this path
_MAX_LEVELS = 4
LANES, ROWS = 16, 1  # csrc/pyramid.cu: PYR_LANES, PYR_ROWS


def pyramid_supported(fine_hw: Tuple[int, int]) -> bool:
    """Fine grids the JAX package sends through this path."""
    return fine_hw[0] * fine_hw[1] <= _MAX_FINE_PIXELS


def _fine_coords(uv: torch.Tensor, hf: int, wf: int):
    """Normalized [-1, 1] coordinates (..., 2) -> clipped fine pixel ones."""
    x = ((uv[..., 0] + 1.0) * 0.5 * (wf - 1)).clamp(0.0, wf - 1.0)
    y = ((uv[..., 1] + 1.0) * 0.5 * (hf - 1)).clamp(0.0, hf - 1.0)
    return x, y


def _axis_taps(cf: torch.Tensor, wn: int, wf: int):
    """Composed taps on a native axis of size wn for fine coordinates cf in
    [0, wf-1]: (base index, weights (..., 3) of base, base+1, base+2)."""
    if wn == wf:
        j = torch.floor(cf)
        t = cf - j
        return j.long(), torch.stack([1.0 - t, t, torch.zeros_like(t)], dim=-1)
    r = (wn - 1.0) / (wf - 1.0)
    j = torch.minimum(torch.floor(cf), torch.full_like(cf, wf - 2.0))
    t = cf - j
    xl = j * r
    xr = (j + 1.0) * r
    ilf = torch.floor(xl)
    irf = torch.minimum(torch.floor(xr), torch.full_like(xr, wn - 1.0))
    fl = xl - ilf
    fr = xr - irf
    d = (irf - ilf).long()  # 0 or 1: r <= 1
    w = torch.stack([(1.0 - t) * (1.0 - fl), (1.0 - t) * fl, torch.zeros_like(t)], dim=-1)
    w = w.scatter_add(-1, d[..., None], (t * (1.0 - fr))[..., None])
    w = w.scatter_add(-1, d[..., None] + 1, (t * fr)[..., None])
    return ilf.long(), w


def _level_taps(uv, hn: int, wn: int, hf: int, wf: int, dtype):
    """The <=9 taps of one level: flat pixel indices (B, N, 9) clipped into
    the map, and float32 weights (B, N, 9) rounded as the TPU kernel's
    one-hot matrices in `dtype`, zero for taps past the map's edge."""
    x, y = _fine_coords(uv.float(), hf, wf)
    bx, wx = _axis_taps(x, wn, wf)
    by, wy = _axis_taps(y, hn, hf)
    rnd = lambda a: a.to(dtype).float()
    off = torch.arange(3, device=uv.device)
    ix = bx[..., None] + off  # (B, N, 3)
    iy = by[..., None] + off
    w = rnd(rnd(wy)[..., :, None] * rnd(wx)[..., None, :])  # (B, N, 3y, 3x)
    valid = (iy < hn)[..., :, None] & (ix < wn)[..., None, :]
    w = torch.where(valid, w, torch.zeros_like(w))
    idx = iy.clamp(max=hn - 1)[..., :, None] * wn + ix.clamp(max=wn - 1)[..., None, :]
    return idx.flatten(-2), w.flatten(-2)


def pyramid_gather_plain(feats: Sequence[torch.Tensor], uv: torch.Tensor) -> torch.Tensor:
    """The plain version of the gather; same signature and result."""
    b, hf, wf, _ = feats[0].shape
    bidx = torch.arange(b, device=uv.device)[:, None]
    outs = []
    for f in feats:
        hn, wn, c = f.shape[1:]
        idx, w = _level_taps(uv, hn, wn, hf, wf, f.dtype)
        flat = f.reshape(b, hn * wn, c)
        acc = torch.zeros(uv.shape[:2] + (c,), dtype=torch.float32, device=uv.device)
        for t in range(idx.shape[-1]):
            acc += w[..., t, None] * flat[bidx, idx[..., t]].float()
        outs.append(acc)
    return torch.cat(outs, dim=-1).to(feats[0].dtype)


def pyramid_scatter_add_plain(
    uv: torch.Tensor, dz: torch.Tensor, csizes: Sequence[int],
    hws: Sequence[Tuple[int, int]], fine_hw: Tuple[int, int],
    dz2: Optional[torch.Tensor] = None,
) -> List[torch.Tensor]:
    """The plain version of the scatter; same signature and result."""
    b, n, _ = dz.shape
    if dz2 is not None:
        dz = dz + dz2  # rounded to the cotangent dtype, as the TPU kernel
    hf, wf = fine_hw
    outs, c0 = [], 0
    for c, (hn, wn) in zip(csizes, hws):
        idx, w = _level_taps(uv, hn, wn, hf, wf, dz.dtype)
        g = dz[..., c0 : c0 + c].float()
        c0 += c
        acc = torch.zeros((b * hn * wn, c), dtype=torch.float32, device=uv.device)
        rows = torch.arange(b, device=uv.device)[:, None] * (hn * wn)
        for t in range(idx.shape[-1]):
            acc.index_add_(0, (rows + idx[..., t]).reshape(-1), (w[..., t, None] * g).reshape(-1, c))
        outs.append(acc.reshape(b, hn, wn, c))
    return outs


def _check_levels(feats, uv):
    if not 1 <= len(feats) <= _MAX_LEVELS:
        raise ValueError(f"1 to {_MAX_LEVELS} pyramid levels, got {len(feats)}")
    if uv.ndim != 3 or uv.shape[2] != 2:
        raise ValueError(f"uv must be (B, N, 2), got {tuple(uv.shape)}")
    b, hf, wf, _ = feats[0].shape
    for f in feats:
        if f.ndim != 4 or f.shape[0] != b or f.shape[1] > hf or f.shape[2] > wf:
            raise ValueError("levels must be (B, H_l, W_l, C_l), finest first")
    if uv.shape[0] != b:
        raise ValueError(f"uv has {uv.shape[0]} maps, the levels {b}")


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built `csrc/pyramid.cu`, its C signatures bound once."""
    lib = load_library("pyramid")
    lib.pnt_error_string.restype = ctypes.c_char_p
    lib.pnt_error_string.argtypes = [ctypes.c_int]
    head = [ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int), ctypes.c_int]
    lib.pnt_pyramid_gather.restype = ctypes.c_int
    lib.pnt_pyramid_gather.argtypes = head + [ctypes.POINTER(ctypes.c_int)] + [
        ctypes.c_void_p
    ] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    lib.pnt_pyramid_scatter.restype = ctypes.c_int
    lib.pnt_pyramid_scatter.argtypes = head + [ctypes.POINTER(ctypes.c_int)] + [
        ctypes.c_void_p
    ] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    return lib


def _level_args(tensors, dims):
    ptrs = (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])
    flat = (ctypes.c_int * (3 * len(dims)))(*[d for hwc in dims for d in hwc])
    return ptrs, flat, len(tensors)


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: {_library().pnt_error_string(err).decode()}")


def _cuda_checks(uv, tensors, dtype):
    device = uv.device
    if uv.dtype != torch.float32:
        raise TypeError("uv must be float32")
    for t in tensors:
        if t.device != device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"pyramid kernels take contiguous {dtype} tensors on {device}")
        if t.shape[-1] % 2:
            raise ValueError("channel counts must be even")


def pyramid_gather(feats: Sequence[torch.Tensor], uv: torch.Tensor) -> torch.Tensor:
    """Sample each native level at normalized fine-grid uv and concatenate.

    :param feats levels [(B, H_l, W_l, C_l)], finest first
    :param uv (B, N, 2) normalized [-1, 1] coordinates on the finest grid
        (align_corners, border padding)
    :return (B, N, sum C_l) in the levels' dtype
    """
    feats = tuple(feats)
    _check_levels(feats, uv)
    if uv.device.type == "cpu":
        return pyramid_gather_plain(feats, uv)
    if uv.device.type != "cuda":
        raise ValueError(f"pyramid_gather runs on CUDA or CPU tensors, got {uv.device}")
    _cuda_checks(uv, feats, torch.bfloat16)
    uv = aligned(uv.contiguous(), 8)
    b, n, _ = uv.shape
    out = torch.empty((b, n, sum(f.shape[3] for f in feats)), dtype=torch.bfloat16, device=uv.device)
    maps = [tuple(f.shape[1:]) for f in feats]
    plan = plan_gather(maps, b, n, device_sms(uv.device), LANES, ROWS,
                       all(f.data_ptr() % 16 == 0 for f in feats))
    pyramid_gather.plan = plan
    if plan.units == 0:
        return out
    ptrs, dims, nlev = _level_args(feats, maps)
    ints = plan.as_ints()
    err = _library().pnt_pyramid_gather(
        ptrs, dims, nlev, (ctypes.c_int * len(ints))(*ints), uv.data_ptr(), out.data_ptr(), b, n,
        torch.cuda.current_stream(uv.device).cuda_stream,
    )
    _raise_on(err, "pyramid_gather")
    pyramid_gather.launches += 1
    return out


pyramid_gather.launches = 0
pyramid_gather.plan = None


def pyramid_scatter_add(
    uv: torch.Tensor, dz: torch.Tensor, csizes: Sequence[int],
    hws: Sequence[Tuple[int, int]], fine_hw: Tuple[int, int],
    dz2: Optional[torch.Tensor] = None,
) -> List[torch.Tensor]:
    """Scatter the concatenated cotangent back onto the native grids.

    :param uv (B, N, 2) normalized fine-grid coordinates
    :param dz (B, N, sum C_l) cotangent in the features' dtype
    :param csizes, hws per-level channel counts and (H, W), concat order
    :param fine_hw (H, W) of the finest level
    :param dz2 optional second cotangent like dz, summed with it first
    :return [(B, H_l, W_l, C_l)] float32
    """
    csizes = [int(c) for c in csizes]
    hws = [tuple(int(d) for d in hw) for hw in hws]
    if dz.ndim != 3 or dz.shape[:2] != uv.shape[:2] or dz.shape[2] != sum(csizes):
        raise ValueError(f"dz must be (B, N, {sum(csizes)}), got {tuple(dz.shape)}")
    if dz2 is not None and (dz2.shape != dz.shape or dz2.dtype != dz.dtype):
        raise ValueError("dz2 must match dz in shape and dtype")
    if uv.device.type == "cpu":
        return pyramid_scatter_add_plain(uv, dz, csizes, hws, fine_hw, dz2)
    if uv.device.type != "cuda":
        raise ValueError(f"pyramid_scatter_add runs on CUDA or CPU tensors, got {uv.device}")
    dz = aligned(dz.contiguous(), 4)
    dz2 = None if dz2 is None else aligned(dz2.contiguous(), 4)
    _cuda_checks(uv, [dz] + ([] if dz2 is None else [dz2]), torch.bfloat16)
    if any(c % 2 for c in csizes) or tuple(fine_hw) != hws[0]:
        raise ValueError("even channel counts, and level 0 must be the fine grid")
    uv = aligned(uv.contiguous(), 8)
    b, n, _ = uv.shape
    grads = [
        torch.zeros((b, h, w, c), dtype=torch.float32, device=uv.device)
        for c, (h, w) in zip(csizes, hws)
    ]
    csum = sum(csizes)
    rows8 = csum % 4 == 0 and all(t.data_ptr() % 8 == 0 for t in (dz, dz2) if t is not None)
    offsets = [sum(csizes[:i]) for i in range(len(csizes))]
    maps = [(h, w, c) for c, (h, w) in zip(csizes, hws)]
    plan = plan_scatter(
        maps, b, n, [rows8 and o % 4 == 0 for o in offsets], device_sms(uv.device), 3
    )
    pyramid_scatter_add.plan = plan
    if plan.units == 0:
        return grads
    ptrs, dims, nlev = _level_args(grads, maps)
    ints = plan.as_ints()
    err = _library().pnt_pyramid_scatter(
        ptrs, dims, nlev, (ctypes.c_int * len(ints))(*ints), uv.data_ptr(), dz.data_ptr(),
        0 if dz2 is None else dz2.data_ptr(), b, n, csum,
        torch.cuda.current_stream(uv.device).cuda_stream,
    )
    _raise_on(err, "pyramid_scatter_add")
    pyramid_scatter_add.launches += 1
    return grads


pyramid_scatter_add.launches = 0
pyramid_scatter_add.plan = None


def _scatter_back(ctx, g1, g2):
    uv = ctx.saved_tensors[0]
    dtype = ctx.dtypes[0]
    if g1 is None and g2 is None:
        return (None,) * (1 + len(ctx.dtypes))
    with span("pnt.lookup.bwd"):
        gs = [g.to(dtype) for g in (g1, g2) if g is not None]
        d = pyramid_scatter_add(
            uv, gs[0], ctx.csizes, ctx.hws, ctx.hws[0], gs[1] if len(gs) == 2 else None
        )
        return (torch.zeros_like(uv),) + tuple(x.to(t) for x, t in zip(d, ctx.dtypes))


class _IndexTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, uv, *feats):
        ctx.save_for_backward(uv)
        ctx.csizes = [f.shape[3] for f in feats]
        ctx.hws = [tuple(f.shape[1:3]) for f in feats]
        ctx.dtypes = [f.dtype for f in feats]
        return pyramid_gather(feats, uv)

    @staticmethod
    def backward(ctx, g):
        return _scatter_back(ctx, g, None)


class _IndexTrainDual(torch.autograd.Function):
    @staticmethod
    def forward(ctx, uv, *feats):
        ctx.save_for_backward(uv)
        ctx.csizes = [f.shape[3] for f in feats]
        ctx.hws = [tuple(f.shape[1:3]) for f in feats]
        ctx.dtypes = [f.dtype for f in feats]
        out = pyramid_gather(feats, uv)
        # a view, not the same tensor twice: autograd then hands backward
        # the two cotangents apart instead of adding them first
        return out, out.view_as(out)

    @staticmethod
    def backward(ctx, g1, g2):
        return _scatter_back(ctx, g1, g2)


def pyramid_index_train(feats: Sequence[torch.Tensor], uv: torch.Tensor) -> torch.Tensor:
    """Training-path lookup: gather forward, scatter-add backward, zero
    gradient for uv. Returns (B, N, sum C_l) in the levels' dtype."""
    return _IndexTrain.apply(uv, *feats)


def pyramid_index_train_dual(
    feats: Sequence[torch.Tensor], uv: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The lookup for two consumers (the coarse MLP and the fine pass's
    query cache): the same latent twice, whose two cotangents reach the
    scatter kernel apart and are summed there."""
    return _IndexTrainDual.apply(uv, *feats)
