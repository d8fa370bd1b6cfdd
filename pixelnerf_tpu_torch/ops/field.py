"""Fused pixel-aligned field: native-pyramid gather feeding the ResnetFC.

Replaces the TPU kernel `pixelnerf_tpu/ops/field_pallas.py:
pyramid_field_fused` (forward only; its VJP belongs to the training path)
with the CUDA C++ kernel `csrc/field_fwd.cu`, whose header note gives the
bound on the H100 (operations: ~11.6 MFLOP of bf16 products per point at
NS=2) and the design. The (M, d_latent) gathered latent never exists in
device memory. The kernel takes any number of views whose tile fits in
shared memory: up to 32 at the flagship width (hidden 512, d_latent 512);
beyond, the wrapper raises.

`pyramid_field_fused` launches the kernel on CUDA tensors and counts the
launch in `pyramid_field_fused.launches`; CPU tensors take
`field_plain`: compose_pyramid + grid_sample_2d + the per-layer ResnetFC
chain, with the kernel's cast points (z cast to bf16 after a float32
gather, bf16 matmul operands, float32 accumulation and residual stream).
Both take the weights as `pack_field_weights` leaves them; packing
packed weights copies nothing.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence

import torch

from pixelnerf_tpu_torch.models.encoder import compose_pyramid
from pixelnerf_tpu_torch.ops.grid_sample import grid_sample_2d

__all__ = [
    "FieldWeights",
    "pyramid_field_fused",
    "field_plain",
    "field_supported",
    "pack_field_weights",
    "field_flops",
]

_MAX_LEVELS = 4
_SMEM_LIMIT = 232448  # dynamic shared memory one Hopper block may use


class FieldWeights(NamedTuple):
    """ResnetFC weights in (in, out) orientation (H = d_hidden):

    w_in (d_in, H), b_in (H,); wz (n_inj, d_latent, H), bz (n_inj, H);
    w0, w1 (n_blocks, H, H), b0, b1 (n_blocks, H); w_out (H, d_out),
    b_out (d_out,). `pack_field_weights` gives the kernel's form.
    """

    w_in: torch.Tensor
    b_in: torch.Tensor
    wz: torch.Tensor
    bz: torch.Tensor
    w0: torch.Tensor
    b0: torch.Tensor
    w1: torch.Tensor
    b1: torch.Tensor
    w_out: torch.Tensor
    b_out: torch.Tensor


def field_supported(ns: int, n_blocks: int, combine_layer: int) -> bool:
    """Configurations the kernel takes (those of the TPU kernel's
    `supported_config`): at least one latent injection, and the view
    pooling inside the block chain when there are several views."""
    if ns < 1 or min(combine_layer, n_blocks) == 0:
        return False
    return ns == 1 or combine_layer < n_blocks


def field_flops(ns: int, d_in: int, d_latent: int, hidden: int, d_out: int,
                n_blocks: int, combine_layer: int) -> int:
    """Floating-point operations of the field for one point (2 per MAC)."""
    n_inj = min(combine_layer, n_blocks)
    pre = min(combine_layer, n_blocks) if ns > 1 else n_blocks
    macs = ns * (d_in * hidden + n_inj * d_latent * hidden + pre * 2 * hidden * hidden)
    macs += (n_blocks - pre) * 2 * hidden * hidden + hidden * d_out
    return 2 * macs


def _pad16(n: int) -> int:
    return -(-n // 16) * 16


def pack_field_weights(w: FieldWeights) -> FieldWeights:
    """The kernel's operand form: matrices bf16, biases float32, all
    contiguous and detached, w_in zero-padded to a multiple of 16 rows
    (the wmma K step). Leaves already in that form are kept as they are."""
    mat = lambda t: t.detach().to(torch.bfloat16).contiguous()
    vec = lambda t: t.detach().float().contiguous()
    w_in = mat(w.w_in)
    d_in = w_in.shape[0]
    if d_in % 16:
        w_in = torch.cat([w_in, w_in.new_zeros((_pad16(d_in) - d_in, w_in.shape[1]))])
    return FieldWeights(
        w_in=w_in, b_in=vec(w.b_in), wz=mat(w.wz), bz=vec(w.bz), w0=mat(w.w0),
        b0=vec(w.b0), w1=mat(w.w1), b1=vec(w.b1), w_out=mat(w.w_out), b_out=vec(w.b_out),
    )


def _dot(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """bf16 operands, float32 products and sums (exact bf16 x bf16 in f32)."""
    return a.to(torch.bfloat16).float() @ w.to(torch.bfloat16).float()


def field_plain(
    feats: Sequence[torch.Tensor], grid: torch.Tensor, xin: torch.Tensor,
    w: FieldWeights, n_blocks: int, combine_layer: int, ns: int,
) -> torch.Tensor:
    """The plain version of the kernel; same signature and result."""
    sb, _, b, d_in = xin.shape
    latent = compose_pyramid([f.float() for f in feats])
    z = grid_sample_2d(latent, grid.reshape(sb * ns, b, 2).float())
    z = z.to(torch.bfloat16).reshape(sb, ns, b, -1)
    x = _dot(xin, w.w_in[:d_in]) + w.b_in
    n_inj = min(combine_layer, n_blocks)
    for blk in range(n_blocks):
        if blk == combine_layer and ns > 1:
            x = x.mean(dim=1, keepdim=True)
        if blk < n_inj:
            x = x + (_dot(z, w.wz[blk]) + w.bz[blk])
        h1 = _dot(torch.relu(x), w.w0[blk]) + w.b0[blk]
        x = x + (_dot(torch.relu(h1), w.w1[blk]) + w.b1[blk])
    out = _dot(torch.relu(x), w.w_out) + w.b_out
    return out.reshape(sb, b, -1)


def _check(feats, grid, xin, w, n_blocks, combine_layer, ns):
    if grid.ndim != 4 or grid.shape[1] != ns or grid.shape[3] != 2:
        raise ValueError(f"grid must be (SB, {ns}, B, 2), got {tuple(grid.shape)}")
    sb, _, b, _ = grid.shape
    if xin.ndim != 4 or xin.shape[:3] != (sb, ns, b):
        raise ValueError(f"xin must be (SB, NS, B, d_in), got {tuple(xin.shape)}")
    if w.w_in.shape[0] not in (xin.shape[3], _pad16(xin.shape[3])):
        raise ValueError(f"w_in has {w.w_in.shape[0]} rows for d_in={xin.shape[3]}")
    if not 1 <= len(feats) <= _MAX_LEVELS:
        raise ValueError(f"1 to {_MAX_LEVELS} pyramid levels, got {len(feats)}")
    hf, wf = feats[0].shape[1:3]
    for f in feats:
        if f.ndim != 4 or f.shape[0] != sb * ns:
            raise ValueError(f"levels must be (SB*NS, H, W, C), got {tuple(f.shape)}")
        if f.shape[1] > hf or f.shape[2] > wf:
            raise ValueError("level 0 must be the finest level")
    if sum(f.shape[3] for f in feats) != w.wz.shape[1]:
        raise ValueError("level channels must sum to d_latent")
    if not field_supported(ns, n_blocks, combine_layer):
        raise ValueError(
            f"unsupported field config ns={ns} n_blocks={n_blocks} "
            f"combine_layer={combine_layer}"
        )


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built `csrc/field_fwd.cu`, its C signatures bound once."""
    from pixelnerf_tpu_torch.ops.cuda_build import load_library

    lib = load_library("field_fwd")
    lib.pnt_field_fwd_smem_bytes.restype = ctypes.c_size_t
    lib.pnt_field_fwd_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.pnt_error_string.restype = ctypes.c_char_p
    lib.pnt_error_string.argtypes = [ctypes.c_int]
    lib.pnt_field_fwd.restype = ctypes.c_int
    lib.pnt_field_fwd.argtypes = (
        [ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int), ctypes.c_int]
        + [ctypes.c_void_p] * 13
        + [ctypes.c_int] * 9
        + [ctypes.c_void_p]
    )
    return lib


def _launch(feats, grid, xin, w, n_blocks, combine_layer, ns):
    device = grid.device
    sb, _, b, d_in = xin.shape
    w = pack_field_weights(w)
    d_in_pad, hidden = w.w_in.shape
    d_latent = w.wz.shape[1]
    d_out = w.w_out.shape[1]
    for f in feats:
        if f.dtype != torch.bfloat16 or not f.is_contiguous() or f.device != device:
            raise ValueError("levels must be contiguous bf16 tensors on the grid's device")
        if f.shape[3] % 2:
            raise ValueError("level channel counts must be even")
    if hidden % 16 or d_latent % 16:
        raise ValueError("d_hidden and d_latent must be multiples of 16")
    if grid.dtype != torch.float32 or xin.dtype != torch.bfloat16:
        raise TypeError("grid must be float32 and xin bf16")
    if any(t.device != device for t in w):
        raise ValueError("weights must be on the grid's device")
    lib = _library()
    smem = lib.pnt_field_fwd_smem_bytes(hidden, d_latent, d_in_pad, ns)
    if smem > _SMEM_LIMIT:
        raise ValueError(
            f"a field tile of {ns} views needs {smem} B of shared memory (> {_SMEM_LIMIT})"
        )
    grid = grid.contiguous()
    xin = xin.contiguous()
    out = torch.empty((sb, b, d_out), dtype=torch.float32, device=device)

    nlev = len(feats)
    ptrs = (ctypes.c_void_p * nlev)(*[f.data_ptr() for f in feats])
    dims = (ctypes.c_int * (3 * nlev))(
        *[d for f in feats for d in (f.shape[1], f.shape[2], f.shape[3])]
    )
    err = lib.pnt_field_fwd(
        ptrs, dims, nlev, grid.data_ptr(), xin.data_ptr(),
        *[t.data_ptr() for t in w], out.data_ptr(),
        sb, ns, b, d_in, d_in_pad, hidden, d_out, n_blocks, combine_layer,
        torch.cuda.current_stream(device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"field_fwd launch failed: {lib.pnt_error_string(err).decode()}")
    pyramid_field_fused.launches += 1
    return out


def pyramid_field_fused(
    feats: Sequence[torch.Tensor],
    grid: torch.Tensor,
    xin: torch.Tensor,
    weights: FieldWeights,
    n_blocks: int,
    combine_layer: int,
    ns: int,
) -> torch.Tensor:
    """Gather and field in one kernel.

    :param feats native pyramid levels (SB*NS, H_l, W_l, C_l), finest
        first, bf16
    :param grid (SB, NS, B, 2) normalized [-1, 1] fine-grid coordinates
    :param xin (SB, NS, B, d_in) positional-code features, bf16
    :param weights FieldWeights, as given or packed (pack_field_weights)
    :return (SB, B, d_out) float32, before the rgb/sigma heads
    """
    feats = tuple(feats)
    _check(feats, grid, xin, weights, n_blocks, combine_layer, ns)
    if grid.device.type == "cpu":
        return field_plain(feats, grid, xin, weights, n_blocks, combine_layer, ns)
    if grid.device.type != "cuda":
        raise ValueError(f"pyramid_field_fused runs on CUDA or CPU tensors, got {grid.device}")
    return _launch(feats, grid, xin, weights, n_blocks, combine_layer, ns)


pyramid_field_fused.launches = 0
