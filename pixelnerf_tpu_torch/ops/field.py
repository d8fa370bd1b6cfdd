"""Fused pixel-aligned field: native-pyramid gather feeding the ResnetFC,
with its VJP.

Replaces the TPU kernel `pixelnerf_tpu/ops/field_pallas.py:
pyramid_field_fused` and its custom VJP:

- the primal (`_field_fwd_kernel`, stash=False) and the VJP forward
  (`_field_vjp_fwd`, stash=True) by the CUDA C++ kernel
  `csrc/field_fwd.cu`: null stash pointers give the primal, given ones
  make it also write the bf16 z-stash (SB, NS, B, d_latent) and the
  activation stash in `ops/resnetfc.py:stash_layout`'s layout;
- the backward (`_field_vjp_bwd`, `_field_bwd_kernel`) by
  `csrc/resnetfc_bwd.cu`'s chain kernel (`csrc/bwd_chain.cuh`) with the
  field's epilogue, which
  rounds the latent cotangent to bf16 once and scatters it onto the native
  levels in float32 (the (M, d_latent) cotangent never reaches device
  memory), and its weight-gradient products, with the z-stash as the
  activation of the injection gradients.

Their header notes give the bound on the H100 (operations: ~11.6 MFLOP of
bf16 products per point at NS=2 forward, about twice that backward) and
the design. The chains are built for hidden 64, 128, 256 and 512 (every
config under `conf/` is 512 wide) and up to 64 views, whose rows fit one
64-row tile; the wrappers zero-pad other widths up to 512 and d_latent
to a multiple of 64, and run more than 16 outputs in groups
(`ops/resnetfc.py:chain_plan`). Past 512 or 64 views
(`ops/resnetfc.py:takes_chains`) they compose the pyramid gather and
scatter kernels with the layered ResnetFC kernels instead
(`ops/layer_chain.py:layered_field_fwd`, `layered_field_bwd`), which count
their own launches, not these wrappers'.

`pyramid_field_fused` is the entry point: with autograd recording and an
input or weight that needs a gradient it runs the stash forward and, on
backward, the backward (a `torch.autograd.Function` whose saved tensors
are the stash; the grid gets a zero gradient, as in
`field_pallas.py:595-596`); otherwise it runs the primal. The primal
launches count in `pyramid_field_fused.launches`, the others in
`pyramid_field_fused_fwd_stash.launches` and
`pyramid_field_fused_bwd.launches`, one a run of the chain (an output
group; the chain and the weight-gradient products together count one). CPU tensors take the plain versions: the
composition `pyramid_gather_plain` + `resnetfc_fwd_plain` forward, and
`resnetfc_bwd_plain` from the stash then `pyramid_scatter_add_plain` of
the cotangent in the levels' dtype backward, which are the cast points of
the TPU kernel (its z is bit-identical to the standalone gather's, and its
backward casts `dz` once, `field_pallas.py:253-270, 582-587`). The weights
come as `pack_field_weights` leaves them or as float32 (in, out) views of
the parameters, whose gradients come back in the same shapes.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence, Tuple

import torch

from pixelnerf_tpu_torch.ops.cuda_build import SMEM_LIMIT, load_library
from pixelnerf_tpu_torch.ops.pyramid import pyramid_gather_plain, pyramid_scatter_add_plain
from pixelnerf_tpu_torch.ops import layer_chain
from pixelnerf_tpu_torch.ops.resnetfc import (
    FieldWeights, _chains_take, _device_of, _pad16, _pad_last, chain_plan, check_chain_widths,
    even_d_in, launch_bwd, out_group, out_groups, pack_field_weights, pad_chain_weights,
    resnetfc_bwd_plain, resnetfc_fwd_plain, stash_layout,
)
from pixelnerf_tpu_torch.ops.scatter_plan import ScatterPlan, Segment

__all__ = [
    "FieldWeights",
    "pyramid_field_fused",
    "pyramid_field_fused_fwd_stash",
    "pyramid_field_fused_bwd",
    "level_scatter_plan",
    "field_plain",
    "field_bwd_plain",
    "field_supported",
    "pack_field_weights",
    "field_flops",
]

_MAX_LEVELS = 4


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


def _levels(feats) -> List[Tuple[int, int, int]]:
    return [tuple(int(d) for d in f.shape[1:]) for f in feats]


def field_plain(
    feats: Sequence[torch.Tensor], grid: torch.Tensor, xin: torch.Tensor,
    w: FieldWeights, n_blocks: int, combine_layer: int, ns: int, stash: bool = False,
):
    """The plain version of the kernel: (SB, B, d_out) float32, and with
    `stash` (out, zstash (SB, NS, B, d_latent) in the levels' dtype,
    stash_pre or None, stash_post)."""
    sb, _, b, _ = xin.shape
    z = pyramid_gather_plain(feats, grid.reshape(sb * ns, b, 2).float()).reshape(sb, ns, b, -1)
    res = resnetfc_fwd_plain(z, xin, w, n_blocks, combine_layer, ns, stash=stash)
    return (res[0], z, res[1], res[2]) if stash else res


def field_bwd_plain(
    grid: torch.Tensor, xin: torch.Tensor, g: torch.Tensor, zstash: torch.Tensor,
    stash_pre, stash_post: torch.Tensor, w: FieldWeights, n_blocks: int,
    combine_layer: int, ns: int, levels: Sequence[Tuple[int, int, int]],
):
    """The plain version of the backward: (d_feats [(SB*NS, H_l, W_l, C_l)]
    in the z-stash's dtype, dxin in xin's dtype, float32 FieldWeights
    gradients with w_in (d_in, H))."""
    sb, _, b, dl = zstash.shape
    dz, dxin, dw = resnetfc_bwd_plain(
        zstash, xin, g, stash_pre, stash_post, w, n_blocks, combine_layer, ns,
    )
    hws = [(h, wd) for h, wd, _ in levels]
    d_feats = pyramid_scatter_add_plain(
        grid.reshape(sb * ns, b, 2).float(), dz.reshape(sb * ns, b, dl),
        [c for _, _, c in levels], hws, hws[0],
    )
    return [d.to(zstash.dtype) for d in d_feats], dxin, dw


def level_scatter_plan(levels: Sequence[Tuple[int, int, int]], nb: int, ns: int, n: int) -> ScatterPlan:
    """The backward chain's level scatter (`csrc/bwd_chain.cuh:scatter_gz`)
    as a plan of global units of `ops/scatter_plan.py`, for counting its
    reductions into device memory with `count_reductions`: each of the `nb`
    = SB * NS maps' `n` points goes in runs of a tile's points (64 // NS,
    the chain's `chain_points`), one vector reduction of `vec` floats a lane
    and nonzero tap a run of points with the same tap base; `vec` 4 where a
    level's channel count and offset in the latent row are multiples of 4,
    else 2."""
    run = 64 // ns if ns < 64 else 1
    segments, c0, first = [], 0, 0
    for i, (_, _, c) in enumerate(levels):
        vec = 4 if c % 4 == 0 and c0 % 4 == 0 else 2
        nchunks = -(-n // run)
        segments.append(Segment(i, False, c, 1, run, nchunks, vec, first, nb * nchunks, 0))
        c0 += c
        first += nb * nchunks
    return ScatterPlan(tuple(segments), first, 0, run)


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
        if f.dtype != feats[0].dtype:
            raise ValueError("levels must share one dtype")
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
    lib = load_library("field_fwd")
    lib.pnt_field_fwd_smem_bytes.restype = ctypes.c_size_t
    lib.pnt_field_fwd_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.pnt_error_string.restype = ctypes.c_char_p
    lib.pnt_error_string.argtypes = [ctypes.c_int]
    lib.pnt_field_fwd.restype = ctypes.c_int
    lib.pnt_field_fwd.argtypes = (
        [ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int), ctypes.c_int]
        + [ctypes.c_void_p] * 16
        + [ctypes.c_int] * 9
        + [ctypes.c_void_p]
    )
    return lib


def _launch(feats, grid, xin, w, n_blocks, combine_layer, ns, stash: bool):
    """(out, zstash, stash_pre, stash_post); the three stash tensors are
    None without `stash`. Widths go through `ops/resnetfc.py:chain_plan`:
    the kernel reads the levels whole, so a d_latent off 64 gets its zero
    channels on the last (coarsest, smallest) level, and the z-stash and
    the stash come back at the chain's widths, as the backward takes them;
    each group of 16 outputs is a run, the first with the stash."""
    w = pack_field_weights(w)
    d_latent = w.wz.shape[1]
    hidden, dl, groups = chain_plan(w.w_in.shape[1], d_latent, xin.shape[3], w.w_out.shape[1])
    if dl != d_latent:
        feats = (*feats[:-1], _pad_last(feats[-1], feats[-1].shape[3] + dl - d_latent))
    w = pad_chain_weights(w, hidden, dl)
    runs = [_launch_chain(feats, grid, xin, out_group(w, i), n_blocks, combine_layer, ns,
                          stash and i == 0) for i in range(groups)]
    out = runs[0][0] if groups == 1 else torch.cat([r[0] for r in runs], -1)
    return (out, *runs[0][1:])


def _launch_chain(feats, grid, xin, w, n_blocks, combine_layer, ns, stash: bool):
    device = grid.device
    sb, _, b, d_in = xin.shape
    d_in_pad, hidden = w.w_in.shape
    d_latent = w.wz.shape[1]
    d_out = w.w_out.shape[1]
    for f in feats:
        if f.dtype != torch.bfloat16 or not f.is_contiguous() or f.device != device:
            raise ValueError("levels must be contiguous bf16 tensors on the grid's device")
        if f.shape[3] % 2:
            raise ValueError("level channel counts must be even")
    xin = even_d_in(xin)
    d_in = xin.shape[3]
    check_chain_widths(hidden, d_latent, d_in, d_out, ns)
    if grid.dtype != torch.float32 or xin.dtype != torch.bfloat16:
        raise TypeError("grid must be float32 and xin bf16")
    if any(t.device != device for t in w):
        raise ValueError("weights must be on the grid's device")
    lib = _library()
    smem = lib.pnt_field_fwd_smem_bytes(hidden, d_latent, d_in_pad, ns)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"a field tile of {ns} views at d_hidden={hidden} d_latent={d_latent} needs {smem} B "
            f"of shared memory (> {SMEM_LIMIT})"
        )
    grid = grid.contiguous()
    xin = xin.contiguous()
    out = torch.empty((sb, b, d_out), dtype=torch.float32, device=device)
    zstash = spre = spost = None
    if stash:
        k, m = stash_layout(n_blocks, combine_layer, ns)
        zstash = torch.empty((sb, ns, b, d_latent), dtype=torch.bfloat16, device=device)
        if k:
            spre = torch.empty((2 * k, sb, ns, b, hidden), dtype=torch.bfloat16, device=device)
        spost = torch.empty((2 * m + 1, sb, b, hidden), dtype=torch.bfloat16, device=device)

    nlev = len(feats)
    ptrs = (ctypes.c_void_p * nlev)(*[f.data_ptr() for f in feats])
    dims = (ctypes.c_int * (3 * nlev))(*[d for hwc in _levels(feats) for d in hwc])
    ptr = lambda t: 0 if t is None else t.data_ptr()
    err = lib.pnt_field_fwd(
        ptrs, dims, nlev, grid.data_ptr(), xin.data_ptr(),
        *[t.data_ptr() for t in w], out.data_ptr(), ptr(zstash), ptr(spre), ptr(spost),
        sb, ns, b, d_in, d_in_pad, hidden, d_out, n_blocks, combine_layer,
        torch.cuda.current_stream(device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"field_fwd launch failed: {lib.pnt_error_string(err).decode()}")
    return out, zstash, spre, spost


def pyramid_field_fused_fwd_stash(
    feats: Sequence[torch.Tensor], grid: torch.Tensor, xin: torch.Tensor,
    weights: FieldWeights, n_blocks: int, combine_layer: int, ns: int,
):
    """The forward that also writes the bf16 stash: (out (SB, B, d_out)
    float32, zstash (SB, NS, B, d_latent), stash_pre or None, stash_post)."""
    feats = tuple(feats)
    _check(feats, grid, xin, weights, n_blocks, combine_layer, ns)
    if _device_of(grid, "pyramid_field_fused_fwd_stash") == "cpu":
        return field_plain(feats, grid, xin, weights, n_blocks, combine_layer, ns, stash=True)
    if not _chains_take(sum(f.shape[3] for f in feats), xin, weights, ns):
        return layer_chain.layered_field_fwd(feats, grid, xin, weights, n_blocks, combine_layer, ns,
                                             stash=True)
    res = _launch(feats, grid, xin, weights, n_blocks, combine_layer, ns, stash=True)
    pyramid_field_fused_fwd_stash.launches += out_groups(res[0].shape[-1])
    return res


pyramid_field_fused_fwd_stash.launches = 0


def pyramid_field_fused_bwd(
    grid: torch.Tensor, xin: torch.Tensor, g: torch.Tensor, zstash: torch.Tensor,
    stash_pre, stash_post: torch.Tensor, weights: FieldWeights, n_blocks: int,
    combine_layer: int, ns: int, levels: Sequence[Tuple[int, int, int]],
):
    """The backward from the stash of `pyramid_field_fused_fwd_stash` and
    the output cotangent g (SB, B, d_out): (d_feats [(SB*NS, H_l, W_l,
    C_l)] in the levels' dtype, dxin in xin's dtype, float32 FieldWeights
    gradients with w_in (d_in, H)).

    :param levels (H_l, W_l, C_l) of each native level, finest first
    """
    levels = [tuple(int(d) for d in hwc) for hwc in levels]
    d_latent = sum(c for _, _, c in levels)
    # the card's z-stash may come at the chain's d_latent (`_launch`)
    if zstash.shape[3] not in (d_latent, -(-d_latent // 64) * 64) or not 1 <= len(levels) <= _MAX_LEVELS:
        raise ValueError("levels do not match the z-stash")
    if not field_supported(ns, n_blocks, combine_layer):
        raise ValueError(f"unsupported field config ns={ns} n_blocks={n_blocks}")
    if _device_of(grid, "pyramid_field_fused_bwd") == "cpu":
        return field_bwd_plain(
            grid, xin, g, zstash, stash_pre, stash_post, weights, n_blocks, combine_layer, ns,
            levels,
        )
    if any(c % 2 for _, _, c in levels):
        raise ValueError("level channel counts must be even")
    if not _chains_take(d_latent, xin, weights, ns):
        d_feats, dxin, dw = layer_chain.layered_field_bwd(
            grid, xin, g, zstash, stash_pre, stash_post, weights, n_blocks, combine_layer, ns, levels)
        return [d.to(zstash.dtype) for d in d_feats], dxin, dw
    d_feats, dxin, dw, _ = launch_bwd(
        zstash, xin, g, stash_pre, stash_post, weights, n_blocks, combine_layer, ns,
        levels=levels, grid=grid,
    )
    pyramid_field_fused_bwd.launches += out_groups(g.shape[-1])
    return [d.to(zstash.dtype) for d in d_feats], dxin, dw


pyramid_field_fused_bwd.launches = 0


class _FieldFn(torch.autograd.Function):
    """Forward with stash, backward from it: the stash is the saved
    tensors (no recomputation); the feature maps are not kept."""

    @staticmethod
    def forward(ctx, grid, xin, cfg, nlev, *tensors):
        feats, w = tensors[:nlev], FieldWeights(*tensors[nlev:])
        out, zstash, spre, spost = pyramid_field_fused_fwd_stash(feats, grid, xin, w, *cfg)
        ctx.cfg = cfg
        ctx.levels = _levels(feats)
        ctx.has_pre = spre is not None
        ctx.save_for_backward(grid, xin, zstash, spost, *([spre] if ctx.has_pre else []), *w)
        return out

    @staticmethod
    def backward(ctx, g):
        grid, xin, zstash, spost, *rest = ctx.saved_tensors
        spre = rest.pop(0) if ctx.has_pre else None
        d_feats, dxin, dw = pyramid_field_fused_bwd(
            grid, xin, g, zstash, spre, spost, FieldWeights(*rest), *ctx.cfg, ctx.levels,
        )
        grads = (*d_feats, *dw)
        grads = tuple(d if need else None for d, need in zip(grads, ctx.needs_input_grad[4:]))
        return (torch.zeros_like(grid), dxin, None, None) + grads


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
    :param weights FieldWeights, packed (pack_field_weights) or the float32
        parameters in (in, out) orientation
    :return (SB, B, d_out) float32, before the rgb/sigma heads
    """
    feats = tuple(feats)
    _check(feats, grid, xin, weights, n_blocks, combine_layer, ns)
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in (*feats, grid, xin, *weights)
    ):
        return _FieldFn.apply(grid, xin, (n_blocks, combine_layer, ns), len(feats), *feats, *weights)
    if _device_of(grid, "pyramid_field_fused") == "cpu":
        return field_plain(feats, grid, xin, weights, n_blocks, combine_layer, ns)
    if not _chains_take(sum(f.shape[3] for f in feats), xin, weights, ns):
        return layer_chain.layered_field_fwd(feats, grid, xin, weights, n_blocks, combine_layer, ns,
                                             False)[0]
    out = _launch(feats, grid, xin, weights, n_blocks, combine_layer, ns, stash=False)[0]
    pyramid_field_fused.launches += out_groups(out.shape[-1])
    return out


pyramid_field_fused.launches = 0
