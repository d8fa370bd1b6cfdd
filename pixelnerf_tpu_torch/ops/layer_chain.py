"""The layered ResnetFC path: the fused ResnetFC and field at the widths
the block chains are not built for, one hand-written kernel launch a
product.

The chains (`csrc/fwd_chain.cuh`, `csrc/bwd_chain.cuh`) keep a tile's f32
residual stream in registers and its views in one 64-row product, so they
take hidden (and the padded d_in) up to 512 and at most 64 views
(`ops/resnetfc.py:chain_widths_ok`). The TPU kernels they replace
(`pixelnerf_tpu/ops/resnetfc_pallas.py`: `_fwd_kernel`, `_fwd_stash_kernel`,
`_bwd_kernel`; `pixelnerf_tpu/ops/field_pallas.py`: `_field_fwd_kernel`,
`_field_bwd_kernel`) check neither, so every other width takes this path on
the card (`ops/resnetfc.py:takes_chains`). The CUDA C++ kernels are in
`csrc/layer_chain.cu`, whose header note gives the bound on the H100 and
the design:

- `layer_fwd`: v = bf(A) @ W + b with the epilogue into the f32 residual
  (x = v or x += v) and the bf16 copy bf(relu(v)), which is the next
  product's operand and the stash slot;
- `layer_bwd`: v = bf(A) @ W^T * [mask > 0] with the same epilogue (no
  relu) and the column sums of v (the bias gradients: each CTA's sums in a
  workspace the wrapper allocates, added in a fixed order by a second
  launch, `layer_colsum`);
- `view_pool_fwd`: the mean over the views at combine_layer and its relu'd
  bf16 copy, a stream of 16-byte accesses that adds the views in order;
  `view_pool_bwd`: the broadcast of the cotangent / NS, its bf16 copy and
  column sums (per row-block sums in a workspace, added in a fixed order
  by a second launch, `view_pool_colsum`; with NS = 1 also bf(g) for the
  weight gradients);
- `layer_wgrad`: the weight gradients by `csrc/wgrad.cuh`'s grouped
  products and fixed-order reduction, unchanged, from the cotangents the
  products wrote in the chain's layout.

`layered_fwd` and `layered_bwd` sequence them with the chain's cast points
(f32 residual stream, bf16 product operands) and its stash
(`stash_layout`'s slots, the same bf16 values), so that either path's
backward consumes either path's stash; `layered_field_fwd` /
`layered_field_bwd` put the pyramid gather and scatter kernels
(`ops/pyramid.py`) around them, the gathered z being the z-stash. Hidden
is zero-padded to a multiple of 64 and d_latent as `chain_plan` pads it;
d_out takes no output groups (one product takes any N). Each kernel
wrapper launches on CUDA tensors and counts each launch (`.launches`;
`layer_wgrad` two a call, `layer_bwd` and `view_pool_bwd` two where they
sum columns; `layer_fwd.plan` / `layer_bwd.plan` hold the last product's
`LayerPlan`);
on CPU tensors it runs its plain version (`*_plain`), which the CPU tests
compose into the same sequence. A and W are read by TMA: their rows must
start on 16 bytes and lie a multiple of 8 elements apart.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from pixelnerf_tpu_torch.ops.cuda_build import load_library
from pixelnerf_tpu_torch.ops.pyramid import pyramid_gather, pyramid_scatter_add
from pixelnerf_tpu_torch.ops.resnetfc_common import (
    FieldWeights, _pad16, _pad_last, cut_weight_grads, pack_field_weights,
    pad_chain_weights, resnetfc_wgrad_plain, stash_layout,
)

__all__ = [
    "layer_fwd",
    "layer_bwd",
    "view_pool_fwd",
    "view_pool_bwd",
    "layer_wgrad",
    "layer_fwd_plain",
    "layer_bwd_plain",
    "view_pool_fwd_plain",
    "view_pool_bwd_plain",
    "layered_widths",
    "layered_fwd",
    "layered_bwd",
    "layered_field_fwd",
    "layered_field_bwd",
]

_BF = torch.bfloat16
_F32 = torch.float32


def layered_widths(hidden: int, d_latent: int) -> Tuple[int, int]:
    """(hidden, d_latent) the layered path runs: hidden zero-padded to a
    multiple of 64 (whole 64-column boxes of the weight-gradient products
    per injection), d_latent as `chain_plan` pads it (a multiple of 64)."""
    return -(-hidden // 64) * 64, -(-d_latent // 64) * 64


def _device_of(t: torch.Tensor, what: str) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on CUDA or CPU tensors, got {t.device}")
    return t.device.type


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built `csrc/layer_chain.cu`, its C signatures bound once."""
    lib = load_library("layer_chain")
    lib.pnt_error_string.restype = ctypes.c_char_p
    lib.pnt_error_string.argtypes = [ctypes.c_int]
    lib.pnt_layer.restype = ctypes.c_int
    lib.pnt_layer.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
                              ctypes.c_int, ctypes.c_void_p]
    lib.pnt_layer_plan.restype = ctypes.c_int
    lib.pnt_layer_plan.argtypes = [ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.pnt_view_pool_fwd.restype = ctypes.c_int
    lib.pnt_view_pool_fwd.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.pnt_view_pool_bwd_workspace.restype = ctypes.c_longlong
    lib.pnt_view_pool_bwd_workspace.argtypes = [ctypes.c_int] * 3
    lib.pnt_view_pool_bwd.restype = ctypes.c_int
    lib.pnt_view_pool_bwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.pnt_wgrad_workspace.restype = ctypes.c_longlong
    lib.pnt_wgrad_workspace.argtypes = [ctypes.POINTER(ctypes.c_int),
                                        ctypes.POINTER(ctypes.c_longlong)]
    lib.pnt_layer_wgrad.restype = ctypes.c_int
    lib.pnt_layer_wgrad.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
                                    ctypes.c_int, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    return lib


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: {_library().pnt_error_string(err).decode()}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _ptr(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.data_ptr()


def _rows_of(t: Optional[torch.Tensor], dtype, m: int, what: str) -> int:
    """The row stride of a 2-D operand or output of `m` rows with unit
    column stride (0 for None)."""
    if t is None:
        return 0
    if t.dtype != dtype or t.ndim != 2 or t.shape[0] != m or t.stride(1) != 1:
        raise ValueError(f"{what} must be a 2-D {dtype} tensor of {m} rows with unit column stride")
    return t.stride(0)


def _epilogue(v, x, add, y, relu, colsum, cols):
    v = v[:, :cols]
    if add:
        v = x[:, :cols] + v
    if x is not None:
        x[:, :cols] = v
    if y is not None:
        y[:, :cols] = (torch.relu(v) if relu else v).to(_BF)
    if colsum is not None:
        colsum += v.sum(dim=0)


def layer_fwd_plain(a, w, bias, x=None, add=False, y=None, relu=True, cols=None):
    """The plain version of `layer_fwd`, in place on x and y."""
    v = a.float() @ w.float()
    if bias is not None:
        v = v + bias
    _epilogue(v, x, add, y, relu, None, cols or w.shape[1])


def layer_bwd_plain(a, w, mask=None, x=None, add=False, y=None, colsum=None, cols=None):
    """The plain version of `layer_bwd`, in place on x, y and colsum."""
    v = a.float() @ w.float().t()
    cols = cols or w.shape[0]
    if mask is not None:
        v = v[:, :cols] * (mask[:, :cols] > 0)
    _epilogue(v, x, add, y, False, colsum, cols)


def _tma_rows(t: torch.Tensor, m: int, what: str) -> int:
    """The row stride of A or W (bf16, `m` rows), which TMA reads in rows
    of a multiple of 16 bytes from a 16-byte aligned start."""
    ld = _rows_of(t, _BF, m, what)
    if ld % 8 or t.data_ptr() % 16:
        raise ValueError(f"{what} must start on 16 bytes with rows a multiple of 8 elements apart "
                         f"(TMA), got a row stride of {ld}")
    return ld


class LayerPlan(NamedTuple):
    """A product's launch (`csrc/layer_chain.cu:layer_plan`): its N tile
    (64 or 128 columns), N tiles, row slots, persistent grid (slots x N
    tiles) and 128-row tiles."""
    bn: int
    n_tiles: int
    slots: int
    grid: int
    row_tiles: int


def _layer(wt: int, a, w, bias, mask, x, add, y, relu, colsum, cols, what):
    """Launch one product: (its LayerPlan, the kernels launched: the column
    sums' reduction is a second)."""
    m, k = a.shape
    n = w.shape[0] if wt else w.shape[1]
    if (w.shape[1] if wt else w.shape[0]) != k:
        raise ValueError(f"{what}: A is {tuple(a.shape)}, W {tuple(w.shape)}")
    cols = cols or n
    ints = [
        m, n, k, _tma_rows(a, m, f"{what} A"), _tma_rows(w, w.shape[0], f"{what} W"),
        _rows_of(mask, _BF, m, f"{what} mask"), _rows_of(x, _F32, m, f"{what} x"),
        _rows_of(y, _BF, m, f"{what} y"), cols, int(add), int(relu),
    ]
    for t, need in ((bias, n), (colsum, cols)):
        if t is not None and (t.dtype != _F32 or not t.is_contiguous() or t.numel() < need):
            raise ValueError(f"{what}: bias and colsum are contiguous f32 vectors")
    if any(t is not None and t.device != a.device for t in (w, bias, mask, x, y, colsum)):
        raise ValueError(f"{what}: every tensor on A's device")
    lib = _library()
    cints = (ctypes.c_int * 11)(*ints)
    plan = (ctypes.c_int * 6)()
    _raise_on(lib.pnt_layer_plan(cints, plan), what)
    reduce = colsum is not None and m > 0 and cols > 0
    ws = torch.empty(plan[4] if reduce else 0, dtype=_F32, device=a.device)
    ptrs = (ctypes.c_void_p * 8)(*[_ptr(t) for t in (a, w, bias, mask, x, y, colsum, ws)])
    _raise_on(lib.pnt_layer(ptrs, cints, wt, _stream(a)), what)
    return LayerPlan(plan[0], plan[1], plan[2], plan[3], plan[5]), 1 + reduce


def layer_fwd(a: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
              x: Optional[torch.Tensor] = None, add: bool = False, y: Optional[torch.Tensor] = None,
              relu: bool = True, cols: Optional[int] = None) -> None:
    """v = bf(a) @ w + bias, then v += x (add), x = v (x given), y =
    bf(relu(v)) or bf(v) (y given), over the first `cols` columns (all of
    w's N by default).

    :param a (M, K) bf16, rows of unit column stride
    :param w (K, N) bf16; K and N multiples of 8
    :param bias (N,) float32 or None
    :param x (M, >= cols) float32 residual, updated in place
    :param y (M, >= cols) bf16 output
    """
    if _device_of(a, "layer_fwd") == "cpu":
        return layer_fwd_plain(a, w, bias, x, add, y, relu, cols)
    layer_fwd.plan, n = _layer(0, a, w, bias, None, x, add, y, relu, None, cols, "layer_fwd")
    layer_fwd.launches += n


layer_fwd.launches = 0
layer_fwd.plan = None


def layer_bwd(a: torch.Tensor, w: torch.Tensor, mask: Optional[torch.Tensor] = None,
              x: Optional[torch.Tensor] = None, add: bool = False, y: Optional[torch.Tensor] = None,
              colsum: Optional[torch.Tensor] = None, cols: Optional[int] = None) -> None:
    """v = bf(a) @ w^T * [mask > 0], then v += x (add), x = v, y = bf(v),
    colsum += the column sums of v, over the first `cols` columns.

    :param a (M, K) bf16
    :param w (N, K) bf16: the weight as the forward reads it (in, out)
    :param mask (M, >= cols) bf16 stash slot or None
    """
    if _device_of(a, "layer_bwd") == "cpu":
        return layer_bwd_plain(a, w, mask, x, add, y, colsum, cols)
    layer_bwd.plan, n = _layer(1, a, w, None, mask, x, add, y, False, colsum, cols, "layer_bwd")
    layer_bwd.launches += n


layer_bwd.launches = 0
layer_bwd.plan = None


def view_pool_fwd_plain(x, out, y=None):
    """The plain version of `view_pool_fwd`, in place on out and y."""
    out.copy_(x.mean(dim=1).reshape(out.shape))
    if y is not None:
        y.copy_(torch.relu(out).to(_BF).reshape(y.shape))


def view_pool_fwd(x: torch.Tensor, out: torch.Tensor, y: Optional[torch.Tensor] = None) -> None:
    """The mean over the views: x (SB, NS, B, H) float32 into out (SB*B, H)
    float32, and bf(relu(out)) into y (SB*B, H) bf16 if given, the views
    added in order."""
    if _device_of(x, "view_pool_fwd") == "cpu":
        return view_pool_fwd_plain(x, out, y)
    sb, ns, b, h = x.shape
    for t, dt in ((x, _F32), (out, _F32), (y, _BF)):
        if t is not None and (t.dtype != dt or not t.is_contiguous() or t.device != x.device):
            raise ValueError("view_pool_fwd takes contiguous tensors on one device")
    if out.numel() != sb * b * h or (y is not None and y.numel() != sb * b * h):
        raise ValueError("view_pool_fwd: out and y must hold (SB*B, H)")
    _raise_on(_library().pnt_view_pool_fwd(x.data_ptr(), out.data_ptr(), _ptr(y), sb, ns, b, h,
                                           _stream(x)), "view_pool_fwd")
    view_pool_fwd.launches += 1


view_pool_fwd.launches = 0


def view_pool_bwd_plain(g, ns, gx=None, y=None, colsum=None):
    """The plain version of `view_pool_bwd`, in place on gx, y and colsum."""
    sb, b, c = g.shape
    v = (g / float(ns))[:, None].expand(sb, ns, b, c)
    if gx is not None:
        gx.copy_(v.reshape(gx.shape))
    if y is not None:
        yv = y.view(sb, ns, b, -1)
        yv.zero_()
        yv[..., :c] = v.to(_BF)
    if colsum is not None:
        colsum += v.reshape(-1, c).sum(dim=0)


def view_pool_bwd(g: torch.Tensor, ns: int, gx: Optional[torch.Tensor] = None,
                  y: Optional[torch.Tensor] = None, colsum: Optional[torch.Tensor] = None) -> None:
    """The pooling's backward: v = g / ns broadcast over the views, for g
    (SB, B, C) float32: gx (SB*NS*B, C) float32 = v, y (SB*NS*B, L >= C)
    bf16 = bf(v) zero past C, colsum (C,) += the sums of v over every row
    (in a fixed order: a second launch adds the row blocks' sums). With
    ns = 1, y is the bf16 copy of the output cotangent."""
    if _device_of(g, "view_pool_bwd") == "cpu":
        return view_pool_bwd_plain(g, ns, gx, y, colsum)
    sb, b, c = g.shape
    ldy = 0 if y is None else y.shape[-1]
    for t, dt in ((g, _F32), (gx, _F32), (y, _BF), (colsum, _F32)):
        if t is not None and (t.dtype != dt or not t.is_contiguous() or t.device != g.device):
            raise ValueError("view_pool_bwd takes contiguous tensors on one device")
    if (gx is not None and gx.numel() != sb * ns * b * c) or (
            y is not None and (y.numel() != sb * ns * b * ldy or ldy < c)):
        raise ValueError("view_pool_bwd: gx must hold (SB*NS*B, C), y (SB*NS*B, >= C)")
    lib = _library()
    reduce = colsum is not None and sb * b > 0 and c > 0
    ws = torch.empty(lib.pnt_view_pool_bwd_workspace(sb, b, c) if reduce else 0, dtype=_F32,
                     device=g.device)
    _raise_on(lib.pnt_view_pool_bwd(g.data_ptr(), _ptr(gx), _ptr(y), _ptr(colsum), _ptr(ws), sb,
                                    ns, b, c, ldy, _stream(g)), "view_pool_bwd")
    view_pool_bwd.launches += 1 + reduce


view_pool_bwd.launches = 0


def layer_wgrad(z, xin_pad, d_in, stash_pre, stash_post, gpre, gpost, gin, gout, dw,
                n_blocks, combine_layer, ns, d_out) -> None:
    """The weight gradients act^T @ G of the layered backward, added into
    dw's w_in (d_in, H), wz, w0, w1 and w_out: `csrc/wgrad.cuh`'s grouped
    products and fixed-order reduction on the cotangents in the chain's
    layout (`resnetfc_cotangents_plain`'s, gout (SB, B, pad16(d_out)));
    on CPU tensors `resnetfc_wgrad_plain`."""
    if _device_of(z, "layer_wgrad") == "cpu":
        want = resnetfc_wgrad_plain(z, xin_pad[..., :d_in], stash_pre, stash_post, gpre, gpost, gin,
                                    gout, n_blocks, combine_layer, ns, d_out)
        for name, t in want.items():
            getattr(dw, name).add_(t)
        return
    sb, _, b, dl = z.shape
    d_in_pad, hidden = xin_pad.shape[-1], gin.shape[-1]
    lib = _library()
    dims = (ctypes.c_int * 10)(sb, ns, b, dl, d_in, d_in_pad, hidden, d_out, n_blocks, combine_layer)
    ws_floats = lib.pnt_wgrad_workspace(dims, (ctypes.c_longlong * 4)())
    if ws_floats < 0:
        raise ValueError(f"the weight-gradient products take at most 14 blocks, got {n_blocks}")
    ws = torch.empty(ws_floats, dtype=_F32, device=z.device)
    tensors = [z, xin_pad, stash_pre, stash_post, gpre, gpost, gin, gout, dw.w_in, dw.wz, dw.w0,
               dw.w1, dw.w_out, ws]
    if any(t is not None and not t.is_contiguous() for t in tensors):
        raise ValueError("layer_wgrad takes contiguous tensors")
    launched = (ctypes.c_int * 1)(0)
    err = lib.pnt_layer_wgrad((ctypes.c_void_p * 14)(*[_ptr(t) for t in tensors]), dims,
                              gout.shape[-1], _stream(z), launched)
    layer_wgrad.launches += launched[0]
    _raise_on(err, "layer_wgrad")


layer_wgrad.launches = 0


def _prepare(z, w, stash_pre=None, stash_post=None):
    """Packed weights, z and a stash at the layered widths, and those
    widths' (hidden, d_latent)."""
    w = pack_field_weights(w)
    hidden, dl = layered_widths(w.w_in.shape[1], z.shape[3])
    w = pad_chain_weights(w, hidden, dl)
    return (w, _pad_last(z, dl).contiguous(), _pad_last(stash_pre, hidden),
            _pad_last(stash_post, hidden), hidden, dl)


def _padded_out(w: FieldWeights):
    """W_out and b_out with zero columns up to a multiple of 16 (the
    products' N is a multiple of 8; 16 is the chain's bf(g) width)."""
    d_out = w.w_out.shape[1]
    n = _pad16(d_out)
    return _pad_last(w.w_out, n).contiguous(), _pad_last(w.b_out, n).contiguous()


def _slots(stash, rows, hidden):
    return None if stash is None else stash.view(stash.shape[0], rows, hidden)


def layered_fwd(z: torch.Tensor, xin: torch.Tensor, w: FieldWeights, n_blocks: int,
                combine_layer: int, ns: int, stash: bool):
    """The fused ResnetFC forward as layered launches: (out (SB, B, d_out)
    float32, stash_pre or None, stash_post) with the stash at the layered
    hidden width (`layered_widths`), both None without `stash`.

    :param z (SB, NS, B, d_latent), xin (SB, NS, B, d_in) bf16
    :param w FieldWeights, float32 (in, out) or packed
    """
    w, z, _, _, hidden, dl = _prepare(z, w)
    sb, _, b, _ = z.shape
    d_in_pad, d_out = w.w_in.shape[0], w.w_out.shape[1]
    k, m = stash_layout(n_blocks, combine_layer, ns)
    n_inj = min(combine_layer, n_blocks)
    mpre, mpost, dev = sb * ns * b, sb * b, z.device
    xp = _pad_last(xin, d_in_pad).contiguous().view(mpre, d_in_pad)
    zz = z.view(mpre, dl)
    empty = lambda *s, dt=_BF: torch.empty(s, dtype=dt, device=dev)
    if stash:
        spre = empty(2 * k, sb, ns, b, hidden) if k else None
        spost = empty(2 * m + 1, sb, b, hidden)
        pre, post = _slots(spre, mpre, hidden), _slots(spost, mpost, hidden)
        slot = lambda blk, h1: pre[k * h1 + blk] if blk < k else post[m * h1 + blk - k]
        rxf = post[2 * m]
    else:
        spre = spost = None
        # the primal keeps two slots a side: relu(x) and relu(h1)
        pre = empty(2, mpre, hidden) if k else None
        post = empty(2, mpost, hidden)
        slot = lambda blk, h1: (pre if blk < k else post)[h1]
        rxf = post[0]
    x_pre = empty(mpre, hidden, dt=_F32)
    x_post = empty(mpost, hidden, dt=_F32) if k else x_pre
    x = x_pre
    layer_fwd(xp, w.w_in, w.b_in, x=x)
    for blk in range(n_blocks):
        if k and blk == k:
            view_pool_fwd(x_pre.view(sb, ns, b, hidden), x_post, y=slot(blk, 0))
            x = x_post
        if blk < n_inj:
            layer_fwd(zz, w.wz[blk], w.bz[blk], x=x, add=True, y=slot(blk, 0))
        layer_fwd(slot(blk, 0), w.w0[blk], w.b0[blk], y=slot(blk, 1))
        nxt = blk + 1
        # relu(x) for the next block, unless an injection or the pooling
        # updates x first (their launch writes it)
        y = rxf if nxt == n_blocks else None if nxt < n_inj or (k and nxt == k) else slot(nxt, 0)
        layer_fwd(slot(blk, 1), w.w1[blk], w.b1[blk], x=x, add=True, y=y)
    w_out, b_out = _padded_out(w)
    out = empty(mpost, d_out, dt=_F32)
    layer_fwd(rxf, w_out, b_out, x=out, cols=d_out)
    return out.view(sb, b, d_out), spre, spost


def layered_bwd(z: torch.Tensor, xin: torch.Tensor, g: torch.Tensor,
                stash_pre: Optional[torch.Tensor], stash_post: torch.Tensor, w: FieldWeights,
                n_blocks: int, combine_layer: int, ns: int):
    """The fused ResnetFC backward as layered launches from either path's
    stash: (dz (SB, NS, B, d_latent) bf16, dxin (SB, NS, B, d_in) bf16,
    float32 FieldWeights gradients at the caller's widths, the bf16
    cotangents (gpre, gpost, gin, gout) at the layered widths)."""
    hidden_call = w.w_in.shape[1]
    dl_call, d_in = z.shape[3], xin.shape[3]
    w, z, stash_pre, stash_post, hidden, dl = _prepare(z, w, stash_pre, stash_post)
    sb, _, b, _ = z.shape
    d_in_pad, d_out = w.w_in.shape[0], w.w_out.shape[1]
    k, m = stash_layout(n_blocks, combine_layer, ns)
    n_inj = min(combine_layer, n_blocks)
    if (stash_pre is None) != (k == 0) or stash_post.shape != (2 * m + 1, sb, b, hidden):
        raise ValueError("the stash does not match this configuration")
    mpre, mpost, dev = sb * ns * b, sb * b, z.device
    empty = lambda *s, dt=_BF: torch.empty(s, dtype=dt, device=dev)
    zeros = lambda *s: torch.zeros(s, dtype=_F32, device=dev)
    gpre = empty(2 * k, sb, ns, b, hidden) if k else None
    gpost = empty(2 * m, sb, b, hidden)
    gin = empty(sb, ns, b, hidden)
    w_out, _ = _padded_out(w)
    gout = empty(sb, b, w_out.shape[1])
    spre, spost = _slots(stash_pre.contiguous() if k else None, mpre, hidden), _slots(
        stash_post.contiguous(), mpost, hidden)
    cpre, cpost = _slots(gpre, mpre, hidden), _slots(gpost, mpost, hidden)
    act = lambda blk, h1: spre[k * h1 + blk] if blk < k else spost[m * h1 + blk - k]
    cot = lambda blk, g0: cpre[k * g0 + blk] if blk < k else cpost[m * g0 + blk - k]
    db_in, db0, db1, db_out = zeros(hidden), zeros(n_blocks, hidden), zeros(n_blocks, hidden), zeros(d_out)
    gx_post = empty(mpost, hidden, dt=_F32)
    gx_pre = empty(mpre, hidden, dt=_F32) if k else gx_post
    gin2 = gin.view(mpre, hidden)

    view_pool_bwd(g.to(device=dev, dtype=_F32).contiguous(), 1, y=gout, colsum=db_out)
    layer_bwd(gout.view(mpost, -1), w_out, mask=spost[2 * m], x=gx_post, y=cot(n_blocks - 1, 0),
              colsum=db1[n_blocks - 1])
    gx = gx_post
    for blk in reversed(range(n_blocks)):
        layer_bwd(cot(blk, 0), w.w1[blk], mask=act(blk, 1), y=cot(blk, 1), colsum=db0[blk])
        pool = k and blk == k
        nxt_y, nxt_sum = (gin2, db_in) if blk == 0 else (None, None) if pool else (
            cot(blk - 1, 0), db1[blk - 1])
        layer_bwd(cot(blk, 1), w.w0[blk], mask=act(blk, 0), x=gx, add=True, y=nxt_y,
                  colsum=nxt_sum)
        if pool:
            view_pool_bwd(gx_post.view(sb, b, hidden), ns, gx=gx_pre, y=cot(blk - 1, 0),
                          colsum=db1[blk - 1])
            gx = gx_pre
    # g_z: the injections' cotangents (Gin, then G1 of the block before)
    # times their Wz^T, summed in f32 in injection order
    gz = empty(mpre, dl, dt=_F32)
    dz = empty(sb, ns, b, dl)
    for i in range(n_inj):
        layer_bwd(gin2 if i == 0 else cot(i - 1, 0), w.wz[i], x=gz, add=i > 0,
                  y=dz.view(mpre, dl) if i == n_inj - 1 else None)
    dxin = empty(mpre, d_in_pad)
    layer_bwd(gin2, w.w_in, y=dxin)
    xin_pad = _pad_last(xin, d_in_pad).contiguous()
    dw = FieldWeights(
        w_in=zeros(d_in, hidden), b_in=db_in,
        wz=zeros(n_inj, dl, hidden),
        bz=torch.stack([db_in] + [db1[i - 1] for i in range(1, n_inj)]),
        w0=zeros(n_blocks, hidden, hidden), b0=db0, w1=zeros(n_blocks, hidden, hidden), b1=db1,
        w_out=zeros(hidden, d_out), b_out=db_out,
    )
    layer_wgrad(z, xin_pad, d_in, stash_pre, stash_post, gpre, gpost, gin, gout, dw, n_blocks,
                combine_layer, ns, d_out)
    dw = cut_weight_grads(dw, d_in, hidden_call, dl_call)
    return (dz[..., :dl_call], dxin[:, :d_in].reshape(sb, ns, b, d_in), dw,
            (gpre, gpost, gin, gout))


def layered_field_fwd(feats: Sequence[torch.Tensor], grid: torch.Tensor, xin: torch.Tensor,
                      w: FieldWeights, n_blocks: int, combine_layer: int, ns: int, stash: bool):
    """The fused field's forward at the layered widths: the pyramid gather
    kernel, then `layered_fwd` on the gathered z: (out, zstash, stash_pre,
    stash_post), the z-stash being the gathered z (None without `stash`)."""
    sb, _, b, _ = xin.shape
    z = pyramid_gather(feats, grid.reshape(sb * ns, b, 2).float().contiguous())
    z = z.reshape(sb, ns, b, -1)
    out, spre, spost = layered_fwd(z, xin, w, n_blocks, combine_layer, ns, stash)
    return out, (z if stash else None), spre, spost


def layered_field_bwd(grid: torch.Tensor, xin: torch.Tensor, g: torch.Tensor, zstash: torch.Tensor,
                      stash_pre, stash_post, w: FieldWeights, n_blocks: int, combine_layer: int,
                      ns: int, levels: Sequence[Tuple[int, int, int]]):
    """The fused field's backward at the layered widths: `layered_bwd` from
    the z-stash, then the pyramid scatter kernel of bf(dz) onto the levels:
    (float32 level gradients [(SB*NS, H_l, W_l, C_l)], dxin, dw)."""
    sb, _, b, _ = xin.shape
    d_latent = sum(c for _, _, c in levels)
    dz, dxin, dw, _ = layered_bwd(zstash[..., :d_latent], xin, g, stash_pre, stash_post, w,
                                  n_blocks, combine_layer, ns)
    hws = [(h, wd) for h, wd, _ in levels]
    d_feats = pyramid_scatter_add(grid.reshape(sb * ns, b, 2).float().contiguous(),
                                  dz.reshape(sb * ns, b, d_latent).contiguous(),
                                  [c for _, _, c in levels], hws, hws[0])
    return d_feats, dxin, dw
