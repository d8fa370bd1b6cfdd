"""Fused ResnetFC on a (z, x) pair, with its backward.

Replaces the TPU kernels of `pixelnerf_tpu/ops/resnetfc_pallas.py`:
`_fwd_kernel` (the primal), `_fwd_stash_kernel` (the primal that also
writes the bf16 relu'd activations for the backward) and `_bwd_kernel`
(dz, dxin and every weight gradient from that stash, with no forward
recomputation). The CUDA C++ kernels are `csrc/resnetfc_fwd.cu` (one
kernel over `csrc/fwd_chain.cuh`; null stash pointers make it the primal)
and `csrc/resnetfc_bwd.cu` (the cotangent chain of `csrc/bwd_chain.cuh`,
then the weight-gradient products of `csrc/wgrad.cuh` in one grouped
launch and their fixed-order reduction); their header notes give the bound
on the H100 (operations) and the design.

The cast points are the TPU kernel's (`_dot`, `_dot_t`, `_dot_g`): every
matmul operand is bf16, both operands of the weight-gradient products
included, and every product and sum is float32; the residual stream is
float32; the relu masks of the backward come from the bf16 stash (> 0).
The port's stash layout is its own: `stash_pre` (2k, SB, NS, B, H) holds
[relu(block_in) | relu(h1)] of the k blocks before the view pooling (NS >
1), `stash_post` (2m+1, SB, B, H) those of the m others and relu(x_final).

`resnetfc_fused` is the entry point: with autograd recording and an input
that needs a gradient it runs the stash forward and, on backward, the
backward kernel (a `torch.autograd.Function` whose saved tensors are the
stash); otherwise it runs the stash-free forward. It takes bf16 or
float32 z and xin, as the TPU kernels do: the kernels read one bf16 copy
of a float32 input (the TPU kernel's cast at its products, bit for bit),
and the backward writes dz and dxin in the input's dtype, a float32
caller's unrounded (`grad_dtype`; the chain's F32 store, or the layered
path's float32 sums). Each of
`resnetfc_fwd`, `resnetfc_fwd_stash` and `resnetfc_bwd` launches its
kernel on CUDA tensors, once a group of 16 outputs, and counts each
launch (`.launches`, `out_groups`; `resnetfc_bwd.f32_launches` those of
them that write float32 dz and dxin); on CPU tensors it takes its plain
version (`*_plain`). At widths the chains lack after the wrappers'
padding (hidden or the padded d_in past 512, more than 64 views:
`takes_chains`) the CUDA wrappers run the layered kernels of
`ops/layer_chain.py` instead, which count their own launches. The fused
field (ops/field.py) shares the plain versions and the backward kernel;
both and the layered path share the weights' form, the stash's slots and
the padding (`ops/resnetfc_common.py`, whose names this module
re-exports).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch

from pixelnerf_tpu_torch.ops.cuda_build import SMEM_LIMIT, load_library
from pixelnerf_tpu_torch.ops import layer_chain
from pixelnerf_tpu_torch.ops.resnetfc_common import (
    FieldWeights, _dot_g, _pad16, _pad_last, cut_weight_grads, pack_field_weights,
    pad_chain_weights, resnetfc_wgrad_plain, stash_layout,
)
from pixelnerf_tpu_torch.utils.spans import span

__all__ = [
    "FieldWeights",
    "pack_field_weights",
    "resnetfc_fused",
    "resnetfc_fwd",
    "resnetfc_fwd_stash",
    "resnetfc_bwd",
    "resnetfc_fwd_plain",
    "resnetfc_bwd_plain",
    "resnetfc_cotangents_plain",
    "resnetfc_wgrad_plain",
    "supported_config",
    "stash_layout",
    "check_chain_widths",
    "chain_widths_ok",
    "chain_plan",
    "takes_chains",
    "pad_chain_weights",
    "even_d_in",
]

_GOUT_LD = 16  # columns of the backward's bf16 copy of g (csrc/bwd_chain.cuh)

_BF = torch.bfloat16


def supported_config(
    beta: float, use_spade: bool, combine_type: str, d_latent: int, d_in: int,
    combine_layer: Optional[int] = None, n_blocks: Optional[int] = None,
    ns: Optional[int] = None,
) -> bool:
    """Configurations the fused kernels take (the TPU kernel's
    `supported_config`): ReLU, no SPADE, average pooling, a latent and a
    positional code; with combine_layer/n_blocks known, at least one latent
    injection and, unless ns == 1 is known, the pooling inside the chain."""
    if not (beta == 0.0 and not use_spade and combine_type == "average"
            and d_latent > 0 and d_in > 0):
        return False
    if combine_layer is not None and n_blocks is not None:
        if min(combine_layer, n_blocks) == 0:
            return False
        if (ns is None or ns > 1) and combine_layer >= n_blocks:
            return False
    return True


def _dot(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a @ w with bf16 operands, float32 products and sums."""
    return a.to(_BF).float() @ w.to(_BF).float()


def _dot_t(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a @ w.T with bf16 operands: (..., N) x (K, N) -> (..., K)."""
    return a.to(_BF).float() @ w.to(_BF).float().t()


def _rows(t: torch.Tensor) -> torch.Tensor:
    """Sum over every axis but the last."""
    return t.reshape(-1, t.shape[-1]).sum(dim=0)


def resnetfc_fwd_plain(
    z: torch.Tensor, xin: torch.Tensor, w: FieldWeights, n_blocks: int,
    combine_layer: int, ns: int, stash: bool = False,
):
    """The plain version of the forward kernel: (SB, B, d_out) float32, and
    with `stash` also (stash_pre or None, stash_post)."""
    sb, _, b, _ = z.shape
    k, m = stash_layout(n_blocks, combine_layer, ns)
    n_inj = min(combine_layer, n_blocks)
    d_in = xin.shape[-1]
    if ns == 1:
        z, xin = z[:, 0], xin[:, 0]
    x = _dot(xin, w.w_in[:d_in]) + w.b_in
    bins, h1s = [], []
    for blk in range(n_blocks):
        if blk == combine_layer and ns > 1:
            x = x.mean(dim=1)
        if blk < n_inj:
            x = x + (_dot(z, w.wz[blk]) + w.bz[blk])
        rx = torch.relu(x).to(_BF)
        rh = torch.relu(_dot(rx, w.w0[blk]) + w.b0[blk]).to(_BF)
        x = x + (_dot(rh, w.w1[blk]) + w.b1[blk])
        bins.append(rx)
        h1s.append(rh)
    rxf = torch.relu(x).to(_BF)
    out = _dot(rxf, w.w_out) + w.b_out
    if not stash:
        return out
    spre = torch.stack(bins[:k] + h1s[:k]) if k else None
    spost = torch.stack(bins[k:] + h1s[k:] + [rxf])
    return out, spre, spost


def _chain_plain(g, stash_pre, stash_post, w, n_blocks, combine_layer, ns, sb, b):
    """The cotangent chain of the plain backward: float32 (gx at every
    block's output G1, gh1 G0, each injection's cotangent, gx at block 0's
    input)."""
    k, m = stash_layout(n_blocks, combine_layer, ns)
    n_inj = min(combine_layer, n_blocks)

    def act(blk, h1):
        if blk < k:
            return stash_pre[k * h1 + blk]
        return stash_post[m * h1 + blk - k]

    gx = _dot_t(g, w.w_out) * (stash_post[2 * m] > 0)
    g1s, g0s, g_inj = [None] * n_blocks, [None] * n_blocks, [None] * n_inj
    for blk in reversed(range(n_blocks)):
        rx, rh = act(blk, 0), act(blk, 1)
        g1s[blk] = gx
        gh1 = _dot_t(gx, w.w1[blk]) * (rh > 0)
        g0s[blk] = gh1
        gx = gx + _dot_t(gh1, w.w0[blk]) * (rx > 0)
        if blk < n_inj:
            g_inj[blk] = gx
        if blk == combine_layer and ns > 1:
            gx = (gx / float(ns))[:, None].expand(sb, ns, b, gx.shape[-1])
    return g1s, g0s, g_inj, gx


def resnetfc_bwd_plain(
    z: torch.Tensor, xin: torch.Tensor, g: torch.Tensor,
    stash_pre: Optional[torch.Tensor], stash_post: torch.Tensor,
    w: FieldWeights, n_blocks: int, combine_layer: int, ns: int,
    grad_dtype: Optional[torch.dtype] = None,
):
    """The plain version of the backward kernel: (dz in z's dtype, dxin in
    xin's dtype, FieldWeights of float32 weight gradients with w_in
    (d_in, H)); with `grad_dtype`, dz and dxin in that dtype instead (a
    float32 caller's from its bf16 copies of z and xin)."""
    sb, _, b, dl = z.shape
    d_in = xin.shape[-1]
    k, m = stash_layout(n_blocks, combine_layer, ns)
    n_inj = min(combine_layer, n_blocks)
    zz, xx = (z[:, 0], xin[:, 0]) if ns == 1 else (z, xin)

    def act(blk, h1):
        if blk < k:
            return stash_pre[k * h1 + blk]
        return stash_post[m * h1 + blk - k]

    g = g.float()
    rxf = stash_post[2 * m]
    g1s, g0s, g_inj, gx = _chain_plain(g, stash_pre, stash_post, w, n_blocks, combine_layer,
                                       ns, sb, b)
    gz = sum(_dot_t(g_inj[i], w.wz[i]) for i in range(n_inj))
    dxin = _dot_t(gx, w.w_in[:d_in])
    if ns == 1:
        gz, dxin = gz[:, None], dxin[:, None]
    dw = FieldWeights(
        w_in=_dot_g(xx, gx), b_in=_rows(gx),
        wz=torch.stack([_dot_g(zz, gi) for gi in g_inj]),
        bz=torch.stack([_rows(gi) for gi in g_inj]),
        w0=torch.stack([_dot_g(act(i, 0), g0s[i]) for i in range(n_blocks)]),
        b0=torch.stack([_rows(t) for t in g0s]),
        w1=torch.stack([_dot_g(act(i, 1), g1s[i]) for i in range(n_blocks)]),
        b1=torch.stack([_rows(t) for t in g1s]),
        w_out=_dot_g(rxf, g), b_out=_rows(g),
    )
    return gz.to(grad_dtype or z.dtype), dxin.to(grad_dtype or xin.dtype), dw


def resnetfc_cotangents_plain(
    g: torch.Tensor, stash_pre: Optional[torch.Tensor], stash_post: torch.Tensor,
    w: FieldWeights, n_blocks: int, combine_layer: int, ns: int,
):
    """The bf16 cotangents the backward kernel's chain hands its
    weight-gradient products, in its layout: (gpre (2k, SB, NS, B, H) or
    None, gpost (2m, SB, B, H), gin (SB, NS, B, H), gout (SB, B, 16) with
    bf(g) zero past d_out). `_dot_g` of each with its activation gives the
    plain backward's weight gradients."""
    sb, b, d_out = g.shape
    k, m = stash_layout(n_blocks, combine_layer, ns)
    g = g.float()
    g1s, g0s, _, gx = _chain_plain(g, stash_pre, stash_post, w, n_blocks, combine_layer, ns, sb, b)
    bf = lambda ts: torch.stack(ts).to(_BF)
    gpre = bf(g1s[:k] + g0s[:k]) if k else None
    gpost = bf(g1s[k:] + g0s[k:])
    gin = (gx[:, None] if ns == 1 else gx).to(_BF)
    gout = torch.zeros((sb, b, _GOUT_LD), dtype=_BF, device=g.device)
    gout[..., :d_out] = g.to(_BF)
    return gpre, gpost, gin, gout


def _check(z, xin, w, n_blocks, combine_layer, ns):
    if z.ndim != 4 or z.shape[1] != ns:
        raise ValueError(f"z must be (SB, {ns}, B, d_latent), got {tuple(z.shape)}")
    if xin.ndim != 4 or xin.shape[:3] != z.shape[:3]:
        raise ValueError(f"xin must be (SB, NS, B, d_in) like z, got {tuple(xin.shape)}")
    if w.wz.shape[1] != z.shape[3] or w.w_in.shape[0] < xin.shape[3]:
        raise ValueError("weights do not match d_latent / d_in")
    if w.wz.shape[0] != min(combine_layer, n_blocks) or w.w0.shape[0] != n_blocks:
        raise ValueError("weight stacks do not match n_blocks / combine_layer")
    if not supported_config(0.0, False, "average", z.shape[3], xin.shape[3],
                            combine_layer, n_blocks, ns):
        raise ValueError(
            f"unsupported config ns={ns} n_blocks={n_blocks} combine_layer={combine_layer}"
        )


# widths the chains (csrc/fwd_chain.cuh, csrc/bwd_chain.cuh) are compiled
# for: the powers of two that split into whole wgmma widths per warpgroup
CHAIN_HIDDEN = (64, 128, 256, 512)
# views one tile pools: a tile is one 64-row product (FWD_ROWS)
CHAIN_MAX_VIEWS = 64


def chain_widths_ok(hidden: int, d_latent: int, d_in: int, d_out: int, ns: int) -> bool:
    """Do the block chains (`csrc/fwd_chain.cuh` and `csrc/bwd_chain.cuh`,
    shared by the ResnetFC and field kernels, forward and backward) take
    these widths as they are? hidden 64, 128, 256 or 512, d_latent a
    multiple of 64 (their 128-byte swizzled operand tiles), an even d_in
    whose padding to 16 is at most hidden (it shares the relu(x) tile), at
    most 16 outputs and 1 to 64 views (past 64 a tile no longer fits one
    64-row product). The wrappers first bring a model's widths to these
    (`chain_plan`, `even_d_in`): what is left to refuse is a hidden width
    or d_in past 512 and more than 64 views."""
    return (
        hidden in CHAIN_HIDDEN
        and d_latent % 64 == 0
        and d_in % 2 == 0
        and _pad16(d_in) <= hidden
        and d_out <= 16
        and 1 <= ns <= CHAIN_MAX_VIEWS
    )


def check_chain_widths(hidden: int, d_latent: int, d_in: int, d_out: int, ns: int = 1) -> None:
    """Raise unless `chain_widths_ok`: the chain launches' own guard. The
    wrappers send the widths the chains lack after their padding (hidden
    or d_in past 512, more than 64 views) to the layered path
    (`takes_chains`), so this raises only on a direct launch at such
    widths."""
    if not chain_widths_ok(hidden, d_latent, d_in, d_out, ns):
        raise ValueError(
            f"the chain kernels take d_hidden in {CHAIN_HIDDEN}, d_latent a multiple of 64, an "
            f"even d_in <= d_hidden, d_out <= 16 and 1 to {CHAIN_MAX_VIEWS} views, got "
            f"d_hidden={hidden} d_latent={d_latent} d_in={d_in} d_out={d_out} views={ns}"
        )


def takes_chains(hidden: int, d_latent: int, d_in: int, d_out: int, ns: int) -> bool:
    """Do the block chains run a model of these widths once the wrappers
    have padded them (`chain_plan`, `even_d_in`, output groups)? Otherwise
    (hidden or the padded d_in past 512, more than 64 views) the CUDA
    wrappers launch the layered path (`ops/layer_chain.py`)."""
    h, dl, _ = chain_plan(hidden, d_latent, d_in, d_out)
    return chain_widths_ok(h, dl, d_in + d_in % 2, min(d_out, 16), ns)


def _chains_take(d_latent: int, xin, w: FieldWeights, ns: int) -> bool:
    """`takes_chains` for a call of these inputs and weights (the
    ResnetFC's and the field's wrappers)."""
    return takes_chains(w.w_in.shape[1], d_latent, xin.shape[3], w.w_out.shape[1], ns)


def even_d_in(xin: torch.Tensor) -> torch.Tensor:
    """xin with an odd d_in given one zero column: the chains read the
    positional code in bf16 pairs, and w_in's zero-padded row d_in meets
    the new column, so the product is unchanged."""
    return torch.nn.functional.pad(xin, (0, 1)) if xin.shape[-1] % 2 else xin


def _device_of(z: torch.Tensor, what: str) -> str:
    if z.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on CUDA or CPU tensors, got {z.device}")
    return z.device.type


def _cuda_inputs(z, xin, w):
    device = z.device
    for t in (z, xin):
        if t.dtype != _BF or t.device != device:
            raise TypeError("z and xin must be bf16 tensors on one device")
    w = pack_field_weights(w)
    if any(t.device != device for t in w):
        raise ValueError("weights must be on z's device")
    return z.contiguous(), xin.contiguous(), w


def chain_plan(hidden: int, d_latent: int, d_in: int, d_out: int) -> Tuple[int, int, int]:
    """(hidden, d_latent, output groups) at which the wrappers run a model
    of these widths on the chains, every one exact:

    - hidden zero-padded to the narrowest of CHAIN_HIDDEN that holds it
      and the padded positional code. A channel with zero weights in and
      out and a zero bias stays relu(0) = 0 through every block, the
      pooling and lin_out, and its weight gradients are zero and cut off.
      Past 512 it stays as it is, and `check_chain_widths` raises.
    - d_latent zero-padded to a multiple of 64: zero columns on z, zero
      rows on wz (for the field, zero channels on the last level).
    - d_out in ceil(d_out / 16) groups of 16 columns of W_out / b_out, a
      run of the chain each: the kernels' output layer is one n16
      product. The backward sums the groups' gradients (the loss is the
      sum of the groups' losses).
    """
    need = max(hidden, _pad16(d_in + d_in % 2))
    hidden_pad = next((h for h in CHAIN_HIDDEN if h >= need), hidden)
    return hidden_pad, -(-d_latent // 64) * 64, out_groups(d_out)


def out_groups(d_out: int) -> int:
    """The chain's runs for d_out outputs, one a group of 16 columns: what
    a wrapper adds to its `.launches` a call."""
    return max(1, -(-d_out // 16))


def out_group(w: FieldWeights, i: int) -> FieldWeights:
    """w with the i-th group of 16 output columns of W_out / b_out."""
    if w.w_out.shape[1] <= 16:
        return w
    cols = slice(16 * i, 16 * i + 16)
    return w._replace(w_out=w.w_out[:, cols].contiguous(), b_out=w.b_out[cols].contiguous())


def sum_groups(grads: Sequence[FieldWeights]) -> FieldWeights:
    """One FieldWeights gradient from the output groups' runs: each group
    gives W_out / b_out its own columns and adds to every other weight."""
    if len(grads) == 1:
        return grads[0]
    sums = {f: sum(getattr(d, f) for d in grads) for f in FieldWeights._fields[:-2]}
    return FieldWeights(**sums, w_out=torch.cat([d.w_out for d in grads], 1),
                        b_out=torch.cat([d.b_out for d in grads]))


@functools.lru_cache(maxsize=None)
def _library(name: str) -> ctypes.CDLL:
    """A built `csrc/<name>.cu`, its C signatures bound once."""
    return bind_library(load_library(name), name)


def bind_library(lib: ctypes.CDLL, name: str) -> ctypes.CDLL:
    """Bind the C signatures of `csrc/<name>.cu` ("resnetfc_fwd" or
    "resnetfc_bwd") on a loaded library."""
    lib.pnt_error_string.restype = ctypes.c_char_p
    lib.pnt_error_string.argtypes = [ctypes.c_int]
    if name == "resnetfc_fwd":
        lib.pnt_resnetfc_fwd_smem_bytes.restype = ctypes.c_size_t
        lib.pnt_resnetfc_fwd_smem_bytes.argtypes = [ctypes.c_int] * 4
        lib.pnt_resnetfc_fwd.restype = ctypes.c_int
        lib.pnt_resnetfc_fwd.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 10 + [
            ctypes.c_void_p
        ]
    else:
        lib.pnt_resnetfc_bwd_smem_bytes.restype = ctypes.c_size_t
        lib.pnt_resnetfc_bwd_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.pnt_resnetfc_bwd.restype = ctypes.c_int
        lib.pnt_resnetfc_bwd.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int), ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
        ]
        if hasattr(lib, "pnt_resnetfc_bwd_f32"):  # an earlier tree's library may lack it
            lib.pnt_resnetfc_bwd_f32.restype = ctypes.c_int
            lib.pnt_resnetfc_bwd_f32.argtypes = [
                ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int), ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_int),
            ]
        lib.pnt_wgrad_workspace.restype = ctypes.c_longlong
        lib.pnt_wgrad_workspace.argtypes = [
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_longlong),
        ]
    return lib


def _raise_on(err: int, lib, what: str):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: {lib.pnt_error_string(err).decode()}")


def _launch_fwd(z, xin, w, n_blocks, combine_layer, ns, stash: bool):
    """(out, stash_pre, stash_post) of `csrc/resnetfc_fwd.cu` at the
    caller's widths through `chain_plan`: the stash comes back at the
    chain's hidden width (its padded channels zero), as the backward takes
    it; the output groups after the first run without a stash (it is the
    same for every group)."""
    z, xin, w = _cuda_inputs(z, xin, w)
    d_out = w.w_out.shape[1]
    hidden, dl, groups = chain_plan(w.w_in.shape[1], z.shape[3], xin.shape[3], d_out)
    z, w = _pad_last(z, dl), pad_chain_weights(w, hidden, dl)
    outs = []
    for i in range(groups):
        out, spre_i, spost_i = _launch_fwd_chain(
            z, xin, out_group(w, i), n_blocks, combine_layer, ns, stash and i == 0)
        if i == 0:
            spre, spost = spre_i, spost_i
        outs.append(out)
    return (outs[0] if groups == 1 else torch.cat(outs, -1)), spre, spost


def _launch_fwd_chain(z, xin, w, n_blocks, combine_layer, ns, stash: bool):
    sb, _, b, dl = z.shape
    d_in_pad, hidden = w.w_in.shape
    d_out = w.w_out.shape[1]
    xin = even_d_in(xin)
    d_in = xin.shape[3]
    check_chain_widths(hidden, dl, d_in, d_out, ns)
    lib = _library("resnetfc_fwd")
    smem = lib.pnt_resnetfc_fwd_smem_bytes(hidden, dl, d_in_pad, ns)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"a ResnetFC tile of {ns} views at d_hidden={hidden} d_latent={dl} needs {smem} B "
            f"of shared memory (> {SMEM_LIMIT})")
    out = torch.empty((sb, b, d_out), dtype=torch.float32, device=z.device)
    spre = spost = None
    if stash:
        k, m = stash_layout(n_blocks, combine_layer, ns)
        if k:
            spre = torch.empty((2 * k, sb, ns, b, hidden), dtype=_BF, device=z.device)
        spost = torch.empty((2 * m + 1, sb, b, hidden), dtype=_BF, device=z.device)
    ptr = lambda t: 0 if t is None else t.data_ptr()
    err = lib.pnt_resnetfc_fwd(
        z.data_ptr(), xin.data_ptr(), *[t.data_ptr() for t in w], out.data_ptr(),
        ptr(spre), ptr(spost), sb, ns, b, dl, d_in, d_in_pad, hidden, d_out,
        n_blocks, combine_layer, torch.cuda.current_stream(z.device).cuda_stream,
    )
    _raise_on(err, lib, "resnetfc_fwd")
    return out, spre, spost


def resnetfc_fwd(z, xin, w: FieldWeights, n_blocks: int, combine_layer: int, ns: int):
    """The stash-free forward: (SB, B, d_out) float32.

    :param z (SB, NS, B, d_latent), xin (SB, NS, B, d_in), bf16 on CUDA
    :param w FieldWeights in (in, out) orientation, float32 or packed
    """
    _check(z, xin, w, n_blocks, combine_layer, ns)
    if _device_of(z, "resnetfc_fwd") == "cpu":
        return resnetfc_fwd_plain(z, xin, w, n_blocks, combine_layer, ns)
    if not _chains_take(z.shape[3], xin, w, ns):
        return layer_chain.layered_fwd(*_cuda_inputs(z, xin, w), n_blocks, combine_layer, ns,
                                       stash=False)[0]
    out = _launch_fwd(z, xin, w, n_blocks, combine_layer, ns, stash=False)[0]
    resnetfc_fwd.launches += out_groups(out.shape[-1])
    return out


resnetfc_fwd.launches = 0


def resnetfc_fwd_stash(z, xin, w: FieldWeights, n_blocks: int, combine_layer: int, ns: int):
    """The forward that also writes the bf16 stash: (out, stash_pre or
    None, stash_post)."""
    _check(z, xin, w, n_blocks, combine_layer, ns)
    if _device_of(z, "resnetfc_fwd_stash") == "cpu":
        return resnetfc_fwd_plain(z, xin, w, n_blocks, combine_layer, ns, stash=True)
    if not _chains_take(z.shape[3], xin, w, ns):
        return layer_chain.layered_fwd(*_cuda_inputs(z, xin, w), n_blocks, combine_layer, ns,
                                       stash=True)
    res = _launch_fwd(z, xin, w, n_blocks, combine_layer, ns, stash=True)
    resnetfc_fwd_stash.launches += out_groups(res[0].shape[-1])
    return res


resnetfc_fwd_stash.launches = 0


def launch_bwd(
    z, xin, g, stash_pre, stash_post, w: FieldWeights, n_blocks: int, combine_layer: int,
    ns: int, levels: Sequence[Tuple[int, int, int]] = (), grid: Optional[torch.Tensor] = None,
    grad_dtype: torch.dtype = _BF,
):
    """Launch `csrc/resnetfc_bwd.cu` on CUDA tensors: (dz, dxin, float32
    FieldWeights gradients, the chain's bf16 cotangents (gpre, gpost, gin,
    gout) as `resnetfc_cotangents_plain` gives them, at the chain's widths
    and of the first output group); with the field's `levels` ((H_l, W_l,
    C_l), finest first) and forward `grid` (SB, NS, B, 2), the float32
    level gradients [(SB*NS, H_l, W_l, C_l)] in place of dz. Widths go
    through `chain_plan`: z (or the z-stash), the weights, the last
    level's channels and a stash at the caller's hidden width are
    zero-padded, each output group runs the chain, and the gradients come
    back summed over the groups at the caller's widths. dz and dxin come
    back in `grad_dtype`: bf16, or float32 from the chain's float32 sums
    (a float32 caller's; not with `levels`). Counts the kernels
    it launches in `launch_bwd.chain_launches` (the cotangent chain) and
    `launch_bwd.wgrad_launches` (the weight-gradient products and their
    reduction: 2 a run), not the wrappers' `.launches`;
    `launch_bwd.wgrad_plan` holds the last run's workspace bytes, units,
    the most and fewest splits of a product and the bytes of the boxes
    its TMA loads read from L2."""
    z, xin, wp = _cuda_inputs(z, xin, w)
    if grad_dtype not in (_BF, torch.float32) or (levels and grad_dtype != _BF):
        raise ValueError(f"the backward writes bf16 or float32 dz and dxin (bf16 with levels), "
                         f"got {grad_dtype}")
    d_in, dl_call, hidden_call = xin.shape[3], z.shape[3], wp.w_in.shape[1]
    if levels:  # z is the field's z-stash, possibly at the chain's width already
        dl_call = sum(c for _, _, c in levels)
    hidden, dl, groups = chain_plan(hidden_call, dl_call, d_in, wp.w_out.shape[1])
    if levels and dl != dl_call:
        *finer, (h, wd, c) = levels
        levels = [*finer, (h, wd, c + dl - dl_call)]
    z, wp = _pad_last(z, dl), pad_chain_weights(wp, hidden, dl)
    stash_pre, stash_post = _pad_last(stash_pre, hidden), _pad_last(stash_post, hidden)
    g = g.to(device=z.device, dtype=torch.float32)
    runs = [
        _launch_bwd_chain(z, xin, g[..., 16 * i : 16 * i + 16] if groups > 1 else g, stash_pre,
                          stash_post, out_group(wp, i), n_blocks, combine_layer, ns, levels, grid,
                          grad_dtype)
        for i in range(groups)
    ]
    dz = [sum(ts) for ts in zip(*[r[0] for r in runs])] if levels else sum(r[0] for r in runs)
    dxin = sum(r[1] for r in runs)
    dw = cut_weight_grads(sum_groups([r[2] for r in runs]), d_in, hidden_call, dl_call)
    if levels:
        dz[-1] = dz[-1][..., : dz[-1].shape[-1] - (dl - dl_call)]
    else:
        dz = dz[..., :dl_call]
    return dz, dxin[..., :d_in], dw, runs[0][3]


def _launch_bwd_chain(z, xin, g, stash_pre, stash_post, wp, n_blocks, combine_layer, ns, levels,
                      grid, grad_dtype):
    sb, _, b, dl = z.shape
    d_in_pad, hidden = wp.w_in.shape
    d_out = wp.w_out.shape[1]
    k, m = stash_layout(n_blocks, combine_layer, ns)
    n_inj = min(combine_layer, n_blocks)
    xin = even_d_in(xin)
    d_in = xin.shape[3]
    check_chain_widths(hidden, dl, d_in, d_out, ns)
    lib = _library("resnetfc_bwd")
    smem = lib.pnt_resnetfc_bwd_smem_bytes(hidden, dl, ns)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"a ResnetFC backward tile of {ns} views at d_hidden={hidden} d_latent={dl} needs "
            f"{smem} B of shared memory (> {SMEM_LIMIT})")
    dev = z.device
    g = g.contiguous()
    if g.shape != (sb, b, d_out):
        raise ValueError(f"g must be {(sb, b, d_out)}, got {tuple(g.shape)}")
    empty = lambda *s: torch.empty(s, dtype=_BF, device=dev)
    zeros = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)
    gpre = empty(2 * k, sb, ns, b, hidden) if k else None
    gpost = empty(2 * m, sb, b, hidden)
    gin = empty(sb, ns, b, hidden)
    gout = empty(sb, b, _GOUT_LD)
    dxin = torch.empty(xin.shape, dtype=grad_dtype, device=dev)
    dz = None if levels else torch.empty(z.shape, dtype=grad_dtype, device=dev)
    d_feats = [zeros(sb * ns, h, wd, c) for h, wd, c in levels]
    if levels:
        if grid is None or grid.shape != (sb, ns, b, 2) or grid.dtype != torch.float32:
            raise ValueError(f"grid must be float32 {(sb, ns, b, 2)}")
        if sum(c for _, _, c in levels) != dl:
            raise ValueError("level channels must sum to d_latent")
        grid = grid.to(dev).contiguous()
    dw = FieldWeights(
        w_in=zeros(d_in, hidden), b_in=zeros(hidden), wz=zeros(n_inj, dl, hidden),
        bz=zeros(n_inj, hidden), w0=zeros(n_blocks, hidden, hidden), b0=zeros(n_blocks, hidden),
        w1=zeros(n_blocks, hidden, hidden), b1=zeros(n_blocks, hidden),
        w_out=zeros(hidden, d_out), b_out=zeros(d_out),
    )
    if (stash_pre is None) != (k == 0) or stash_post.shape != (2 * m + 1, sb, b, hidden):
        raise ValueError("the stash does not match this configuration")
    ptr = lambda t: 0 if t is None else t.data_ptr()
    dims = (ctypes.c_int * 10)(sb, ns, b, dl, d_in, d_in_pad, hidden, d_out, n_blocks, combine_layer)
    # the products' TMA maps need rows of a multiple of 16 bytes: xin's
    # columns zero-padded to d_in_pad; their split partials go to `ws`
    xin_pad = torch.nn.functional.pad(xin, (0, d_in_pad - d_in)) if d_in_pad != d_in else xin
    info = (ctypes.c_longlong * 4)()
    ws_floats = lib.pnt_wgrad_workspace(dims, info)
    if ws_floats < 0:
        raise ValueError(f"the weight-gradient products take at most 14 blocks, got {n_blocks}")
    ws = torch.empty(ws_floats, dtype=torch.float32, device=dev)
    launch_bwd.wgrad_plan = dict(
        workspace_bytes=4 * ws_floats, units=info[0], splits=(info[1], info[2]), box_bytes=info[3],
    )
    tensors = [
        z, xin, g, stash_pre, stash_post, wp.w_in, wp.wz, wp.w0, wp.w1, wp.w_out,
        gpre, gpost, gin, gout, dz, dxin, dw.w_in, dw.b_in, dw.wz, dw.bz, dw.w0,
        dw.b0, dw.w1, dw.b1, dw.w_out, dw.b_out, xin_pad, ws,
    ]
    tensors = [None if t is None else t.contiguous() for t in tensors]
    ptrs = (ctypes.c_void_p * len(tensors))(*[ptr(t) for t in tensors])
    nlev = len(levels)
    lptrs = (ctypes.c_void_p * max(nlev, 1))(*[t.data_ptr() for t in d_feats])
    ldims = (ctypes.c_int * max(3 * nlev, 1))(*[d for hwc in levels for d in hwc])
    launched = (ctypes.c_int * 2)(0, 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if grad_dtype == _BF:
        err = lib.pnt_resnetfc_bwd(ptrs, dims, lptrs, ldims, nlev, ptr(grid), stream, launched)
    else:
        err = lib.pnt_resnetfc_bwd_f32(ptrs, dims, stream, launched)
    launch_bwd.chain_launches += launched[0]
    launch_bwd.wgrad_launches += launched[1]
    _raise_on(err, lib, "resnetfc_bwd")
    return (d_feats if levels else dz), dxin, dw, (gpre, gpost, gin, gout)


launch_bwd.chain_launches = 0
launch_bwd.wgrad_launches = 0
launch_bwd.wgrad_plan = None


def resnetfc_bwd(z, xin, g, stash_pre, stash_post, w: FieldWeights, n_blocks: int,
                 combine_layer: int, ns: int, grad_dtype: Optional[torch.dtype] = None):
    """dz, dxin and the float32 weight gradients (FieldWeights, w_in
    (d_in, H)) from the stash of `resnetfc_fwd_stash` and the output
    cotangent g (SB, B, d_out). dz and dxin come in z's dtype, or in
    `grad_dtype`: float32 for a float32 caller, whose z and xin are the
    bf16 copies its forward made (the TPU kernel writes them in the
    input's dtype, unrounded)."""
    _check(z, xin, w, n_blocks, combine_layer, ns)
    grad_dtype = grad_dtype or z.dtype
    if _device_of(z, "resnetfc_bwd") == "cpu":
        return resnetfc_bwd_plain(z, xin, g, stash_pre, stash_post, w, n_blocks, combine_layer, ns,
                                  grad_dtype)
    if not _chains_take(z.shape[3], xin, w, ns):
        z, xin, wp = _cuda_inputs(z, xin, w)
        return layer_chain.layered_bwd(z, xin, g, stash_pre, stash_post, wp, n_blocks,
                                       combine_layer, ns, grad_dtype)[:3]
    res = launch_bwd(z, xin, g, stash_pre, stash_post, w, n_blocks, combine_layer, ns,
                     grad_dtype=grad_dtype)[:3]
    resnetfc_bwd.launches += out_groups(g.shape[-1])
    if grad_dtype == torch.float32:  # the F32 chain's share of them
        resnetfc_bwd.f32_launches += out_groups(g.shape[-1])
    return res


resnetfc_bwd.launches = 0
resnetfc_bwd.f32_launches = 0


class _ResnetFCFn(torch.autograd.Function):
    """Forward with stash, backward from it: the stash is the saved
    tensors (no recomputation). float32 z and xin are copied to bf16 once
    (the TPU kernel's casts at its products, bit for bit) and the copies
    are saved; dz and dxin come back in the inputs' dtypes."""

    @staticmethod
    def forward(ctx, z, xin, n_blocks, combine_layer, ns, *weights):
        w = FieldWeights(*weights)
        ctx.grad_dtypes = (z.dtype, xin.dtype)
        z, xin = z.to(_BF), xin.to(_BF)
        out, spre, spost = resnetfc_fwd_stash(z, xin, w, n_blocks, combine_layer, ns)
        ctx.cfg = (n_blocks, combine_layer, ns)
        ctx.has_pre = spre is not None
        ctx.save_for_backward(z, xin, spost, *([spre] if spre is not None else []), *weights)
        return out

    @staticmethod
    def backward(ctx, g):
        z, xin, spost, *rest = ctx.saved_tensors
        spre = rest.pop(0) if ctx.has_pre else None
        w = FieldWeights(*rest)
        dz_dtype, dxin_dtype = ctx.grad_dtypes
        with span("pnt.mlp.bwd"):
            dz, dxin, dw = resnetfc_bwd(z, xin, g, spre, spost, w, *ctx.cfg,
                                        grad_dtype=torch.promote_types(dz_dtype, dxin_dtype))
            return (dz.to(dz_dtype), dxin.to(dxin_dtype), None, None, None) + tuple(dw)


def resnetfc_fused(
    z: torch.Tensor, xin: torch.Tensor, weights: FieldWeights, n_blocks: int,
    combine_layer: int, ns: int,
) -> torch.Tensor:
    """Run the fused ResnetFC on a flattened point batch.

    :param z (SB, NS, B, d_latent) conditioning latents, bf16 or float32
    :param xin (SB, NS, B, d_in) positional-code features, bf16 or float32;
        the kernels read bf16 copies of float32 ones, and dz and dxin come
        back in each one's own dtype
    :param weights FieldWeights of the float32 parameters in (in, out)
        orientation; their gradients come back in the same shapes
    :return (SB, B, d_out) float32
    """
    for name, t in (("z", z), ("xin", xin)):
        if t.dtype not in (_BF, torch.float32):
            raise TypeError(f"{name} must be bf16 or float32, got {t.dtype}")
    needs_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (z, xin, *weights)
    )
    if not needs_grad:
        return resnetfc_fwd(z.to(_BF), xin.to(_BF), weights, n_blocks, combine_layer, ns)
    return _ResnetFCFn.apply(z, xin, n_blocks, combine_layer, ns, *weights)
