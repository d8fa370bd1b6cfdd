"""What the ResnetFC chains' wrappers (`ops/resnetfc.py`, `ops/field.py`)
and the layered path (`ops/layer_chain.py`) share: the weights' form
(`FieldWeights`, `pack_field_weights`), the stash's slots
(`stash_layout`), the zero padding to a kernel's widths and its cut back
(`pad_chain_weights`, `cut_weight_grads`), and the weight-gradient
products' plain version (`resnetfc_wgrad_plain`, of `csrc/wgrad.cuh`,
which both backwards launch). `ops/resnetfc.py` re-exports every name.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

__all__ = [
    "FieldWeights",
    "pack_field_weights",
    "stash_layout",
    "pad_chain_weights",
    "cut_weight_grads",
    "resnetfc_wgrad_plain",
]

_BF = torch.bfloat16


class FieldWeights(NamedTuple):
    """ResnetFC weights in (in, out) orientation (H = d_hidden):

    w_in (d_in, H), b_in (H,); wz (n_inj, d_latent, H), bz (n_inj, H);
    w0, w1 (n_blocks, H, H), b0, b1 (n_blocks, H); w_out (H, d_out),
    b_out (d_out,). `pack_field_weights` gives the kernels' form.
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


def _pad16(n: int) -> int:
    return -(-n // 16) * 16


def pack_field_weights(w: FieldWeights) -> FieldWeights:
    """The kernels' operand form: matrices bf16, biases float32, all
    contiguous and detached, w_in zero-padded to a multiple of 16 rows
    (the K step of the kernels' products). Leaves already in that form are kept as they are."""
    mat = lambda t: t.detach().to(_BF).contiguous()
    vec = lambda t: t.detach().float().contiguous()
    w_in = mat(w.w_in)
    d_in = w_in.shape[0]
    if d_in % 16:
        w_in = torch.cat([w_in, w_in.new_zeros((_pad16(d_in) - d_in, w_in.shape[1]))])
    return FieldWeights(
        w_in=w_in, b_in=vec(w.b_in), wz=mat(w.wz), bz=vec(w.bz), w0=mat(w.w0),
        b0=vec(w.b0), w1=mat(w.w1), b1=vec(w.b1), w_out=mat(w.w_out), b_out=vec(w.b_out),
    )


def stash_layout(n_blocks: int, combine_layer: int, ns: int) -> Tuple[int, int]:
    """(k, m): blocks before the view pooling (NS > 1) and after it."""
    k = min(combine_layer, n_blocks) if ns > 1 else 0
    return k, n_blocks - k


def _dot_g(a: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """a^T @ g over all rows, both bf16: (..., K) x (..., N) -> (K, N)."""
    return a.reshape(-1, a.shape[-1]).to(_BF).float().t() @ g.reshape(-1, g.shape[-1]).to(_BF).float()


def resnetfc_wgrad_plain(
    z: torch.Tensor, xin: torch.Tensor, stash_pre: Optional[torch.Tensor],
    stash_post: torch.Tensor, gpre: Optional[torch.Tensor], gpost: torch.Tensor,
    gin: torch.Tensor, gout: torch.Tensor, n_blocks: int, combine_layer: int, ns: int,
    d_out: int,
) -> dict:
    """The plain version of the weight-gradient kernel (`csrc/wgrad.cuh`):
    from the stash and the bf16 cotangents in the layout
    `resnetfc_cotangents_plain` gives, the float32 weight gradients by
    FieldWeights name (w_in (d_in, H), wz, w0, w1, w_out), each `_dot_g` of
    an activation and a cotangent; wz as one packed product of z with the
    injection cotangents side by side, [Gin | G1_0 | ... | G1_{n_inj-2}], as
    the kernel and the TPU kernel compute it."""
    k, m = stash_layout(n_blocks, combine_layer, ns)
    n_inj = min(combine_layer, n_blocks)
    dl, hidden = z.shape[-1], gin.shape[-1]

    def act(blk, h1):
        return stash_pre[k * h1 + blk] if blk < k else stash_post[m * h1 + blk - k]

    def cot(blk, g0):
        return gpre[k * g0 + blk] if blk < k else gpost[m * g0 + blk - k]

    zz, xx, gi = (z[:, 0], xin[:, 0], gin[:, 0]) if ns == 1 else (z, xin, gin)
    packed = torch.cat([gi] + [cot(i - 1, 0) for i in range(1, n_inj)], dim=-1)
    dwz = _dot_g(zz, packed).reshape(dl, n_inj, hidden).permute(1, 0, 2).contiguous()
    return dict(
        w_in=_dot_g(xx, gi), wz=dwz,
        w0=torch.stack([_dot_g(act(i, 0), cot(i, 1)) for i in range(n_blocks)]),
        w1=torch.stack([_dot_g(act(i, 1), cot(i, 0)) for i in range(n_blocks)]),
        w_out=_dot_g(stash_post[2 * m], gout[..., :d_out]),
    )


def _pad_last(t: Optional[torch.Tensor], n: int) -> Optional[torch.Tensor]:
    """t with zero columns up to n on its last axis (t itself at n)."""
    if t is None or t.shape[-1] == n:
        return t
    return torch.nn.functional.pad(t, (0, n - t.shape[-1]))


def pad_chain_weights(w: FieldWeights, hidden: int, d_latent: int) -> FieldWeights:
    """Packed weights with zero hidden channels up to `hidden` and zero
    latent rows up to `d_latent` (`chain_plan`); themselves at those
    widths."""
    dh, dl = hidden - w.w_in.shape[1], d_latent - w.wz.shape[1]
    if not dh and not dl:
        return w
    pad = torch.nn.functional.pad
    return FieldWeights(
        w_in=pad(w.w_in, (0, dh)), b_in=pad(w.b_in, (0, dh)), wz=pad(w.wz, (0, dh, 0, dl)),
        bz=pad(w.bz, (0, dh)), w0=pad(w.w0, (0, dh, 0, dh)), b0=pad(w.b0, (0, dh)),
        w1=pad(w.w1, (0, dh, 0, dh)), b1=pad(w.b1, (0, dh)), w_out=pad(w.w_out, (0, 0, 0, dh)),
        b_out=w.b_out,
    )


def cut_weight_grads(dw: FieldWeights, d_in: int, hidden: int, d_latent: int) -> FieldWeights:
    """The weight gradients of a padded run cut back to the caller's
    widths (the padded rows and columns are zero)."""
    h, dl = slice(0, hidden), slice(0, d_latent)
    return FieldWeights(
        w_in=dw.w_in[:d_in, h], b_in=dw.b_in[h], wz=dw.wz[:, dl, h], bz=dw.bz[:, h],
        w0=dw.w0[:, h, h], b0=dw.b0[:, h], w1=dw.w1[:, h, h], b1=dw.b1[:, h],
        w_out=dw.w_out[h], b_out=dw.b_out,
    )
