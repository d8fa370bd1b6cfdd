"""Latent-conditioned ResNet-style NeRF MLP.

Counterpart of `pixelnerf_tpu/models/resnetfc.py:ResnetFC`: the per-layer
path (latent injection below `combine_layer`, view pooling at it) and
the `FieldInput` path, which hands the native pyramid and the sample
coordinates to the fused field kernel (ops/field.py). Parameter names
follow the Flax tree: `lin_in`, `lin_z_{i}`, `block_{i}.fc_{0,1}`,
`lin_out`, each an `nn.Linear`. Parameters stay float32; the per-layer
path computes in the model dtype, as Flax's `nn.Dense(dtype=...)` does.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from pixelnerf_tpu_torch.ops.field import (
    FieldWeights, field_supported, pack_field_weights, pyramid_field_fused,
)
from pixelnerf_tpu_torch.utils.rays import combine_interleaved

__all__ = ["ResnetFC", "ResnetBlockFC", "FieldInput"]


class FieldInput(NamedTuple):
    """Input of the fused field path: native levels (SB*NS, H_l, W_l, C_l),
    normalized fine-grid coordinates (SB*NS, B, 2) and the positional-code
    features (SB*NS*B, d_in)."""

    feats: Tuple[torch.Tensor, ...]
    grid: torch.Tensor
    x: torch.Tensor


def _linear(size_in: int, size_out: int, zero: bool = False) -> nn.Linear:
    """nn.Linear initialized as the Flax modules: kaiming-normal over
    fan_in (or zeros), zero bias."""
    lin = nn.Linear(size_in, size_out)
    if zero:
        nn.init.zeros_(lin.weight)
    else:
        nn.init.normal_(lin.weight, std=math.sqrt(2.0 / size_in))
    nn.init.zeros_(lin.bias)
    return lin


def _dense(lin: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return F.linear(x.to(dtype), lin.weight.to(dtype), lin.bias.to(dtype))


class ResnetBlockFC(nn.Module):
    """Pre-activation block: x + fc_1(relu(fc_0(relu(x)))), fc_1 zero-init."""

    def __init__(self, size: int):
        super().__init__()
        self.fc_0 = _linear(size, size)
        self.fc_1 = _linear(size, size, zero=True)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        net = _dense(self.fc_0, torch.relu(x), dtype)
        return x + _dense(self.fc_1, torch.relu(net), dtype)


class ResnetFC(nn.Module):
    """:param d_in positional-code size
    :param d_out output size (4: rgb + sigma)
    :param n_blocks residual blocks
    :param d_latent conditioning latent size
    :param d_hidden hidden width
    :param combine_layer block at which the NS views are average-pooled
    """

    def __init__(
        self,
        d_in: int,
        d_out: int = 4,
        n_blocks: int = 5,
        d_latent: int = 0,
        d_hidden: int = 128,
        beta: float = 0.0,
        combine_layer: int = 1000,
        combine_type: str = "average",
        use_spade: bool = False,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        if beta > 0 or use_spade or d_in <= 0:
            raise NotImplementedError(
                "softplus, SPADE and latent-only ResnetFC are not ported yet"
            )
        self.d_in = d_in
        self.d_out = d_out
        self.n_blocks = n_blocks
        self.d_latent = d_latent
        self.d_hidden = d_hidden
        self.combine_layer = combine_layer
        self.combine_type = combine_type
        self.dtype = dtype
        self.n_inj = min(combine_layer, n_blocks) if d_latent > 0 else 0
        self.lin_in = _linear(d_in, d_hidden)
        for i in range(self.n_inj):
            self.add_module(f"lin_z_{i}", _linear(d_latent, d_hidden))
        for i in range(n_blocks):
            self.add_module(f"block_{i}", ResnetBlockFC(d_hidden))
        self.lin_out = _linear(d_hidden, d_out)
        self._field_cache = None  # (parameter key, packed FieldWeights)

    def field_path_ok(self, ns: int) -> bool:
        """Can this module consume a FieldInput for `ns` views?"""
        return (
            self.combine_type == "average"
            and self.d_latent > 0
            and field_supported(ns, self.n_blocks, self.combine_layer)
        )

    def field_weights(self) -> FieldWeights:
        """The parameters in the fused kernel's packed (in, out) form
        (ops/field.py:pack_field_weights), packed on first use and again
        only after a parameter is replaced or changed in place."""
        key = tuple((p.data_ptr(), p._version) for p in self.parameters())
        if self._field_cache is None or self._field_cache[0] != key:
            t = lambda lin: lin.weight.t()
            blocks = [getattr(self, f"block_{i}") for i in range(self.n_blocks)]
            lin_z = [getattr(self, f"lin_z_{i}") for i in range(self.n_inj)]
            with torch.no_grad(), torch.inference_mode(False):
                packed = pack_field_weights(FieldWeights(
                    w_in=t(self.lin_in),
                    b_in=self.lin_in.bias,
                    wz=torch.stack([t(l) for l in lin_z]),
                    bz=torch.stack([l.bias for l in lin_z]),
                    w0=torch.stack([t(b.fc_0) for b in blocks]),
                    b0=torch.stack([b.fc_0.bias for b in blocks]),
                    w1=torch.stack([t(b.fc_1) for b in blocks]),
                    b1=torch.stack([b.fc_1.bias for b in blocks]),
                    w_out=t(self.lin_out),
                    b_out=self.lin_out.bias,
                ))
            self._field_cache = (key, packed)
        return self._field_cache[1]

    def forward(self, zx, combine_inner_dims: Tuple[int, ...] = (1,)) -> torch.Tensor:
        """:param zx a (z, x) pair of (..., d_latent) / (..., d_in) tensors,
            or a FieldInput
        :param combine_inner_dims (NS, B) multi-view reduction dims
        :return (..., d_out); the leading dim shrinks by NS at combine_layer
        """
        if isinstance(zx, FieldInput):
            return self._call_field(zx, combine_inner_dims)
        z, x = zx
        x = _dense(self.lin_in, x, self.dtype)
        for blk in range(self.n_blocks):
            if blk == self.combine_layer:
                x = combine_interleaved(x, combine_inner_dims, self.combine_type)
            if blk < self.n_inj:
                x = x + _dense(getattr(self, f"lin_z_{blk}"), z, self.dtype)
            x = getattr(self, f"block_{blk}")(x, self.dtype)
        return _dense(self.lin_out, torch.relu(x), self.dtype)

    def _call_field(self, fi: FieldInput, combine_inner_dims) -> torch.Tensor:
        ns, b = combine_inner_dims
        if not self.field_path_ok(ns):
            raise ValueError("FieldInput passed but the fused field path does not apply")
        m = fi.x.shape[0]
        sb = m // (ns * b)
        out = pyramid_field_fused(
            tuple(fi.feats),
            fi.grid.reshape(sb, ns, b, 2),
            fi.x.reshape(sb, ns, b, -1),
            self.field_weights(),
            self.n_blocks,
            self.combine_layer,
            ns,
        )
        return out.reshape(sb * b, self.d_out)

    @classmethod
    def from_conf(cls, conf, d_in: int, **kwargs) -> "ResnetFC":
        return cls(
            d_in=d_in,
            n_blocks=conf.get_int("n_blocks", 5),
            d_hidden=conf.get_int("d_hidden", 128),
            beta=conf.get_float("beta", 0.0),
            combine_layer=conf.get_int("combine_layer", 1000),
            combine_type=conf.get_string("combine_type", "average"),
            use_spade=conf.get_bool("use_spade", False),
            **kwargs,
        )
