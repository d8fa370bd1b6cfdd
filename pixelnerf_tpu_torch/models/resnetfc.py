"""Latent-conditioned ResNet-style NeRF MLP.

Counterpart of `pixelnerf_tpu/models/resnetfc.py:ResnetFC`: the per-layer
path (latent injection below `combine_layer`, view pooling at it), the
fused (z, x) path (`_call_pallas`'s counterpart: the ResnetFC kernels of
ops/resnetfc.py, with their backward; routed by `use_pallas` as the JAX
module routes its Pallas kernels, `fused_ok`), and the
`FieldInput` path, which hands the native pyramid and the sample
coordinates to the fused field kernel (ops/field.py, with its backward).
Parameter names follow the Flax tree: `lin_in`, `lin_z_{i}`, `scale_z_{i}`
(SPADE), `block_{i}.fc_{0,1}`, `lin_out`, each an `nn.Linear`. Parameters
stay float32; the per-layer path computes in the model dtype, as Flax's
`nn.Dense(dtype=...)` does. A softplus `beta`, SPADE injection and a
latent-only net (`d_in = 0`) run the per-layer path on every device, where
the JAX package's `supported_config` refuses its kernels.
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
from pixelnerf_tpu_torch.ops.resnetfc import resnetfc_fused, supported_config
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


def activation(beta: float):
    """softplus(beta * x) / beta for beta > 0, else relu (Flax's
    `_activation`)."""
    if beta > 0:
        return lambda x: F.softplus(beta * x) / beta
    return torch.relu


class ResnetBlockFC(nn.Module):
    """Pre-activation block: x + fc_1(act(fc_0(act(x)))), fc_1 zero-init."""

    def __init__(self, size: int, beta: float = 0.0):
        super().__init__()
        self.act = activation(beta)
        self.fc_0 = _linear(size, size)
        self.fc_1 = _linear(size, size, zero=True)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        net = _dense(self.fc_0, self.act(x), dtype)
        return x + _dense(self.fc_1, self.act(net), dtype)


class ResnetFC(nn.Module):
    """:param d_in positional-code size; 0: latent only (no lin_in)
    :param d_out output size (4: rgb + sigma)
    :param n_blocks residual blocks
    :param d_latent conditioning latent size
    :param d_hidden hidden width
    :param beta softplus beta; <= 0 is relu
    :param combine_layer block at which the NS views are pooled
    :param combine_type 'average' | 'max'
    :param use_spade scale-and-shift latent injection (scale_z_{i})
    :param use_pallas the JAX module's switch of its Pallas kernels, with
        its meaning in the port. "auto": the ResnetFC kernels take every
        config the JAX `_pallas_ok` takes, bf16 and float32 alike, on the
        card; off the card a bf16 model takes their plain versions, and a
        float32 model keeps the exact per-layer chain (as the JAX
        package's "auto" off the TPU). True: the kernel route on every
        device (the plain versions on the CPU: the JAX interpret mode's
        counterpart). False: the per-layer chain everywhere, and no field
        path.
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
        use_pallas="auto",
    ):
        super().__init__()
        if use_pallas not in (True, False, "auto"):
            raise ValueError(f"use_pallas is True, False or 'auto', got {use_pallas!r}")
        self.use_pallas = use_pallas
        self.d_in = d_in
        self.d_out = d_out
        self.n_blocks = n_blocks
        self.d_latent = d_latent
        self.d_hidden = d_hidden
        self.combine_layer = combine_layer
        self.combine_type = combine_type
        self.beta = beta
        self.use_spade = use_spade
        self.dtype = dtype
        self.n_inj = min(combine_layer, n_blocks) if d_latent > 0 else 0
        self.lin_in = _linear(d_in, d_hidden) if d_in > 0 else None
        for i in range(self.n_inj):
            self.add_module(f"lin_z_{i}", _linear(d_latent, d_hidden))
            if use_spade:
                self.add_module(f"scale_z_{i}", _linear(d_latent, d_hidden))
        for i in range(n_blocks):
            self.add_module(f"block_{i}", ResnetBlockFC(d_hidden, beta))
        self.lin_out = _linear(d_hidden, d_out)
        self._field_cache = None  # (parameter key, packed FieldWeights)

    def _kernels_take(self, ns: int) -> bool:
        """The JAX package's `supported_config` for this module at `ns`
        views."""
        return supported_config(
            self.beta, self.use_spade, self.combine_type, self.d_latent, self.d_in,
            self.combine_layer, self.n_blocks, ns,
        )

    def _on_kernel_route(self, device_type=None) -> bool:
        """`use_pallas` read as the JAX module reads it, the card in place
        of the TPU: "auto" takes the kernel route for a float32 model only
        where `device_type` (the parameters' device by default) is "cuda",
        for a bf16 model everywhere (the plain versions off the card)."""
        if self.use_pallas == "auto" and self.dtype != torch.bfloat16:
            return (device_type or self.lin_out.weight.device.type) == "cuda"
        return self.use_pallas is not False

    def field_path_ok(self, ns: int) -> bool:
        """Can this module consume a FieldInput for `ns` views? The JAX
        module's `field_path_ok`: the kernels' `supported_config`, unless
        `use_pallas` is False. The field's levels are bf16 only (the
        caller's `pyramid_fused_ok`), so a float32 model never takes it."""
        return (
            self.use_pallas is not False
            and self._kernels_take(ns)
            and field_supported(ns, self.n_blocks, self.combine_layer)
        )

    def fused_ok(self, combine_inner_dims, device_type=None) -> bool:
        """Does a (z, x) call take the fused ResnetFC kernels? The JAX
        module's `_pallas_ok` with the card in place of the TPU
        (`_on_kernel_route`). The wrappers take every width: the chains up
        to 512 and 64 views, the layered path past them
        (`ops/resnetfc.py:takes_chains`)."""
        return (
            len(combine_inner_dims) == 2
            and self._kernels_take(combine_inner_dims[0])
            and self._on_kernel_route(device_type)
        )

    def weights(self) -> FieldWeights:
        """The float32 parameters in (in, out) orientation, as views and
        stacks that autograd follows back to the parameters."""
        t = lambda lin: lin.weight.t()
        blocks = [getattr(self, f"block_{i}") for i in range(self.n_blocks)]
        lin_z = [getattr(self, f"lin_z_{i}") for i in range(self.n_inj)]
        return FieldWeights(
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
        )

    def field_weights(self) -> FieldWeights:
        """The parameters in the fused kernel's packed (in, out) form
        (ops/field.py:pack_field_weights), packed on first use and again
        only after a parameter is replaced or changed in place."""
        key = tuple((p.data_ptr(), p._version) for p in self.parameters())
        if self._field_cache is None or self._field_cache[0] != key:
            with torch.no_grad(), torch.inference_mode(False):
                packed = pack_field_weights(self.weights())
            self._field_cache = (key, packed)
        return self._field_cache[1]

    def forward(self, zx, combine_inner_dims: Tuple[int, ...] = (1,)) -> torch.Tensor:
        """:param zx a (z, x) pair of (..., d_latent) / (..., d_in) tensors,
            one (..., d_latent + d_in) tensor, latent first, or a FieldInput
        :param combine_inner_dims (NS, B) multi-view reduction dims
        :return (..., d_out); the leading dim shrinks by NS at combine_layer
        """
        if isinstance(zx, FieldInput):
            return self._call_field(zx, combine_inner_dims)
        if isinstance(zx, (tuple, list)):
            z, x = zx
        else:
            z, x = zx[..., : self.d_latent], zx[..., self.d_latent :]
        if self.fused_ok(combine_inner_dims):
            return self._call_fused(z, x, combine_inner_dims)
        act = activation(self.beta)
        if self.lin_in is not None:
            x = _dense(self.lin_in, x, self.dtype)
        else:
            x = torch.zeros(z.shape[:-1] + (self.d_hidden,), dtype=self.dtype, device=z.device)
        for blk in range(self.n_blocks):
            if blk == self.combine_layer:
                x = combine_interleaved(x, combine_inner_dims, self.combine_type)
            if blk < self.n_inj:
                tz = _dense(getattr(self, f"lin_z_{blk}"), z, self.dtype)
                if self.use_spade:
                    x = _dense(getattr(self, f"scale_z_{blk}"), z, self.dtype) * x + tz
                else:
                    x = x + tz
            x = getattr(self, f"block_{blk}")(x, self.dtype)
        return _dense(self.lin_out, act(x), self.dtype)

    def _call_fused(self, z, x, combine_inner_dims) -> torch.Tensor:
        ns, b = combine_inner_dims
        sb = x.shape[0] // (ns * b)
        # in the model's dtype: a float32 model's dz and dxin come back in
        # float32, as the TPU kernel writes them
        out = resnetfc_fused(
            z.reshape(sb, ns, b, -1), x.reshape(sb, ns, b, -1),
            self.weights(), self.n_blocks, self.combine_layer, ns,
        )
        return out.reshape(sb * b, self.d_out)

    def _call_field(self, fi: FieldInput, combine_inner_dims) -> torch.Tensor:
        ns, b = combine_inner_dims
        if not self.field_path_ok(ns):
            raise ValueError("FieldInput passed but the fused field path does not apply")
        # with a gradient wanted, views that autograd follows back to the
        # float32 parameters (as _call_fused); otherwise the packed cache
        wants_grad = torch.is_grad_enabled() and any(p.requires_grad for p in self.parameters())
        m = fi.x.shape[0]
        sb = m // (ns * b)
        out = pyramid_field_fused(
            tuple(fi.feats),
            fi.grid.reshape(sb, ns, b, 2),
            fi.x.reshape(sb, ns, b, -1),
            self.weights() if wants_grad else self.field_weights(),
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
