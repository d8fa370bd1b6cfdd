"""Plain skip-connection implicit MLP (IGR-style), the `mlp.type = mlp` head.

Counterpart of `pixelnerf_tpu/models/mlp.py:ImplicitNet`: layers `lin{i}`
(`nn.Linear`, computed in the model dtype as Flax's `nn.Dense(dtype=...)`),
skip connections that concatenate the input and scale by 1/sqrt(2) below
`combine_layer`, the view pooling at it, softplus (`beta` > 0) or relu
between layers, and the geometric (sphere-SDF) initialization the JAX
module makes by default (the options `from_conf` never sets are its
defaults here), drawn from torch's generator. It takes the (z, x) pair of
`PixelNeRFNet.query` as their concatenation.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from pixelnerf_tpu_torch.models.resnetfc import activation
from pixelnerf_tpu_torch.utils.rays import combine_interleaved

__all__ = ["ImplicitNet"]

RADIUS_INIT, OUTPUT_INIT_GAIN, NUM_POSITION_INPUTS = 0.3, 2.0, 3


class ImplicitNet(nn.Module):
    def __init__(
        self,
        d_in: int,
        dims: Sequence[int] = (),
        skip_in: Sequence[int] = (),
        d_out: int = 4,
        beta: float = 0.0,
        dim_excludes_skip: bool = False,
        combine_layer: int = 1000,
        combine_type: str = "average",
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.d_in = d_in
        self.skip_in = tuple(skip_in)
        self.combine_layer = combine_layer
        self.combine_type = combine_type
        self.beta = beta
        self.dtype = dtype
        dims = [d_in] + list(dims) + [d_out]
        if dim_excludes_skip:
            for i in range(1, len(dims) - 1):
                if i in self.skip_in:
                    dims[i] += d_in
        self.num_layers = len(dims)
        size_in = d_in
        for layer in range(self.num_layers - 1):
            if layer < combine_layer and layer in self.skip_in:
                size_in += d_in
            out_dim = dims[layer + 1] - d_in if (layer + 1) in self.skip_in else dims[layer + 1]
            lin = nn.Linear(size_in, out_dim)
            with torch.no_grad():
                w = torch.empty(size_in, out_dim)  # Flax's (in, out) orientation
                b = torch.zeros(out_dim)
                if layer == self.num_layers - 2:
                    w.zero_()
                    w[:, 0] = torch.randn(size_in) * 1e-5 - math.sqrt(math.pi / dims[layer])
                    if out_dim > 1:
                        w[:, 1:] = torch.randn(size_in, out_dim - 1) * OUTPUT_INIT_GAIN
                    b[0] = RADIUS_INIT
                else:
                    w.normal_(std=math.sqrt(2.0) / math.sqrt(out_dim))
                if d_in > NUM_POSITION_INPUTS and (layer == 0 or layer in self.skip_in):
                    w[size_in - d_in + NUM_POSITION_INPUTS:, :] = 0.0
                lin.weight.copy_(w.t())
                lin.bias.copy_(b)
            self.add_module(f"lin{layer}", lin)
            size_in = out_dim

    def forward(self, x, combine_inner_dims: Tuple[int, ...] = (1,)) -> torch.Tensor:
        """:param x (..., d_in) or a (z, x) pair, concatenated latent first
        :param combine_inner_dims (NS, B) multi-view reduction dims
        :return (..., d_out)"""
        if isinstance(x, (tuple, list)):
            x = torch.cat([x[0], x[1].to(x[0].dtype)], dim=-1)
        act = activation(self.beta)
        x_init = x
        for layer in range(self.num_layers - 1):
            if layer == self.combine_layer:
                x = combine_interleaved(x, combine_inner_dims, self.combine_type)
                x_init = combine_interleaved(x_init, combine_inner_dims, self.combine_type)
            if layer < self.combine_layer and layer in self.skip_in:
                x = torch.cat([x, x_init.to(x.dtype)], dim=-1) / math.sqrt(2.0)
            lin = getattr(self, f"lin{layer}")
            x = F.linear(x.to(self.dtype), lin.weight.to(self.dtype), lin.bias.to(self.dtype))
            if layer < self.num_layers - 2:
                x = act(x)
        return x

    @classmethod
    def from_conf(cls, conf, d_in: int, **kwargs) -> "ImplicitNet":
        return cls(
            d_in=d_in,
            dims=tuple(conf.get_list("dims")),
            skip_in=tuple(conf.get_list("skip_in")),
            beta=conf.get_float("beta", 0.0),
            dim_excludes_skip=conf.get_bool("dim_excludes_skip", False),
            combine_layer=conf.get_int("combine_layer", 1000),
            combine_type=conf.get_string("combine_type", "average"),
            **kwargs,
        )
