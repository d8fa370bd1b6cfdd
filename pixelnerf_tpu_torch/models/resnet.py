"""ResNet-18/34 feature trunk, NHWC at its boundary.

Counterpart of `pixelnerf_tpu/models/resnet.py:ResNetTrunk` and
`BasicBlock`, written out by hand (torchvision is not a dependency):
7x7/2 stem conv + BatchNorm + ReLU, optional 3x3/2 max-pool, then stages
of BasicBlocks. Module names follow the Flax tree (`conv1`, `bn1`,
`layer1_0.conv1`, `layer2_0.downsample_conv`, ...) so that
`convert.state_dict_from_jax` maps a JAX checkpoint one to one.

Parameters stay float32; convolutions run in the model's compute dtype.
BatchNorm normalizes in float32 and casts back: in eval mode with its
running statistics, in train mode with the batch's, as Flax
`nn.BatchNorm(momentum=0.9, epsilon=1e-5)` does (see `BatchNorm`). The
other norms of the JAX trunk (`_make_norm`): `group` (32 groups, Flax's
`nn.GroupNorm`), `instance` (a group a channel, no scale or bias) and
`none` (`make_norm`).
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["ResNetTrunk", "BasicBlock", "BatchNorm", "GroupNorm", "make_norm", "STAGE_BLOCKS"]

STAGE_BLOCKS = {"resnet18": (2, 2, 2, 2), "resnet34": (3, 4, 6, 3)}
STAGE_CHANNELS = (64, 128, 256, 512)


class BatchNorm(nn.Module):
    """Batch norm over the channel axis of an NCHW tensor.

    Train mode matches Flax `nn.BatchNorm(momentum=0.9, epsilon=1e-5)`:
    the statistics are taken in float32 over the batch and both spatial
    axes, the variance as E[x^2] - E[x]^2 clipped at 0 (biased, as Flax's
    fast variance), and the running averages move by
    `running = momentum * running + (1 - momentum) * batch` with the biased
    variance. (`F.batch_norm(training=True)` would store the unbiased
    variance, and its `momentum` weights the new value.)
    """

    def __init__(self, channels: int, eps: float = 1e-5, momentum: float = 0.9):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            y = F.batch_norm(
                x.float(), self.running_mean, self.running_var, self.weight,
                self.bias, training=False, eps=self.eps,
            )
            return y.to(x.dtype)
        xf = x.float()
        mean = xf.mean(dim=(0, 2, 3))
        var = ((xf * xf).mean(dim=(0, 2, 3)) - mean * mean).clamp_min(0.0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(m).add_(mean.detach(), alpha=1.0 - m)
            self.running_var.mul_(m).add_(var.detach(), alpha=1.0 - m)
        shape = (1, -1, 1, 1)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean.reshape(shape)) * mul.reshape(shape) + self.bias.reshape(shape)
        return y.to(x.dtype)


class GroupNorm(nn.Module):
    """Group norm over the channel axis of an NCHW tensor, as Flax
    `nn.GroupNorm` computes it: statistics in float32 over each group's
    channels and both spatial axes, the variance as E[x^2] - E[x]^2
    clipped at 0, epsilon 1e-6, then the optional scale and bias; cast back
    to the input's dtype. `group_size=1` without affine is the JAX trunk's
    instance norm."""

    def __init__(self, channels: int, num_groups: int = 32, affine: bool = True,
                 eps: float = 1e-6):
        super().__init__()
        if channels % num_groups:
            raise ValueError(f"{num_groups} groups do not divide {channels} channels")
        self.num_groups = num_groups
        self.eps = eps
        if affine:
            self.weight = nn.Parameter(torch.ones(channels))
            self.bias = nn.Parameter(torch.zeros(channels))
        else:
            self.weight = self.bias = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c, h, w = x.shape
        xf = x.float()
        g = xf.reshape(n, self.num_groups, -1)
        mean = g.mean(dim=-1)
        var = ((g * g).mean(dim=-1) - mean * mean).clamp_min(0.0)
        rep = lambda t: t.repeat_interleave(c // self.num_groups, dim=1).reshape(n, c, 1, 1)
        mul = torch.rsqrt(rep(var) + self.eps)
        if self.weight is not None:
            mul = mul * self.weight.reshape(1, c, 1, 1)
        y = (xf - rep(mean)) * mul
        if self.bias is not None:
            y = y + self.bias.reshape(1, c, 1, 1)
        return y.to(x.dtype)


def make_norm(norm_type: str, channels: int) -> Optional[nn.Module]:
    """The norm layer of the JAX trunk's `_make_norm`: batch | group |
    instance | none (None)."""
    if norm_type == "batch":
        return BatchNorm(channels)
    if norm_type == "group":
        return GroupNorm(channels, 32)
    if norm_type == "instance":
        return GroupNorm(channels, channels, affine=False)
    if norm_type == "none":
        return None
    raise NotImplementedError(f"normalization layer [{norm_type}] not found")


def _norm(norm: Optional[nn.Module], x: torch.Tensor) -> torch.Tensor:
    return x if norm is None else norm(x)


def _conv(cin: int, cout: int, k: int, stride: int, pad: int) -> nn.Conv2d:
    conv = nn.Conv2d(cin, cout, k, stride=stride, padding=pad, bias=False)
    # kaiming-normal over fan_out, as the Flax trunk initializes
    nn.init.kaiming_normal_(conv.weight, mode="fan_out", nonlinearity="relu")
    return conv


def _apply_conv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    return F.conv2d(
        x, conv.weight.to(x.dtype), stride=conv.stride, padding=conv.padding
    )


class BasicBlock(nn.Module):
    def __init__(self, cin: int, filters: int, stride: int = 1, norm_type: str = "batch"):
        super().__init__()
        self.conv1 = _conv(cin, filters, 3, stride, 1)
        self.bn1 = make_norm(norm_type, filters)
        self.conv2 = _conv(filters, filters, 3, 1, 1)
        self.bn2 = make_norm(norm_type, filters)
        self.has_downsample = stride != 1 or cin != filters
        if self.has_downsample:
            self.downsample_conv = _conv(cin, filters, 1, stride, 0)
            self.downsample_bn = make_norm(norm_type, filters)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(_norm(self.bn1, _apply_conv(self.conv1, x)))
        out = _norm(self.bn2, _apply_conv(self.conv2, out))
        identity = x
        if self.has_downsample:
            identity = _norm(self.downsample_bn, _apply_conv(self.downsample_conv, x))
        return torch.relu(out + identity)


class ResNetTrunk(nn.Module):
    """Per-stage features [stem, layer1, ...][: num_stages + 1], NHWC.

    :param backbone 'resnet18' | 'resnet34'
    :param num_stages residual stages to run (0-4)
    :param use_first_pool skip the stem max-pool when False
    :param norm_type batch | group | instance | none (`make_norm`)
    :param dtype compute dtype of the convolutions
    """

    def __init__(
        self,
        backbone: str = "resnet34",
        num_stages: int = 3,
        use_first_pool: bool = True,
        norm_type: str = "batch",
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.num_stages = num_stages
        self.use_first_pool = use_first_pool
        self.dtype = dtype
        self.conv1 = _conv(3, 64, 7, 2, 3)
        self.bn1 = make_norm(norm_type, 64)
        self.block_names: List[List[str]] = []
        cin = 64
        for stage in range(num_stages):
            names = []
            for blk in range(STAGE_BLOCKS[backbone][stage]):
                stride = 2 if (stage > 0 and blk == 0) else 1
                name = f"layer{stage + 1}_{blk}"
                self.add_module(
                    name, BasicBlock(cin, STAGE_CHANNELS[stage], stride, norm_type)
                )
                cin = STAGE_CHANNELS[stage]
                names.append(name)
            self.block_names.append(names)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """:param x (B, H, W, 3) -> list of (B, H_l, W_l, C_l)"""
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        x = torch.relu(_norm(self.bn1, _apply_conv(self.conv1, x)))
        latents = [x]
        for stage, names in enumerate(self.block_names):
            if stage == 0 and self.use_first_pool:
                x = F.max_pool2d(x, 3, stride=2, padding=1)
            for name in names:
                x = getattr(self, name)(x)
            latents.append(x)
        return [l.permute(0, 2, 3, 1) for l in latents]
