"""ResNet-18/34 feature trunk, NHWC at its boundary.

Counterpart of `pixelnerf_tpu/models/resnet.py:ResNetTrunk` and
`BasicBlock`, written out by hand (torchvision is not a dependency):
7x7/2 stem conv + BatchNorm + ReLU, optional 3x3/2 max-pool, then stages
of BasicBlocks. Module names follow the Flax tree (`conv1`, `bn1`,
`layer1_0.conv1`, `layer2_0.downsample_conv`, ...) so that
`convert.state_dict_from_jax` maps a JAX checkpoint one to one.

Parameters stay float32; convolutions run in the model's compute dtype.
BatchNorm runs in eval mode on running statistics (eps 1e-5) in float32
and casts back; training-mode statistics belong to the training path.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["ResNetTrunk", "BasicBlock", "BatchNorm", "STAGE_BLOCKS"]

STAGE_BLOCKS = {"resnet18": (2, 2, 2, 2), "resnet34": (3, 4, 6, 3)}
STAGE_CHANNELS = (64, 128, 256, 512)


class BatchNorm(nn.Module):
    """Eval-mode batch norm over the channel axis of an NCHW tensor."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.batch_norm(
            x.float(), self.running_mean, self.running_var, self.weight,
            self.bias, training=False, eps=self.eps,
        )
        return y.to(x.dtype)


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
    def __init__(self, cin: int, filters: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv(cin, filters, 3, stride, 1)
        self.bn1 = BatchNorm(filters)
        self.conv2 = _conv(filters, filters, 3, 1, 1)
        self.bn2 = BatchNorm(filters)
        self.has_downsample = stride != 1 or cin != filters
        if self.has_downsample:
            self.downsample_conv = _conv(cin, filters, 1, stride, 0)
            self.downsample_bn = BatchNorm(filters)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(_apply_conv(self.conv1, x)))
        out = self.bn2(_apply_conv(self.conv2, out))
        identity = x
        if self.has_downsample:
            identity = self.downsample_bn(_apply_conv(self.downsample_conv, x))
        return torch.relu(out + identity)


class ResNetTrunk(nn.Module):
    """Per-stage features [stem, layer1, ...][: num_stages + 1], NHWC.

    :param backbone 'resnet18' | 'resnet34'
    :param num_stages residual stages to run (0-4)
    :param use_first_pool skip the stem max-pool when False
    :param dtype compute dtype of the convolutions
    """

    def __init__(
        self,
        backbone: str = "resnet34",
        num_stages: int = 3,
        use_first_pool: bool = True,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.num_stages = num_stages
        self.use_first_pool = use_first_pool
        self.dtype = dtype
        self.conv1 = _conv(3, 64, 7, 2, 3)
        self.bn1 = BatchNorm(64)
        self.block_names: List[List[str]] = []
        cin = 64
        for stage in range(num_stages):
            names = []
            for blk in range(STAGE_BLOCKS[backbone][stage]):
                stride = 2 if (stage > 0 and blk == 0) else 1
                name = f"layer{stage + 1}_{blk}"
                self.add_module(
                    name, BasicBlock(cin, STAGE_CHANNELS[stage], stride)
                )
                cin = STAGE_CHANNELS[stage]
                names.append(name)
            self.block_names.append(names)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """:param x (B, H, W, 3) -> list of (B, H_l, W_l, C_l)"""
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        x = torch.relu(self.bn1(_apply_conv(self.conv1, x)))
        latents = [x]
        for stage, names in enumerate(self.block_names):
            if stage == 0 and self.use_first_pool:
                x = F.max_pool2d(x, 3, stride=2, padding=1)
            for name in names:
                x = getattr(self, name)(x)
            latents.append(x)
        return [l.permute(0, 2, 3, 1) for l in latents]
