"""Training losses.

Counterpart of `pixelnerf_tpu/models/losses.py` (the losses the training
step wires): pure functions of tensors, configuration read host-side.
"""

from __future__ import annotations

from typing import Callable

import torch

__all__ = [
    "ConfigError",
    "mse_loss",
    "l1_loss",
    "rgb_loss_from_conf",
    "alpha_loss_nv2",
    "alpha_loss_from_conf",
]


class ConfigError(ValueError):
    """A config requests behaviour the training step does not wire."""


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - target))


def rgb_loss_from_conf(conf, coarse: bool = True) -> Callable:
    """L1 or MSE from a `loss.rgb` subtree. `use_uncertainty` on the fine
    head needs a beta head the training step does not provide, and raises."""
    if conf.get_bool("use_uncertainty", False) and not coarse:
        raise ConfigError(
            "loss.rgb*.use_uncertainty requires a beta (uncertainty) head the "
            "training step does not provide"
        )
    return l1_loss if conf.get_bool("use_l1", False) else mse_loss


def alpha_loss_nv2(
    alpha_fine: torch.Tensor,
    lambda_alpha: float,
    clamp_alpha: float,
    epoch: int,
    init_epoch: int,
    force_opaque: bool = False,
) -> torch.Tensor:
    """Neural Volumes opacity regularizer, gated by epoch on the host."""
    if lambda_alpha <= 0.0 or epoch < init_epoch:
        return torch.zeros((), device=alpha_fine.device)
    a = alpha_fine.clamp(0.01, 0.99)
    if force_opaque:
        return lambda_alpha * torch.mean(-torch.log(a))
    loss = torch.log(a) + torch.log(1.0 - a)
    return lambda_alpha * torch.mean(loss.clamp_min(-clamp_alpha))


def alpha_loss_from_conf(conf):
    """(fn(alpha, epoch) -> scalar, init_epoch) from a `loss.alpha` subtree,
    or (None, 0) when it is absent or lambda_alpha <= 0."""
    if conf is None:
        return None, 0
    lambda_alpha = conf.get_float("lambda_alpha", 0.0)
    if lambda_alpha <= 0.0:
        return None, 0
    clamp_alpha = conf.get_float("clamp_alpha", 100.0)
    init_epoch = conf.get_int("init_epoch", 5)
    force_opaque = conf.get_bool("force_opaque", False)

    def fn(alpha: torch.Tensor, epoch: int) -> torch.Tensor:
        return alpha_loss_nv2(
            alpha, lambda_alpha, clamp_alpha, epoch, init_epoch, force_opaque=force_opaque
        )

    return fn, init_epoch
