"""Training losses.

Counterpart of `pixelnerf_tpu/models/losses.py`: pure functions of
tensors, configuration read host-side. `rgb_with_uncertainty` and
`rgb_with_background` are for callers that thread their own per-ray betas
or background weights; the training step wires neither, as in JAX.
"""

from __future__ import annotations

from typing import Callable

import torch

__all__ = [
    "ConfigError",
    "mse_loss",
    "l1_loss",
    "rgb_loss_from_conf",
    "rgb_with_uncertainty",
    "rgb_with_uncertainty_from_conf",
    "rgb_with_background",
    "alpha_loss_nv2",
    "alpha_loss_from_conf",
]


class ConfigError(ValueError):
    """A config requests behaviour the training step does not wire."""


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - target))


def rgb_loss_from_conf(conf, coarse: bool = True, allow_uncertainty: bool = False) -> Callable:
    """L1 or MSE from a `loss.rgb` subtree. `use_uncertainty` on the fine
    head needs a beta head the training step does not provide, and raises,
    unless the caller threads betas itself (`allow_uncertainty`: the
    3-argument `rgb_with_uncertainty`)."""
    if conf.get_bool("use_uncertainty", False) and not coarse:
        if not allow_uncertainty:
            raise ConfigError(
                "loss.rgb*.use_uncertainty requires a beta (uncertainty) head the "
                "training step does not provide"
            )
        return rgb_with_uncertainty_from_conf(conf)
    return l1_loss if conf.get_bool("use_l1", False) else mse_loss


def rgb_with_uncertainty(outputs: torch.Tensor, targets: torch.Tensor, betas: torch.Tensor,
                         use_l1: bool = False) -> torch.Tensor:
    """Kendall's heteroscedastic loss: mean(err / beta) + mean(log beta).

    :param outputs (B, 3), targets (B, 3), betas (B)"""
    elem = torch.abs(outputs - targets) if use_l1 else (outputs - targets) ** 2
    return torch.mean(torch.mean(elem, dim=-1) / betas) + torch.mean(torch.log(betas))


def rgb_with_uncertainty_from_conf(conf) -> Callable:
    use_l1 = conf.get_bool("use_l1", False)
    return lambda outputs, targets, betas: rgb_with_uncertainty(outputs, targets, betas, use_l1)


def rgb_with_background(outputs: torch.Tensor, targets: torch.Tensor, lambda_bg: torch.Tensor,
                        use_l1: bool = False) -> torch.Tensor:
    """mean(err / (1 + lambda_bg)) + mean(log lambda_bg)."""
    elem = torch.abs(outputs - targets) if use_l1 else (outputs - targets) ** 2
    return torch.mean(torch.mean(elem, dim=-1) / (1.0 + lambda_bg)) + torch.mean(
        torch.log(lambda_bg))


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
