"""Losses for inverse rendering against golden images — counterpart of
``rt/grad/loss.py``."""

from __future__ import annotations

import torch


def image_mse(rendered: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean squared error in linear RGB: the optimisation twin of the golden
    comparator's mean-abs metric (MAE's gradient is a sign, MSE's is smooth,
    so MSE optimises and MAE validates)."""
    d = rendered - target
    return torch.mean(d * d)


def replay_mse(rendered: torch.Tensor, target: torch.Tensor, weight=None,
               norm=None) -> torch.Tensor:
    """``fit_replay``'s loss: ``image_mse`` when neither a per-pixel
    ``weight`` (H, W) nor a divisor ``norm`` is given, else the (weighted)
    sum of squares over ``norm`` (a row band's share of the frame's
    loss)."""
    if weight is None and norm is None:
        return image_mse(rendered, target)
    d = rendered - target
    if weight is None:
        return torch.sum(d * d) / norm
    return torch.sum(d * d * weight[..., None]) / norm


def golden_mae_percent(rendered: torch.Tensor,
                       target: torch.Tensor) -> torch.Tensor:
    """The acceptance metric itself: mean absolute difference as a percentage
    of 255 over u8-quantised pixels."""
    q = lambda x: torch.clamp(x * 255.0, 0.0, 255.0).to(torch.uint8).to(
        torch.float32)
    return torch.mean(torch.abs(q(rendered) - q(target))) / 255.0 * 100.0
