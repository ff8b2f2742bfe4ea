"""Inverse rendering: parameters, loss, path-replay gradients and the
record -> replay -> Adam loop — counterpart of ``rt/grad`` (``params``,
``loss``, ``replay``, ``train.fit_replay``)."""

from rt_torch.grad.loss import golden_mae_percent, image_mse
from rt_torch.grad.params import (CameraParams, SphereParams, TriangleParams,
                                  apply_params, apply_tri_params,
                                  camera_from_params, look_at)
from rt_torch.grad.replay import record_hits, replay_color, replay_loss_fn
from rt_torch.grad.train import fit_replay

__all__ = [
    "CameraParams", "SphereParams", "TriangleParams", "apply_params",
    "apply_tri_params", "camera_from_params", "look_at", "image_mse",
    "golden_mae_percent", "record_hits", "replay_color", "replay_loss_fn",
    "fit_replay",
]
