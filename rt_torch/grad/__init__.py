"""Inverse rendering: parameters, loss, path-replay gradients, the full
differentiable renderer, the finite-difference check and the training
loops — counterpart of ``rt/grad`` (``params``, ``loss``, ``replay``,
``diff_render``, ``fd``, ``train``, and the soft-visibility surrogates
``soft`` and ``soft_tris``)."""

from rt_torch.grad.diff_render import (render_color_diff, render_image_diff,
                                       trace_diff)
from rt_torch.grad.fd import finite_difference_check
from rt_torch.grad.loss import golden_mae_percent, image_mse
from rt_torch.grad.params import (CameraParams, SphereParams, TriangleParams,
                                  apply_params, apply_tri_params,
                                  camera_from_params, look_at)
from rt_torch.grad.replay import (record_hits, record_hits_oracle,
                                  replay_color, replay_loss_fn)
from rt_torch.grad.soft import (make_soft_geom_loss, make_soft_loss,
                                recover_camera, recover_geometry, soft_render)
from rt_torch.grad.soft_tris import (OrbitParams, downsample,
                                     make_soft_tris_loss, recover_camera_tris,
                                     recover_orbit_tris, soft_render_tris,
                                     subject_roi)
from rt_torch.grad.train import fit, fit_replay, make_train_step

__all__ = [
    "CameraParams", "SphereParams", "TriangleParams", "apply_params",
    "apply_tri_params", "camera_from_params", "look_at", "image_mse",
    "golden_mae_percent", "record_hits", "record_hits_oracle",
    "replay_color", "replay_loss_fn", "render_color_diff",
    "render_image_diff", "trace_diff", "finite_difference_check", "fit",
    "fit_replay", "make_train_step",
    "soft_render", "make_soft_loss", "make_soft_geom_loss",
    "recover_camera", "recover_geometry",
    "soft_render_tris", "make_soft_tris_loss", "recover_camera_tris",
    "recover_orbit_tris", "OrbitParams", "downsample", "subject_roi",
]
