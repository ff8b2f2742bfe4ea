"""The differentiable renderer — counterpart of ``rt/grad/diff_render.py``:
the oracle's render graph with a backward pass.

The bounce loop is ``core.trace.trace`` with each bounce checkpointed
(``torch.utils.checkpoint``): the backward pass recomputes a bounce's
intersections instead of keeping every hit record, so its memory does not
grow with the bounce depth.

Gradient semantics, as in the JAX package: the RNG draws are integer-
derived floats and carry no gradient (the sampled decisions are frozen);
``torch.where`` selections (hit mask, material arm, Schlick draw) pass
gradients through the taken branch only; geometry gradients flow through
t, the hit point and the normal, material gradients through the albedo
attenuation, fuzz and index of refraction.  Triangle scenes use the
brute-force closest hit (``core.triangle.intersect_all_bruteforce``), not
the BVH walk; its gradient reaches only the winning triangle.

Forward values equal the oracle's (``render.oracle.render_color``) on
sphere scenes: the same operations in the same order.
"""

from __future__ import annotations

import numpy as np
import torch

from rt_torch.config import RenderConfig
from rt_torch.core import camera as camera_mod
from rt_torch.core.trace import trace
from rt_torch.render.oracle import scene_functions


def trace_diff(intersect_fn, hit_record_fn, state, origin, direction, *,
               bounces: int, normalize_reflect_in: bool, remat: bool = True,
               sky_from_final_dir: bool = False):
    """The differentiable bounce loop: ``core.trace.trace`` with a
    checkpoint per bounce.  Returns (state, color (..., 3)).

    sky_from_final_dir=True closes the continuous chain parameters -> t and
    normal -> reflected or refracted direction -> final direction -> sky;
    under the reference transport (False) geometry and pose gradients are
    zero by construction."""
    return trace(intersect_fn, hit_record_fn, state, origin, direction,
                 bounces=bounces, normalize_reflect_in=normalize_reflect_in,
                 sky_from_final_dir=sky_from_final_dir, remat=remat)


def render_color_diff(scene, camera, config: RenderConfig, time,
                      remat: bool = True):
    """One frame's (H, W, 3) color, differentiable in the scene tensors and
    a camera made of tensors (``grad.params.look_at``), on the scene's
    device."""
    state, origin, direction = camera_mod.generate_primary_rays(
        camera, config.width, config.height, time,
        config.normalize_defocus_dir, device=scene[0].device)
    intersect, hit_rec = scene_functions(scene, bvh=False)
    color = torch.zeros_like(origin)
    for _ in range(config.samples_per_frame):
        state, c = trace_diff(
            intersect, hit_rec, state, origin, direction,
            bounces=config.bounces,
            normalize_reflect_in=config.normalize_reflect_in, remat=remat,
            sky_from_final_dir=config.sky_from_final_dir)
        color = color + c
    # a tensor divisor: CUDA division by a Python scalar multiplies by its
    # reciprocal, which is not the IEEE quotient
    return color / torch.tensor(float(config.samples_per_frame),
                                dtype=torch.float32, device=origin.device)


def render_image_diff(scene, camera, config: RenderConfig, times,
                      remat: bool = True):
    """Progressive frames at ``times`` (the u32 time uniforms) as one
    differentiable graph, accumulated with the reference's EMA weights
    (frame f gets w = 1 / (min(f, sample_frame) + 1)), as a
    ProgressiveRenderer over the same times accumulates them."""
    image = None
    for f, t in enumerate(times):
        c = render_color_diff(scene, camera, config, int(t), remat=remat)
        w = np.float32(1.0) / (np.float32(min(f, config.sample_frame))
                               + np.float32(1.0))
        image = torch.zeros_like(c) if image is None else image
        image = image + (c - image) * float(w)
    return image
