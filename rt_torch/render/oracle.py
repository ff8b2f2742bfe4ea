"""The oracle backend — counterpart of ``rt/render/renderer.py:
render_color``, the JAX package's default ``backend="jax"``.

Plain tensor code that reaches no kernel: per bounce, every sphere of the
padded buffer, or the stackless BVH walk over the triangles
(``core.triangle.intersect_all_bvh``), then the material scatter, on
whichever device the scene lies.  It is the reference the kernels' images
(``tests/golden_tris``) were rendered with, and the recorder
``grad.replay.record_hits_oracle`` runs it.
"""

from __future__ import annotations

from functools import partial

import torch

from rt_torch.config import RenderConfig
from rt_torch.core import camera as camera_mod
from rt_torch.core import sphere as sphere_mod
from rt_torch.core import triangle as triangle_mod
from rt_torch.core.trace import trace
from rt_torch.kernels import dispatch


def scene_functions(scene, bvh: bool = True):
    """(intersect_fn, hit_record_fn) of a SphereArray or TriangleScene for
    ``core.trace.trace``; a mesh by the BVH walk or, with ``bvh=False``, by
    the differentiable brute-force scan."""
    if isinstance(scene, sphere_mod.SphereArray):
        return (partial(sphere_mod.intersect_all_spheres, scene),
                partial(sphere_mod.hit_record, scene))
    if isinstance(scene, triangle_mod.TriangleScene):
        walk = (triangle_mod.intersect_all_bvh if bvh
                else triangle_mod.intersect_all_bruteforce)
        return partial(walk, scene), partial(triangle_mod.hit_record, scene)
    raise TypeError(f"unknown scene type {type(scene)}")


def render_color(scene, camera, config: RenderConfig, time, device="cuda",
                 row0: int = 0, rows: int | None = None):
    """(H, W, 3) color of one frame: ``config.samples_per_frame`` samples
    of the same primary rays with the RNG state carried across them, summed
    and divided by their count.  With ``row0``/``rows``: (rows, W, 3), the
    frame's rows row0.. bit for bit (every ray is traced on its own)."""
    dispatch.check_device(scene[0], device)
    state, origin, direction = camera_mod.generate_primary_rays(
        camera, config.width, config.height, time,
        config.normalize_defocus_dir, device=device, row0=row0, rows=rows)
    intersect, hit_rec = scene_functions(scene)
    color = torch.zeros_like(origin)
    with torch.no_grad():
        for _ in range(config.samples_per_frame):
            state, c = trace(intersect, hit_rec, state, origin, direction,
                             bounces=config.bounces,
                             normalize_reflect_in=config.normalize_reflect_in,
                             sky_from_final_dir=config.sky_from_final_dir)
            color = color + c
    # a tensor divisor: CUDA division by a Python scalar multiplies by its
    # reciprocal, which is not the IEEE quotient
    return color / torch.tensor(float(config.samples_per_frame),
                                dtype=torch.float32, device=origin.device)
