"""The bounce loop (``trace``) and the sky — counterpart of
``rt/core/trace.py``.

The transport of the reference shaders: attenuation ``albedo * 0.7`` per
bounce; a lane that misses freezes; no black on running out of bounces —
the color is always ``attenuation * sky(primary direction)``, the sky an
unclamped ``mix(SKY, BLUE, dir.y * 0.5 + 0.5)`` of the (unnormalised)
camera-ray direction.  Plain tensor code on any device, differentiable
through the scene tensors a hit record reads.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from rt_torch.config import BLUE, FLT_MAX, SKY
from rt_torch.core.materials import scatter


def sky_color(direction):
    """mix(SKY, BLUE, dir.y * 0.5 + 0.5), unclamped: the direction is not
    normalised and the gradient extrapolates where |y| > 1."""
    t = (direction[..., 1] * 0.5 + 0.5)[..., None]
    sky = direction.new_tensor(SKY)
    blue = direction.new_tensor(BLUE)
    return sky * (1.0 - t) + blue * t


def trace(intersect_fn, hit_record_fn, state, origin, direction, *,
          bounces: int, normalize_reflect_in: bool,
          sky_from_final_dir: bool = False, remat: bool = False, hits=None):
    """The bounce loop.  Returns (state, color (..., 3)).

    intersect_fn(o, d) -> (t, idx) with t == FLT_MAX on a miss;
    hit_record_fn(o, d, t, idx) -> the hit dict ``scatter`` reads.
    sky_from_final_dir: the sky of the last bounced direction (an
    extension) instead of the primary ray's.
    remat: checkpoint each bounce (``torch.utils.checkpoint``) while a
    graph is built: the backward pass recomputes a bounce's intersections
    instead of keeping its hit records.
    hits: a list that gets, per bounce, the index of the primitive each
    lane hit (-1 on a miss and from then on).
    """
    def body(state, o, d, atten, active):
        t, idx = intersect_fn(o, d)
        hm = active & (t != FLT_MAX)
        hit = hit_record_fn(o, d, t, idx)
        ns, no, nd = scatter(state, o, d, hit,
                             normalize_reflect_in=normalize_reflect_in)
        m3 = hm[..., None]
        return (torch.where(hm, ns, state), torch.where(m3, no, o),
                torch.where(m3, nd, d),
                torch.where(m3, atten * hit["albedo"] * 0.7, atten), hm,
                torch.where(hm, idx, -1))

    o, d = origin, direction
    atten = torch.ones_like(origin)
    active = torch.ones(origin.shape[:-1], dtype=torch.bool,
                        device=origin.device)
    for _ in range(bounces):
        args = (state, o, d, atten, active)
        if remat and torch.is_grad_enabled():
            out = checkpoint(body, *args, use_reentrant=False)
        else:
            out = body(*args)
        state, o, d, atten, active, idx = out
        if hits is not None:
            hits.append(idx)
    return state, atten * sky_color(d if sky_from_final_dir else direction)
