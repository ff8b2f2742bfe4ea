"""The sky of the path tracer on (..., 3) directions — counterpart of
``rt/core/trace.py:sky_color``, for the differentiable replay graph."""

from __future__ import annotations

import torch

from rt_torch.config import BLUE, SKY


def sky_color(direction):
    """mix(SKY, BLUE, dir.y * 0.5 + 0.5), unclamped: the direction is not
    normalised and the gradient extrapolates where |y| > 1."""
    t = (direction[..., 1] * 0.5 + 0.5)[..., None]
    sky = direction.new_tensor(SKY)
    blue = direction.new_tensor(BLUE)
    return sky * (1.0 - t) + blue * t
