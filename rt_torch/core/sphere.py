"""The sphere-scene container and the differentiable single-sphere
intersection — counterpart of ``rt/core/sphere.py:29-87``.

The scene buffer is padded with zero rows to a static count (by default the
reference's ``MAX_SPHERES``); the kernels scan only the live prefix
(``RenderConfig.n_active_spheres``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from rt_torch.config import MAX_SPHERES
from rt_torch.core import vecmath as vm


class SphereArray(NamedTuple):
    """SoA sphere scene as tensors on one device, padded to a static count."""

    center: torch.Tensor     # (N, 3) f32
    radius: torch.Tensor     # (N,)   f32
    albedo: torch.Tensor     # (N, 3) f32
    mat_param: torch.Tensor  # (N,)   f32 (fuzz or index of refraction)
    mat_kind: torch.Tensor   # (N,)   i32 (1 lambertian, 2 metal, 3 dielectric)

    @property
    def count(self) -> int:
        return self.center.shape[0]

    def to(self, device) -> "SphereArray":
        return SphereArray(*(t.to(device) for t in self))


def pack_spheres(spheres, pad_to: int = MAX_SPHERES,
                 device="cuda") -> SphereArray:
    """A padded SphereArray from a list of (center(3,), radius, albedo(3,),
    param, kind) tuples, filled in NumPy and moved to ``device``."""
    n = len(spheres)
    if n > pad_to:
        raise ValueError(f"{n} spheres > cap {pad_to}")
    center = np.zeros((pad_to, 3), np.float32)
    radius = np.zeros((pad_to,), np.float32)
    albedo = np.zeros((pad_to, 3), np.float32)
    param = np.zeros((pad_to,), np.float32)
    kind = np.zeros((pad_to,), np.int32)
    for i, (c, r, a, p, k) in enumerate(spheres):
        center[i] = c
        radius[i] = r
        albedo[i] = a
        param[i] = p
        kind[i] = k
    return SphereArray(*(torch.from_numpy(x).to(device)
                         for x in (center, radius, albedo, param, kind)))


def intersect_sphere_t(origin, direction, center, radius):
    """The near root ``t`` of rays against one sphere each (or one for all):
    origin/direction (..., 3), center (3,) or (..., 3), radius scalar or
    (...); -1 where the discriminant is negative.  Differentiable: the
    square root is guarded so that the lanes with a non-positive
    discriminant see sqrt(1) in the backward pass and not the infinite
    derivative at 0, which would poison the geometry and camera cotangents
    of lanes that are masked away (0 * inf)."""
    oc = origin - center
    a = vm.dot(direction, direction)
    b = 2.0 * vm.dot(oc, direction)
    c = vm.dot(oc, oc) - radius * radius
    disc = b * b - 4.0 * a * c
    pos = disc > 0.0
    sq = torch.where(pos, vm.sqrt(torch.where(pos, disc, 1.0)), 0.0)
    t = (-b - sq) / (2.0 * a)
    return torch.where(disc < 0.0, -1.0, t)
