"""The sphere-scene container, the differentiable single-sphere
intersection and the oracle's closest-hit scan and hit record —
counterpart of ``rt/core/sphere.py``.

The scene buffer is padded with zero rows to a static count (by default the
reference's ``MAX_SPHERES``); the kernels scan only the live prefix
(``RenderConfig.n_active_spheres``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from rt_torch.config import FLT_MAX, MAX_SPHERES
from rt_torch.core import vecmath as vm
from rt_torch.core.hits import closest_hit, gather_rows

# spheres per block of the closest-hit scan
SCAN_BLOCK = 128


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


def intersect_all_spheres(scene: SphereArray, origin, direction,
                          block: int = SCAN_BLOCK):
    """Closest hit over the whole padded buffer, as the reference's linear
    loop with a strict ``t < closest`` (the earliest index wins a tie).
    The scan picks the winner without a graph; its t is then recomputed
    from the winner's row, so the gradient reaches only the winning sphere
    and the forward value is the scan's bit for bit.  Returns (t with
    FLT_MAX where nothing was hit, index int32, -1 there)."""
    o, d = origin[..., None, :], direction[..., None, :]

    def t_of(lo, hi):
        t = intersect_sphere_t(o, d, scene.center[lo:hi],
                               scene.radius[lo:hi])
        return (t > 0.0) & (t < FLT_MAX), t

    best_t, best_i = closest_hit(t_of, scene.count, origin.shape[:-1],
                                 origin.device, block)
    hit = best_i >= 0
    row = gather_rows(torch.cat([scene.center, scene.radius[:, None]], dim=1),
                torch.clamp(best_i, min=0))
    t = intersect_sphere_t(origin, direction, row[..., 0:3], row[..., 3])
    return torch.where(hit, t, best_t), best_i.to(torch.int32)


def hit_record(scene: SphereArray, origin, direction, t, idx):
    """The hit-record fields of the winning sphere: outward normal flipped
    against the ray, front_face = dot(dir, normal) < 0.  A miss lane
    (t == FLT_MAX) gets t = 1 so that its discarded values and their
    cotangents stay finite."""
    i = torch.clamp(idx, 0, scene.count - 1).long()
    row = gather_rows(torch.cat([scene.center, scene.radius[:, None],
                           scene.albedo, scene.mat_param[:, None]], dim=1), i)
    center, radius = row[..., 0:3], row[..., 3]
    t_safe = torch.where(t == FLT_MAX, 1.0, t)
    point = origin + t_safe[..., None] * direction
    normal = (point - center) / radius[..., None]
    front_face = vm.dot(direction, normal) < 0.0
    return {
        "point": point,
        "normal": torch.where(front_face[..., None], normal, -normal),
        "front_face": front_face,
        "albedo": row[..., 4:7],
        "mat_param": row[..., 7],
        "mat_kind": scene.mat_kind[i],
    }
