"""Differentiable parameters for inverse rendering — counterpart of
``rt/grad/params.py``.

Parameters live in small NamedTuples of tensors (``CameraParams``,
``SphereParams``, ``TriangleParams``) that are applied onto a base scene
inside the loss, so the path params -> camera basis -> rays -> replayed hits
-> scatter -> image -> loss is one autograd graph.  Discrete Monte-Carlo
decisions (hit index, material arm, reflect against refract) stay frozen at
their sampled values: ``torch.where`` routes gradients through the chosen
branch only, the detached-sampling estimator of differentiable rendering.
A field left ``None`` stays frozen at the base scene's value.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from rt_torch.core import vecmath as vm
from rt_torch.core.camera import Camera
from rt_torch.core.sphere import SphereArray


class CameraParams(NamedTuple):
    """Differentiable camera: the inputs of the scene-authored look-at."""

    eye: torch.Tensor           # (3,) f32
    target: torch.Tensor        # (3,) f32
    focal_length: torch.Tensor  # ()  f32
    focal_blur: torch.Tensor    # ()  f32
    fov: torch.Tensor           # ()  f32

    @staticmethod
    def create(eye, target, focal_length, focal_blur, fov,
               device="cuda") -> "CameraParams":
        f = lambda v: torch.from_numpy(
            np.array(v, dtype=np.float32)).to(device)
        return CameraParams(f(eye), f(target), f(focal_length), f(focal_blur),
                            f(fov))


def look_at(p: CameraParams) -> Camera:
    """``core.camera.look_at`` as tensor code: right = normalize(dir x +Y),
    up = normalize(right x dir), w = 1 on every basis vector (make_ray's
    vec4 normalize needs those w's).  The returned Camera holds tensors."""
    d = vm.normalize(p.target - p.eye)
    r = vm.normalize(vm.cross(d, d.new_tensor([0.0, 1.0, 0.0])))
    u = vm.normalize(vm.cross(r, d))
    ext = lambda v: torch.cat([v, v.new_ones(1)])
    return Camera(eye=ext(p.eye), direction=ext(d), up=ext(u), right=ext(r),
                  focal_length=p.focal_length, focal_blur=p.focal_blur,
                  fov=p.fov)


def camera_from_params(p: Optional[CameraParams], base: Camera) -> Camera:
    return base if p is None else look_at(p)


def host_camera(camera: Camera) -> Camera:
    """The camera with NumPy fields, as the kernels' ``pack_camera`` reads
    it (a camera made from parameters holds tensors)."""
    f = lambda v: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                   else v)
    return Camera(*(f(v) for v in camera))


class SphereParams(NamedTuple):
    """Differentiable per-sphere scene parameters."""

    albedo: Optional[torch.Tensor] = None     # (N, 3)
    mat_param: Optional[torch.Tensor] = None  # (N,)  fuzz / IOR
    center: Optional[torch.Tensor] = None     # (N, 3)
    radius: Optional[torch.Tensor] = None     # (N,)

    @staticmethod
    def from_scene(scene: SphereArray, *, albedo=True, mat_param=False,
                   center=False, radius=False) -> "SphereParams":
        return SphereParams(
            albedo=scene.albedo if albedo else None,
            mat_param=scene.mat_param if mat_param else None,
            center=scene.center if center else None,
            radius=scene.radius if radius else None)


def apply_params(scene: SphereArray, p: SphereParams) -> SphereArray:
    """Overlay the set fields onto the base scene (mat_kind stays discrete
    and fixed)."""
    return scene._replace(**{k: v for k, v in p._asdict().items()
                             if v is not None})


class TriangleParams(NamedTuple):
    """Differentiable TriangleScene parameters: the per-mesh material table
    and, optionally, the vertices.  When a vertex field is set, the face
    normals are re-derived in ``apply_tri_params`` with the BVH build's
    convention (normalize(cross(b-a, c-a))), so they follow the moving
    surface.  Vertex optimisation needs ``frozen_geometry=False`` in the
    replay: the frozen-geometry fast path detaches the triangle rows."""

    mat_albedo: Optional[torch.Tensor] = None  # (K, 3)
    mat_param: Optional[torch.Tensor] = None   # (K,)  fuzz / IOR
    a: Optional[torch.Tensor] = None           # (m, 3) vertex 0
    b: Optional[torch.Tensor] = None           # (m, 3) vertex 1
    c: Optional[torch.Tensor] = None           # (m, 3) vertex 2

    @staticmethod
    def from_scene(scene, *, albedo=True, param=False,
                   vertices=False) -> "TriangleParams":
        return TriangleParams(
            mat_albedo=scene.mat_albedo if albedo else None,
            mat_param=scene.mat_param if param else None,
            a=scene.a if vertices else None,
            b=scene.b if vertices else None,
            c=scene.c if vertices else None)

    @property
    def has_vertices(self) -> bool:
        return not (self.a is None and self.b is None and self.c is None)


def apply_tri_params(scene, p: TriangleParams):
    sc = scene._replace(**{k: v for k, v in p._asdict().items()
                           if v is not None})
    if p.has_vertices:
        n = vm.cross(sc.b - sc.a, sc.c - sc.a)
        # the norm is clamped: a triangle collapsed to zero area (on the way
        # through a vertex optimisation) would give 0/0 and poison the whole
        # loss; a real face normal's length is far above 1e-20
        n = n / torch.clamp(vm.sqrt(vm.dot(n, n))[..., None], min=1e-20)
        sc = sc._replace(normal=n)
    return sc
