"""Camera model and primary-ray generation — counterpart of
``rt/core/camera.py``.

A scene's camera is host-side NumPy float32: a handful of scalars that
``kernels.dispatch.pack_camera`` packs into one row.  The vec4 fields keep
the reference's w components (w = 1 for ``look_at``), which take part in
``make_ray``'s 4-D normalize — baked into the golden images.

``generate_primary_rays`` is the differentiable form of the kernels' raygen
for the replay graph (``rt_torch/grad``): it also takes a camera whose
fields are tensors (``grad.params.look_at``), and gradients then flow to
them.  On a NumPy camera it repeats the kernels' arithmetic operation for
operation (``tan(fov/2)`` from ``tan_half_fov``), so a replay starts from
the recorder's rays.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from rt_torch.core import rng
from rt_torch.core import vecmath as vm


class Camera(NamedTuple):
    eye: np.ndarray            # (4,) f32
    direction: np.ndarray      # (4,) f32
    up: np.ndarray             # (4,) f32
    right: np.ndarray          # (4,) f32
    focal_length: np.float32
    focal_blur: np.float32
    fov: np.float32


def _unit(v):
    return v / np.sqrt(np.sum(v * v, dtype=np.float32))


def _basis(eye, target):
    d = _unit(np.asarray(target, np.float32) - np.asarray(eye, np.float32))
    r = _unit(np.cross(d, np.array([0, 1, 0], np.float32)).astype(np.float32))
    u = _unit(np.cross(r, d).astype(np.float32))
    return d, r, u


def _ext(v, w):
    return np.append(np.asarray(v, np.float32), np.float32(w))


def look_at(eye, target, focal_length, focal_blur, fov) -> Camera:
    """Scene-authored camera (w = 1 on every vec4)."""
    d, r, u = _basis(eye, target)
    return Camera(eye=_ext(eye, 1.0), direction=_ext(d, 1.0),
                  up=_ext(u, 1.0), right=_ext(r, 1.0),
                  focal_length=np.float32(focal_length),
                  focal_blur=np.float32(focal_blur), fov=np.float32(fov))


def orbit_uniform(position, target, fov, focal_length=10.0,
                  focal_blur=0.0) -> Camera:
    """Interactive-path camera (w = 0 on direction/up/right, w = 1 on eye)."""
    f, r, u = _basis(position, target)
    return Camera(eye=_ext(position, 1.0), direction=_ext(f, 0.0),
                  up=_ext(u, 0.0), right=_ext(r, 0.0),
                  focal_length=np.float32(focal_length),
                  focal_blur=np.float32(focal_blur), fov=np.float32(fov))


def tan_half_fov(fov) -> np.float32:
    """tan(fov * 0.5) of a host camera: the f32 half angle's tangent in
    float64, rounded to f32 (the correctly rounded value; NumPy's f32 tan is
    1 ULP off it at the scenes' fov of 0.3*pi).  The one place it is
    evaluated for the kernels and for the replay of a host camera."""
    half = np.float32(fov) * np.float32(0.5)
    return np.float32(math.tan(float(half)))


def random_on_disk(state, radius):
    """normalize(rng_vec2) * rng_float * radius: first-quadrant arc bias
    included, always 3 draws.  Returns (state, (..., 3) offset with z = 0)."""
    state, a = rng.next_float(state)
    state, b = rng.next_float(state)
    v2 = vm.normalize(torch.stack([a, b], dim=-1))
    state, r = rng.next_float(state)
    r = r * radius
    off = torch.cat([v2 * r[..., None], torch.zeros_like(r)[..., None]],
                    dim=-1)
    return state, off


def make_ray(camera: Camera, uv, state, normalize_defocus_dir: bool):
    """uv (..., 2) -> (state, origin (..., 3), direction (..., 3)).  The
    vec4 quirk: ``normalize(x + y + z)`` runs on vec4s whose w components
    come straight from the camera.  camera: tensor fields on uv's device,
    or NumPy fields."""
    dev = uv.device
    vec = lambda v: (v if isinstance(v, torch.Tensor) else torch.tensor(
        np.asarray(v, np.float32), device=dev))
    if isinstance(camera.fov, torch.Tensor):
        k = torch.tan(camera.fov * 0.5)
    else:
        k = float(tan_half_fov(camera.fov))
    d4 = (vec(camera.right) * (uv[..., 0] * k)[..., None]
          + vec(camera.up) * (uv[..., 1] * k)[..., None]
          + vec(camera.direction))
    d4 = vm.normalize(d4)
    o4 = torch.zeros_like(d4) + vec(camera.eye)
    focus = o4 + d4 * vec(camera.focal_length)
    state, disk = random_on_disk(state, vec(camera.focal_blur))
    o4 = o4 + torch.cat([disk, torch.ones_like(disk[..., :1])], dim=-1)
    d4 = focus - o4
    if normalize_defocus_dir:
        d4 = vm.normalize(d4)
    return state, o4[..., :3], d4[..., :3]


def generate_primary_rays(camera: Camera, width: int, height: int, time,
                          normalize_defocus_dir: bool, device="cuda",
                          row0: int = 0, rows: int | None = None):
    """Per-pixel seed + AA jitter + uv + make_ray for a (H, W) image, or
    for its band of ``rows`` rows from ``row0`` (the seed and the uv take
    the global (x, y) and ``height``, so a band's rays are those rows of
    the frame's bit for bit).  time: the u32 time uniform (int).  Returns
    (state (rows, W) int64 of u32 values, origin (rows, W, 3), direction
    (rows, W, 3))."""
    rows = height - row0 if rows is None else rows
    y = torch.arange(row0, row0 + rows, dtype=torch.int64,
                     device=device)[:, None]
    x = torch.arange(width, dtype=torch.int64, device=device)[None, :]
    x = x.expand(rows, width)
    y = y.expand(rows, width)
    state = rng.seed(x, y, height, int(time) & rng.MASK)
    state, jx = rng.next_float(state)
    state, jy = rng.next_float(state)
    jitter = vm.normalize(torch.stack([jx, jy], dim=-1))
    pos_aa = torch.stack([x.to(torch.float32) + 0.5,
                          y.to(torch.float32) + 0.5], dim=-1) + jitter
    # tensor divisors: CUDA division by a Python scalar multiplies by its
    # reciprocal, which is not the IEEE quotient
    f32 = lambda *v: torch.tensor(v, dtype=torch.float32, device=device)
    uv = pos_aa / f32(width - 1, height - 1)
    aspect = (f32(width) / f32(height)).item()
    uv = (2.0 * uv - 1.0) * f32(aspect, -1.0)
    return make_ray(camera, uv, state, normalize_defocus_dir)
