"""Camera model — counterpart of ``rt/core/camera.py:34-89``.

Host-side NumPy float32, as in the JAX package: the camera is a handful of
scalars that ``kernels.dispatch.pack_camera`` packs into one row.  The vec4
fields keep the reference's w components (w = 1 for ``look_at``), which take
part in ``make_ray``'s 4-D normalize — baked into the golden images.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


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
