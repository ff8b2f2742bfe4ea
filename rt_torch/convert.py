"""State carried across from the JAX package, as NumPy arrays.

The inputs are the fields of the JAX ``TriangleScene`` / ``SphereArray`` /
``Camera`` / ``RenderState`` and of its parameter tuples (``SphereParams`` /
``TriangleParams`` / ``CameraParams``) after ``np.asarray`` on each; this
module never sees a JAX type.  The tests use it so both packages compute on
the same scene and start a fit from the same state.
"""

from __future__ import annotations

import numpy as np
import torch

from rt_torch.core.camera import Camera
from rt_torch.core.sphere import SphereArray
from rt_torch.core.triangle import TriangleScene
from rt_torch.grad.params import CameraParams, SphereParams, TriangleParams
from rt_torch.render.renderer import RenderState

_SCENE_DTYPES = {"a": np.float32, "b": np.float32, "c": np.float32,
                 "normal": np.float32, "mat_id": np.int32,
                 "bmin": np.float32, "bmax": np.float32,
                 "mat_albedo": np.float32, "mat_param": np.float32,
                 "mat_kind": np.int32}

_SPHERE_DTYPES = {"center": np.float32, "radius": np.float32,
                  "albedo": np.float32, "mat_param": np.float32,
                  "mat_kind": np.int32}


def _from_numpy(cls, dtypes: dict, fields: dict, device):
    missing = set(dtypes) - set(fields)
    if missing:
        raise ValueError(f"scene fields missing: {sorted(missing)}")
    return cls(**{
        k: torch.from_numpy(np.array(fields[k], dtype=dt, order="C")).to(
            device) for k, dt in dtypes.items()})


def scene_from_numpy(fields: dict, device="cuda") -> TriangleScene:
    """fields: name -> array for every field of TriangleScene."""
    return _from_numpy(TriangleScene, _SCENE_DTYPES, fields, device)


def spheres_from_numpy(fields: dict, device="cuda") -> SphereArray:
    """fields: name -> array for every field of SphereArray (``mat_kind`` is
    u32 in the JAX package, i32 here)."""
    return _from_numpy(SphereArray, _SPHERE_DTYPES, fields, device)


def camera_from_numpy(fields: dict) -> Camera:
    """fields: name -> array/scalar for every field of Camera."""
    vec = lambda k: np.asarray(fields[k], np.float32).reshape(4)
    return Camera(eye=vec("eye"), direction=vec("direction"), up=vec("up"),
                  right=vec("right"),
                  focal_length=np.float32(fields["focal_length"]),
                  focal_blur=np.float32(fields["focal_blur"]),
                  fov=np.float32(fields["fov"]))


def render_state_from_numpy(image, frame_count, device="cuda") -> RenderState:
    img = np.array(image, dtype=np.float32, order="C")
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"image: need (H, W, 3), got {img.shape}")
    return RenderState(image=torch.from_numpy(img).to(device),
                       frame_count=int(frame_count) & 0xFFFFFFFF)


def _params_from_numpy(cls, fields: dict, device):
    """Leaf tensors that require a gradient for the fields that are set;
    a field that is missing or None stays frozen."""
    unknown = set(fields) - set(cls._fields)
    if unknown:
        raise ValueError(f"{cls.__name__} has no field {sorted(unknown)}")
    leaf = lambda v: torch.from_numpy(
        np.array(v, dtype=np.float32, order="C")).to(device).requires_grad_()
    return cls(**{k: leaf(v) for k, v in fields.items() if v is not None})


def sphere_params_from_numpy(fields: dict, device="cuda") -> SphereParams:
    """fields: name -> array for the set fields of the JAX SphereParams."""
    return _params_from_numpy(SphereParams, fields, device)


def triangle_params_from_numpy(fields: dict,
                               device="cuda") -> TriangleParams:
    return _params_from_numpy(TriangleParams, fields, device)


def camera_params_from_numpy(fields: dict, device="cuda") -> CameraParams:
    """fields: every field of the JAX CameraParams."""
    return _params_from_numpy(CameraParams, fields, device)
