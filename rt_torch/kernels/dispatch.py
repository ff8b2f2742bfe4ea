"""Kernel dispatch: pack scene and camera into the kernels' operand layouts,
pad the image to tile multiples, launch, crop — counterpart of
``rt/kernels/dispatch.py`` for TriangleScene.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from rt_torch.config import MAT_DIELECTRIC, MAT_METAL, RenderConfig
from rt_torch.core.triangle import TriangleScene
from rt_torch.kernels import tris_kernel
from rt_torch.kernels.tracer_common import (CAM_BLUR, CAM_DIR, CAM_EYE,
                                            CAM_FL, CAM_FOV, CAM_RIGHT,
                                            CAM_TAN, CAM_UP, CAM_WIDTH)

# Rays per tile on the card: one CUDA block per tile.
DEFAULT_TILE = (8, 16)
SMALL_SCENE_MAX_TRIS = 8192


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def pack_camera(camera) -> np.ndarray:
    """(1, 20) f32 host row.  Slot CAM_TAN holds tan(fov * 0.5), evaluated
    here and nowhere else: the f32 half angle's tangent in float64, rounded
    to f32 (the correctly rounded value; NumPy's f32 tan is 1 ULP off it at
    the scenes' fov of 0.3*pi, XLA's agrees with it there)."""
    row = np.zeros((1, CAM_WIDTH), np.float32)
    row[0, CAM_EYE:CAM_EYE + 4] = camera.eye
    row[0, CAM_DIR:CAM_DIR + 4] = camera.direction
    row[0, CAM_UP:CAM_UP + 4] = camera.up
    row[0, CAM_RIGHT:CAM_RIGHT + 4] = camera.right
    row[0, CAM_FL] = camera.focal_length
    row[0, CAM_BLUR] = camera.focal_blur
    row[0, CAM_FOV] = camera.fov
    half = np.float32(camera.fov) * np.float32(0.5)
    row[0, CAM_TAN] = np.float32(math.tan(float(half)))
    return row


def wave_params(scene, config: RenderConfig) -> dict:
    """Wavefront knobs for this scene and config: the small-scene branch
    (m <= 8192) of the JAX package's ``wave_params`` — ``chunk_oct`` key,
    a re-sort every 2 bounces, no sort before a short final launch."""
    m = scene.m if isinstance(scene, TriangleScene) else scene.tab.shape[0]
    if m > SMALL_SCENE_MAX_TRIS:
        raise NotImplementedError(
            f"{m} triangles: the large-scene wave branch (morton key, "
            "sort_every=1, split_big) is not ported yet (ROADMAP M5)")
    if config.samples_per_frame != 1:
        raise NotImplementedError(
            "samples_per_frame > 1 is not ported yet (ROADMAP M5, kernel K4)")
    th, tw = config.tile or DEFAULT_TILE
    return dict(
        bounces=config.bounces,
        normalize_defocus_dir=config.normalize_defocus_dir,
        flags=tris_kernel.TraceFlags(
            normalize_reflect_in=config.normalize_reflect_in,
            has_metal=MAT_METAL in config.mat_kinds,
            has_dielectric=MAT_DIELECTRIC in config.mat_kinds),
        sort_every=2, skip_last_sort=True, th=th, tw=tw)


def pack_scene(scene: TriangleScene) -> tris_kernel.PackedScene:
    """The kernels' tables for a scene.  They depend on the scene only, so a
    renderer packs once and passes them to every frame."""
    return tris_kernel.pack_tri_table(scene)


def render_color_frames(scene, camera, config: RenderConfig, times,
                        device="cuda"):
    """(F, H, W, 3) colors for F frames of a triangle scene in one
    wavefront stream.  scene: a TriangleScene or its PackedScene.
    times: F u32 time uniforms (ints)."""
    if isinstance(scene, TriangleScene):
        scene = pack_scene(scene)
    elif not isinstance(scene, tris_kernel.PackedScene):
        raise TypeError(f"unknown scene type {type(scene)}")
    device = torch.device(device)
    if scene.tab.device.type != device.type:
        raise ValueError(f"scene lies on {scene.tab.device}, asked to "
                         f"render on {device}")
    h, w = config.height, config.width
    kw = wave_params(scene, config)
    hp, wp = _round_up(h, kw["th"]), _round_up(w, kw["tw"])

    t = np.atleast_1d(np.asarray(times, np.int64)) & 0xFFFFFFFF
    time_arr = torch.from_numpy(t.astype(np.uint32).view(np.int32)).to(
        scene.tab.device)
    colors = tris_kernel.render_color_tris_wave(
        scene, pack_camera(camera), time_arr, height=h, width=w,
        height_pad=hp, width_pad=wp, **kw)              # (F, 3, Hp, Wp)
    colors = colors.permute(0, 2, 3, 1)                 # (F, Hp, Wp, 3)
    if (hp, wp) != (h, w):
        colors = colors[:, :h, :w]
    return colors


def render_color(scene, camera, config: RenderConfig, time, device="cuda"):
    """(H, W, 3) color for one frame."""
    return render_color_frames(scene, camera, config, [int(time)], device)[0]
