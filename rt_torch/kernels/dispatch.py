"""Kernel dispatch: pack scene and camera into the kernels' operand layouts,
pad the image to tile multiples, launch, crop — counterpart of
``rt/kernels/dispatch.py``: sphere scenes through the fused sphere kernels
(flat up to 128 live spheres, chunk-culled above), triangle scenes through
the wavefront path or, with ``config.tris_path == "mono"``, through the
whole-frame kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from rt_torch.config import MAT_DIELECTRIC, MAT_METAL, RenderConfig
from rt_torch.core.camera import tan_half_fov
from rt_torch.core.sphere import SphereArray
from rt_torch.core.triangle import TriangleScene
from rt_torch.kernels import replay_kernel, sphere_kernel, tris_kernel
from rt_torch.kernels.tracer_common import (CAM_BLUR, CAM_DIR, CAM_EYE,
                                            CAM_FL, CAM_FOV, CAM_RIGHT,
                                            CAM_TAN, CAM_UP, CAM_WIDTH)
from rt_torch.utils.profiling import span

# Rays per tile on the card: one CUDA block per tile.
DEFAULT_TILE = (8, 16)
SMALL_SCENE_MAX_TRIS = 8192


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def pack_camera(camera) -> np.ndarray:
    """(1, 20) f32 host row.  Slot CAM_TAN holds tan(fov * 0.5), evaluated
    on the host (``core.camera.tan_half_fov``) and in no kernel."""
    row = np.zeros((1, CAM_WIDTH), np.float32)
    row[0, CAM_EYE:CAM_EYE + 4] = camera.eye
    row[0, CAM_DIR:CAM_DIR + 4] = camera.direction
    row[0, CAM_UP:CAM_UP + 4] = camera.up
    row[0, CAM_RIGHT:CAM_RIGHT + 4] = camera.right
    row[0, CAM_FL] = camera.focal_length
    row[0, CAM_BLUR] = camera.focal_blur
    row[0, CAM_FOV] = camera.fov
    row[0, CAM_TAN] = tan_half_fov(camera.fov)
    return row


def trace_flags(config: RenderConfig) -> tris_kernel.TraceFlags:
    """The scene/config facts the bounces specialise on."""
    return tris_kernel.TraceFlags(
        normalize_reflect_in=config.normalize_reflect_in,
        has_metal=MAT_METAL in config.mat_kinds,
        has_dielectric=MAT_DIELECTRIC in config.mat_kinds)


def wave_params(scene, config: RenderConfig) -> dict:
    """Wavefront knobs for this scene and config.  Small scenes
    (m <= 8192): ``chunk_oct`` key, a re-sort every 2 bounces, no sort
    before a short final launch.  Large scenes: ``morton`` key, a re-sort
    every bounce, oversized triangles split off into their own chunks
    (``pack_scene`` reads ``split_big`` from here)."""
    m = scene.m if isinstance(scene, TriangleScene) else scene.tab.shape[0]
    large = m > SMALL_SCENE_MAX_TRIS
    th, tw = config.tile or DEFAULT_TILE
    return dict(
        bounces=config.bounces,
        normalize_defocus_dir=config.normalize_defocus_dir,
        flags=trace_flags(config),
        key_mode="morton" if large else "chunk_oct",
        sort_every=1 if large else 2, skip_last_sort=True,
        spp=config.samples_per_frame,
        sky_from_final_dir=config.sky_from_final_dir, th=th, tw=tw)


def pack_spheres_table(scene: SphereArray):
    """((N, 8) f32 table: centre, radius, albedo, parameter; (N,) int32
    kinds; N)."""
    tab = torch.cat([scene.center.to(torch.float32),
                     scene.radius.to(torch.float32)[:, None],
                     scene.albedo.to(torch.float32),
                     scene.mat_param.to(torch.float32)[:, None]], dim=1)
    return (tab.contiguous(), scene.mat_kind.to(torch.int32).contiguous(),
            scene.count)


def pack_scene(scene, config: RenderConfig | None = None):
    """The kernels' tables for a scene.  They depend on the scene and, for
    spheres, on ``config.n_active_spheres`` only, so a renderer packs once
    and passes them to every frame.

    A TriangleScene gives a ``tris_kernel.PackedScene`` (large scenes with
    ``split_big``).  A SphereArray gives a ``sphere_kernel.PackedSpheres``:
    the flat table when at most 128 spheres are live, the Morton-chunked
    one above."""
    if isinstance(scene, TriangleScene):
        return tris_kernel.pack_tri_table(
            scene, split_big=scene.m > SMALL_SCENE_MAX_TRIS)
    if isinstance(scene, SphereArray):
        tab, kinds, n = pack_spheres_table(scene)
        if config is not None and 0 < config.n_active_spheres < n:
            n = config.n_active_spheres
        if n > sphere_kernel.FLAT_MAX_SPHERES:
            return sphere_kernel.pack_spheres_chunked(tab, kinds, n)
        return sphere_kernel.PackedSpheres(tab, kinds, n, None)
    raise TypeError(f"unknown scene type {type(scene)}")


def check_device(tab: torch.Tensor, device) -> None:
    device = torch.device(device)
    if tab.device.type != device.type:
        raise ValueError(f"scene lies on {tab.device}, asked to render on "
                         f"{device}")


def render_color_frames(scene, camera, config: RenderConfig, times,
                        device="cuda", row0: int = 0,
                        rows: int | None = None):
    """(F, H, W, 3) colors for F frames of a triangle scene in one
    wavefront stream.  scene: a TriangleScene or its PackedScene.
    times: F u32 time uniforms (ints).  With ``row0``/``rows``: (F, rows,
    W, 3), the band of the frame's rows row0.. in a stream of its own (the
    band padded to the tile and cropped), bit for bit those rows of the
    frame."""
    if isinstance(scene, TriangleScene):
        scene = pack_scene(scene)
    elif not isinstance(scene, tris_kernel.PackedScene):
        raise TypeError(f"unknown scene type {type(scene)}")
    check_device(scene.tab, device)
    h, w = config.height, config.width
    rows = h - row0 if rows is None else rows
    kw = wave_params(scene, config)
    hp, wp = _round_up(rows, kw["th"]), _round_up(w, kw["tw"])

    t = np.atleast_1d(np.asarray(times, np.int64)) & 0xFFFFFFFF
    time_arr = torch.from_numpy(t.astype(np.uint32).view(np.int32)).to(
        scene.tab.device)
    colors = tris_kernel.render_color_tris_wave(
        scene, pack_camera(camera), time_arr, height=h, width=w,
        height_pad=hp, width_pad=wp, row0=row0, **kw)   # (F, 3, Hp, Wp)
    colors = colors.permute(0, 2, 3, 1)                 # (F, Hp, Wp, 3)
    if (hp, wp) != (rows, w):
        colors = colors[:, :rows, :w]
    return colors


def frame_geometry(config: RenderConfig) -> dict:
    """The real and the tile-padded extent and the tile of a whole-frame
    launch."""
    th, tw = config.tile or DEFAULT_TILE
    return dict(height=config.height, width=config.width,
                height_pad=_round_up(config.height, th),
                width_pad=_round_up(config.width, tw), th=th, tw=tw)


def _crop(color, config: RenderConfig):
    """(C, Hp, Wp) planes -> (H, W, C)."""
    color = color.permute(1, 2, 0)
    if color.shape[:2] != (config.height, config.width):
        color = color[:config.height, :config.width]
    return color


def render_color_spheres(scene, camera, config: RenderConfig, time,
                         device="cuda"):
    """(H, W, 3) color for one frame of a sphere scene, one kernel launch.
    scene: a SphereArray or its PackedSpheres."""
    if isinstance(scene, SphereArray):
        scene = pack_scene(scene, config)
    check_device(scene.tab, device)
    kw = dict(bounces=config.bounces,
              normalize_defocus_dir=config.normalize_defocus_dir,
              flags=trace_flags(config),
              sky_from_final_dir=config.sky_from_final_dir,
              spp=config.samples_per_frame, **frame_geometry(config))
    cam_row = pack_camera(camera)
    with span("spheres.frame"):
        if scene.chunks is None:
            color = sphere_kernel.render_color_spheres(
                scene.tab, scene.kinds, cam_row, int(time),
                n_spheres=scene.n, **kw)
        else:
            color = sphere_kernel.render_color_spheres_chunked(
                scene, cam_row, int(time), **kw)
        return _crop(color, config)


def render_color_tris_mono(scene, camera, config: RenderConfig, time,
                           device="cuda"):
    """(H, W, 3) color for one frame of a triangle scene in one launch of
    the whole-frame kernel.  scene: a TriangleScene or its PackedScene."""
    if isinstance(scene, TriangleScene):
        scene = pack_scene(scene)
    check_device(scene.tab, device)
    color = tris_kernel.render_color_tris(
        scene, pack_camera(camera), int(time), bounces=config.bounces,
        normalize_defocus_dir=config.normalize_defocus_dir,
        flags=trace_flags(config),
        sky_from_final_dir=config.sky_from_final_dir,
        spp=config.samples_per_frame, **frame_geometry(config))
    return _crop(color, config)


def render_color(scene, camera, config: RenderConfig, time, device="cuda"):
    """(H, W, 3) color for one frame.  scene: a SphereArray, a
    TriangleScene, or what ``pack_scene`` made of one."""
    if isinstance(scene, (SphereArray, sphere_kernel.PackedSpheres)):
        return render_color_spheres(scene, camera, config, time, device)
    if config.tris_path == "mono":
        return render_color_tris_mono(scene, camera, config, time, device)
    if config.tris_path != "wave":
        raise ValueError(f"tris_path {config.tris_path!r}: wave or mono")
    return render_color_frames(scene, camera, config, [int(time)], device)[0]


def launch_counts() -> dict:
    """Kernel launches so far, by wrapper name (every kernel)."""
    return (tris_kernel.LAUNCHES | sphere_kernel.LAUNCHES
            | replay_kernel.LAUNCHES)


def reset_launch_counts() -> None:
    for table in (tris_kernel.LAUNCHES, sphere_kernel.LAUNCHES,
                  replay_kernel.LAUNCHES):
        for name in table:
            table[name] = 0
