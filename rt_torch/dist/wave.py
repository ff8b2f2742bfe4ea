"""Row-band sharding of the wavefront triangle path — counterpart of
``rt/dist/wave.py``.

The wave path flattens a frame into one ray stream and re-sorts it between
bounces, so a band cannot be a slice of the full frame's stream.  Each rank
instead runs the whole pipeline — raygen (K2, or K4 at spp > 1), the
bounces (K3), the coherence sorts and the pixel-order restore — on a stream
of its own band's rays, the scene tables replicated.  The band's launch
starts at ``row0 = rank * band_h``: seeds and uvs come from the global
(x, y), so its rays are those rows of the full frame bit for bit; a sort
only decides which stream tile a ray lands in, which the closest-hit
arithmetic does not observe (strict ``t < best``; the same measure-zero
exact-t tie caveat as wave against mono).  No collective is made while
rendering.
"""

from __future__ import annotations

import dataclasses

from rt_torch.config import RenderConfig
from rt_torch.dist.sharding import Mesh
from rt_torch.kernels import dispatch
from rt_torch.render.renderer import RenderState, accumulate

__all__ = ["sharded_wave_render_frames", "sharded_wave_step",
           "sharded_wave_frames"]


def _band_params(config: RenderConfig, n_shards: int, rank: int
                 ) -> tuple[int, int, RenderConfig]:
    """(row0, band_h, config with the band's tile): a height the shards do
    not divide raises; the tile height is capped at the band's height
    rounded up to 8, so that a band keeps at least one tile row (the tile
    changes no ray's arithmetic)."""
    h = config.height
    if h % n_shards:
        raise ValueError(f"height {h} not divisible by {n_shards} shards")
    band_h = h // n_shards
    th, tw = config.tile or dispatch.DEFAULT_TILE
    th = min(th, dispatch._round_up(band_h, 8))
    return (rank * band_h, band_h,
            dataclasses.replace(config, tile=(th, tw)))


def sharded_wave_render_frames(scene, camera, config: RenderConfig, times,
                               mesh: Mesh):
    """(F, band_h, W, 3) colors of this rank's band for F frames — the
    sharded form of ``dispatch.render_color_frames``, whose rows row0..
    they equal bit for bit.  scene: a TriangleScene or its PackedScene on
    the mesh's device."""
    row0, band_h, cfg = _band_params(config, mesh.world_size, mesh.rank)
    return dispatch.render_color_frames(scene, camera, cfg, times,
                                        mesh.device, row0=row0,
                                        rows=band_h)


def sharded_wave_step(mesh: Mesh):
    """step(scene, camera, state, time, config) -> RenderState: this rank's
    band traced on its stream and EMA-accumulated into its band (the
    accumulator's shape), with ``render_frame``'s weights; frame_count is a
    host int, the same on every rank."""

    def step(scene, camera, state: RenderState, time,
             config: RenderConfig) -> RenderState:
        color = sharded_wave_render_frames(scene, camera, config,
                                           [int(time)], mesh)[0]
        return accumulate(state, color, config)

    return step


def sharded_wave_frames(mesh: Mesh):
    """frames(scene, camera, state, time0, time_step, config, n_frames) ->
    RenderState: ``n_frames`` sharded steps at time0 + i*time_step (u32
    wrap) — the sharded ``render_frames``, a Python loop as that one is;
    what ``rt_torch.cli --sharded`` drives for triangle scenes."""
    step = sharded_wave_step(mesh)

    def frames(scene, camera, state: RenderState, time0, time_step,
               config: RenderConfig, n_frames: int) -> RenderState:
        for i in range(n_frames):
            t = (int(time0) + i * int(time_step)) & 0xFFFFFFFF
            state = step(scene, camera, state, t, config)
        return state

    return frames
