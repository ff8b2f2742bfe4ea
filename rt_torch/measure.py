"""Measurements of the port on the card, one JSON line each.

    python -m rt_torch.measure tiles [PATH]       # tile-shape sweep
    python -m rt_torch.measure breakdown [PATH]   # where a frame's time goes
    python -m rt_torch.measure wall [PATH]        # ms per frame, five windows

PATH names one of the port's paths (``PATHS`` below, the table
``chip_smoke.py`` drives too; default ``suzanne``: Suzanne 512x512, 8
bounces, 1 sample per pixel per frame).  Both run on ``cuda:0`` and fail
without a card.  Every line carries the card's name and power limit as
``nvidia-smi`` reports them.

A wall time is taken over a window of at least ``MIN_WINDOW_S`` seconds that
ends in a synchronise: a path whose frame is a few tens of microseconds is
not read off a few milliseconds.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from typing import NamedTuple

import torch

from rt_torch.kernels import dispatch
from rt_torch.render.renderer import ProgressiveRenderer
from rt_torch.scene import scenes



class Path(NamedTuple):
    scene_id: int
    width: int
    height: int
    overrides: dict     # RenderConfig fields set over the scene's own
    launches: dict      # kernel launches one frame makes, by wrapper name
    smoke_frames: int   # frames ``chip_smoke.py`` times


PATHS = {
    # 1 sample per pixel: the fused first kernel, then [2, 2, 2, 1] bounces
    "suzanne": Path(5, 512, 512, dict(bounces=8),
                    {"wave_first": 1, "wave_bounce": 4}, 32),
    # one launch per frame, a frame of some tens of microseconds
    "sphere_simple": Path(1, 512, 512, {}, {"spheres": 1}, 4096),
    # 486 live spheres: the chunk-culled kernel
    "sphere_cover": Path(8, 1280, 720, {}, {"spheres_chunked": 1}, 16),
    # raygen once, then per sample four 2-bounce launches from bounce 0
    "suzanne_spp4": Path(5, 512, 512,
                         dict(bounces=8, samples_per_frame=4),
                         {"wave_raygen": 1, "wave_bounce": 16}, 8),
    # the large-scene branch: a sort and a 1-bounce launch per bounce after
    # the fused first kernel
    "dragon": Path(7, 512, 512, dict(bounces=5),
                   {"wave_first": 1, "wave_bounce": 4}, 8),
}
MIN_WINDOW_S = 0.3
TILES = [(4, 8), (8, 8), (8, 16), (8, 32), (16, 32), (32, 32)]


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def renderer(path: str, tile=None, device="cuda") -> ProgressiveRenderer:
    """A ProgressiveRenderer of the named path's scene, size and config."""
    p = PATHS[path]
    sd = scenes.build_scene(p.scene_id, p.width, p.height, device=device)
    sd = dataclasses.replace(sd, config=dataclasses.replace(
        sd.config, tile=tile, **p.overrides))
    return ProgressiveRenderer(sd, device=device)


def _segments_per_frame(r: ProgressiveRenderer) -> int:
    c = r.config
    return c.width * c.height * c.bounces * c.samples_per_frame


def _ms_per_frame(r: ProgressiveRenderer, frames: int) -> float:
    """Wall milliseconds per frame over ``frames`` frames, or over as many
    more as fill MIN_WINDOW_S (sized from a first pass of ``frames``)."""
    def window(n):
        r.set_time(1000)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r.draw_frames(n)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n

    per_frame = window(frames)
    if per_frame * frames < MIN_WINDOW_S:
        per_frame = window(math.ceil(MIN_WINDOW_S / per_frame))
    return per_frame * 1e3


def tiles(path: str = "suzanne", frames: int = 16):
    """ms per frame for each tile shape, each measured twice in turns
    (forward then backward over the list) on one card."""
    card = _card()
    renderers = {t: renderer(path, t) for t in TILES}
    for r in renderers.values():
        r.draw_frames(2)                                  # warm-up
    runs = {t: [] for t in TILES}
    for t in TILES + TILES[::-1]:
        runs[t].append(_ms_per_frame(renderers[t], frames))
    for t in TILES:
        print(json.dumps({
            "measure": "tiles", "path": path, "card": card, "tile": list(t),
            "rays_per_tile": t[0] * t[1], "frames": frames,
            "ms_per_frame": runs[t],
            "ray_segments_per_s": [
                _segments_per_frame(renderers[t]) / (m * 1e-3)
                for m in runs[t]]}), flush=True)


def wall(path: str = "suzanne", windows: int = 5):
    """Wall ms per frame of ``windows`` windows in a row in one process:
    the spread between them is the host's, the device work is the same."""
    card = _card()
    r = renderer(path)
    r.draw_frames(4)                                      # warm-up
    runs = [_ms_per_frame(r, 16) for _ in range(windows)]
    print(json.dumps({
        "measure": "wall", "path": path, "card": card,
        "min_window_s": MIN_WINDOW_S, "ms_per_frame": runs,
        "frames_per_s": [1e3 / m for m in runs]}), flush=True)


_GROUPS = (
    ("kernel_wave_first", ("wave_first_kernel",)),
    ("kernel_wave_bounce", ("wave_bounce_kernel",)),
    ("kernel_wave_raygen", ("wave_raygen_kernel",)),
    ("kernel_spheres", ("spheres_kernel",)),
    ("kernel_spheres_chunked", ("spheres_chunked_kernel",)),
    ("sort", ("sort", "Sort", "radix", "Radix")),
    ("gather_scatter", ("index", "gather", "scatter")),
)


def breakdown(path: str = "suzanne", frames: int = 16):
    """Device time of one steady frame by kind of kernel, from
    torch.profiler, and the share of the frame the device sat idle."""
    from torch.profiler import ProfilerActivity, profile

    card = _card()
    r = renderer(path)
    r.draw_frames(4)
    wall_ms = _ms_per_frame(r, frames)                    # unprofiled
    r.set_time(1000)
    dispatch.reset_launch_counts()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        r.draw_frames(frames)
        torch.cuda.synchronize()
    sums = {name: 0.0 for name, _ in _GROUPS}
    sums["other_torch"] = 0.0
    counts = dict.fromkeys(sums, 0)
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0.0)
        if not us:
            continue
        group = next((g for g, keys in _GROUPS
                      if any(k in ev.key for k in keys)), "other_torch")
        sums[group] += us
        counts[group] += ev.count
    busy_ms = sum(sums.values()) / 1e3 / frames
    if busy_ms == 0.0:
        raise SystemExit("torch.profiler recorded no device time")
    print(json.dumps({
        "measure": "breakdown", "path": path, "card": card, "frames": frames,
        "frames_per_s": 1e3 / wall_ms,
        "ray_segments_per_s": _segments_per_frame(r) / (wall_ms * 1e-3),
        "tile": list(r.config.tile or ()) or "default",
        "wall_ms_per_frame": wall_ms,
        "device_ms_per_frame": {k: v / 1e3 / frames
                                for k, v in sums.items()},
        "device_kernels_per_frame": {k: c / frames
                                     for k, c in counts.items()},
        "device_busy_ms_per_frame": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "launches": dispatch.launch_counts()}), flush=True)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("rt_torch.measure needs a CUDA device", file=sys.stderr)
        return 1
    what = {"tiles": tiles, "breakdown": breakdown, "wall": wall}
    if (len(argv) not in (1, 2) or argv[0] not in what
            or (len(argv) == 2 and argv[1] not in PATHS)):
        print(__doc__, file=sys.stderr)
        print(f"paths: {', '.join(PATHS)}", file=sys.stderr)
        return 2
    what[argv[0]](*argv[1:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
