"""Measurements of the port on the card, one JSON line each.

    python -m rt_torch.measure tiles       # tile-shape sweep, main path
    python -m rt_torch.measure breakdown   # where one frame's time goes

Both run Suzanne 512x512, 8 bounces, 1 sample per pixel per frame — the
main path — on ``cuda:0`` and fail without a card.  Every line carries the
card's name and power limit as ``nvidia-smi`` reports them.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import torch

from rt_torch.kernels import tris_kernel
from rt_torch.render.renderer import ProgressiveRenderer
from rt_torch.scene import scenes

SIZE, BOUNCES = 512, 8
TILES = [(4, 8), (8, 8), (8, 16), (8, 32), (16, 32), (32, 32)]


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def _renderer(tile=None) -> ProgressiveRenderer:
    sd = scenes.scene_suzanne(SIZE, SIZE, device="cuda")
    sd = dataclasses.replace(sd, config=dataclasses.replace(
        sd.config, bounces=BOUNCES, tile=tile))
    return ProgressiveRenderer(sd, device="cuda")


def _ms_per_frame(r: ProgressiveRenderer, frames: int) -> float:
    r.set_time(1000)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r.draw_frames(frames)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / frames * 1e3


def tiles(frames: int = 32):
    """ms per frame for each tile shape, each measured twice in turns
    (forward then backward over the list) on one card."""
    card = _card()
    renderers = {t: _renderer(t) for t in TILES}
    for r in renderers.values():
        r.draw_frames(2)                                  # warm-up
    runs = {t: [] for t in TILES}
    for t in TILES + TILES[::-1]:
        runs[t].append(_ms_per_frame(renderers[t], frames))
    for t in TILES:
        print(json.dumps({
            "measure": "tiles", "card": card, "tile": list(t),
            "rays_per_tile": t[0] * t[1], "frames": frames,
            "ms_per_frame": runs[t],
            "ray_segments_per_s": [SIZE * SIZE * BOUNCES / (m * 1e-3)
                                   for m in runs[t]]}), flush=True)


_GROUPS = (
    ("kernel_wave_first", ("wave_first_kernel",)),
    ("kernel_wave_bounce", ("wave_bounce_kernel",)),
    ("sort", ("sort", "Sort", "radix", "Radix")),
    ("gather_scatter", ("index", "gather", "scatter")),
)


def breakdown(frames: int = 16):
    """Device time of one steady frame by kind of kernel, from
    torch.profiler, and the share of the frame the device sat idle."""
    from torch.profiler import ProfilerActivity, profile

    card = _card()
    r = _renderer()
    r.draw_frames(4)
    wall_ms = _ms_per_frame(r, frames)                    # unprofiled
    r.set_time(1000)
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
        "measure": "breakdown", "card": card, "frames": frames,
        "tile": list(r.config.tile or ()) or "default",
        "wall_ms_per_frame": wall_ms,
        "device_ms_per_frame": {k: v / 1e3 / frames
                                for k, v in sums.items()},
        "device_kernels_per_frame": {k: c / frames
                                     for k, c in counts.items()},
        "device_busy_ms_per_frame": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "launches": dict(tris_kernel.LAUNCHES)}), flush=True)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("rt_torch.measure needs a CUDA device", file=sys.stderr)
        return 1
    what = {"tiles": tiles, "breakdown": breakdown}
    if len(argv) != 1 or argv[0] not in what:
        print(__doc__, file=sys.stderr)
        return 2
    what[argv[0]]()
    return 0


if __name__ == "__main__":
    sys.exit(main())
