"""How the flat sphere kernel's lanes spend a frame — a model in plain
tensor code of its schedule, from the plain version's own counts.

- ``sample_scans``: the segments (a scan, and the resolve and scatter of a
  hit) each pixel's path runs in each sample, from the live masks of the
  plain version (``sphere_kernel.sphere_bounce``): at most ``bounces``, one
  more than its hits where it escapes.
- ``tile_schedule``: a thread a pixel of a (th, tw) tile, 32 threads a warp,
  every thread running each sample's bounce loop to its own end
  (``csrc/spheres.cu:spheres_kernel``): a warp turns the loop, sample by
  sample, as often as its longest path.
- ``merged_schedule``: the same threads, each running its pixel's samples
  back to back in one loop: a warp turns as often as its lanes' most
  segments summed over all samples.  ``spheres_kernel`` keeps the loop per
  sample: the merged one, fewer turns, was no faster on an H100 (PERF.md).

Lane efficiency is segments over 32 times the warp turns that ran one; its
inverse is the most any schedule of whole pixels could save in turns.
These are counts, not times: what a turn costs is the kernel's business,
and on a frame with a dielectric the warps of pixels whose paths run to
the bounce limit in nearly every sample take most of it.
"""

from __future__ import annotations

import torch

from rt_torch.kernels import sphere_kernel as sk

WARP = 32


def sample_scans(tab, kinds, cam_row, time: int, *, n_spheres: int,
                 height: int, width: int, height_pad: int, width_pad: int,
                 bounces: int, normalize_defocus_dir: bool, flags,
                 spp: int = 1, **_) -> torch.Tensor:
    """(spp, Hp, Wp) int32: segments of each pixel's path in each sample,
    the sample loop of ``tracer_common.sample_loop`` (RNG state carried
    across samples) counting each bounce's live rays."""
    state, o, d0, _ = sk._primary_rays(
        cam_row, time, tab.device, height=height, width=width,
        height_pad=height_pad, width_pad=width_pad,
        normalize_defocus_dir=normalize_defocus_dir)
    one = torch.ones_like(o[0])
    out = []
    for _ in range(spp):
        carry = (state, o, d0, (one, one, one),
                 torch.ones_like(state, dtype=torch.int32))
        n = torch.zeros_like(state, dtype=torch.int32)
        for _ in range(bounces):
            alive = carry[4] > 0
            if not bool(alive.any()):
                break
            n += alive.to(torch.int32)
            carry = sk.sphere_bounce(tab, kinds, carry, flags,
                                     n_spheres=n_spheres)
        state = carry[0]
        out.append(n)
    return torch.stack(out)


def _warps(scans: torch.Tensor, th: int, tw: int) -> torch.Tensor:
    """(spp, warps, 32) int64: ``scans`` by warp, 32 consecutive threads of
    a (th, tw) block, row-major."""
    spp, hp, wp = scans.shape
    if (th * tw) % WARP or hp % th or wp % tw:
        raise ValueError(f"tile {th}x{tw}: whole warps over {hp}x{wp}")
    return (scans.reshape(spp, hp // th, th, wp // tw, tw)
            .permute(0, 1, 3, 2, 4).reshape(spp, -1, WARP).to(torch.int64))


def _schedule(turns: torch.Tensor, warps: torch.Tensor) -> dict:
    turns, segments = int(turns.sum()), int(warps.sum())
    return {"warp_turns": turns, "segments": segments,
            "lane_efficiency": segments / max(1, WARP * turns)}


def tile_schedule(scans: torch.Tensor, th: int, tw: int) -> dict:
    """Warp turns of a loop per sample over a (spp, Hp, Wp) ``scans``: per
    warp and sample, the most segments of its lanes."""
    warps = _warps(scans, th, tw)
    return _schedule(warps.amax(dim=2), warps)


def merged_schedule(scans: torch.Tensor, th: int, tw: int) -> dict:
    """Warp turns of one loop over all samples' segments: per warp, the
    most of its lanes' segments summed over the samples.  The keys of
    ``tile_schedule``."""
    warps = _warps(scans, th, tw)
    return _schedule(warps.sum(dim=0).amax(dim=1), warps)
