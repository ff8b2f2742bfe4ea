"""The fused sphere path — counterpart of ``rt/kernels/sphere_kernel.py``
(``_sphere_bounce``, ``_kernel``, ``_kernel_record``,
``pack_spheres_chunked``, ``_sphere_bounce_chunked``, ``_kernel_chunked``).

Three kernels, each a hand-written CUDA kernel (``csrc/spheres.cu``) with a
plain PyTorch version beside it; one launch traces a whole frame — raygen,
the sample loop, the bounce loop, the closest-hit scan, scatter, sky and the
divide by the sample count:

- ``render_color_spheres`` — flat scan over the first ``n_spheres`` rows of
  the table in ascending order (at most ``FLAT_MAX_SPHERES`` rows);
- ``render_color_spheres_record`` — the same scan at one sample per pixel
  that also returns the winning row of every bounce (counterpart of
  ``_kernel_record``), for the path-replay gradients;
- ``render_color_spheres_chunked`` — for larger scenes: the table in Morton
  order in chunks of 32 with one box each, visited front to back from the
  eye; a (th, tw) pixel tile scans a chunk only if one of its live rays
  enters the chunk's box nearer than its best hit.

A wrapper runs the plain version only when its tensors lie on the CPU; on a
CUDA tensor it launches the kernel or raises.  ``LAUNCHES`` counts kernel
launches, nothing else.

The plain versions keep the winning row's index through the scan and read
the row once afterwards; the closest hit is the same as with the JAX
package's select chain because ``t < best`` is strict.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from rt_torch.config import FLT_MAX
from rt_torch.core import rng
from rt_torch.core import vecmath as vm
from rt_torch.kernels import tracer_common as tc
from rt_torch.kernels.tris_kernel import (TraceFlags, _cam_array,
                                          _check_block, _check_tile, _fmax,
                                          _fmin, _morton_order, _require,
                                          eye_order, primary_rays)

SPH_COLS = 8      # centre(3), radius, albedo(3), material parameter
CHUNK = 32        # spheres per chunk
FLAT_MAX_SPHERES = 128   # the render dispatch goes chunked above this
MAX_STAGED_SPHERES = 1024   # rows the flat kernels stage in shared memory
PAD_RADIUS = -1e30       # a padding row: r*r = +inf, t = -inf, never a hit

_FLT_MAX = float(np.float32(FLT_MAX))

LAUNCHES = {"spheres": 0, "spheres_chunked": 0, "spheres_record": 0}


class PackedSpheres(NamedTuple):
    """Kernel operand tables of one SphereArray.  ``chunks`` is None for
    the flat scan; for the chunked scan ``tab`` is in Morton order, padded
    to a chunk multiple, and ``n`` counts the padded rows."""

    tab: torch.Tensor            # (N, 8) f32
    kinds: torch.Tensor          # (N,) i32
    n: int                       # rows the scan covers
    chunks: torch.Tensor | None  # (n_chunks, 6) f32: box min xyz, max xyz

    @property
    def n_chunks(self) -> int:
        return 0 if self.chunks is None else self.chunks.shape[0]


def pack_spheres_chunked(tab, kinds, n: int,
                         chunk: int = CHUNK) -> PackedSpheres:
    """Morton-sort the first ``n`` rows of the (N, 8) table by centre, pad
    to a chunk multiple with rows of radius ``PAD_RADIUS``, and build the
    per-chunk boxes (centre -+ radius over real rows; padding never widens
    a box)."""
    sph = tab[:n]
    kk = kinds[:n]
    order = _morton_order(sph[:, 0:3])
    sph = sph[order]
    kk = kk[order]

    n_pad = -(-n // chunk) * chunk
    if n_pad != n:
        pad = sph.new_zeros((n_pad - n, SPH_COLS))
        pad[:, 3] = PAD_RADIUS
        sph = torch.cat([sph, pad])
        kk = torch.cat([kk, kk.new_zeros(n_pad - n)])

    ctr = sph[:, 0:3]
    rad = sph[:, 3:4]
    real = (torch.arange(n_pad, device=tab.device) < n)[:, None]
    big = torch.full_like(ctr, 3.0e38)
    bmin = torch.where(real, ctr - rad, big).reshape(-1, chunk, 3).amin(dim=1)
    bmax = torch.where(real, ctr + rad, -big).reshape(-1, chunk,
                                                      3).amax(dim=1)
    return PackedSpheres(sph.contiguous(), kk.contiguous(), n_pad,
                         torch.cat([bmin, bmax], dim=1).contiguous())


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _scan_rows(tab, lo: int, hi: int, o, d, two_a, four_a, bt, bidx,
               gate=None):
    """Closest-hit scan of table rows lo..hi-1 in ascending order with
    strict ``0 < t < best``, on lanes where ``gate`` holds (all if None).
    Returns the updated (best t, winning row index)."""
    for si in range(lo, hi):
        cx, cy, cz, r = tab[si, 0], tab[si, 1], tab[si, 2], tab[si, 3]
        oc = (o[0] - cx, o[1] - cy, o[2] - cz)
        b = 2.0 * vm.dot3(oc, d)
        cc = vm.dot3(oc, oc) - r * r
        disc = b * b - four_a * cc
        # maximum(disc, 0) that keeps a NaN, as a select
        sq = vm.sqrt(torch.where(disc < 0.0, torch.zeros_like(disc), disc))
        t = (-b - sq) / two_a
        t = torch.where(disc < 0.0, torch.full_like(t, -1.0), t)
        better = (t > 0.0) & (t < bt)
        if gate is not None:
            better = better & gate
        bt = torch.where(better, t, bt)
        bidx = torch.where(better, si, bidx)
    return bt, bidx


def _resolve_and_scatter(tab, kinds, carry, bt, bidx, flags: TraceFlags):
    """Hit record from the winning row, scatter, masked carry update."""
    state, o, d, atten, active = carry
    hit = (active > 0) & (bt != _FLT_MAX)
    won = bidx >= 0
    row = tab[torch.clamp(bidx, min=0)]                  # (..., 8)
    zero = torch.zeros_like(bt)
    pick = lambda c, miss: torch.where(won, row[..., c], miss)
    bc = (pick(0, zero), pick(1, zero), pick(2, zero))
    br = pick(3, zero + 1.0)
    bal = (pick(4, zero), pick(5, zero), pick(6, zero))
    bpar = pick(7, zero)
    bkind = torch.where(won, kinds[torch.clamp(bidx, min=0)], 0)

    point = vm.add3(o, vm.scale3(d, bt))
    normal = ((point[0] - bc[0]) / br, (point[1] - bc[1]) / br,
              (point[2] - bc[2]) / br)
    front_face = vm.dot3(d, normal) < 0.0
    normal = vm.where3(front_face, normal, vm.neg3(normal))
    ns, nd = tc.scatter(state, d, point, normal, front_face, bal, bpar,
                        bkind, normalize_reflect_in=flags.normalize_reflect_in,
                        has_metal=flags.has_metal,
                        has_dielectric=flags.has_dielectric)
    state = torch.where(hit, ns, state)
    o = vm.where3(hit, point, o)
    d = vm.where3(hit, nd, d)
    # (atten * albedo) * 0.7, in that order
    atten = vm.where3(hit, vm.scale3(vm.mul3(atten, bal), 0.7), atten)
    return state, o, d, atten, hit.to(torch.int32)


def _hoisted(d):
    """a, 2a, 4a of the ray quadratic: d is fixed within a bounce and the
    multiples are exact exponent shifts."""
    a = vm.dot3(d, d)
    return 2.0 * a, 4.0 * a


def sphere_bounce(tab, kinds, carry, flags: TraceFlags, *, n_spheres: int,
                  scan_counts=None, track_idx: bool = False):
    """One bounce: flat closest-hit scan over rows 0..n_spheres-1, scatter.

    carry: (state int64, o3, d3, atten3, active int32), same-shaped tensors.
    Returns the new carry; with ``track_idx`` also the winning row (int32,
    -1 on a miss or a dead ray).  scan_counts: optional list; gets [(live
    ray, sphere) pairs, 0 box tests, hits resolved and scattered] appended
    — a dead ray's scan is discarded.
    """
    state, o, d, atten, active = carry
    two_a, four_a = _hoisted(d)
    bt = torch.zeros_like(o[0]) + _FLT_MAX
    bidx = torch.full_like(active, -1, dtype=torch.int64)
    bt, bidx = _scan_rows(tab, 0, n_spheres, o, d, two_a, four_a, bt, bidx)
    out = _resolve_and_scatter(tab, kinds, carry, bt, bidx, flags)
    if scan_counts is not None:
        scan_counts.append([int((active > 0).sum()) * n_spheres, 0,
                            int(out[4].sum())])
    if track_idx:
        won = torch.where(out[4] > 0, bidx, torch.full_like(bidx, -1))
        return out + (won.to(torch.int32),)
    return out


def sphere_bounce_chunked(packed: PackedSpheres, order, carry,
                          flags: TraceFlags, *, chunk: int = CHUNK,
                          scan_counts=None):
    """One bounce over all tiles: front-to-back chunk-culled closest-hit
    scan, scatter.  Same hit and scatter as ``sphere_bounce``.

    order: (n_chunks,) chunk visit order, shared by all tiles.
    carry: as in ``sphere_bounce``, each tensor (n_tiles, T).
    scan_counts: optional list; gets [(live ray, sphere) pairs scanned,
    (ray, box) tests] appended: every live ray of a tile scans each chunk
    that is live for the tile, and every ray of a tile with a live ray
    tests every box.
    """
    tab, chunks = packed.tab, packed.chunks
    state, o, d, atten, active = carry
    alive = active > 0
    two_a, four_a = _hoisted(d)
    inv_d = (1.0 / d[0], 1.0 / d[1], 1.0 / d[2])
    bt = torch.zeros_like(o[0]) + _FLT_MAX
    bidx = torch.full_like(active, -1, dtype=torch.int64)
    alive_per_tile = alive.sum(dim=1)
    scans = 0

    for ci in order.tolist():
        box = chunks[ci]
        t0x = (box[0] - o[0]) * inv_d[0]
        t1x = (box[3] - o[0]) * inv_d[0]
        t0y = (box[1] - o[1]) * inv_d[1]
        t1y = (box[4] - o[1]) * inv_d[1]
        t0z = (box[2] - o[2]) * inv_d[2]
        t1z = (box[5] - o[2]) * inv_d[2]
        tmin = _fmax(_fmax(_fmin(t0x, t1x), _fmin(t0y, t1y)),
                     _fmin(t0z, t1z))
        tmax = _fmin(_fmin(_fmax(t0x, t1x), _fmax(t0y, t1y)),
                     _fmax(t0z, t1z))
        live = alive & (tmin <= tmax) & (tmax >= 0.0) & (tmin < bt)
        tile_live = live.any(dim=1, keepdim=True)           # (n_tiles, 1)
        if not bool(tile_live.any()):
            continue
        if scan_counts is not None:
            scans += int((alive_per_tile * tile_live[:, 0]).sum())
        # every lane of a live tile scans the chunk's rows, also a lane
        # whose own box test failed
        lo = ci * chunk
        bt, bidx = _scan_rows(tab, lo, lo + chunk, o, d, two_a, four_a, bt,
                              bidx, gate=tile_live)

    if scan_counts is not None:
        boxes = int((alive_per_tile > 0).sum()) * alive.shape[1]
        scan_counts.append([scans * chunk, boxes * packed.n_chunks])
    return _resolve_and_scatter(tab, packed.kinds, carry, bt, bidx, flags)


def _primary_rays(cam_row, time: int, dev, **geometry):
    """(state, o3, d3, primary dy) of one frame as (Hp, Wp) planes."""
    times = torch.tensor([int(time) & rng.MASK], dtype=torch.int64,
                         device=dev)
    state, o, d = primary_rays(cam_row, times, 0, **geometry)
    return (state[0], tuple(c[0] for c in o), tuple(c[0] for c in d),
            d[1][0])


def render_color_spheres_plain(tab, kinds, cam_row, time: int, *,
                               n_spheres: int, height: int, width: int,
                               height_pad: int, width_pad: int, bounces: int,
                               normalize_defocus_dir: bool, flags: TraceFlags,
                               sky_from_final_dir: bool = False, spp: int = 1,
                               scan_counts=None):
    """Plain version of ``render_color_spheres`` (same arguments without the
    launch geometry, same result)."""
    state, o, d0, pdy = _primary_rays(
        cam_row, time, tab.device, height=height, width=width,
        height_pad=height_pad, width_pad=width_pad,
        normalize_defocus_dir=normalize_defocus_dir)
    col = tc.sample_loop(
        lambda c: sphere_bounce(tab, kinds, c, flags, n_spheres=n_spheres,
                                scan_counts=scan_counts),
        state, o, d0, pdy, bounces=bounces, spp=spp,
        sky_from_final_dir=sky_from_final_dir)
    return torch.stack(col)


def render_color_spheres_record_plain(tab, kinds, cam_row, time: int, *,
                                      n_spheres: int, height: int,
                                      width: int, height_pad: int,
                                      width_pad: int, bounces: int,
                                      normalize_defocus_dir: bool,
                                      flags: TraceFlags,
                                      sky_from_final_dir: bool = False,
                                      scan_counts=None):
    """Plain version of ``render_color_spheres_record``."""
    state, o, d0, pdy = _primary_rays(
        cam_row, time, tab.device, height=height, width=width,
        height_pad=height_pad, width_pad=width_pad,
        normalize_defocus_dir=normalize_defocus_dir)
    planes = []

    def bounce(carry):
        *carry, won = sphere_bounce(tab, kinds, carry, flags,
                                    n_spheres=n_spheres,
                                    scan_counts=scan_counts, track_idx=True)
        planes.append(won)
        return tuple(carry)

    col = tc.sample_loop(bounce, state, o, d0, pdy, bounces=bounces, spp=1,
                         sky_from_final_dir=sky_from_final_dir)
    return torch.stack(col), tc.index_planes(planes, bounces, state)


def render_color_spheres_chunked_plain(packed: PackedSpheres, cam_row,
                                       time: int, *, height: int, width: int,
                                       height_pad: int, width_pad: int,
                                       bounces: int,
                                       normalize_defocus_dir: bool,
                                       flags: TraceFlags, th: int, tw: int,
                                       sky_from_final_dir: bool = False,
                                       spp: int = 1, scan_counts=None):
    """Plain version of ``render_color_spheres_chunked``."""
    _check_tile(th, tw, height_pad, width_pad)
    dev = packed.tab.device
    nh, nw = height_pad // th, width_pad // tw

    def tiled(x):       # (Hp, Wp) -> (n_tiles, th*tw)
        return (x.reshape(nh, th, nw, tw).permute(0, 2, 1, 3)
                .reshape(nh * nw, th * tw))

    def untiled(x):
        return (x.reshape(nh, nw, th, tw).permute(0, 2, 1, 3)
                .reshape(height_pad, width_pad))

    state, o, d0, pdy = _primary_rays(
        cam_row, time, dev, height=height, width=width,
        height_pad=height_pad, width_pad=width_pad,
        normalize_defocus_dir=normalize_defocus_dir)
    order = eye_chunk_order(packed, cam_row)
    col = tc.sample_loop(
        lambda c: sphere_bounce_chunked(packed, order, c, flags,
                                        scan_counts=scan_counts),
        tiled(state), tuple(tiled(c) for c in o),
        tuple(tiled(c) for c in d0), tiled(pdy), bounces=bounces, spp=spp,
        sky_from_final_dir=sky_from_final_dir)
    return torch.stack([untiled(c) for c in col])


def eye_chunk_order(packed: PackedSpheres, cam_row) -> torch.Tensor:
    """Front-to-back chunk visit order from the camera eye, (n_chunks,)
    int32.  Order never changes the closest hit, only how early far chunks
    are rejected."""
    centroid = (packed.chunks[:, 0:3] + packed.chunks[:, 3:6]) * 0.5
    return eye_order(centroid, cam_row)


# ---------------------------------------------------------------------------
# wrappers: kernel on a CUDA tensor, plain version on a CPU tensor
# ---------------------------------------------------------------------------

def _launch_flat(name: str, max_rows: int, tab, kinds, cam_row, time: int,
                 *, n_spheres: int, height: int, width: int, height_pad: int,
                 width_pad: int, bounces: int, normalize_defocus_dir: bool,
                 flags: TraceFlags, th: int, tw: int,
                 sky_from_final_dir: bool, spp: int):
    """One launch of the flat kernel; ``name`` says which: ``"spheres"``
    returns the color, ``"spheres_record"`` (color, index planes)."""
    from rt_torch.kernels import _build

    _check_tile(th, tw, height_pad, width_pad)
    _check_block(th, tw)
    if not 0 < n_spheres <= min(max_rows, tab.shape[0]):
        raise ValueError(f"n_spheres={n_spheres}: the {name} kernel scans 1 "
                         f"to {max_rows} rows of a {tab.shape[0]}-row table")
    _require(tab, "tab", torch.float32, (tab.shape[0], SPH_COLS))
    _require(kinds, "kinds", torch.int32, (tab.shape[0],))
    cam = _cam_array(cam_row)
    out = torch.empty((3, height_pad, width_pad), dtype=torch.float32,
                      device=tab.device)
    idx = None
    if name == "spheres_record":
        idx = torch.empty((bounces, height_pad, width_pad),
                          dtype=torch.int32, device=tab.device)
    lib = _build.load()
    code = lib.rt_spheres(
        tab.data_ptr(), kinds.data_ptr(), cam.ctypes.data,
        int(time) & rng.MASK, out.data_ptr(),
        None if idx is None else idx.data_ptr(), n_spheres, height, width,
        height_pad, width_pad, th, tw, bounces, spp,
        int(normalize_defocus_dir), int(flags.normalize_reflect_in),
        int(flags.has_metal), int(flags.has_dielectric),
        int(sky_from_final_dir),
        torch.cuda.current_stream(tab.device).cuda_stream)
    _build.check(lib, code, name)
    LAUNCHES[name] += 1
    return out if idx is None else (out, idx)


def render_color_spheres(tab, kinds, cam_row, time: int, *, flags: TraceFlags,
                         th: int, tw: int, sky_from_final_dir: bool = False,
                         spp: int = 1, **kw):
    """Planar (3, Hp, Wp) color of one frame: flat scan over the first
    ``n_spheres`` rows of ``tab`` (at most ``FLAT_MAX_SPHERES``).

    tab: (N, 8) f32.  kinds: (N,) int32.  cam_row: (1, 20) f32 on the host.
    time: the u32 time uniform.  kw: n_spheres; height, width: the real
    resolution (seed and uv math); height_pad, width_pad: the traced extent,
    a multiple of (th, tw), one CUDA block per tile; bounces;
    normalize_defocus_dir.  The result does not depend on the tile: no ray
    reads another's state.
    """
    if tab.device.type == "cpu":
        return render_color_spheres_plain(
            tab, kinds, cam_row, time, flags=flags,
            sky_from_final_dir=sky_from_final_dir, spp=spp, **kw)
    return _launch_flat("spheres", FLAT_MAX_SPHERES, tab, kinds, cam_row,
                        time, flags=flags, th=th, tw=tw,
                        sky_from_final_dir=sky_from_final_dir, spp=spp, **kw)


def render_color_spheres_record(tab, kinds, cam_row, time: int, *,
                                flags: TraceFlags, th: int, tw: int,
                                sky_from_final_dir: bool = False, **kw):
    """(color (3, Hp, Wp) f32, hit indices (bounces, Hp, Wp) int32): the
    frame of ``render_color_spheres`` at one sample per pixel, and per
    bounce the table row each pixel's ray hit, -1 on a miss and from then
    on — what the path-replay gradients consume.  The flat scan whatever
    the sphere count, up to ``MAX_STAGED_SPHERES`` rows on the card.
    kw: as for ``render_color_spheres``.
    """
    if tab.device.type == "cpu":
        return render_color_spheres_record_plain(
            tab, kinds, cam_row, time, flags=flags,
            sky_from_final_dir=sky_from_final_dir, **kw)
    return _launch_flat("spheres_record", MAX_STAGED_SPHERES, tab, kinds,
                        cam_row, time, flags=flags, th=th, tw=tw,
                        sky_from_final_dir=sky_from_final_dir, spp=1, **kw)


def render_color_spheres_chunked(packed: PackedSpheres, cam_row, time: int, *,
                                 height: int, width: int, height_pad: int,
                                 width_pad: int, bounces: int,
                                 normalize_defocus_dir: bool,
                                 flags: TraceFlags, th: int, tw: int,
                                 sky_from_final_dir: bool = False,
                                 spp: int = 1):
    """Planar (3, Hp, Wp) color of one frame: chunk-culled scan for scenes
    past ``FLAT_MAX_SPHERES``.  packed: ``pack_spheres_chunked``'s tables.
    One CUDA block traces one (th, tw) tile, the unit of the chunk cull, so
    the image depends on the tile at box-surface roundings.
    """
    if packed.tab.device.type == "cpu":
        return render_color_spheres_chunked_plain(
            packed, cam_row, time, height=height, width=width,
            height_pad=height_pad, width_pad=width_pad, bounces=bounces,
            normalize_defocus_dir=normalize_defocus_dir, flags=flags, th=th,
            tw=tw, sky_from_final_dir=sky_from_final_dir, spp=spp)
    from rt_torch.kernels import _build

    _check_tile(th, tw, height_pad, width_pad)
    _check_block(th, tw)
    n_pad = packed.tab.shape[0]
    if packed.chunks is None or packed.n != n_pad or n_pad % CHUNK:
        raise ValueError("packed: need pack_spheres_chunked's tables")
    _require(packed.tab, "tab", torch.float32, (n_pad, SPH_COLS))
    _require(packed.kinds, "kinds", torch.int32, (n_pad,))
    _require(packed.chunks, "chunks", torch.float32, (n_pad // CHUNK, 6))
    if packed.tab.data_ptr() % 16:
        raise ValueError("tab: the kernel stages rows with 16-byte loads; "
                         "need a 16-byte aligned table")
    order = eye_chunk_order(packed, cam_row)
    cam = _cam_array(cam_row)
    dev = packed.tab.device
    out = torch.empty((3, height_pad, width_pad), dtype=torch.float32,
                      device=dev)
    lib = _build.load()
    code = lib.rt_spheres_chunked(
        packed.tab.data_ptr(), packed.kinds.data_ptr(),
        packed.chunks.data_ptr(), order.data_ptr(), cam.ctypes.data,
        int(time) & rng.MASK, out.data_ptr(), packed.n_chunks, CHUNK, height,
        width, height_pad, width_pad, th, tw, bounces, spp,
        int(normalize_defocus_dir), int(flags.normalize_reflect_in),
        int(flags.has_metal), int(flags.has_dielectric),
        int(sky_from_final_dir), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, code, "spheres_chunked")
    LAUNCHES["spheres_chunked"] += 1
    return out
