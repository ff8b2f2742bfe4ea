"""The triangle paths — counterpart of ``rt/kernels/tris_kernel.py``
(``_morton_order``, ``pack_tri_table``, ``_trace_bounce``, ``_ray_sort_key``,
the first/bounce/raygen wave kernels and ``render_color_tris_wave`` with the
``lean`` payload, ``chunk_oct`` and ``morton`` coherence keys and any number
of samples per pixel; the sorted-stream recorder
``render_color_tris_wave_record``; the monolithic ``render_color_tris`` and
its recording variant ``render_color_tris_record``).

Three kernels carry the wavefront path, each a hand-written CUDA kernel
(``csrc/tris_wave.cu``) with a plain PyTorch version beside it:

- ``wave_first`` — raygen fused with bounce 0 over (th, tw) pixel tiles
  (one sample per pixel);
- ``wave_bounce`` — ``n_bounces`` fused bounces over tiles of th*tw
  consecutive rays of the sorted stream, payload updated in place;
- ``wave_raygen`` — primary rays only (more than one sample per pixel:
  every sample's bounces then start from them, through ``wave_bounce``).

With ``track_idx`` the first two are the recorder's K10a and K10b
(``LAUNCHES["wave_record"]``, ``["wave_record_bounce"]``): the same bounce,
and per bounce the winning row of the triangle table (-1 on a miss).  The
recorder launches K10b on the tiles that hold the stream's live rays only
(``live_tiles``).

The wave kernels test a ray against the group boxes of ``GROUP``
consecutive table chunks (``group_boxes``) before the chunk boxes inside:
a chunk box lies within its group's, so the group test only skips chunk
tests that would have failed.

Two more trace a whole frame in one launch (``csrc/tris_mono.cu``), with the
same bounce (``trace_bounce`` here, ``csrc/tris_trace.cuh`` there):

- ``tris_mono`` — ``render_color_tris``: raygen, the sample loop, every
  bounce in the eye's chunk order, the sky;
- ``tris_record`` — ``render_color_tris_record``: the same at one sample
  per pixel, and per bounce the table row each ray hit (-1 on a miss), for
  the path-replay gradients (``rt_torch/grad``).

A wrapper runs the plain version only when its tensors lie on the CPU; on
a CUDA tensor it launches the kernel or raises.  ``LAUNCHES`` counts kernel
launches, nothing else.  While the program's spans are on
(``profiling.enable``), the render launches of ``wave_first`` and
``wave_bounce`` count their scan work into the program's counters
(``profiling.counters``: ``wave_rays``, ``wave_chunk_scans``,
``wave_box_tests``): the kernels through their counting instances, the
plain versions from ``trace_bounce``'s ``scan_counts``.

The plain versions are vectorised over all tiles at once — tensors are
(n_tiles, th*tw) — and loop over chunks in Python, and over a chunk's
triangles on the CPU (a card takes the 32 at once).  The tile-union chunk
skip is ``live.any(dim=1)``: a tile scans a chunk only if one of its live
rays enters the chunk's box nearer than its best hit.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from rt_torch.config import EPSILON_TRIS, FLT_MAX
from rt_torch.core import rng
from rt_torch.core import vecmath as vm
from rt_torch.kernels import tracer_common as tc
from rt_torch.utils.profiling import count, device_counts, enabled, span

CHUNK = 32        # triangles per chunk
GROUP = 32        # chunks per group box (csrc/tris_trace.cuh GROUP)
MAX_GROUPS = 64   # group boxes a ray tests (csrc/tris_trace.cuh MAX_GROUPS)
# tables of fewer groups get none: a ray enters nearly every one of 2 or 3
# groups over a mesh, and their test cost Suzanne's (2 groups) K2 and K3
# 2-5 % on an H100 (PERF.md)
MIN_GROUPS = 4
TRI_COLS = 13     # a(3), e1 = b-a (3), e2 = c-a (3), normal(3), mat_id as f32
DEAD_KEY = 2**31 - 1   # sort key of a dead ray: after every live key
KEY_BITS = 8           # origin bits per axis of the morton key
# origin code and direction octant must fit below DEAD_KEY together
assert 3 * KEY_BITS + 3 <= 31

# scalars as the exact f32 values the kernels use
_EPS = float(np.float32(EPSILON_TRIS))
_FLT_MAX = float(np.float32(FLT_MAX))

# the recorder's two (K10a, K10b) count apart from the render ones
LAUNCHES = {"wave_first": 0, "wave_bounce": 0, "wave_raygen": 0,
            "tris_mono": 0, "tris_record": 0, "wave_record": 0,
            "wave_record_bounce": 0}


class PackedScene(NamedTuple):
    """Kernel operand tables of one TriangleScene (see ``pack_tri_table``)."""

    tab: torch.Tensor       # (m_pad, 13) f32, Morton-clustered order
    mats: torch.Tensor      # (K, 5) f32: albedo rgb, param, kind
    chunks: torch.Tensor    # (n_chunks, 6) f32: box min xyz, max xyz
    centroid: torch.Tensor  # (n_chunks, 3) f32 box centres
    order: torch.Tensor     # (m,) int64: scene triangle id of each table row
    # (n_groups, 6) f32 boxes of GROUP consecutive chunks (``group_boxes``);
    # None for a table of fewer than MIN_GROUPS groups
    groups: torch.Tensor | None = None

    @property
    def n_chunks(self) -> int:
        return self.chunks.shape[0]


class TraceFlags(NamedTuple):
    """Scene/config facts the bounce specialises on."""

    normalize_reflect_in: bool
    has_metal: bool
    has_dielectric: bool


def _spread10(v):
    """Spread the low 10 bits of ``v`` out to every 3rd bit."""
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def _morton_order(centroids: torch.Tensor) -> torch.Tensor:
    """Spatial sort by 30-bit Morton code.  The sort is stable, so equal
    codes keep the BVH build's order."""
    c = centroids.to(torch.float32)
    lo = c.amin(dim=0)
    span = torch.clamp(c.amax(dim=0) - lo, min=1e-12)
    q = torch.clamp((c - lo) / span * 1023.0, 0, 1023).to(torch.int64)
    code = ((_spread10(q[:, 0]) << 2) | (_spread10(q[:, 1]) << 1)
            | _spread10(q[:, 2]))
    return torch.argsort(code, stable=True)


def _median(x: torch.Tensor) -> torch.Tensor:
    """Median as the mean of the two middle values (``torch.median`` takes
    the lower one); NaN if any element is."""
    v, _ = torch.sort(x)
    mid = (x.shape[0] - 1) / 2
    med = (v[math.floor(mid)] + v[math.ceil(mid)]) * 0.5
    return torch.where(torch.isnan(v[-1]), v[-1], med)


def pack_tri_table(scene, chunk: int = CHUNK,
                   split_big: bool = False) -> PackedScene:
    """Build the kernels' tables: triangles in Morton-clustered order with
    precomputed edges and the material id in column 12, zero-padded to a
    chunk multiple (padding rows are degenerate: det == 0 rejects them);
    the material table; per-chunk vertex AABBs.

    split_big: move oversized triangles (area > 16x the median: a scene's
    enclosure, a floor) behind all others, into trailing chunks of their
    own, so they stop inflating the Morton clusters' boxes.  A reordering
    only: the closest hit does not depend on the order up to exact-t ties.
    """
    m = scene.m
    # a tensor divisor: CUDA division by a Python scalar is a multiply by
    # its reciprocal, and the clustering should not depend on the device
    three = torch.tensor(3.0, dtype=torch.float32, device=scene.a.device)
    order = _morton_order((scene.a + scene.b + scene.c) / three)
    if split_big:
        e1 = scene.b - scene.a
        e2 = scene.c - scene.a
        cr = vm.cross3((e1[:, 0], e1[:, 1], e1[:, 2]),
                       (e2[:, 0], e2[:, 1], e2[:, 2]))
        area2 = cr[0] * cr[0] + cr[1] * cr[1] + cr[2] * cr[2]
        big = area2 > 256.0 * _median(area2)    # (16x median edge scale)^2
        keyed = torch.argsort(big[order].to(torch.int32), stable=True)
        order = order[keyed]
    a = scene.a[order].to(torch.float32)
    b = scene.b[order].to(torch.float32)
    c = scene.c[order].to(torch.float32)
    mid = torch.clamp(scene.mat_id, 0, scene.mat_albedo.shape[0] - 1)[order]
    tab = torch.cat([a, b - a, c - a, scene.normal[order].to(torch.float32),
                     mid.to(torch.float32)[:, None]], dim=1)
    mats = material_table(scene)

    m_pad = -(-m // chunk) * chunk
    verts_min = verts_max = torch.stack([a, b, c], dim=1)      # (m, 3, 3)
    if m_pad != m:
        tab = torch.cat([tab, tab.new_zeros((m_pad - m, TRI_COLS))])
        pad = tab.new_zeros((m_pad - m, 3, 3))
        verts_min = torch.cat([verts_min, pad + 3.0e38])
        verts_max = torch.cat([verts_max, pad - 3.0e38])
    vmin = verts_min.reshape(-1, chunk * 3, 3).amin(dim=1)
    vmax = verts_max.reshape(-1, chunk * 3, 3).amax(dim=1)
    chunks = torch.cat([vmin, vmax], dim=1)
    centroid = (chunks[:, 0:3] + chunks[:, 3:6]) * 0.5
    many = chunks.shape[0] > GROUP * (MIN_GROUPS - 1)
    groups = group_boxes(chunks) if many else None
    return PackedScene(tab.contiguous(), mats.contiguous(),
                       chunks.contiguous(), centroid, order, groups)


def material_table(scene) -> torch.Tensor:
    """(K, 5) f32 ``PackedScene.mats``: albedo rgb, param, kind.  The one
    part of the tables that a material fit changes."""
    return torch.cat([scene.mat_albedo.to(torch.float32),
                      scene.mat_param.to(torch.float32)[:, None],
                      scene.mat_kind.to(torch.float32)[:, None]],
                     dim=1).contiguous()


def group_boxes(chunks: torch.Tensor, group: int = GROUP) -> torch.Tensor:
    """(ceil(n_chunks / group), 6) f32: the exact min and max of the boxes
    of each run of ``group`` consecutive chunks (the last run may be
    shorter).  The table is Morton-clustered, so the runs are compact."""
    n = chunks.shape[0]
    pad = -n % group
    if pad:         # repeats of the last box change no min or max
        chunks = torch.cat([chunks, chunks[-1:].expand(pad, 6)])
    runs = chunks.reshape(-1, group, 6)
    return torch.cat([runs[:, :, 0:3].amin(dim=1),
                      runs[:, :, 3:6].amax(dim=1)], dim=1).contiguous()


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _fmin(a, b):
    """WGSL min: returns the non-NaN operand."""
    return torch.where(torch.isnan(a) | (b < a), b, a)


def _fmax(a, b):
    return torch.where(torch.isnan(a) | (b > a), b, a)


def _moller_trumbore(o, d, col):
    """(valid, t) of rays o, d against the triangles of columns ``col``
    (broadcast), every test but the strict t < best."""
    e1 = (col[3], col[4], col[5])
    e2 = (col[6], col[7], col[8])
    h = vm.cross3(d, e2)
    det = vm.dot3(e1, h)
    inv_det = 1.0 / det
    s = (o[0] - col[0], o[1] - col[1], o[2] - col[2])
    u = inv_det * vm.dot3(s, h)
    q = vm.cross3(s, e1)
    v = inv_det * vm.dot3(d, q)
    t = inv_det * vm.dot3(e2, q)
    valid = torch.abs(det) >= _EPS
    valid &= (u >= 0.0) & (u <= 1.0)
    valid &= (v >= 0.0) & (u + v <= 1.0)
    valid &= t >= _EPS
    return valid, t


def _whole_chunks(rays: torch.Tensor) -> bool:
    """Whether the plain scan takes a chunk's 32 triangles at once: on a
    card, where it is bound by its launches; not on the CPU, where torch's
    reductions over a small dimension cost more than the loop over them."""
    return rays.is_cuda


def trace_bounce(packed: PackedScene, order, carry, flags: TraceFlags, *,
                 chunk: int = CHUNK, scan_counts=None,
                 track_idx: bool = False):
    """One bounce over all tiles: front-to-back chunk-culled closest-hit
    scan, once-per-bounce material resolve, scatter.

    order: (n_tiles, n_chunks) int64 chunk visit order per tile.
    carry: (state int64, o3, d3, atten3, active int32), each (n_tiles, T).
    Returns (state, o3, d3, atten3, active, winning chunk id or -1).
    scan_counts: optional list; gets one [ray-chunk scans, box tests,
    tile-chunk visits, candidates, tile-chunk scans, the most chunks one
    tile scans, ray-chunk box tests] entry appended — the work this
    bounce's data asked for: every live ray of a tile scans each chunk
    that is live for the tile; the box tests are what the table's group
    boxes leave (``group_box_tests``), or without them every ray of a tile
    with a live ray against every chunk's box, which the last entry counts
    in either case.  The next three count per tile with a live ray: every
    chunk of its order (visits); the chunks whose box some live ray of the
    tile enters at t >= 0 whatever its best t (candidates: the bits of the
    kernel's batch mask, each of which the kernel stages and votes on); the
    chunks it scans.  The sixth is the heaviest tile's share of those,
    which a block runs alone once the others are done.
    """
    tab, mats, chunks = packed.tab, packed.mats, packed.chunks
    state, o, d, atten, active = carry
    alive = active > 0
    inv_d = (1.0 / d[0], 1.0 / d[1], 1.0 / d[2])
    zero = torch.zeros_like(o[0])
    bt = zero + _FLT_MAX
    bn = (zero, zero, zero)
    bmid = zero
    wch = torch.full_like(active, -1)
    btid = torch.full_like(active, -1) if track_idx else None
    alive_per_tile = alive.sum(dim=1)
    scans = candidates = 0
    tile_scans = torch.zeros_like(alive_per_tile)
    whole = _whole_chunks(o[0])
    ks = torch.arange(chunk, device=order.device)
    o3 = tuple(x[None] for x in o)
    d3 = tuple(x[None] for x in d)

    for oi in range(packed.n_chunks):
        ci = order[:, oi]                                   # (n_tiles,)
        box = chunks[ci]                                    # (n_tiles, 6)
        bx = [box[:, c:c + 1] for c in range(6)]
        t0x = (bx[0] - o[0]) * inv_d[0]
        t1x = (bx[3] - o[0]) * inv_d[0]
        t0y = (bx[1] - o[1]) * inv_d[1]
        t1y = (bx[4] - o[1]) * inv_d[1]
        t0z = (bx[2] - o[2]) * inv_d[2]
        t1z = (bx[5] - o[2]) * inv_d[2]
        tmin = _fmax(_fmax(_fmin(t0x, t1x), _fmin(t0y, t1y)),
                     _fmin(t0z, t1z))
        tmax = _fmin(_fmin(_fmax(t0x, t1x), _fmax(t0y, t1y)),
                     _fmax(t0z, t1z))
        live = alive & (tmin <= tmax) & (tmax >= 0.0) & (tmin < bt)
        tile_live = live.any(dim=1, keepdim=True)           # (n_tiles, 1)
        if scan_counts is not None:
            entered = alive & (tmin <= tmax) & (tmax >= 0.0)
            candidates += int(entered.any(dim=1).sum())
        if not bool(tile_live.any()):
            continue
        if scan_counts is not None:
            scans += int((alive_per_tile * tile_live[:, 0]).sum())
            tile_scans += tile_live[:, 0]

        prev = bt
        lo = ci * chunk
        if not whole:
            for k in range(chunk):
                tri = tab[lo + k]                           # (n_tiles, 13)
                col = [tri[:, c:c + 1] for c in range(TRI_COLS)]
                valid, t = _moller_trumbore(o, d, col)
                valid &= tile_live & (t < bt)
                bt = torch.where(valid, t, bt)
                bn = vm.where3(valid, (col[9], col[10], col[11]), bn)
                bmid = torch.where(valid, col[12], bmid)
                if track_idx:
                    btid = torch.where(valid, (lo + k)[:, None].to(
                        btid.dtype), btid)
        else:
            # the chunk's 32 triangles at once, (32, n_tiles, T): the scan
            # in index order with strict t < best ends at the least valid t
            # below the best t before the chunk, set by the first triangle
            # of that t
            rows = tab[lo[:, None] + ks]                    # (n_tiles, 32, 13)
            col = [c[:, :, None] for c in rows.permute(2, 1, 0)]
            valid, t = _moller_trumbore(o3, d3, col)
            valid &= tile_live[None]
            t = torch.where(valid, t, math.inf)
            tmin = t.amin(dim=0)
            k = torch.where(valid & (t == tmin), ks[:, None, None],
                            chunk).amin(dim=0)
            won = tmin < bt
            k = torch.clamp(k, max=chunk - 1)   # read only where it won
            bt = torch.where(won, tmin, bt)
            bn = vm.where3(won, tuple(torch.gather(rows[:, :, c], 1, k)
                                      for c in (9, 10, 11)), bn)
            bmid = torch.where(won, torch.gather(rows[:, :, 12], 1, k), bmid)
            if track_idx:
                btid = torch.where(won, (lo[:, None] + k).to(btid.dtype),
                                   btid)
        # the chunk whose scan last improved best-t owns the hit
        wch = torch.where(bt < prev, ci[:, None].to(wch.dtype), wch)

    if scan_counts is not None:
        tiles = int((alive_per_tile > 0).sum())
        every_box = tiles * alive.shape[1] * packed.n_chunks
        boxes = every_box if packed.groups is None else sum(
            group_box_tests(packed, o, d, alive)[::2])
        scan_counts.append([scans, boxes, tiles * packed.n_chunks,
                            candidates, int(tile_scans.sum()),
                            int(tile_scans.max()), every_box])

    hit = alive & (bt != _FLT_MAX)

    # material resolved once per bounce from the winning mat id; misses
    # resolve to nothing and their scatter output is discarded
    bal = (zero, zero, zero)
    bpar = zero
    bkind = zero
    for j in range(mats.shape[0]):
        match = bmid == float(j)
        bal = vm.where3(match, (mats[j, 0], mats[j, 1], mats[j, 2]), bal)
        bpar = torch.where(match, mats[j, 3], bpar)
        bkind = torch.where(match, mats[j, 4], bkind)

    # hit record: flat normal, NO flip, inverted front_face convention
    point = vm.add3(o, vm.scale3(d, bt))
    front_face = vm.dot3(bn, d) > 0.0
    ns, nd = tc.scatter(state, d, point, bn, front_face, bal, bpar,
                        bkind.to(torch.int32),
                        normalize_reflect_in=flags.normalize_reflect_in,
                        has_metal=flags.has_metal,
                        has_dielectric=flags.has_dielectric)

    state = torch.where(hit, ns, state)
    o = vm.where3(hit, point, o)
    d = vm.where3(hit, nd, d)
    atten = vm.where3(hit, vm.scale3(vm.mul3(atten, bal), 0.7), atten)
    wch = torch.where(hit, wch, torch.full_like(wch, -1))
    out = (state, o, d, atten, hit.to(torch.int32), wch)
    if track_idx:
        out += (torch.where(hit, btid, torch.full_like(btid, -1)),)
    return out


def _check_tile(th: int, tw: int, height_pad: int, width_pad: int):
    if height_pad % th or width_pad % tw:
        raise ValueError(f"padded size {width_pad}x{height_pad} is not a "
                         f"multiple of the tile {tw}x{th}")


def primary_rays(cam_row, times, row0: int, *, height: int, width: int,
                 height_pad: int, width_pad: int,
                 normalize_defocus_dir: bool):
    """Primary rays of F frames as (F, Hp, Wp) planes on the device of
    ``times`` ((F,) u32 time uniforms, as int32 bit patterns or int64):
    (RNG state int64, o3, d3); d3[1] is the primary dy.  Rows start at
    ``row0``; padding pixels are generated like any other."""
    dev = times.device
    shape = (times.shape[0], height_pad, width_pad)
    ys = torch.arange(height_pad, device=dev, dtype=torch.int64) + row0
    xs = torch.arange(width_pad, device=dev, dtype=torch.int64)
    t = (times.to(torch.int64) & rng.MASK)[:, None, None].expand(shape)
    cam = [float(v) for v in np.asarray(cam_row).reshape(-1).tolist()]
    state, o, d4 = tc.generate_rays(
        cam, xs[None, None, :].expand(shape), ys[None, :, None].expand(shape),
        height=height, width=width, time=t,
        normalize_defocus_dir=normalize_defocus_dir)
    return state, o, (d4[0], d4[1], d4[2])


def wave_first_plain(packed: PackedScene, order, cam_row, times, row0: int,
                     flags: TraceFlags, *, height: int, width: int,
                     height_pad: int, width_pad: int, th: int, tw: int,
                     normalize_defocus_dir: bool, track_idx: bool = False,
                     scan_counts=None):
    """Plain version of ``wave_first`` (same arguments, same results)."""
    _check_tile(th, tw, height_pad, width_pad)
    n_frames = times.shape[0]
    nh, nw = height_pad // th, width_pad // tw
    n_tiles = n_frames * nh * nw

    def tiled(x):       # (F, Hp, Wp) image order -> (n_tiles, th*tw)
        return (x.reshape(n_frames, nh, th, nw, tw).permute(0, 1, 3, 2, 4)
                .reshape(n_tiles, th * tw))

    def untiled(x):     # back to the flat (F*Hp*Wp,) image order
        return (x.reshape(n_frames, nh, nw, th, tw).permute(0, 1, 3, 2, 4)
                .reshape(-1))

    state, o, d = primary_rays(
        cam_row, times, row0, height=height, width=width,
        height_pad=height_pad, width_pad=width_pad,
        normalize_defocus_dir=normalize_defocus_dir)
    state, o, d = tiled(state), tuple(map(tiled, o)), tuple(map(tiled, d))
    primary_dy = d[1]
    one = torch.ones_like(o[0])
    carry = (state, o, d, (one, one, one),
             torch.ones_like(state, dtype=torch.int32))
    tile_order = order.to(torch.int64).reshape(1, -1).expand(n_tiles, -1)
    counting = _counting(track_idx)
    entries = [] if counting else scan_counts
    state, o, d, atten, active, wch, *idx = trace_bounce(
        packed, tile_order, carry, flags, scan_counts=entries,
        track_idx=track_idx)
    if counting:
        _count_scans(entries, n_tiles * th * tw, scan_counts)

    payf = torch.stack([untiled(p) for p in (*o, *d, *atten, primary_dy)])
    return (payf, rng.to_i32(untiled(state)), untiled(active), untiled(wch),
            *(untiled(x) for x in idx))


def wave_raygen_plain(cam_row, times, row0: int, *, height: int, width: int,
                      height_pad: int, width_pad: int,
                      normalize_defocus_dir: bool):
    """Plain version of ``wave_raygen`` (same arguments without the launch
    geometry, same results)."""
    state, o, d = primary_rays(
        cam_row, times, row0, height=height, width=width,
        height_pad=height_pad, width_pad=width_pad,
        normalize_defocus_dir=normalize_defocus_dir)
    od = torch.stack([p.reshape(-1) for p in (*o, *d)])
    return od, d[1].reshape(-1), rng.to_i32(state.reshape(-1))


def _counting(track_idx: bool) -> bool:
    """Whether a wave launch counts its scan work: a render launch (not
    the recorder's) while the program's spans are on."""
    return enabled() and not track_idx


def _count_scans(entries, rays: int, scan_counts=None) -> None:
    """A plain render launch's scan work into the program's counters:
    ``rays`` live rays traced, and the ray-chunk scans and box tests of its
    ``trace_bounce`` entries, which go on to the caller's ``scan_counts``
    too where it gave one."""
    count("wave_rays", rays)
    count("wave_chunk_scans", sum(e[0] for e in entries))
    count("wave_box_tests", sum(e[1] for e in entries))
    if scan_counts is not None:
        scan_counts.extend(entries)


def enters_groups(groups, o, inv_d):
    """The wave kernels' group test (``csrc/tris_trace.cuh``
    ``group_entered``) on rays (..., 3 planes) against every group box:
    (..., n_groups) bool, False only where the ray enters none of the
    group's chunk boxes.  An axis whose products hold a NaN is widened to
    everything.  Plain tensor code for counts and tests; the render and
    record results never depend on it."""
    lo, hi = groups[:, 0:3], groups[:, 3:6]
    tmin = tmax = None
    for c in range(3):
        oc, ic = o[c][..., None], inv_d[c][..., None]
        t0 = (lo[:, c] - oc) * ic
        t1 = (hi[:, c] - oc) * ic
        nan = torch.isnan(t0 + t1)
        a = torch.where(nan, -math.inf, torch.fmin(t0, t1))
        b = torch.where(nan, math.inf, torch.fmax(t0, t1))
        tmin = a if tmin is None else torch.fmax(tmin, a)
        tmax = b if tmax is None else torch.fmin(tmax, b)
    return (tmin <= tmax) & (tmax >= 0.0)


def group_box_tests(packed: PackedScene, o, d, alive):
    """The box tests of the live rays (``alive``; planes o, d of its shape)
    over a table with group boxes, as (group boxes tested, group boxes
    entered, chunk boxes tested) summed over the rays: each tests the first
    MAX_GROUPS group boxes (``enters_groups``), then the chunk boxes of the
    groups it enters and every chunk past those groups."""
    groups = packed.groups[:MAX_GROUPS]
    n_groups = groups.shape[0]
    o = tuple(c[alive] for c in o)
    inv_d = tuple(1.0 / c[alive] for c in d)
    entered = enters_groups(groups, o, inv_d)           # (live rays, groups)
    sizes = torch.full((n_groups,), GROUP, device=groups.device)
    sizes[-1] = min(GROUP, packed.n_chunks - GROUP * (n_groups - 1))
    past = packed.n_chunks - int(sizes.sum())
    rays = entered.shape[0]
    return (rays * n_groups, int(entered.sum()),
            int((entered * sizes).sum()) + rays * past)


def _launched_tiles(n: int, tile: int, live_tiles: int | None) -> int:
    """The tiles a bounce launch traces: all n / tile of the stream, or its
    first ``live_tiles``."""
    if n % tile:
        raise ValueError(f"stream of {n} rays is not a multiple of the "
                         f"{tile}-ray tile")
    if live_tiles is None:
        return n // tile
    if not 0 <= live_tiles <= n // tile:
        raise ValueError(f"live_tiles {live_tiles}: the stream has "
                         f"{n // tile} tiles")
    return live_tiles


def wave_bounce_plain(packed: PackedScene, tile_order, pay, state, active,
                      flags: TraceFlags, *, n_bounces: int, th: int, tw: int,
                      track_idx: bool = False, scan_counts=None,
                      live_tiles: int | None = None):
    """Plain version of ``wave_bounce``: updates pay/state/active in place
    and returns the last fused bounce's winning-chunk plane (and with
    ``track_idx`` the index planes).  live_tiles: as ``wave_bounce``; a
    live ray past those tiles raises."""
    n = state.shape[0]
    tile = th * tw
    n_tiles = _launched_tiles(n, tile, live_tiles)
    m = n_tiles * tile
    if bool((active[m:] > 0).any()):
        raise ValueError(f"a live ray lies past the first {n_tiles} tiles")
    wch_out = torch.full((n,), -1, dtype=torch.int32, device=state.device)
    idx_out = (torch.full((n_bounces, n), -1, dtype=torch.int32,
                          device=state.device) if track_idx else None)
    if n_tiles:
        order = tile_order.to(torch.int64).reshape(n_tiles, -1)
        p = pay[:, :m].reshape(9, n_tiles, tile)
        carry = (rng.from_i32(state[:m]).reshape(n_tiles, tile),
                 (p[0], p[1], p[2]), (p[3], p[4], p[5]), (p[6], p[7], p[8]),
                 active[:m].reshape(n_tiles, tile))
        wch = torch.full((n_tiles, tile), -1, dtype=torch.int32,
                         device=state.device)
        counting = _counting(track_idx)
        entries = [] if counting else scan_counts
        rays = 0
        for b in range(n_bounces):
            # a tile with no live ray is skipped by the kernel; here its
            # lanes pass through trace_bounce unchanged (no chunk is live
            # for it) except the chunk plane, which the skip leaves as it
            # was; its index plane is -1, as trace_bounce gives a dead ray
            tile_alive = (carry[4] > 0).any(dim=1, keepdim=True)
            if counting:
                rays += int((carry[4] > 0).sum())
            out = trace_bounce(packed, order, tuple(carry), flags,
                               scan_counts=entries, track_idx=track_idx)
            carry = out[:5]
            wch = torch.where(tile_alive, out[5], wch)
            if track_idx:
                idx_out[b, :m] = out[6].reshape(m)
        if counting:
            _count_scans(entries, rays, scan_counts)
        s, o, d, atten, act = carry
        pay[:, :m] = torch.stack([*o, *d, *atten]).reshape(9, m)
        state[:m] = rng.to_i32(s).reshape(m)
        active[:m] = act.reshape(m)
        wch_out[:m] = wch.reshape(m)
    return (wch_out, idx_out) if track_idx else wch_out


# ---------------------------------------------------------------------------
# wrappers: kernel on a CUDA tensor, plain version on a CPU tensor
# ---------------------------------------------------------------------------

def _require(t: torch.Tensor, name: str, dtype, shape=None):
    if t.dtype != dtype or not t.is_contiguous() or not t.is_cuda:
        raise ValueError(f"{name}: need a contiguous CUDA {dtype} tensor, "
                         f"got {t.dtype} on {t.device}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")


def _cam_array(cam_row) -> np.ndarray:
    """The camera row as the 20 contiguous host floats a launch reads."""
    cam = np.ascontiguousarray(cam_row, dtype=np.float32).reshape(-1)
    if cam.shape[0] != tc.CAM_WIDTH:
        raise ValueError(f"cam_row: need {tc.CAM_WIDTH} floats")
    return cam


def _check_block(th: int, tw: int):
    tile = th * tw
    if tile % 32 or not 32 <= tile <= 1024:
        raise ValueError(f"tile {tw}x{th} = {tile} rays: one CUDA block "
                         f"traces one tile, so it must be a multiple of 32 "
                         f"and at most 1024")


def _require_tables(packed: PackedScene, chunk: int):
    m_pad = packed.tab.shape[0]
    _require(packed.tab, "tab", torch.float32, (m_pad, TRI_COLS))
    if packed.tab.data_ptr() % 16:
        raise ValueError("tab: the kernels copy chunks with 16-byte loads; "
                         "need a 16-byte aligned table")
    _require(packed.mats, "mats", torch.float32, (packed.mats.shape[0], 5))
    _require(packed.chunks, "chunks", torch.float32, (m_pad // chunk, 6))
    if packed.groups is not None:
        _require(packed.groups, "groups", torch.float32,
                 (-(-packed.n_chunks // GROUP), 6))


def _groups(packed: PackedScene):
    """(pointer or None, count) of the tables' group boxes."""
    if packed.groups is None:
        return None, 0
    return packed.groups.data_ptr(), packed.groups.shape[0]


def wave_first(packed: PackedScene, order, cam_row, times, row0: int,
               flags: TraceFlags, *, height: int, width: int,
               height_pad: int, width_pad: int, th: int, tw: int,
               normalize_defocus_dir: bool, track_idx: bool = False):
    """Raygen fused with bounce 0 for F frames of (height_pad, width_pad)
    pixels (rows beyond ``height`` and columns beyond ``width`` are padding
    pixels, traced like any other).

    order: (n_chunks,) int32 global chunk visit order.
    cam_row: (1, 20) f32 on the host.  times: (F,) int32 u32 bit patterns.
    Returns (payf (10, n) f32: o, d, atten, primary_dy; state (n,) int32;
    active (n,) int32; winning chunk (n,) int32), n = F*Hp*Wp in image order.
    track_idx (the recorder, K10a): one more (n,) int32 plane, the winning
    row of the triangle table, -1 on a miss.
    """
    if packed.tab.device.type == "cpu":
        return wave_first_plain(
            packed, order, cam_row, times, row0, flags, height=height,
            width=width, height_pad=height_pad, width_pad=width_pad, th=th,
            tw=tw, normalize_defocus_dir=normalize_defocus_dir,
            track_idx=track_idx)
    from rt_torch.kernels import _build

    _check_tile(th, tw, height_pad, width_pad)
    _check_block(th, tw)
    _require_tables(packed, CHUNK)
    _require(order, "order", torch.int32, (packed.n_chunks,))
    _require(times, "times", torch.int32)
    n_frames = times.shape[0]
    n = n_frames * height_pad * width_pad
    dev = packed.tab.device
    payf = torch.empty((10, n), dtype=torch.float32, device=dev)
    state = torch.empty((n,), dtype=torch.int32, device=dev)
    active = torch.empty((n,), dtype=torch.int32, device=dev)
    wch = torch.empty((n,), dtype=torch.int32, device=dev)
    idx = (torch.empty((n,), dtype=torch.int32, device=dev) if track_idx
           else None)
    cam = _cam_array(cam_row)

    groups, n_groups = _groups(packed)
    counts = device_counts(dev).data_ptr() if _counting(track_idx) else None
    lib = _build.load()
    code = lib.rt_wave_first(
        packed.tab.data_ptr(), packed.mats.data_ptr(),
        packed.chunks.data_ptr(), groups, order.data_ptr(), cam.ctypes.data,
        times.data_ptr(), row0, payf.data_ptr(), state.data_ptr(),
        active.data_ptr(), wch.data_ptr(),
        None if idx is None else idx.data_ptr(), packed.n_chunks, n_groups,
        CHUNK, packed.mats.shape[0], height, width, height_pad, width_pad,
        n_frames, th, tw, int(normalize_defocus_dir),
        int(flags.normalize_reflect_in), int(flags.has_metal),
        int(flags.has_dielectric), counts,
        torch.cuda.current_stream(dev).cuda_stream)
    name = "wave_record" if track_idx else "wave_first"
    _build.check(lib, code, name)
    LAUNCHES[name] += 1
    return (payf, state, active, wch) + ((idx,) if track_idx else ())


def wave_raygen(cam_row, times, row0: int, *, height: int, width: int,
                height_pad: int, width_pad: int, th: int, tw: int,
                normalize_defocus_dir: bool):
    """Primary rays of F frames of (height_pad, width_pad) pixels, padding
    pixels included, on the device ``times`` lies on.

    cam_row: (1, 20) f32 on the host.  times: (F,) int32 u32 bit patterns.
    Returns (od (6, n) f32: o, d; primary dy (n,) f32; post-raygen RNG
    state (n,) int32), n = F*Hp*Wp in image order.  (th, tw) must tile the
    padded frame, as for the other wave kernels, but the kernel ignores it:
    no ray reads another's, and it launches on its own grid of row strips
    (``raygen_grid``).
    """
    if times.device.type == "cpu":
        return wave_raygen_plain(
            cam_row, times, row0, height=height, width=width,
            height_pad=height_pad, width_pad=width_pad,
            normalize_defocus_dir=normalize_defocus_dir)
    from rt_torch.kernels import _build

    _check_tile(th, tw, height_pad, width_pad)
    _check_block(th, tw)
    _require(times, "times", torch.int32)
    n_frames = times.shape[0]
    n = n_frames * height_pad * width_pad
    dev = times.device
    od = torch.empty((6, n), dtype=torch.float32, device=dev)
    pdy = torch.empty((n,), dtype=torch.float32, device=dev)
    state = torch.empty((n,), dtype=torch.int32, device=dev)
    cam = _cam_array(cam_row)

    lib = _build.load()
    code = lib.rt_wave_raygen(
        cam.ctypes.data, times.data_ptr(), row0, od.data_ptr(),
        pdy.data_ptr(), state.data_ptr(), height, width, height_pad,
        width_pad, n_frames, int(normalize_defocus_dir),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, code, "wave_raygen")
    LAUNCHES["wave_raygen"] += 1
    return od, pdy, state


# K4's launch (csrc/tris_wave.cu): a block is RAYGEN_THREADS consecutive
# columns of one row of one frame
RAYGEN_THREADS = 128


def raygen_grid(n_frames: int, height_pad: int, width_pad: int) -> tuple:
    """K4's grid for F frames of Hp x Wp pixels: (x, y, z) blocks."""
    return -(-width_pad // RAYGEN_THREADS), height_pad, n_frames


def raygen_pixels(n_frames: int, height_pad: int,
                  width_pad: int) -> torch.Tensor:
    """K4's map from threads to pixels, as its index arithmetic runs: for
    each thread of the grid (``raygen_grid``, block by block) that takes a
    pixel, the flat index it stores to and the (frame, row, column) it
    generates the ray of: block (x, y, z), thread t takes column
    x * RAYGEN_THREADS + t (none past Wp) of row y of frame z.  (pixels, 4)
    int64."""
    gx, gy, gz = raygen_grid(n_frames, height_pad, width_pad)
    z, y, x, t = torch.meshgrid(
        torch.arange(gz), torch.arange(gy), torch.arange(gx),
        torch.arange(RAYGEN_THREADS), indexing="ij")
    col = (x * RAYGEN_THREADS + t).reshape(-1)
    row, f = y.reshape(-1), z.reshape(-1)
    keep = col < width_pad
    col, row, f = col[keep], row[keep], f[keep]
    return torch.stack([(f * height_pad + row) * width_pad + col, f, row,
                        col], dim=1)


def wave_bounce(packed: PackedScene, tile_order, pay, state, active,
                flags: TraceFlags, *, n_bounces: int, th: int, tw: int,
                track_idx: bool = False, live_tiles: int | None = None):
    """``n_bounces`` fused bounces over the ray stream, one tile of th*tw
    consecutive rays per block.  pay (9, n) f32, state (n,) int32 and active
    (n,) int32 are UPDATED IN PLACE.

    tile_order: (tiles traced * n_chunks,) int32, each tile's chunk visit
    order.  Returns the winning-chunk plane (n,) int32 of the last bounce a
    tile ran (-1 on a miss or a dead ray).  track_idx (the recorder, K10b):
    returns (that plane, index planes (n_bounces, n) int32: per bounce the
    winning row of the triangle table, -1 on a miss, a dead ray or a
    skipped tile).
    live_tiles: trace only the stream's first ``live_tiles`` tiles, which
    must hold all its live rays (a sorted stream: ``DEAD_KEY`` sorts last);
    the others keep their payload, state and active flags and get -1 in the
    returned planes, what the kernel gives an all-dead tile.  No launch at
    0.  The recorder's kernel takes 2, 4 or 8 threads a ray: the most at
    which all the tiles launched are resident on the card at once.
    """
    if packed.tab.device.type == "cpu":
        return wave_bounce_plain(packed, tile_order, pay, state, active,
                                 flags, n_bounces=n_bounces, th=th, tw=tw,
                                 track_idx=track_idx, live_tiles=live_tiles)
    from rt_torch.kernels import _build

    _check_block(th, tw)
    _require_tables(packed, CHUNK)
    n = state.shape[0]
    tile = th * tw
    n_tiles = _launched_tiles(n, tile, live_tiles)
    _require(tile_order, "tile_order", torch.int32,
             (n_tiles * packed.n_chunks,))
    _require(pay, "pay", torch.float32, (9, n))
    _require(state, "state", torch.int32, (n,))
    _require(active, "active", torch.int32, (n,))
    # the planes of tiles not launched are -1
    new = torch.empty if n_tiles * tile == n else functools.partial(
        torch.full, fill_value=-1)
    wch = new((n,), dtype=torch.int32, device=state.device)
    idx = (new((n_bounces, n), dtype=torch.int32, device=state.device)
           if track_idx else None)
    name = "wave_record_bounce" if track_idx else "wave_bounce"
    if n_tiles:
        groups, n_groups = _groups(packed)
        counts = (device_counts(state.device).data_ptr()
                  if _counting(track_idx) else None)
        lib = _build.load()
        code = lib.rt_wave_bounce(
            packed.tab.data_ptr(), packed.mats.data_ptr(),
            packed.chunks.data_ptr(), groups, tile_order.data_ptr(),
            pay.data_ptr(), state.data_ptr(), active.data_ptr(),
            wch.data_ptr(), None if idx is None else idx.data_ptr(), n,
            n_tiles, tile, n_bounces, packed.n_chunks, n_groups, CHUNK,
            packed.mats.shape[0], int(flags.normalize_reflect_in),
            int(flags.has_metal), int(flags.has_dielectric), counts,
            torch.cuda.current_stream(state.device).cuda_stream)
        _build.check(lib, code, name)
        LAUNCHES[name] += 1
    return (wch, idx) if track_idx else wch


# ---------------------------------------------------------------------------
# the whole-frame path: one launch traces a frame (K7) or records it (K9)
# ---------------------------------------------------------------------------

def eye_order(centroid, cam_row) -> torch.Tensor:
    """``chunk_order(centroid, eye)`` for the camera row's eye, with the eye
    as three f32 scalars: the same distances and order, and no copy to the
    card, which would wait for the stream (a wrapper that calls this stays
    asynchronous)."""
    eye = np.asarray(cam_row, np.float32)[0, 0:3]
    diff = [centroid[:, c] - float(eye[c]) for c in range(3)]
    dist = diff[0] * diff[0] + diff[1] * diff[1] + diff[2] * diff[2]
    return torch.argsort(dist, stable=True).to(torch.int32)


def eye_chunk_order(packed: PackedScene, cam_row) -> torch.Tensor:
    """Front-to-back chunk visit order from the camera eye, (n_chunks,)
    int32 on the tables' device: the order of bounce 0 in the wave paths
    and of every bounce in the whole-frame kernels."""
    return eye_order(packed.centroid, cam_row)


def _mono_plain(packed: PackedScene, cam_row, time: int, row0: int,
                flags: TraceFlags, *, record: bool, height: int, width: int,
                height_pad: int, width_pad: int, bounces: int,
                normalize_defocus_dir: bool, th: int, tw: int,
                sky_from_final_dir: bool = False, spp: int = 1,
                scan_counts=None):
    """Plain version of both whole-frame kernels: (color (3, Hp, Wp), index
    planes (bounces, Hp, Wp) int32 or None)."""
    _check_tile(th, tw, height_pad, width_pad)
    dev = packed.tab.device
    nh, nw = height_pad // th, width_pad // tw

    def tiled(x):       # (Hp, Wp) -> (n_tiles, th*tw)
        return (x.reshape(nh, th, nw, tw).permute(0, 2, 1, 3)
                .reshape(nh * nw, th * tw))

    def untiled(x):
        return (x.reshape(nh, nw, th, tw).permute(0, 2, 1, 3)
                .reshape(height_pad, width_pad))

    times = torch.tensor([int(time) & rng.MASK], dtype=torch.int64,
                         device=dev)
    state, o, d0 = primary_rays(
        cam_row, times, row0, height=height, width=width,
        height_pad=height_pad, width_pad=width_pad,
        normalize_defocus_dir=normalize_defocus_dir)
    order = (eye_chunk_order(packed, cam_row).to(torch.int64)
             .reshape(1, -1).expand(nh * nw, -1))
    planes = []

    def bounce(carry):
        # a tile with no live ray passes through unchanged: no chunk is
        # live for it (the kernel leaves the bounce loop there)
        out = trace_bounce(packed, order, carry, flags,
                           scan_counts=scan_counts, track_idx=record)
        if record:
            planes.append(out[6])
        return out[:5]

    col = tc.sample_loop(
        bounce, tiled(state[0]), tuple(tiled(c[0]) for c in o),
        tuple(tiled(c[0]) for c in d0), tiled(d0[1][0]), bounces=bounces,
        spp=spp, sky_from_final_dir=sky_from_final_dir)
    color = torch.stack([untiled(c) for c in col])
    if not record:
        return color, None
    idx = tc.index_planes(planes, bounces, tiled(state[0]))
    return color, torch.stack([untiled(p) for p in idx])


def render_color_tris_plain(packed: PackedScene, cam_row, time: int, *,
                            flags: TraceFlags, row0: int = 0, **kw):
    """Plain version of ``render_color_tris`` (same arguments, same
    result; ``scan_counts`` as in ``trace_bounce``)."""
    return _mono_plain(packed, cam_row, time, row0, flags, record=False,
                       **kw)[0]


def render_color_tris_record_plain(packed: PackedScene, cam_row, time: int,
                                   *, flags: TraceFlags, **kw):
    """Plain version of ``render_color_tris_record``."""
    color, idx = _mono_plain(packed, cam_row, time, 0, flags, record=True,
                             **kw)
    return color, idx, packed.order


def _launch_mono(name: str, packed: PackedScene, cam_row, time: int,
                 row0: int, flags: TraceFlags, *, height: int, width: int,
                 height_pad: int, width_pad: int, bounces: int,
                 normalize_defocus_dir: bool, th: int, tw: int,
                 sky_from_final_dir: bool, spp: int):
    """One launch of the whole-frame kernel; ``name`` says which:
    ``"tris_mono"`` returns the color, ``"tris_record"`` (color, index
    planes)."""
    from rt_torch.kernels import _build

    _check_tile(th, tw, height_pad, width_pad)
    _check_block(th, tw)
    _require_tables(packed, CHUNK)
    dev = packed.tab.device
    order = eye_chunk_order(packed, cam_row)
    cam = _cam_array(cam_row)
    out = torch.empty((3, height_pad, width_pad), dtype=torch.float32,
                      device=dev)
    idx = None
    if name == "tris_record":
        idx = torch.empty((bounces, height_pad, width_pad),
                          dtype=torch.int32, device=dev)
    lib = _build.load()
    code = lib.rt_tris_mono(
        packed.tab.data_ptr(), packed.mats.data_ptr(),
        packed.chunks.data_ptr(), order.data_ptr(), cam.ctypes.data,
        int(time) & rng.MASK, row0, out.data_ptr(),
        None if idx is None else idx.data_ptr(), packed.n_chunks, CHUNK,
        packed.mats.shape[0], height, width, height_pad, width_pad, th, tw,
        bounces, spp, int(normalize_defocus_dir),
        int(flags.normalize_reflect_in), int(flags.has_metal),
        int(flags.has_dielectric), int(sky_from_final_dir),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, code, name)
    LAUNCHES[name] += 1
    return out if idx is None else (out, idx)


def render_color_tris(packed: PackedScene, cam_row, time: int, *,
                      flags: TraceFlags, sky_from_final_dir: bool = False,
                      spp: int = 1, row0: int = 0, **kw):
    """Planar (3, Hp, Wp) color of one frame in ONE launch: raygen, every
    bounce, the sample loop and the sky.  Every bounce visits the chunks
    front to back from the camera eye; one CUDA block traces one (th, tw)
    pixel tile, the unit of the chunk cull.

    cam_row: (1, 20) f32 on the host.  time: the u32 time uniform.
    kw: height, width: the real resolution (seed and uv math); height_pad,
    width_pad: the traced extent, a multiple of the tile (th, tw); bounces;
    normalize_defocus_dir.
    spp > 1: the same primary ray traced spp times with the RNG state
    carried across samples, summed from zero, then a true divide.
    row0: global row of the launch's first row (the rays of rows row0.. of
    a full frame).
    """
    run = (render_color_tris_plain if packed.tab.device.type == "cpu"
           else functools.partial(_launch_mono, "tris_mono"))
    return run(packed, cam_row, time, row0=row0, flags=flags,
               sky_from_final_dir=sky_from_final_dir, spp=spp, **kw)


def render_color_tris_record(packed: PackedScene, cam_row, time: int, *,
                             flags: TraceFlags,
                             sky_from_final_dir: bool = False, **kw):
    """(color (3, Hp, Wp) f32, hit indices (bounces, Hp, Wp) int32, order
    (m,)): the frame of ``render_color_tris`` at one sample per pixel, and
    per bounce the row of the triangle TABLE each pixel's ray hit, -1 on a
    miss and from then on.  ``order`` maps table rows back to scene triangle
    ids (``PackedScene.order``).  What the path-replay gradients consume.
    kw: as for ``render_color_tris``.
    """
    if packed.tab.device.type == "cpu":
        return render_color_tris_record_plain(
            packed, cam_row, time, flags=flags,
            sky_from_final_dir=sky_from_final_dir, **kw)
    color, idx = _launch_mono("tris_record", packed, cam_row, time, 0, flags,
                              sky_from_final_dir=sky_from_final_dir, spp=1,
                              **kw)
    return color, idx, packed.order


# ---------------------------------------------------------------------------
# the wavefront stream around the kernels (plain tensor code on any device)
# ---------------------------------------------------------------------------

def chunk_order(centroid, origin):
    """Front-to-back chunk visit order(s): chunks by squared distance of
    their box centre from ``origin`` ((3,) -> (n_chunks,), or (T, 3) ->
    (T, n_chunks)), stable, int32.  Order never changes the closest hit
    (strict t < best), only how early far chunks are rejected."""
    diff = centroid[None, :, :] - origin.reshape(-1, 1, 3)
    sq = diff * diff
    dist = sq[:, :, 0] + sq[:, :, 1] + sq[:, :, 2]
    order = torch.argsort(dist, dim=1, stable=True).to(torch.int32)
    return order[0] if origin.dim() == 1 else order


def scene_bounds(chunks):
    """(lo (3,), 1 / span (3,)) of the scene, from the chunk boxes: the
    range the morton key quantises ray origins over."""
    lo = chunks[:, 0:3].amin(dim=0)
    span = torch.clamp(chunks[:, 3:6].amax(dim=0) - lo, min=1e-30)
    return lo, 1.0 / span


@functools.lru_cache(maxsize=None)
def _key_tables(device) -> tuple:
    """The tables ``ray_sort_key`` reads on ``device``: the Morton spread
    (``_spread10``) of every KEY_BITS-bit code, and the shift of each of
    the key's six fields, (6, 1) int32."""
    codes = torch.arange(1 << KEY_BITS, dtype=torch.int32, device=device)
    shifts = torch.tensor([5, 4, 3, 2, 1, 0], dtype=torch.int32,
                          device=device)
    return _spread10(codes), shifts[:, None]


def ray_sort_key(pay, active, lo, inv_span):
    """``morton`` coherence key: the ray origin's Morton code (KEY_BITS per
    axis over the scene bounds) above the direction's sign octant; dead
    rays get DEAD_KEY and sort last.  int32, like every key here.

    The three axes go through each operation together and the Morton
    spread is a table read: 16 launches where spreading the bits took
    about 70.  A large scene sorts before every bounce, and on a card such
    small launches cost the host more time than the device."""
    top = (1 << KEY_BITS) - 1
    spread, shifts = _key_tables(pay.device)
    q = torch.clamp((pay[0:3] - lo[:, None]) * inv_span[:, None]
                    * float(top), 0.0, float(top)).to(torch.int32)
    # one direction bit per axis: floor((d + 1) * 1) clipped to [0, 1]
    qd = torch.clamp(pay[3:6] + 1.0, 0.0, 1.0).to(torch.int32)
    # the fields' bits are disjoint, so their sum is their OR (an origin
    # that is no number gives some code in range, as any key would do)
    fields = torch.cat([spread[torch.clamp(q, 0, top)], qd]) << shifts
    key = fields.sum(dim=0, dtype=torch.int32)
    return torch.where(active > 0, key, torch.full_like(key, DEAD_KEY))


def stream_key(pay, active, wch, key_mode: str = "chunk_oct", bounds=None):
    """The coherence key of a stream sort, int32.  ``"chunk_oct"``: the
    winning chunk id of the last bounce (the next origin lies on that
    chunk's surface) with the direction octant in the low 3 bits.
    ``"morton"``: ``ray_sort_key`` over ``bounds = scene_bounds(chunks)``.
    Dead rays get DEAD_KEY and sort last."""
    if key_mode == "morton":
        return ray_sort_key(pay, active, *bounds)
    if key_mode != "chunk_oct":
        raise ValueError(f"key_mode {key_mode!r}: chunk_oct or morton")
    octant = (((pay[3] > 0).to(torch.int32) << 2)
              | ((pay[4] > 0).to(torch.int32) << 1)
              | (pay[5] > 0).to(torch.int32))
    return torch.where(active > 0, (wch << 3) | octant,
                       torch.full_like(wch, DEAD_KEY))


def bounce_schedule(bounces: int, sort_every: int, skip_last_sort: bool,
                    start: int = 1):
    """[(first bounce, bounces fused, sort before?)] for bounces start.. of
    the stream.  No sort before bounce 0 (primary rays are coherent in
    pixel order).  The sort before a final launch that is a short remainder
    (< sort_every bounces) is skipped when ``skip_last_sort``."""
    out = []
    for b in range(start, bounces, sort_every):
        nb = min(sort_every, bounces - b)
        skip = (skip_last_sort and b + sort_every >= bounces
                and bounces - b < sort_every)
        out.append((b, nb, b > 0 and not skip))
    return out


def tile_chunk_order(packed: PackedScene, pay, tile: int) -> torch.Tensor:
    """(n_tiles * n_chunks,) int32: each tile of ``tile`` consecutive rays
    of the stream visits the chunks front to back from its mean ray
    origin."""
    mo = pay[0:3].reshape(3, -1, tile).mean(dim=2)
    return chunk_order(packed.centroid, mo.T).reshape(-1)


def to_pixels(x, pix):
    """Stream order -> pixel order along the last axis (an inverse-
    permutation scatter); ``pix`` maps stream position to pixel index,
    None for the identity."""
    if pix is None:
        return x
    out = torch.empty_like(x)
    out[..., pix] = x
    return out


def render_color_tris_wave(packed: PackedScene, cam_row, times, *,
                           height: int, width: int, height_pad: int,
                           width_pad: int, bounces: int,
                           normalize_defocus_dir: bool, flags: TraceFlags,
                           th: int, tw: int, sort_every: int = 2,
                           skip_last_sort: bool = True, row0: int = 0,
                           key_mode: str = "chunk_oct", spp: int = 1,
                           sky_from_final_dir: bool = False):
    """Planar (F, 3, Hp, Wp) colors for F frames.

    cam_row: (1, 20) f32 NumPy row (``dispatch.pack_camera``).
    times: (F,) int32 tensor of u32 time uniforms on the scene's device.
    key_mode: ``"chunk_oct"`` or ``"morton"``, the coherence key of the
    stream sorts.
    spp > 1: the SAME primary rays are traced spp times with the per-pixel
    RNG state carried across samples in pixel order, each sample a full
    pass of the stream from bounce 0, and the sum is divided by spp.
    """
    dev = packed.tab.device
    n_frames = times.shape[0]
    n = n_frames * height_pad * width_pad
    tile = th * tw
    bounds = scene_bounds(packed.chunks) if key_mode == "morton" else None

    def stream_bounces(pay, state, active, wch, start):
        """Bounces start.. over the stream.  Returns (pay, state, stream
        position -> pixel index or None for identity)."""
        pix = None
        for _, nb, do_sort in bounce_schedule(bounces, sort_every,
                                              skip_last_sort, start):
            if do_sort:
                # lean payload: `active` is rebuilt from the sorted key and
                # the primary dy never rides (the sky is applied in pixel
                # order)
                with span("wave.sort"):
                    key, perm = torch.sort(
                        stream_key(pay, active, wch, key_mode, bounds),
                        stable=True)
                    count("sort_keys", n)
                with span("wave.gather"):
                    pay = pay[:, perm]
                    state = state[perm]
                    pix = perm if pix is None else pix[perm]
                    active = (key != DEAD_KEY).to(torch.int32)
            with span("wave.chunk_order"):
                order = tile_chunk_order(packed, pay, tile)
            with span("wave.bounce"):
                wch = wave_bounce(packed, order, pay, state, active, flags,
                                  n_bounces=nb, th=th, tw=tw)
        return pay, state, pix

    def sample_color(pay, pix, pdy):
        atten = to_pixels(pay[6:9], pix)
        dy = to_pixels(pay[4], pix) if sky_from_final_dir else pdy
        return torch.stack(tc.sky_times_atten(
            dy, (atten[0], atten[1], atten[2])))

    if spp == 1:
        with span("wave.first"):
            payf, state, active, wch = wave_first(
                packed, eye_chunk_order(packed, cam_row), cam_row, times,
                row0, flags, height=height, width=width,
                height_pad=height_pad, width_pad=width_pad, th=th, tw=tw,
                normalize_defocus_dir=normalize_defocus_dir)
        pay, _, pix = stream_bounces(payf[0:9], state, active, wch, 1)
        with span("wave.restore"):
            col = sample_color(pay, pix, payf[9])
    else:
        with span("wave.raygen"):
            od, pdy, state_px = wave_raygen(
                cam_row, times, row0, height=height, width=width,
                height_pad=height_pad, width_pad=width_pad, th=th, tw=tw,
                normalize_defocus_dir=normalize_defocus_dir)
        acc = torch.zeros((3, n), dtype=torch.float32, device=dev)
        for _ in range(spp):
            pay = torch.cat([od, torch.ones_like(od[0:3])])
            active = torch.ones((n,), dtype=torch.int32, device=dev)
            pay, state, pix = stream_bounces(pay, state_px, active, None, 0)
            with span("wave.restore"):
                # the RNG state goes back to pixel order with atten
                state_px = to_pixels(state, pix)
                acc = acc + sample_color(pay, pix, pdy)
        # a tensor divisor: CUDA division by a Python scalar multiplies by
        # its reciprocal, which is not the IEEE quotient
        col = acc / torch.tensor(float(spp), dtype=torch.float32, device=dev)
    return (col.reshape(3, n_frames, height_pad, width_pad)
            .permute(1, 0, 2, 3))


def render_color_tris_wave_record(packed: PackedScene, cam_row, time: int, *,
                                  height: int, width: int, height_pad: int,
                                  width_pad: int, bounces: int,
                                  normalize_defocus_dir: bool,
                                  flags: TraceFlags, th: int, tw: int,
                                  sky_from_final_dir: bool = False):
    """(color (3, Hp, Wp) f32, hit indices (bounces, Hp, Wp) int32, order
    (m,)) of one frame through the sorted stream: the recorder for large
    meshes (counterpart of ``render_color_tris_wave_record``).  K10a traces
    bounce 0 in pixel tiles; before every later bounce the stream is sorted
    by the ``morton`` key, dead rays last, and one K10b launch traces the
    tiles that hold its live rays (the others keep their payload, and their
    index planes are -1): the count of live rays is read on the host, a
    4-byte copy a bounce.  Per bounce the row of the triangle TABLE each
    pixel's ray hit, -1 on a miss and from then on; ``order`` maps rows to
    scene triangle ids.

    The color equals ``render_color_tris_wave(..., sort_every=1,
    skip_last_sort=False, key_mode="morton")`` over the same tables bit for
    bit.  Pack the tables as the JAX recorder does, without ``split_big``.
    Each index plane is born in the stream order of its own bounce and goes
    back to pixel order through the permutation current at that bounce.
    """
    tile = th * tw
    times = torch.from_numpy(np.array([int(time) & rng.MASK], np.uint32)
                             .view(np.int32)).to(packed.tab.device)
    payf, state, active, _, idx0 = wave_first(
        packed, eye_chunk_order(packed, cam_row), cam_row, times, 0, flags,
        height=height, width=width, height_pad=height_pad,
        width_pad=width_pad, th=th, tw=tw,
        normalize_defocus_dir=normalize_defocus_dir, track_idx=True)
    pay = payf[0:9]
    bounds = scene_bounds(packed.chunks)
    pix = None                      # stream position -> pixel index
    planes = [idx0]
    for _ in range(1, bounces):
        key, perm = torch.sort(ray_sort_key(pay, active, *bounds),
                               stable=True)
        count("sort_keys", key.numel())
        active = (key != DEAD_KEY).to(torch.int32)
        live = active.sum()         # read on the host after the gathers
        pay = pay[:, perm]
        state = state[perm]
        pix = perm if pix is None else pix[perm]
        count("host_waits")         # int(live) waits for the device
        live_tiles = -(-int(live) // tile)
        _, idx = wave_bounce(
            packed, tile_chunk_order(packed, pay[:, :live_tiles * tile],
                                     tile),
            pay, state, active, flags, n_bounces=1, th=th, tw=tw,
            track_idx=True, live_tiles=live_tiles)
        planes.append(to_pixels(idx[0], pix))
    atten = to_pixels(pay[6:9], pix)
    dy = to_pixels(pay[4], pix) if sky_from_final_dir else payf[9]
    color = torch.stack(tc.sky_times_atten(dy, (atten[0], atten[1],
                                                 atten[2])))
    return (color.reshape(3, height_pad, width_pad),
            torch.stack(planes).reshape(bounces, height_pad, width_pad),
            packed.order)
