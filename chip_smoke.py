#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written kernels from rt_torch/kernels/csrc, holds each of
the fourteen (wave_first, wave_bounce, wave_raygen, spheres, spheres_chunked,
tris_mono, tris_record, spheres_record, the sorted-stream recorder's
wave_record and wave_record_bounce, the fit's replay_loss, and the probes'
lane_gather, mt_scan and woop_mma) against its plain PyTorch version on the
card at the shapes and in the stream states each path gives it, drives the
probes (``python -m rt_torch.probes lane_gather`` and ``r5_mxu`` at the
tools' sizes) and the
port's render paths (``rt_torch.measure.PATHS``) through ``build_scene ->
ProgressiveRenderer -> draw_frames``, after three phases of the soft pose
slice:

- ``config5``: the JAX package's BASELINE config 5 end to end at
  1920x1080 (``rt_torch.config5``: the 4-spp target through wave_raygen
  and wave_bounce, the 1-spp observation through wave_first and
  wave_bounce, three soft pose stages, the replay polish through
  tris_record), its launches counted, the JAX recipe's recovery guards;
- ``soft_devices``: the soft surrogate's image and gradients on the card
  against the CPU on the same inputs;
- ``app``: the CLI's checkpoint/resume byte-equal to an uninterrupted
  render at 512x512, its ``--stats`` lines, a ``profile_trace`` Chrome
  trace;

then:

- Suzanne 512x512, 8 bounces, 1 sample per pixel (wave_first, wave_bounce);
- scene 1 (sphere_simple) 512x512, 10 bounces (spheres);
- scene 8 (sphere_cover) 1280x720, 10 bounces (spheres_chunked);
- Suzanne 512x512, 8 bounces, 4 samples per pixel (wave_raygen, then
  wave_bounce from bounce 0);
- scene 7 (dragon) 512x512, 5 bounces (the large-scene branch);
- Suzanne 512x512, 8 bounces through the whole-frame kernel (tris_mono);
- the JAX package's BENCH_CONFIGS config1 (rtiow_one_sphere 400x225, 16
  samples a pixel, 4 bounces) and config2 (rtiow_three_spheres 800x450, 64
  samples, 10 bounces): one spheres launch a frame;

its training paths (``rt_torch.measure.FITS``) through ``fit_replay``:

- Suzanne 1920x1080 at the scene's own bounces, material 0 set to red, 40
  Adam steps with one re-record (tris_record), the JAX package's BASELINE
  config 5;
- scene 1 512x512, 10 bounces, two albedos wrong, 20 steps with one
  re-record (spheres_record);
- scenes 6 (lucy) and 7 (dragon) 512x512, 5 bounces, the mesh's material
  wrong, 20 steps with one re-record (the sorted-stream recorder:
  wave_record once and wave_record_bounce 4 times a record, each on the
  tiles that hold the stream's live rays);

checks the goldens of ``tests/golden_tris`` and ``tests/golden``
(``rt_torch.goldens``), Suzanne through the whole-frame path too, and
renders through the oracle backend (no kernel): ``rt_torch.cli --oracle``
once, the ``tests/golden_tris`` images, and one frame each of scene 1 and
Suzanne timed.  Every phase prints one JSON line; any failure raises, so the
exit code is non-zero and no result line is printed.  Needs no network and
starts no process that outlives it.

The probes are also held past the tools' sizes: lane_gather at 4 x 1500
(wider than one block's threads), mt_scan at 301 chunks and woop_mma at 600
(each block's slice staged in pieces).  wave_raygen's entry gives an empty
kernel's time on its grid beside its own.

The flat sphere kernels (spheres, spheres_record) are also held on frames
padded to the tile (rtiow_one_sphere's 225 rows to 232) and replayed twice
from a CUDA graph, each replay against the plain version's image.

The recorder's kernels are held at every launch of a whole record: lucy at
512x512 (wave_record_bounce's entry in the last line is the mean of its
four launches there) and dragon at 128x128.

Tolerance of kernel against plain version: none.  The kernels are compiled
with -fmad=false and use IEEE division and square root, so every output
element must be bit-equal (max_abs_err 0, no ray differs) — except
woop_mma's, whose product runs on the tensor cores, which sum in an order
and with a rounding of their own: its limits are ``r5_mxu.woop_agreement``'s
(hit/miss on at most 0.1 % of the rays; t within 1e-5 relative where both
hit, or within the f32 rounding bound of the winning triangle's sums).
"""

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: torch.cuda.is_available() is False; this script "
             "needs one CUDA device")

import numpy as np  # noqa: E402

from rt_torch import cli, goldens, measure  # noqa: E402
from rt_torch.measure import (  # noqa: E402
    FLOPS_PER_PAIR, FLOPS_PER_RAYGEN, FLOPS_PER_REPLAY_BOUNCE,
    FLOPS_PER_REPLAY_PIXEL, FLOPS_PER_SPHERE_HIT,
    FLOPS_PER_SPHERE_PAIR, FLOPS_PER_WOOP_PAIR, PEAK_BF16_FLOPS,
    PEAK_BYTES_PER_S, PEAK_F32_FLOPS, bound)
from rt_torch.kernels import (_build, dispatch,  # noqa: E402
                              replay_kernel, sphere_kernel, tris_kernel)
from rt_torch.scene import scenes  # noqa: E402

DEV = torch.device("cuda", 0)

KERNEL_SIZE = 512     # the triangle paths' image is 512 x 512


def say(**kw):
    print(json.dumps(kw), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def phase_build():
    """Build every kernel; print each one's registers, shared memory and
    spills (``-Xptxas -v``) and, for the triangle kernels, what their code
    holds (``cuobjdump -sass``: the reciprocal of the triangle scan is
    MUFU.RCP with its refinement, not a full division's FCHK)."""
    t0 = time.perf_counter()
    lib = _build.load()
    dt = time.perf_counter() - t0
    sass = {}
    for stem in ("tris_wave", "tris_mono"):
        sass |= _build.sass_summary(lib.paths[stem])
    say(phase="build", seconds=round(dt, 2),
        ptxas=_build.ptxas_usage(lib.build_log), sass=sass)


def _timed(fn, reps):
    """Mean milliseconds of fn(i) over ``reps`` calls, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for i in range(reps):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _diff(kernel_out, plain_out):
    """(max abs difference, fraction of rays with any differing bit) over
    matching tuples of (..., n) tensors."""
    n = kernel_out[0].shape[-1]
    differs = torch.zeros(n, dtype=torch.bool, device=DEV)
    max_abs = 0.0
    for k, p in zip(kernel_out, plain_out):
        if k.dtype.is_floating_point:
            bits_differ = k.view(torch.int32) != p.view(torch.int32)
            d = (k - p).abs()
            d = torch.where(torch.isnan(d), torch.full_like(d, float("inf")),
                            d)
            d = torch.where(bits_differ, d, torch.zeros_like(d))
            max_abs = max(max_abs, float(d.max()))
        else:
            bits_differ = k != p
            max_abs = max(max_abs, float((k - p).abs().max()))
        differs |= bits_differ.reshape(-1, n).any(dim=0)
    return max_abs, float(differs.float().mean())


def _timed_graph(fn, reps):
    """Mean device milliseconds of one fn(), with ``reps`` of them captured
    into one CUDA graph and the graph replayed: the launches run back to
    back, so a kernel of a few microseconds is read, and not the host's cost
    of reaching it through the wrapper."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()                                        # warm-up
    return _timed(lambda i: graph.replay(), 3) / reps


def _wave_record(name, line, case, size, th, tw, k_out, p_out, plain_ms,
                 **more):
    err, frac = _diff(k_out, p_out)
    return dict(name=name, route="cuda",
                source="rt_torch/kernels/csrc/tris_wave.cu",
                replaces=f"rt/kernels/tris_kernel.py:{line}", case=case,
                size=size, tile=[th, tw], max_abs_err=err, rays_differ=frac,
                plain_ms=plain_ms, library_ms=None, **more)


def _compare_bounce(case, size, packed, flags, th, tw, pay0, state0, active0,
                    n_bounces, reps):
    """K3 against its plain version from one stream state."""
    n = state0.shape[0]
    tile_order = tris_kernel.tile_chunk_order(packed, pay0, th * tw)

    def fresh():
        return pay0.clone(), state0.clone(), active0.clone()

    kp, ks, ka = fresh()
    kw_ = tris_kernel.wave_bounce(packed, tile_order, kp, ks, ka, flags,
                                  n_bounces=n_bounces, th=th, tw=tw)
    pp, ps, pa = fresh()
    counts = []
    pw, plain_ms = _plain_timed(lambda: tris_kernel.wave_bounce_plain(
        packed, tile_order, pp, ps, pa, flags, n_bounces=n_bounces, th=th,
        tw=tw, scan_counts=counts))
    rec = _wave_record("wave_bounce", 657, case, size, th, tw,
                       (kp, ks, ka, kw_), (pp, ps, pa, pw), plain_ms,
                       n_bounces=n_bounces, n_chunks=packed.n_chunks,
                       **_counts_record(counts))
    if reps:
        bufs = [fresh() for _ in range(reps)]
        rec["ms"] = _timed(lambda i: tris_kernel.wave_bounce(
            packed, tile_order, *bufs[i], flags, n_bounces=n_bounces, th=th,
            tw=tw), reps)
        table_bytes = sum(t.numel() * 4 for t in
                          (packed.tab, packed.mats, packed.chunks))
        nbytes = table_bytes + tile_order.numel() * 4 + (11 + 12) * n * 4
        rec["bound_ms"], rec["bound_by"], rec["flops"] = bound(counts,
                                                               nbytes)
    return rec


def _counts_record(counts):
    """The plain version's per-bounce counts under their names."""
    names = ("ray_chunk_scans", "box_tests", "tile_chunk_visits",
             "candidates", "tile_chunk_scans", "heaviest_tile_scans",
             "box_tests_every_chunk")
    return {"counts": [dict(zip(names, c)) for c in counts]}


def compare_wave(make_scene, size: int, bounces_fused, reps: int = 0):
    """K2, then K3 on the sorted stream after bounce 0, against their plain
    versions on one frame of ``make_scene`` at size x size: the tables, tile
    shape, coherence key and stream state the scene's path gives them
    (``measure.wave_state``).  With reps > 0 also times them.  Returns one
    record per comparison."""
    st = measure.wave_state(make_scene, size, DEV)
    packed, flags, th, tw = st.packed, st.flags, st.th, st.tw
    case = f"{st.sd.name} {st.kw['key_mode']}"
    n = size * size

    # ---- K2 ----
    counts = []
    p_out, plain_ms = _plain_timed(lambda: tris_kernel.wave_first_plain(
        packed, st.order, st.cam_row, st.times, 0, flags, scan_counts=counts,
        **st.first_kw))
    rec = _wave_record("wave_first", 583, case, size, th, tw, st.first,
                       p_out, plain_ms, n_chunks=packed.n_chunks,
                       **_counts_record(counts))
    if reps:
        rec["ms"] = _timed(lambda i: tris_kernel.wave_first(
            packed, st.order, st.cam_row, st.times, 0, flags, **st.first_kw),
            reps)
        table_bytes = sum(t.numel() * 4 for t in
                          (packed.tab, packed.mats, packed.chunks))
        nbytes = table_bytes + st.order.numel() * 4 + 13 * n * 4
        rec["bound_ms"], rec["bound_by"], rec["flops"] = bound(counts,
                                                               nbytes)
    records = [rec]

    # ---- K3 on the sorted stream after bounce 0 ----
    for nb in bounces_fused:
        records.append(_compare_bounce(
            f"{case}, sorted stream after bounce 0", size, packed, flags, th,
            tw, st.pay0, st.state0, st.active0, nb, reps))
    return records


def compare_bounce_from_raygen(size: int, reps: int):
    """K3 as the paths of more than one sample per pixel launch it first:
    2 fused bounces straight from K4's output on Suzanne, every ray alive,
    in pixel order, no winning-chunk plane before it."""
    st = measure.raygen_state(size, DEV)
    return _compare_bounce(f"{st.sd.name}, primary rays from wave_raygen",
                           size, st.packed, st.flags, st.th, st.tw, st.pay0,
                           st.state0, st.active0, 2, reps)


def _require_bit_equal(records):
    for r in records:
        bad = [k for k in ("max_abs_err", "rays_differ", "flat_max_abs_err",
                           "flat_rays_differ", "index_entries_differ",
                           "color_differs_from_tris_mono",
                           "color_differs_from_spheres")
               if r.get(k, 0.0) != 0.0]
        if r.get("graph_replays_equal") is False:
            bad.append("graph_replays_equal")
        if bad:
            raise SystemExit(f"kernel {r['name']} disagrees with its plain "
                             f"version ({bad}): {r}")


def phase_kernels(make_scene, size: int, bounces_fused, reps: int = 0):
    records = compare_wave(make_scene, size, bounces_fused, reps)
    say(phase="kernels", kernels=["wave_first", "wave_bounce"], size=size,
        limit="bit-equal: max_abs_err 0 and rays_differ 0", results=records)
    _require_bit_equal(records)
    return records


def _plain_timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def compare_raygen(size: int, reps: int):
    """K4 on Suzanne's camera at size x size against its plain version,
    and beside its time from a graph replay: an empty kernel on its own
    grid and on the tile grid (one block a tile), the fixed costs of such
    launches, a fill of its bytes (the card's write rate for them with the
    L2 warm), and the wrapper's cost on the host."""
    args = measure.raygen_args(size, DEV)
    kw = args.kw
    th, tw = kw["th"], kw["tw"]
    plain_kw = {k: v for k, v in kw.items() if k not in ("th", "tw")}
    run = lambda: tris_kernel.wave_raygen(args.cam_row, args.times, 0, **kw)
    k_out = run()
    p_out, plain_ms = _plain_timed(lambda: tris_kernel.wave_raygen_plain(
        args.cam_row, args.times, 0, **plain_kw))
    n = size * size
    rec = _wave_record("wave_raygen", 637, args.sd.name, size, th, tw,
                       k_out, p_out, plain_ms)
    grid = tris_kernel.raygen_grid(1, size, size)
    threads = tris_kernel.RAYGEN_THREADS
    blocks = grid[0] * grid[1] * grid[2]
    rec["grid"] = [*grid, threads]
    # the kernel runs for a few microseconds: read it from a graph replay,
    # and the wrapper's cost on the host beside it
    rec["ms"] = _timed_graph(run, reps)
    rec["empty_ms"] = measure.empty_ms(blocks, threads, reps)
    rec["empty_tile_grid_ms"] = measure.empty_ms(n // (th * tw), th * tw,
                                                 reps)
    planes = torch.empty(8 * n, dtype=torch.float32, device=DEV)
    rec["fill_ms"] = _timed_graph(lambda: planes.fill_(1.0), reps)
    rec["wrapper_ms"] = _timed(lambda i: run(), reps)
    rec["bound_ms"], rec["bound_by"], rec["flops"] = measure.raygen_bound(n)
    return rec


def _graph_replays_equal(run, want) -> bool:
    """One launch captured in a CUDA graph, the graph replayed twice (its
    outputs zeroed before each): does every replay give ``want``?"""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = run()
    outs = out if isinstance(out, tuple) else (out,)
    equal = True
    for _ in range(2):
        for o in outs:
            o.zero_()
        graph.replay()
        torch.cuda.synchronize()
        equal &= all(torch.equal(o.view(torch.int32), w.view(torch.int32))
                     for o, w in zip(outs, want))
    return equal


def compare_spheres(make_scene, width: int, height: int, spp: int,
                    reps: int, bounces: int | None = None):
    """K5 or K6 (as the dispatch chooses for the scene) on one frame at the
    default tile, padded to it as the dispatch pads it, against its plain
    version; K5 also replayed from a CUDA graph, K6 also against the flat
    plain scan over the same Morton-ordered table."""
    sd = make_scene(width, height, device=DEV)
    cfg = dataclasses.replace(sd.config, samples_per_frame=spp,
                              bounces=bounces or sd.config.bounces,
                              tile=dispatch.DEFAULT_TILE)
    packed = dispatch.pack_scene(sd.scene, cfg)
    cam_row = dispatch.pack_camera(sd.camera)
    geo = dispatch.frame_geometry(cfg)
    th, tw = geo.pop("th"), geo.pop("tw")
    kw = dict(bounces=cfg.bounces,
              normalize_defocus_dir=cfg.normalize_defocus_dir,
              flags=dispatch.trace_flags(cfg), spp=spp, **geo)
    counts = []
    nbytes = (packed.tab.numel() + packed.kinds.numel()) * 4 \
        + 20 * 4 + 3 * geo["width_pad"] * geo["height_pad"] * 4
    if packed.chunks is None:
        name, line = "spheres", 129
        run = lambda: sphere_kernel.render_color_spheres(
            packed.tab, packed.kinds, cam_row, 1000, n_spheres=packed.n,
            th=th, tw=tw, **kw)
        plain = lambda: sphere_kernel.render_color_spheres_plain(
            packed.tab, packed.kinds, cam_row, 1000, n_spheres=packed.n,
            scan_counts=counts, **kw)
    else:
        name, line = "spheres_chunked", 420
        run = lambda: sphere_kernel.render_color_spheres_chunked(
            packed, cam_row, 1000, th=th, tw=tw, **kw)
        plain = lambda: sphere_kernel.render_color_spheres_chunked_plain(
            packed, cam_row, 1000, th=th, tw=tw, scan_counts=counts, **kw)
        nbytes += (packed.chunks.numel() + packed.n_chunks) * 4
    k_out = run()
    p_out, plain_ms = _plain_timed(plain)
    err, frac = _diff((k_out.reshape(3, -1),), (p_out.reshape(3, -1),))
    rec = dict(name=name, route="cuda",
               source="rt_torch/kernels/csrc/spheres.cu",
               replaces=f"rt/kernels/sphere_kernel.py:{line}",
               case=sd.name, size=[width, height],
               padded=[geo["width_pad"], geo["height_pad"]], spp=spp,
               bounces=cfg.bounces, tile=[th, tw], n_spheres=packed.n,
               max_abs_err=err, rays_differ=frac, plain_ms=plain_ms,
               library_ms=None)
    if packed.chunks is None:
        rec["graph_replays_equal"] = _graph_replays_equal(run, (p_out,))
    if packed.chunks is not None:
        flat = sphere_kernel.render_color_spheres_plain(
            packed.tab, packed.kinds, cam_row, 1000, n_spheres=packed.n, **kw)
        rec["flat_max_abs_err"], rec["flat_rays_differ"] = _diff(
            (k_out.reshape(3, -1),), (flat.reshape(3, -1),))
    if reps:
        rec["wrapper_ms"] = _timed(lambda i: run(), reps)
        # the flat kernel runs for some tens of microseconds: read it from
        # a graph replay.  The chunked kernel runs for milliseconds: events
        # around the wrapper (the kernel and its chunk order) read it
        rec["ms"] = (_timed_graph(run, reps) if packed.chunks is None
                     else rec["wrapper_ms"])
        # raygen a padded pixel; the flat scan's counts also give its hits,
        # each resolved and scattered
        per_ray = geo["width_pad"] * geo["height_pad"] * FLOPS_PER_RAYGEN
        hits = sum(c[2] for c in counts if len(c) > 2)
        rec["bound_ms"], rec["bound_by"], rec["flops"] = bound(
            counts, nbytes, per_pair=FLOPS_PER_SPHERE_PAIR,
            extra_flops=per_ray + hits * FLOPS_PER_SPHERE_HIT)
    return rec


def _frame_record(name, source, replaces, sd, width, height, th, tw, k_out,
                  p_out, plain_ms, **more):
    err, frac = _diff(k_out, p_out)
    return dict(name=name, route="cuda",
                source=f"rt_torch/kernels/csrc/{source}", replaces=replaces,
                case=sd.name, size=[width, height], tile=[th, tw],
                max_abs_err=err, rays_differ=frac, plain_ms=plain_ms,
                library_ms=None, **more)


def _planes(*tensors):
    """(C, Hp, Wp) outputs as the (C, n) planes ``_diff`` takes."""
    return tuple(t.reshape(t.shape[0], -1) for t in tensors)


def compare_mono(size: int, bounces: int, spp: int, reps: int):
    """K7 on Suzanne at size x size against its plain version."""
    sd = scenes.scene_suzanne(size, size, device=DEV)
    packed = dispatch.pack_scene(sd.scene)
    cam_row = dispatch.pack_camera(sd.camera)
    th, tw = dispatch.DEFAULT_TILE
    kw = dict(height=size, width=size, height_pad=size, width_pad=size,
              bounces=bounces, normalize_defocus_dir=True,
              flags=dispatch.trace_flags(sd.config), th=th, tw=tw, spp=spp)
    run = lambda: tris_kernel.render_color_tris(packed, cam_row, 1000, **kw)
    k_out = run()
    counts = []
    p_out, plain_ms = _plain_timed(lambda: tris_kernel.render_color_tris_plain(
        packed, cam_row, 1000, scan_counts=counts, **kw))
    rec = _frame_record("tris_mono", "tris_mono.cu",
                        "rt/kernels/tris_kernel.py:337", sd, size, size, th,
                        tw, _planes(k_out), _planes(p_out), plain_ms,
                        bounces=bounces, spp=spp, n_chunks=packed.n_chunks)
    if reps:
        rec["ms"] = _timed(lambda i: run(), reps)
        n = size * size
        nbytes = sum(t.numel() * 4 for t in (packed.tab, packed.mats,
                                             packed.chunks)) \
            + packed.n_chunks * 4 + 20 * 4 + 3 * n * 4
        rec["bound_ms"], rec["bound_by"], rec["flops"] = bound(
            counts, nbytes, extra_flops=n * FLOPS_PER_RAYGEN)
    return rec


def compare_tris_record(width: int, height: int, bounces: int, reps: int):
    """K9 on Suzanne against its plain version, color and every index
    plane, and its color against K7's on the same frame."""
    sd = scenes.scene_suzanne(width, height, device=DEV)
    packed = dispatch.pack_scene(sd.scene)
    cam_row = dispatch.pack_camera(sd.camera)
    th, tw = dispatch.DEFAULT_TILE
    kw = dict(height=height, width=width, height_pad=height, width_pad=width,
              bounces=bounces, normalize_defocus_dir=True,
              flags=dispatch.trace_flags(sd.config), th=th, tw=tw)
    run = lambda: tris_kernel.render_color_tris_record(packed, cam_row, 1000,
                                                       **kw)
    color, idx, _ = run()
    mono_color = tris_kernel.render_color_tris(packed, cam_row, 1000, **kw)
    counts = []
    (p_color, p_idx, _), plain_ms = _plain_timed(
        lambda: tris_kernel.render_color_tris_record_plain(
            packed, cam_row, 1000, scan_counts=counts, **kw))
    rec = _frame_record("tris_record", "tris_mono.cu",
                        "rt/kernels/tris_kernel.py:1309", sd, width, height,
                        th, tw, _planes(color, idx), _planes(p_color, p_idx),
                        plain_ms, bounces=bounces,
                        index_entries_differ=float(
                            (idx != p_idx).float().mean()),
                        color_differs_from_tris_mono=_diff(
                            _planes(color), _planes(mono_color))[1])
    if reps:
        rec["ms"] = _timed(lambda i: run(), reps)
        n = width * height
        nbytes = sum(t.numel() * 4 for t in (packed.tab, packed.mats,
                                             packed.chunks)) \
            + packed.n_chunks * 4 + 20 * 4 + (3 + bounces) * n * 4
        rec["bound_ms"], rec["bound_by"], rec["flops"] = bound(
            counts, nbytes, extra_flops=n * FLOPS_PER_RAYGEN)
    return rec


def compare_spheres_record(make_scene, width: int, height: int, reps: int):
    """K8 against its plain version, color and every index plane, and its
    color against K5's (the kernel up to 128 rows, its plain version above:
    the render dispatch scans no more than that flat)."""
    sd = make_scene(width, height, device=DEV)
    cfg = sd.config
    tab, kinds, n = dispatch.pack_spheres_table(sd.scene)
    if 0 < cfg.n_active_spheres < n:
        n = cfg.n_active_spheres
    cam_row = dispatch.pack_camera(sd.camera)
    th, tw = dispatch.DEFAULT_TILE
    kw = dict(n_spheres=n, height=height, width=width, height_pad=height,
              width_pad=width, bounces=cfg.bounces,
              normalize_defocus_dir=cfg.normalize_defocus_dir,
              flags=dispatch.trace_flags(cfg))
    run = lambda: sphere_kernel.render_color_spheres_record(
        tab, kinds, cam_row, 1000, th=th, tw=tw, **kw)
    color, idx = run()
    counts = []
    (p_color, p_idx), plain_ms = _plain_timed(
        lambda: sphere_kernel.render_color_spheres_record_plain(
            tab, kinds, cam_row, 1000, scan_counts=counts, **kw))
    if n <= sphere_kernel.FLAT_MAX_SPHERES:
        render = sphere_kernel.render_color_spheres(
            tab, kinds, cam_row, 1000, th=th, tw=tw, **kw)
    else:
        render = sphere_kernel.render_color_spheres_plain(
            tab, kinds, cam_row, 1000, **kw)
    rec = _frame_record("spheres_record", "spheres.cu",
                        "rt/kernels/sphere_kernel.py:529", sd, width, height,
                        th, tw, _planes(color, idx), _planes(p_color, p_idx),
                        plain_ms, n_spheres=n, bounces=cfg.bounces,
                        index_entries_differ=float(
                            (idx != p_idx).float().mean()),
                        color_differs_from_spheres=_diff(
                            _planes(color), _planes(render))[1],
                        graph_replays_equal=_graph_replays_equal(
                            run, (p_color, p_idx)))
    if reps:
        rec["wrapper_ms"] = _timed(lambda i: run(), reps)
        rec["ms"] = _timed_graph(run, reps)
        npix = width * height
        nbytes = (tab.numel() + kinds.numel()) * 4 + 20 * 4 \
            + (3 + cfg.bounces) * npix * 4
        hits = sum(c[2] for c in counts)
        rec["bound_ms"], rec["bound_by"], rec["flops"] = bound(
            counts, nbytes, per_pair=FLOPS_PER_SPHERE_PAIR,
            extra_flops=npix * FLOPS_PER_RAYGEN
            + hits * FLOPS_PER_SPHERE_HIT)
    return rec


def compare_replay_loss(width: int, height: int, reps: int):
    """The replay kernel on Suzanne's recorded paths at its 5 bounces
    against its plain version, autograd through ``replay_color`` on the
    card: the colour bit-equal (``max_abs_err``, ``rays_differ``); the loss
    within 1e-5 relative and the gradient within 1e-4 of its norm (their
    sums run in another order, autograd's in float32 over every pixel);
    two launches give the same bits.  With reps > 0 its time, beside its
    bound and the plain version's."""
    import numpy as np

    from rt_torch.grad import record_hits

    sd = scenes.scene_suzanne(width, height, device=DEV)
    cfg = sd.config
    _, hits = record_hits(sd.scene, sd.camera, cfg, 1000)
    hits = hits.contiguous()
    target = torch.from_numpy(np.random.RandomState(7).uniform(
        0.0, 1.0, (height, width, 3)).astype(np.float32)).to(DEV)
    args = (sd.scene, sd.camera, cfg, 1000, hits, target)
    tables = replay_kernel.pack_replay_tables(sd.scene, sd.camera)
    run = lambda: replay_kernel.replay_loss_grad(*args, tables=tables)
    loss, grad, color = replay_kernel.replay_loss_grad(*args,
                                                       want_color=True)
    again = run()
    (p_loss, p_grad, p_color), plain_ms = _plain_timed(
        lambda: replay_kernel.replay_loss_grad_plain(*args, want_color=True))
    th, tw = dispatch.DEFAULT_TILE
    rec = _frame_record(
        "replay_loss", "replay.cu", "none: the replay is plain jnp "
        "(rt/grad/replay.py)", sd, width, height, th, tw,
        (color.reshape(-1, 3).T,), (p_color.reshape(-1, 3).T,), plain_ms,
        bounces=cfg.bounces,
        loss_rel_err=float((loss - p_loss).abs() / p_loss.abs()),
        grad_err_of_norm=float((grad - p_grad).abs().max()
                               / torch.linalg.vector_norm(p_grad)),
        launches_bit_equal=bool(torch.equal(again[0], loss)
                                and torch.equal(again[1], grad)))
    if not (rec["loss_rel_err"] <= 1e-5 and rec["grad_err_of_norm"] <= 1e-4
            and rec["launches_bit_equal"]):
        raise SystemExit(f"replay_loss: {rec}")
    if reps:
        rec["ms"] = _timed(lambda i: run(), reps)
        rec["graph_ms"] = _timed_graph(run, reps)
        npix = width * height
        hit_bounces = int((hits >= 0).sum())
        nbytes = (hits.numel() + target.numel()) * 4
        rec["bound_ms"], rec["bound_by"], rec["flops"] = bound(
            [], nbytes, extra_flops=npix * (FLOPS_PER_RAYGEN
                                            + FLOPS_PER_REPLAY_PIXEL)
            + hit_bounces * FLOPS_PER_REPLAY_BOUNCE)
        rec["hit_bounces"] = hit_bounces
        rec["bytes"] = nbytes
    return rec


def phase_kernels_train():
    """K7, K9, K8 and the replay kernel against their plain versions at the
    shapes the whole-frame path and the training paths give them (K9 and
    the replay kernel: the 1920x1080 frame of the Suzanne fit at the
    scene's own 5 bounces; K9 at 512x512 and 8 too); the recorders' color
    against the render kernels'; limit bit-equal (the replay kernel's loss:
    1e-5 relative; its gradient: 1e-4 of its norm)."""
    records = [
        compare_mono(KERNEL_SIZE, 8, 1, reps=10),
        compare_mono(KERNEL_SIZE, 8, 4, reps=0),
        compare_tris_record(1920, 1080, 5, reps=5),
        compare_tris_record(KERNEL_SIZE, KERNEL_SIZE, 8, reps=0),
        compare_spheres_record(scenes.scene_sphere_simple, 512, 512, reps=50),
        compare_spheres_record(scenes.scene_sphere_cover, 256, 144, reps=0),
        compare_replay_loss(1920, 1080, reps=20),
        compare_replay_loss(256, 256, reps=0),
    ]
    say(phase="kernels", kernels=["tris_mono", "tris_record",
                                  "spheres_record", "replay_loss"],
        limit="bit-equal: max_abs_err 0, no pixel and no index entry "
              "differs; recorder color == render color", results=records)
    _require_bit_equal(records)
    return records


def compare_record_launches(make_scene, size: int, reps: int):
    """K10a and every K10b launch of one whole record (``tris_kernel.
    render_color_tris_wave_record`` on one frame of ``make_scene`` at size
    x size, its bounces, over the tables the recorder packs: no
    split_big), each against its plain version on the same inputs:
    payload, state, active, winning chunk and index planes.  The plain
    version runs on copies of each launch's inputs just before the
    record's own launch.  With reps > 0 also times each kernel (the
    profiler's device time, on fresh copies).  Returns one record per
    launch."""
    sd = make_scene(size, size, device=DEV)
    th, tw = dispatch.DEFAULT_TILE
    flags = dispatch.trace_flags(sd.config)
    packed = tris_kernel.pack_tri_table(sd.scene)
    cam_row = dispatch.pack_camera(sd.camera)
    case = f"{sd.name} recorder tables"
    n = size * size
    table_bytes = sum(t.numel() * 4 for t in
                      (packed.tab, packed.mats, packed.chunks, packed.groups)
                      if t is not None)
    wave_first, wave_bounce = tris_kernel.wave_first, tris_kernel.wave_bounce
    records = []

    def first(packed_, order, cam_row_, times, row0, flags_, **kw):
        counts = []
        p_out, plain_ms = _plain_timed(lambda: tris_kernel.wave_first_plain(
            packed_, order, cam_row_, times, row0, flags_,
            scan_counts=counts, **kw))
        k_out = wave_first(packed_, order, cam_row_, times, row0, flags_,
                           **kw)
        rec = _wave_record(
            "wave_record", 1211, f"{case}, bounce 0", size, th, tw, k_out,
            p_out, plain_ms, bounce=0, n_chunks=packed_.n_chunks,
            **_counts_record(counts), index_entries_differ=float(
                (k_out[4] != p_out[4]).float().mean()))
        if reps:
            rec["ms"] = measure._profiled_ms(lambda: wave_first(
                packed_, order, cam_row_, times, row0, flags_, **kw), reps,
                "wave_first_kernel")
            # payf 10, state, active, winning chunk, index: 14 words a ray
            nbytes = table_bytes + order.numel() * 4 + 14 * n * 4
            rec["bound_ms"], rec["bound_by"], rec["flops"] = bound(
                counts, nbytes, extra_flops=n * FLOPS_PER_RAYGEN)
        records.append(rec)
        return k_out

    def bounce(packed_, tile_order, pay, state, active, flags_, **kw):
        ins = pay.clone(), state.clone(), active.clone()
        counts = []
        (pw, pidx), plain_ms = _plain_timed(
            lambda: tris_kernel.wave_bounce_plain(
                packed_, tile_order, *ins, flags_, scan_counts=counts, **kw))
        if reps:
            bufs = []

            def fresh():     # the kernel updates its inputs in place
                bufs[:] = [(pay.clone(), state.clone(), active.clone())
                           for _ in range(reps)]

            ms = measure._profiled_ms(lambda: wave_bounce(
                packed_, tile_order, *bufs.pop(), flags_, **kw), reps,
                "wave_bounce_kernel", prepare=fresh)
        kw_, kidx = wave_bounce(packed_, tile_order, pay, state, active,
                                flags_, **kw)
        launched = kw.get("live_tiles")
        rec = _wave_record(
            "wave_record_bounce", 1277,
            f"{case}, morton-sorted stream before bounce {len(records)}",
            size, th, tw, (pay, state, active, kw_, kidx),
            (*ins, pw, pidx), plain_ms, bounce=len(records),
            n_bounces=kw["n_bounces"], n_chunks=packed_.n_chunks,
            tiles_launched=launched, **_counts_record(counts),
            index_entries_differ=float((kidx != pidx).float().mean()))
        if reps:
            rec["ms"] = ms
            rays = n if launched is None else launched * th * tw
            # reads pay 9, state, active; writes those, winning chunk, index
            nbytes = table_bytes + tile_order.numel() * 4 + 24 * rays * 4
            rec["bound_ms"], rec["bound_by"], rec["flops"] = bound(counts,
                                                                   nbytes)
        records.append(rec)
        return kw_, kidx

    tris_kernel.wave_first, tris_kernel.wave_bounce = first, bounce
    try:
        tris_kernel.render_color_tris_wave_record(
            packed, cam_row, 1000, height=size, width=size, height_pad=size,
            width_pad=size, bounces=sd.config.bounces, flags=flags, th=th,
            tw=tw, normalize_defocus_dir=sd.config.normalize_defocus_dir,
            sky_from_final_dir=sd.config.sky_from_final_dir)
    finally:
        tris_kernel.wave_first, tris_kernel.wave_bounce = wave_first, \
            wave_bounce
    return records


def _per_launch(records, name):
    """One entry for a kernel launched several times a record: its
    launches' mean ms, bound and plain time (the time a record spends in it
    over the count of its launches)."""
    rs = [r for r in records if r["name"] == name]
    mean = {k: sum(r[k] for r in rs) / len(rs)
            for k in ("ms", "bound_ms", "plain_ms")}
    ops = sum(r["flops"] for r in rs)
    return rs[0] | mean | dict(
        case=f"{rs[0]['case'].split(',')[0]}: mean of the {len(rs)} "
             "launches of one record", bound_by=max(
                 rs, key=lambda r: r["bound_ms"])["bound_by"], flops=ops,
        ms_by_bounce=[r["ms"] for r in rs],
        bound_ms_by_bounce=[r["bound_ms"] for r in rs])


def compare_record_color(make_scene, size: int):
    """The sorted-stream recorder's color against the render path's with a
    sort before every bounce (``render_color_tris_wave(sort_every=1,
    skip_last_sort=False, key_mode="morton")``) over the same tables: the
    recording instances of the kernels must leave the arithmetic of the
    render ones alone.  Limit: no pixel differs."""
    sd = make_scene(size, size, device=DEV)
    th, tw = dispatch.DEFAULT_TILE
    packed = tris_kernel.pack_tri_table(sd.scene)
    cam_row = dispatch.pack_camera(sd.camera)
    kw = dict(height=size, width=size, height_pad=size, width_pad=size,
              bounces=sd.config.bounces,
              normalize_defocus_dir=sd.config.normalize_defocus_dir,
              flags=dispatch.trace_flags(sd.config), th=th, tw=tw)
    color, idx, _ = tris_kernel.render_color_tris_wave_record(
        packed, cam_row, 1000, **kw)
    render = tris_kernel.render_color_tris_wave(
        packed, cam_row, torch.tensor([1000], dtype=torch.int32, device=DEV),
        sort_every=1, skip_last_sort=False, key_mode="morton", **kw)[0]
    return dict(case=sd.name, size=size, bounces=kw["bounces"],
                color_pixels_differ=_diff(_planes(color), _planes(render))[1],
                hits_per_bounce=[float((p >= 0).float().mean()) for p in idx])


def phase_kernels_record():
    """K10a and each of the four K10b launches of a whole record against
    their plain versions: lucy at 512x512 (the fits' shape, timed) and
    dragon at 128x128 (limit bit-equal, index planes included); then the
    recorder's color against the render path's on lucy and dragon at
    512x512.  Returns the entries of the kernels line: K10a on lucy, and
    K10b as the mean of lucy's four launches."""
    t0 = time.perf_counter()
    lucy = compare_record_launches(scenes.scene_lucy, KERNEL_SIZE, reps=5)
    dragon = compare_record_launches(scenes.scene_dragon, 128, reps=0)
    colors = [compare_record_color(make, KERNEL_SIZE)
              for make in (scenes.scene_lucy, scenes.scene_dragon)]
    say(phase="kernels", kernels=["wave_record", "wave_record_bounce"],
        limit="bit-equal: max_abs_err 0, no ray and no index entry differs, "
              "at every launch of a record; recorder color == "
              "render_color_tris_wave(sort_every=1, morton) color",
        results=lucy + dragon, recorder_color=colors,
        seconds=time.perf_counter() - t0)
    _require_bit_equal(lucy + dragon)
    bad = [c for c in colors if c["color_pixels_differ"] != 0.0]
    if bad:
        raise SystemExit(f"the recorder's color differs from the render "
                         f"path's: {bad}")
    launches = [r["name"] for r in lucy + dragon]
    if launches != (["wave_record"] + ["wave_record_bounce"] * 4) * 2:
        raise SystemExit(f"a record launched {launches}")
    return [lucy[0], _per_launch(lucy, "wave_record_bounce")] + dragon


def max_sm_clock_mhz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True)
    return float(out.stdout.strip().splitlines()[0])


def _p2_shape(name, kernel, pairs, n_chunks=64):
    """A P2 kernel's launch (``r5_mxu.launch_shape``) at ``n_chunks`` (its
    slice in one piece or in several: ``r5_mxu.piece_plan``), registers
    (``-Xptxas -v``), the SASS instructions of its innermost loop, those a
    pair runs (the loop's less the slow path that a branch skips, the IEEE
    division's for x of an extreme exponent: these inputs take none), and
    the issue floor they give: a pair's instructions for every 32 pairs (a
    warp instruction), four a cycle on each SM at the card's top clock."""
    from rt_torch.probes import r5_mxu

    lib = _build.load()
    shape = r5_mxu.launch_shape(name, r5_mxu.R, n_chunks, DEV)
    want = r5_mxu.piece_plan(name, n_chunks)
    if (shape["piece"], shape["pieces"]) != want:
        raise SystemExit(f"probes: {name} at {n_chunks} chunks stages "
                         f"{shape['piece']} chunks in {shape['pieces']} "
                         f"turns, r5_mxu.piece_plan says {want}")
    ptxas = [u for u in _build.ptxas_usage(lib.build_log)
             if u["kernel"].startswith(kernel + "<")]
    loops = [v for k, v in _build.sass_loops(lib.paths["probes"]).items()
             if k.startswith(kernel + "<")]
    if len(ptxas) != 1 or not loops or not loops[0]:
        raise SystemExit(f"probes: no one {kernel} with a loop in the "
                         "build")
    body = loops[0][0]
    per_pair = (body["instructions"] - body["slow_path"]) \
        / shape["pairs_per_turn"]
    sms = torch.cuda.get_device_properties(DEV).multi_processor_count
    clock = max_sm_clock_mhz() * 1e6
    floor_ms = pairs / 32 * per_pair / (sms * 4 * clock) * 1e3
    return dict(launch=shape, sms=sms, max_sm_clock_mhz=clock / 1e6,
                registers=ptxas[0]["registers"],
                static_smem_bytes=ptxas[0]["smem_bytes"],
                spill_bytes=(ptxas[0].get("spill_store_bytes", 0)
                             + ptxas[0].get("spill_load_bytes", 0)),
                sass_loop=body, instructions_per_pair=per_pair,
                issue_floor_ms=floor_ms)


def _one_launch(name, fn):
    """fn(), which must launch kernel ``name`` exactly once."""
    from rt_torch import probes

    n = probes.launch_counts()[name]
    out = fn()
    if probes.launch_counts()[name] != n + 1:
        raise SystemExit(f"probes: a pass of {name} launched "
                         f"{probes.launch_counts()[name] - n} times")
    return out


# P1 beyond the tool's shapes: a width past the 1024 columns of one block
WIDE_GATHER = (4, 1500)
# P2 past what one block's shared memory holds of a slice on an H100: A at
# 301 chunks, B at 600, each slice staged and scanned in pieces
F2_CHUNKS = {"mt_scan": 301, "woop_mma": 600}


def _gather_record(th, tw, link, sms):
    """P1 at (th, tw) and the tool's 512 iterations against its plain
    version and the NumPy reference; its time from a graph, ns per
    dependent gather, and the least time of its work (``bound_parts``:
    the chain of adds at the measured link, the bank wavefronts counted
    from idx) beside the peak-rate bound of the kernels' line."""
    from rt_torch.probes import lane_gather

    iters = lane_gather.ITERS
    tab_row, tab_np, idx_np = lane_gather.inputs(th, tw)
    tab = torch.from_numpy(tab_np).to(DEV)
    idx = torch.from_numpy(idx_np).to(DEV)
    run = lambda: lane_gather.lane_gather(tab, idx, iters)
    k = _one_launch("lane_gather", run)
    p, plain_ms = _plain_timed(lambda: lane_gather.lane_gather_plain(
        tab, idx, iters))
    ref = torch.from_numpy(lane_gather.reference(tab_row, idx_np,
                                                 iters)).to(DEV)
    n = th * tw
    flops = iters * n                 # one add a gather
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    t_bytes = 3 * n * 4 / PEAK_BYTES_PER_S * 1e3
    ms = _timed_graph(run, 50)
    parts = lane_gather.bound_parts(idx_np, iters, link["cycles_per_add"],
                                    link["clock_mhz"], sms)
    return dict(
        name="lane_gather", route="cuda",
        source="rt_torch/kernels/csrc/probes.cu",
        replaces="tools/exp_lane_gather.py:39", shape=[th, tw],
        iters=iters, copies=lane_gather.copies(tw),
        blocks=lane_gather.grid(th, tw),
        max_abs_err=float((k - p).abs().max()),
        elements_differ=int((k.view(torch.int32)
                             != p.view(torch.int32)).sum()),
        elements_differ_from_reference=int(
            (k.view(torch.int32) != ref.view(torch.int32)).sum()),
        ms=ms, ns_per_dependent_gather=ms * 1e6 / iters, plain_ms=plain_ms,
        bound_ms=max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        flops=flops, library_ms=None, chain_link=link,
        latency_bound=parts,
        of_latency_bound=parts["bound_ms"] / ms)


def _f2_records(n_chunks_a, n_chunks_b):
    """F2: A at ``n_chunks_a`` and B at ``n_chunks_b`` chunks, each slice
    staged and scanned in more than one piece: one launch each, A
    bit-equal to its plain version, B within ``woop_agreement``; their
    launches and times from a graph."""
    from rt_torch.probes import r5_mxu

    a = r5_mxu.to_device(r5_mxu.inputs(n_chunks_a), DEV)
    run_a = lambda: r5_mxu.mt_scan(a["tri"], a["o"], a["d"])
    k = _one_launch("mt_scan", run_a)
    p = r5_mxu.mt_scan_plain(a["tri"], a["o"], a["d"])
    err, frac = _diff((k.reshape(1, -1),), (p.reshape(1, -1),))
    pairs = r5_mxu.R * n_chunks_a * r5_mxu.CHUNK
    scan = dict(name="mt_scan", n_chunks=n_chunks_a, max_abs_err=err,
                rays_differ=frac, ms=_timed_graph(run_a, 10),
                **_p2_shape("mt_scan", "mt_scan_kernel", pairs, n_chunks_a))
    b = r5_mxu.to_device(r5_mxu.inputs(n_chunks_b), DEV)
    run_b = lambda: r5_mxu.woop(b["w"], b["x"])
    k = _one_launch("woop_mma", run_b)
    p, win = r5_mxu.woop_plain(b["w"], b["x"], winner=True)
    pairs = r5_mxu.R * n_chunks_b * r5_mxu.CHUNK
    woop = dict(name="woop_mma", n_chunks=n_chunks_b,
                agreement=r5_mxu.woop_agreement(k, p, b["w"], b["x"], win),
                ms=_timed_graph(run_b, 10),
                **_p2_shape("woop_mma", "woop_mma_kernel", pairs,
                            n_chunks_b))
    short = [r["name"] for r in (scan, woop) if r["launch"]["pieces"] < 2]
    if short:
        raise SystemExit(f"probes: {short} staged its slice in one piece "
                         "at the F2 chunk counts")
    return [scan, woop]


def phase_probes():
    """The probes of ``rt_torch.probes``: ``python -m rt_torch.probes
    lane_gather`` and ``r5_mxu`` at the tools' sizes (three shapes at 512
    iterations; 64 chunks, 200 repetitions) with the launch counts set to 0
    just before and read just after; then each kernel against its plain
    version at those shapes, P1 also at WIDE_GATHER and P2 at F2_CHUNKS
    (slices staged in pieces).  Limits: P1 and P2 A bit-equal (P1 also to
    the tool's NumPy reference); P2 B within ``r5_mxu.woop_agreement``.
    Each P2 kernel is one launch a pass on a grid of at least one block an
    SM; its entry gives its launch (pieces included), registers and
    resident blocks an SM, and its SASS instructions a pair.  P1's entries
    give its least time from the add chain's measured link and the bank
    wavefronts.  Returns (records, launches on the entry point's run)."""
    from rt_torch import probes
    from rt_torch.probes import __main__ as probes_cli
    from rt_torch.probes import lane_gather, r5_mxu

    t0 = time.perf_counter()
    probes.reset_launch_counts()
    rcs = [probes_cli.main(["lane_gather"]), probes_cli.main(["r5_mxu"])]
    torch.cuda.synchronize()
    launches = probes.launch_counts()
    if any(rcs) or not all(launches.values()):
        raise SystemExit(f"probes: the entry point returned {rcs} or a "
                         f"kernel was not launched ({launches})")

    source = "rt_torch/kernels/csrc/probes.cu"
    sms = torch.cuda.get_device_properties(DEV).multi_processor_count
    link = lane_gather.chain_link(DEV)
    gather = [_gather_record(th, tw, link, sms)
              for th, tw in lane_gather.SHAPES + (WIDE_GATHER,)]

    rcp_bad = r5_mxu.reciprocal_mismatches(DEV)
    if rcp_bad:
        raise SystemExit(f"probes: the P2 kernels' reciprocal differs from "
                         f"IEEE division on {rcp_bad} floats")
    n_chunks = 64
    a = r5_mxu.to_device(r5_mxu.inputs(n_chunks), DEV)
    pairs = r5_mxu.R * n_chunks * r5_mxu.CHUNK
    in_bytes = lambda *ts: sum(t.numel() * t.element_size() for t in ts)

    run_a = lambda: r5_mxu.mt_scan(a["tri"], a["o"], a["d"])
    k = _one_launch("mt_scan", run_a)
    p, plain_ms = _plain_timed(lambda: r5_mxu.mt_scan_plain(a["tri"], a["o"],
                                                            a["d"]))
    err, frac = _diff((k.reshape(1, -1),), (p.reshape(1, -1),))
    flops = pairs * FLOPS_PER_PAIR
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    t_bytes = (in_bytes(a["tri"], a["o"], a["d"]) + r5_mxu.R * 4) \
        / PEAK_BYTES_PER_S * 1e3
    scan = dict(name="mt_scan", route="cuda", source=source,
                replaces="tools/exp_r5_mxu.py:137", n_chunks=n_chunks,
                max_abs_err=err, rays_differ=frac,
                hit_share=float((p != r5_mxu._FLT_MAX).float().mean()),
                ms=_timed_graph(run_a, 50), plain_ms=plain_ms,
                bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                flops=flops, library_ms=None,
                **_p2_shape("mt_scan", "mt_scan_kernel", pairs))

    run_b = lambda: r5_mxu.woop(a["w"], a["x"])
    k = _one_launch("woop_mma", run_b)
    (p, win), plain_ms = _plain_timed(lambda: r5_mxu.woop_plain(
        a["w"], a["x"], winner=True))
    agree = r5_mxu.woop_agreement(k, p, a["w"], a["x"], win)
    # the product on the tensor cores and the epilogue on the CUDA cores
    # run side by side: the least time is the larger of the two
    mma_flops = 2 * pairs * 6 * r5_mxu.WOOP_K
    epi_flops = pairs * FLOPS_PER_WOOP_PAIR
    t_mma = mma_flops / PEAK_BF16_FLOPS * 1e3
    t_epi = epi_flops / PEAK_F32_FLOPS * 1e3
    t_bytes = (in_bytes(a["w"], a["x"]) + r5_mxu.R * 4) \
        / PEAK_BYTES_PER_S * 1e3
    woop = dict(name="woop_mma", route="cuda", source=source,
                replaces="tools/exp_r5_mxu.py:142", n_chunks=n_chunks,
                max_abs_err=float((k - p).abs().max()), agreement=agree,
                ms=_timed_graph(run_b, 50), plain_ms=plain_ms,
                bound_ms=max(t_mma, t_epi, t_bytes),
                bound_by="operations" if max(t_mma, t_epi) >= t_bytes
                else "bytes",
                bound_parts_ms=dict(tensor_core=t_mma, cuda_core=t_epi,
                                    bytes=t_bytes),
                flops=mma_flops + epi_flops, library_ms=None,
                **_p2_shape("woop_mma", "woop_mma_kernel", pairs))
    f2 = _f2_records(F2_CHUNKS["mt_scan"], F2_CHUNKS["woop_mma"])

    ab = dict(n_chunks=n_chunks, rays=r5_mxu.R, pairs=pairs,
              a_us_per_pass=scan["ms"] * 1e3,
              b_us_per_pass=woop["ms"] * 1e3,
              a_gpairs_per_s=pairs / scan["ms"] / 1e6,
              b_gpairs_per_s=pairs / woop["ms"] / 1e6,
              a_over_b=scan["ms"] / woop["ms"],
              b_at_least_2x_faster=scan["ms"] >= 2 * woop["ms"])
    say(phase="probes", launches=launches, a_vs_b=ab,
        reciprocal_mismatches_of_2_32=rcp_bad,
        limit="lane_gather, mt_scan bit-equal to plain (lane_gather also "
              "to the NumPy reference); woop_mma: hit/miss on at most "
              f"{r5_mxu.HIT_MISS_LIMIT} of the rays, t within "
              f"{r5_mxu.REL_LIMIT} relative where both hit or within the "
              "rounding bound of the winner's sums", results=gather
        + [scan, woop], f2=f2, seconds=time.perf_counter() - t0)
    bad = [r for r in gather if r["elements_differ"]
           or r["elements_differ_from_reference"]]
    if bad or scan["rays_differ"] or not agree["ok"] \
            or f2[0]["rays_differ"] or not f2[1]["agreement"]["ok"]:
        raise SystemExit(f"probes: a kernel disagrees with its plain "
                         f"version: lane_gather {bad}, mt_scan rays "
                         f"{scan['rays_differ']}, woop_mma {agree}, at "
                         f"{F2_CHUNKS} chunks: mt_scan rays "
                         f"{f2[0]['rays_differ']}, woop_mma "
                         f"{f2[1]['agreement']}")
    small = [r["name"] for r in (scan, woop)
             if r["launch"]["grid"] < r["sms"]]
    if small:
        raise SystemExit(f"probes: the grid of {small} leaves SMs idle")
    # one entry a kernel: lane_gather at the tool's largest shape
    return [gather[len(lane_gather.SHAPES) - 1], scan, woop], launches


def phase_oracle():
    """The oracle backend on the card: ``rt_torch.cli --oracle`` renders
    once; the ``tests/golden_tris`` images under today's bounds; whether
    the two dielectric sphere scenes come under the oracle bound of
    0.05 % (recorded, not a gate); one frame of scene 1 and of Suzanne
    timed; no kernel launched."""
    t0 = time.perf_counter()
    dispatch.reset_launch_counts()
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "oracle.ppm")
        rc = cli.main(["--scene", "5", "--oracle", "--frames", "1",
                       "--size", "128x128", "-o", out])
        cli_ok = rc == 0 and os.path.getsize(out) > 128 * 128 * 3
    diffs = {name: goldens.oracle_diff_pct(name, DEV, backend="oracle")
             for name in goldens.ORACLE_GOLDENS}
    bounds = {name: g.bound_pct for name, g in goldens.ORACLE_GOLDENS.items()}
    timed = [measure.run_oracle("sphere_simple", frames=2),
             measure.run_oracle("suzanne", frames=1)]
    launches = {k: v for k, v in dispatch.launch_counts().items() if v}
    over = {k: v for k, v in diffs.items() if not v <= bounds[k]}
    ok = (cli_ok and not over and not launches
          and all(t["image_finite"] for t in timed))
    say(phase="oracle", ok=ok, cli_ok=cli_ok, bound_pct=bounds,
        diff_pct=diffs, dielectric_under_oracle_bound={
            k: diffs[k] <= goldens.ORACLE_BOUND_PCT
            for k in ("cover", "rtiow_three_spheres")},
        timed=timed, kernel_launches=launches,
        seconds=time.perf_counter() - t0)
    if not ok:
        raise SystemExit("oracle: the CLI failed, an image is over its "
                         f"bound ({over}), an image is not finite, or a "
                         f"kernel was launched ({launches})")


def phase_kernels_new():
    """K4, K5, K6 against their plain versions at the shapes the render
    phase gives them, and K3 in the two stream states the second slice's
    paths add; limit bit-equal."""
    records = [
        compare_raygen(KERNEL_SIZE, reps=50),
        compare_spheres(scenes.scene_sphere_simple, 512, 512, 1, reps=50),
        compare_spheres(scenes.scene_sphere_simple, 512, 512, 4, reps=0),
        # the JAX package's BENCH_CONFIGS config1 and config2 at the
        # samples and depth their paths run; 225 and 450 rows padded to 232
        # and 456
        compare_spheres(scenes.scene_rtiow_one_sphere, 400, 225, 16,
                        reps=10, bounces=4),
        compare_spheres(scenes.scene_rtiow_three_spheres, 800, 450, 64,
                        reps=5, bounces=10),
        compare_spheres(scenes.scene_sphere_cover, 1280, 720, 1, reps=5),
        compare_bounce_from_raygen(KERNEL_SIZE, reps=5),
    ]
    say(phase="kernels", kernels=["wave_raygen", "spheres",
                                  "spheres_chunked", "wave_bounce"],
        limit="bit-equal: max_abs_err 0 and rays_differ 0 (pixels for the "
              "sphere kernels)", results=records)
    _require_bit_equal(records)
    return records


def render_path(name: str):
    """One path of ``measure.PATHS`` through build_scene ->
    ProgressiveRenderer -> draw_frames: warm-up, then the path's frames
    timed with the launch counts set to 0 just before and read just after.
    Returns the counts."""
    path = measure.PATHS[name]
    frames = path.smoke_frames
    r = measure.renderer(name, device=DEV)
    width, height = path.width, path.height
    r.set_time(1000)
    r.draw_frames(2)                      # warm-up: allocator, first launch
    r.reset_frame_count()
    r.set_time(1000)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launch_counts()
    t0 = time.perf_counter()
    r.draw_frames(frames, 10)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dispatch.launch_counts()
    image = r.image
    cfg = r.config
    ok = (image.shape == (height, width, 3)
          and bool(np.isfinite(image).all())
          and float(image.max() - image.min()) > 0.05
          and r.frame_count == frames)
    segs = width * height * cfg.bounces * cfg.samples_per_frame * frames
    say(phase="render", path=name, scene=r.scene_def.name,
        size=[width, height], bounces=cfg.bounces,
        spp=cfg.samples_per_frame, frames=frames,
        seconds=dt, frames_per_s=frames / dt, ray_segments_per_s=segs / dt,
        ms_per_frame=dt / frames * 1e3, launches=launches,
        peak_memory_bytes=torch.cuda.max_memory_allocated(),
        image_min=float(image.min()), image_max=float(image.max()),
        image_mean=float(image.mean()), ok=ok)
    if not ok:
        raise SystemExit(f"render {name}: image is not finite, constant, "
                         "or of the wrong shape")
    want = {k: path.launches.get(k, 0) * frames for k in launches}
    if launches != want:
        raise SystemExit(f"render {name}: kernel launches {launches}, "
                         f"expected {want}")
    return launches


def phase_render():
    """Every path of ``measure.PATHS``.  Returns, for each kernel, its
    launches on the first path that runs it."""
    launches = {}
    for name in measure.PATHS:
        for kernel, count in render_path(name).items():
            if count and kernel not in launches:
                launches[kernel] = count
    return launches


def phase_train():
    """Every path of ``measure.FITS`` through ``fit_replay``, with the
    launch counts set to 0 just before the fit and read just after.
    Returns, for each recorder kernel, its launches in the first fit that
    runs it."""
    launches = {}
    for name, f in measure.FITS.items():
        t0 = time.perf_counter()
        r = measure.run_fit(name)
        records = -(-f.steps // f.rerecord_every)
        # a triangle fit of the albedo alone steps on the replay kernel
        want = {f.kernel: records, "replay_loss": (
            0 if f.kernel == "spheres_record" else f.steps)}
        if f.kernel == "wave_record":
            # one K10b launch for every bounce after the first
            want["wave_record_bounce"] = records * (r["bounces"] - 1)
        ok = (r["losses_finite"] and r["last_loss"] < 0.1 * r["first_loss"]
              and all(r["launches"][k] == v for k, v in want.items()))
        say(phase="train", ok=ok, expected_launches=want,
            seconds=time.perf_counter() - t0, **r)
        if not ok:
            raise SystemExit(f"train {name}: a loss is not finite, the last "
                             "loss is not below a tenth of the first, or the "
                             f"recorder's launches are not {want}")
        for k in want:
            launches.setdefault(k, r["launches"][k])
    return launches


# config 5's step counts in the smoke run (rt_torch.config5's defaults are
# the JAX tool's: soft 240, fine 150, ultra 80, polish 24)
CONFIG5_STEPS = ["--soft-steps", "160", "--fine-steps", "90",
                 "--ultra-steps", "40", "--polish-steps", "32"]


def phase_config5():
    """BASELINE config 5 end to end at 1920x1080 (``rt_torch.config5``):
    the 4-spp target (K4, then K3 from bounce 0) and the 1-sample
    observation (K2, then K3), the three soft pose stages (no kernel), and
    the replay polish (K9 once a record).  The launch counts are set to 0
    just before and read just after; the JAX package's own guards of the
    recipe hold: theta and phi errors down at least 10x, fov 2x, the
    albedo error 5x, every loss finite."""
    from rt_torch import config5

    args = config5.parse_args(CONFIG5_STEPS)
    torch.cuda.synchronize()
    dispatch.reset_launch_counts()
    t0 = time.perf_counter()
    r = config5.run(args)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k: v for k, v in dispatch.launch_counts().items() if v}
    want = r["expected_launches"]
    red = r["reduction"]
    guards = dict(theta_10x=red["theta_deg"] >= 10,
                  phi_10x=red["phi_deg"] >= 10, fov_2x=red["fov_rad"] >= 2,
                  albedo_5x=r["albedo_reduction"] >= 5,
                  losses_finite=r["losses_finite"],
                  launches=launches == {k: v for k, v in want.items() if v})
    ok = all(guards.values())
    say(phase="config5", ok=ok, guards=guards, launches=launches,
        phase_seconds=dt, **r)
    if not ok:
        raise SystemExit(f"config5: a guard failed: {guards}; launches "
                         f"{launches}, expected {want}")


def phase_soft_devices():
    """The soft surrogate on the card against the same inputs on the CPU
    (Suzanne 240x135, chunk 32, tau 0.008, the config-5 loss against a
    seeded random target): the forward within 1e-6 absolute, the camera
    and albedo gradients of the image-gradient loss within 1e-4 of each
    leaf's largest entry (the CPU tests' limits against the JAX
    package)."""
    from rt_torch.config5 import LOOK_TARGET
    from rt_torch.grad.params import look_at
    from rt_torch.grad.soft_tris import (OrbitParams, make_soft_tris_loss,
                                         soft_render_tris)

    t0 = time.perf_counter()
    w, h = 240, 135
    target = np.random.RandomState(5).uniform(
        0.0, 1.0, (h, w, 3)).astype(np.float32)
    # the camera parameters are made once, on the CPU: the card's sinf and
    # cosf would otherwise give another pose to the last bit
    cam = scenes.scene_suzanne(8, 8, device="cpu").camera
    op = OrbitParams.from_eye(np.asarray(cam.eye[:3]), LOOK_TARGET,
                              float(cam.fov) + 0.02, device="cpu")
    op = op._replace(theta=op.theta + 0.03)
    cp0 = op.to_camera_params(LOOK_TARGET, float(cam.focal_length), 0.0)
    out = {}
    for dev in ("cuda", "cpu"):
        sd = scenes.scene_suzanne(w, h, device=dev)
        cp = type(cp0)(*(v.to(dev) for v in cp0))
        with torch.no_grad():
            img = soft_render_tris(sd.scene, look_at(cp), sd.config,
                                   tau=0.008, chunk=32)
        loss = make_soft_tris_loss(sd.scene, sd.config, target, tau=0.008,
                                   chunk=32, loss_mode="grad", grad_pool=2)
        leaves = [v.detach().clone().requires_grad_() for v in cp]
        albedo = sd.scene.mat_albedo.detach().clone().requires_grad_()
        value = loss(type(cp)(*leaves), albedo)
        # focal_blur takes no part (the surrogate has no defocus)
        grads = torch.autograd.grad(value, leaves + [albedo],
                                    allow_unused=True)
        out[dev] = (img.cpu(), float(value.detach()),
                    [torch.zeros_like(x).cpu() if g is None else g.cpu()
                     for g, x in zip(grads, leaves + [albedo])])
    (img_c, loss_c, g_c), (img_p, loss_p, g_p) = out["cuda"], out["cpu"]
    names = list(cp._fields) + ["mat_albedo"]
    grad_rel = {n: float((a - b).abs().max() / max(float(b.abs().max()),
                                                   1e-30))
                for n, a, b in zip(names, g_c, g_p)}
    forward = float((img_c - img_p).abs().max())
    loss_rel = abs(loss_c - loss_p) / loss_p
    live = {n: float(b.abs().max()) > 1e-6 for n, b in zip(names, g_p)}
    # a leaf whose gradient is below 1e-6 must be as small on the card
    ok = (forward <= 1e-6 and loss_rel <= 1e-4
          and all(grad_rel[n] <= 1e-4 if live[n]
                  else float(a.abs().max()) <= 2e-6
                  for n, a in zip(names, g_c))
          and live["eye"] and live["fov"] and live["mat_albedo"])
    say(phase="soft_devices", ok=ok, size=[w, h], forward_max_abs=forward,
        loss_rel=loss_rel, grad_rel_of_leaf_max=grad_rel, live=live,
        limits=dict(forward=1e-6, loss=1e-4, grad=1e-4),
        seconds=time.perf_counter() - t0)
    if not ok:
        raise SystemExit("soft_devices: the card and the CPU disagree past "
                         "the CPU tests' limits")


def phase_app():
    """The app shell on the card: ``rt_torch.cli`` renders Suzanne at
    512x512 through the kernels, 2 frames with ``--batch 2 --checkpoint``,
    then ``--resume`` to 4; its PPM must be byte-equal to an uninterrupted
    4-frame render (drawn under ``profile_trace``, whose Chrome trace must
    hold kernel events), and ``--stats`` prints a line a batch."""
    import contextlib
    import io

    from rt_torch.utils import profile_trace

    t0 = time.perf_counter()
    dispatch.reset_launch_counts()
    with tempfile.TemporaryDirectory() as d:
        ck, a, b = (os.path.join(d, n) for n in ("ck.npz", "a.ppm", "b.ppm"))
        common = ["--scene", "5", "--size", "512x512", "--batch", "2",
                  "--stats"]
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            rcs = [cli.main(common + ["--frames", "2", "--checkpoint", ck,
                                      "-o", a]),
                   cli.main(common + ["--frames", "4", "--checkpoint", ck,
                                      "--resume", "-o", a])]
            with profile_trace(os.path.join(d, "trace")):
                rcs.append(cli.main(common + ["--frames", "4", "-o", b]))
        with open(a, "rb") as f, open(b, "rb") as g:
            equal = f.read() == g.read()
        with open(os.path.join(d, "trace", "trace.json")) as f:
            trace = f.read()
    log = err.getvalue()
    stats_lines = sum(1 for line in log.splitlines()
                      if line.strip().startswith("frame "))
    launches = {k: v for k, v in dispatch.launch_counts().items() if v}
    # a CUDA kernel event in the Chrome trace (torch.profiler has missed
    # single launches, so no one kernel's name is required)
    kernels_traced = '"cat": "kernel"' in trace
    names_traced = [k for k in ("wave_first_kernel", "wave_bounce_kernel")
                    if k in trace]
    ok = (rcs == [0, 0, 0] and equal and stats_lines == 4
          and "resumed at frame 2" in log and kernels_traced
          and launches == {"wave_first": 8, "wave_bounce": 16})
    say(phase="app", ok=ok, rcs=rcs, resumed_equals_uninterrupted=equal,
        stats_lines=stats_lines, kernel_events_in_trace=kernels_traced,
        kernel_names_in_trace=names_traced,
        launches=launches, seconds=time.perf_counter() - t0)
    if not ok:
        raise SystemExit("app: a CLI run failed, the resumed PPM differs "
                         "from the uninterrupted one, a --stats line is "
                         "missing, the trace lacks the kernels, or the "
                         f"launches are not 8 K2 and 16 K3 ({launches})")


# the dist phase's CLI render: Suzanne at full width, 8 bounces (4 K3
# launches a frame), 8 frames in batches of 4
DIST_SIZE = 512
DIST_CLI = ["5", "--bounces", "8", "--size", f"{DIST_SIZE}x{DIST_SIZE}",
            "--frames", "8", "--batch", "4"]
DIST_FIT = dict(time=1000, steps=8, rerecord_every=4, learning_rate=5e-2)
DIST_TIMES = [1000, 1010]
DIST_FRAMES = 64          # the timed window of measure_multihost


def _dist_spp2():
    """(packed Suzanne 512x512 at 2 samples a pixel, camera, config)."""
    sd = measure.scene_def("suzanne", DEV)
    cfg = dataclasses.replace(sd.config, samples_per_frame=2)
    return dispatch.pack_scene(sd.scene, cfg), sd.camera, cfg


def _dist_run(mesh, out_ppm):
    """What a rank of the dist phase runs on ``mesh``: the sharded CLI
    render, the spp-2 wave band, the 8-step 1080p fit, the sample-parallel
    mean, global rays/s and scaling; each with its launches."""
    from rt_torch import dist as rdist
    from rt_torch.grad.train import fit_replay

    res = {}

    def counted(name, fn):
        torch.cuda.synchronize()
        dispatch.reset_launch_counts()
        t0 = time.perf_counter()
        value = fn()
        torch.cuda.synchronize()
        res[name] = dict(seconds=time.perf_counter() - t0, launches={
            k: v for k, v in dispatch.launch_counts().items() if v})
        return value

    res["cli_rc"] = counted("cli", lambda: cli.main(
        DIST_CLI + ["--sharded", "-o", out_ppm]))
    scene, camera, cfg = _dist_spp2()
    band = counted("wave_spp2", lambda: rdist.sharded_wave_render_frames(
        scene, camera, cfg, DIST_TIMES, mesh))
    fit = measure.fit_setup("suzanne_1080p", mesh.device)
    fit_replay(*fit, **(DIST_FIT | dict(steps=2)), mesh=mesh)   # warm-up
    _, losses = counted("fit", lambda: fit_replay(*fit, **DIST_FIT,
                                                  mesh=mesh))
    res["fit"]["ms_per_step"] = res["fit"]["seconds"] * 1e3 / len(losses)
    res["losses"] = losses
    sd = measure.scene_def("suzanne", DEV)
    mean = counted("sample", lambda: rdist.sample_sharded_render(mesh)(
        dispatch.pack_scene(sd.scene), sd.camera, DIST_TIMES, sd.config))
    rays = rdist.measure_multihost(sd, frames=DIST_FRAMES, warmup=2)
    res["sharded_ms_per_frame"] = DIST_SIZE ** 2 / rays * 1e3
    scaling = rdist.measure_scaling(sd, frames=DIST_FRAMES, warmup=2)
    res["scaling"] = dict(topology=scaling.topology,
                          ranks=scaling.device_counts,
                          rays_per_s=scaling.rays_per_s,
                          efficiency=scaling.efficiency)
    return res, band.cpu().numpy(), mean.cpu().numpy()


def dist_worker(outdir: str):
    """One rank of the dist phase's two-process group (torchrun's
    variables in the environment): ``_dist_run``, written to OUTDIR."""
    from rt_torch import dist as rdist

    rdist.multihost_init()
    mesh = rdist.make_mesh()
    res, band, mean = _dist_run(
        mesh, os.path.join(outdir, "world2.ppm"))
    res |= dict(rank=mesh.rank, backend=mesh.backend, device=str(mesh.device),
                band=list(mesh.band(DIST_SIZE)))
    np.savez(os.path.join(outdir, f"rank{mesh.rank}.npz"), band=band,
             mean=mean)
    with open(os.path.join(outdir, f"rank{mesh.rank}.json"), "w") as f:
        json.dump(res, f)
    torch.distributed.destroy_process_group()


def _two_ranks(outdir: str) -> list:
    """Run ``dist_worker`` in two processes on this card (gloo: NCCL
    refuses two ranks on one device); their results, rank by rank."""
    from rt_torch.dist.sharding import free_port

    env = dict(os.environ, WORLD_SIZE="2", LOCAL_WORLD_SIZE="2",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()))
    procs, logs = [], []
    for r in range(2):
        logs.append(open(os.path.join(outdir, f"log{r}.txt"), "w+"))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--dist-worker",
             outdir], env=env | dict(RANK=str(r), LOCAL_RANK=str(r)),
            stdout=logs[-1], stderr=subprocess.STDOUT))
    deadline = time.monotonic() + 300
    try:
        while any(p.poll() is None for p in procs):
            if (any(p.poll() not in (None, 0) for p in procs)
                    or time.monotonic() > deadline):
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    out = []
    for r, (p, log) in enumerate(zip(procs, logs)):
        log.seek(0)
        text = log.read()
        log.close()
        if p.returncode != 0:
            raise SystemExit(f"dist: rank {r} of 2 exited {p.returncode}:\n"
                             f"{text[-4000:]}")
        with open(os.path.join(outdir, f"rank{r}.json")) as f:
            res = json.load(f)
        with np.load(os.path.join(outdir, f"rank{r}.npz")) as z:
            res["band_array"], res["mean_array"] = z["band"], z["mean"]
        res["log_tail"] = text[-600:]
        out.append(res)
    return out


def phase_dist():
    """``rt_torch.dist`` on the card, against the port's own unsharded
    path: (a) a group of one over NCCL in this process, (b) two processes
    over gloo sharing the card (rows 0-255 and 256-511).  In each: the
    CLI's ``--sharded`` Suzanne 512x512 b8 PPM byte-equal to the unsharded
    one, with K2 8 and K3 32 launches a rank; (b) the spp-2 wave band
    (K4) bit-equal to its rows of the unsharded frames; the 8-step
    ``suzanne_1080p`` fit (K9 twice a rank) within rtol 2e-5 of the
    unsharded losses; ``sample_sharded_render`` within 2e-6 of the mean
    of the sequential frames; ``measure_multihost`` and ``measure_scaling``
    rays/s.  Any mismatch raises."""
    import torch.distributed as dist

    from rt_torch import dist as rdist
    from rt_torch.grad.train import fit_replay

    t0 = time.perf_counter()
    want_cli = {"wave_first": 8, "wave_bounce": 32}
    with tempfile.TemporaryDirectory() as d:
        plain = os.path.join(d, "plain.ppm")
        dispatch.reset_launch_counts()
        rc_plain = cli.main(DIST_CLI + ["-o", plain])
        plain_launches = {k: v for k, v in dispatch.launch_counts().items()
                          if v}
        # the unsharded references
        scene, camera, cfg = _dist_spp2()
        frames = dispatch.render_color_frames(scene, camera, cfg,
                                              DIST_TIMES, DEV).cpu().numpy()
        fit = measure.fit_setup("suzanne_1080p", DEV)
        fit_replay(*fit, **(DIST_FIT | dict(steps=2)), device=DEV)  # warm-up
        torch.cuda.synchronize()
        dispatch.reset_launch_counts()
        tf = time.perf_counter()
        _, losses = fit_replay(*fit, **DIST_FIT, device=DEV)
        torch.cuda.synchronize()
        fit_ms = (time.perf_counter() - tf) * 1e3 / len(losses)
        fit_launches = {k: v for k, v in dispatch.launch_counts().items()
                        if v}
        sd = measure.scene_def("suzanne", DEV)
        seqs = [dispatch.render_color(sd.scene, sd.camera, sd.config, t,
                                      DEV).cpu().numpy() for t in DIST_TIMES]
        r = measure.renderer("suzanne", device=DEV)
        r.draw_frames(2)
        unsharded_ms = measure._ms_per_frame(r, DIST_FRAMES)

        # (a) a group of one over NCCL
        assert not dist.is_initialized()
        rdist.multihost_init()
        mesh = rdist.make_mesh()
        world1, band1, mean1 = _dist_run(mesh, os.path.join(d, "world1.ppm"))
        world1 |= dict(rank=0, backend=mesh.backend,
                       band=list(mesh.band(DIST_SIZE)), band_array=band1,
                       mean_array=mean1)
        dist.destroy_process_group()
        # (b) two processes over gloo on this card
        world2 = _two_ranks(d)

        with open(plain, "rb") as f:
            plain_bytes = f.read()
        checks, report = {}, {}
        for name, runs, ppm in (("world1", [world1], "world1.ppm"),
                                ("world2", world2, "world2.ppm")):
            with open(os.path.join(d, ppm), "rb") as f:
                ppm_equal = f.read() == plain_bytes
            full = np.concatenate([x["band_array"] for x in runs], axis=1)
            # the sample-parallel mean: of the first len(runs) times
            seq = np.mean(seqs[:len(runs)], axis=0)
            checks[name] = dict(
                backend=[x["backend"] for x in runs] == (
                    ["nccl"] if name == "world1" else ["gloo", "gloo"]),
                bands=[x["band"] for x in runs] == (
                    [[0, DIST_SIZE]] if name == "world1"
                    else [[0, DIST_SIZE // 2], [DIST_SIZE // 2,
                                               DIST_SIZE // 2]]),
                cli_rc=all(x["cli_rc"] == 0 for x in runs),
                cli_ppm_byte_equal=ppm_equal,
                cli_launches=all(x["cli"]["launches"] == want_cli
                                 for x in runs),
                wave_spp2_bit_equal=bool(np.array_equal(full, frames)),
                wave_spp2_k4=all(x["wave_spp2"]["launches"].get(
                    "wave_raygen", 0) == 1 for x in runs),
                fit_losses=all(bool(np.allclose(x["losses"], losses,
                                                rtol=2e-5, atol=0))
                               for x in runs),
                fit_k9_twice=all(x["fit"]["launches"].get("tris_record")
                                 == 2 for x in runs),
                sample_2e6=all(float(np.abs(x["mean_array"] - seq).max())
                               <= 2e-6 for x in runs))
            report[name] = dict(
                ranks=len(runs), backend=runs[0]["backend"],
                bands=[x["band"] for x in runs],
                cli_seconds=[x["cli"]["seconds"] for x in runs],
                cli_launches=[x["cli"]["launches"] for x in runs],
                wave_spp2_launches=[x["wave_spp2"]["launches"]
                                    for x in runs],
                fit_launches=[x["fit"]["launches"] for x in runs],
                fit_ms_per_step=[x["fit"]["ms_per_step"] for x in runs],
                fit_loss_rel_max=max(
                    float(np.max(np.abs(np.asarray(x["losses"]) - losses)
                                 / np.asarray(losses))) for x in runs),
                sample_max_abs=max(float(np.abs(x["mean_array"] - seq).max())
                                   for x in runs),
                sharded_ms_per_frame=runs[0]["sharded_ms_per_frame"],
                scaling=runs[0]["scaling"])
    checks["plain"] = dict(cli_rc=rc_plain == 0,
                           cli_launches=plain_launches == want_cli,
                           fit_k9_twice=fit_launches.get("tris_record") == 2)
    ok = all(v for c in checks.values() for v in c.values())
    say(phase="dist", ok=ok, nvidia_smi=nvidia_smi_line(), checks=checks,
        unsharded=dict(ms_per_frame=unsharded_ms, fit_ms_per_step=fit_ms,
                       fit_losses=losses),
        **report, seconds=time.perf_counter() - t0)
    if not ok:
        raise SystemExit(f"dist: a check failed: {checks}")


def phase_golden():
    """tests/golden_tris (the JAX oracle's images): 128x128, 8 frames from
    time 1000 (lucy, dragon: 96x96, 2 frames) under the 0.05 % bound (0.6 %
    where the scene holds a dielectric sphere).  tests/golden (the
    reference renderer's images): 512x512, 100 frames at times 1000, 1010,
    ..., under the 100-frame bounds of tests/test_golden.py.  The tables
    and the bounds' reasons are in rt_torch/goldens.py."""
    results, bounds = {}, {}
    for name, golden in goldens.ORACLE_GOLDENS.items():
        results[name] = goldens.oracle_diff_pct(name, DEV)
        bounds[name] = golden.bound_pct
    results["suzanne through tris_mono"] = goldens.oracle_diff_pct(
        "suzanne", DEV, "mono")
    bounds["suzanne through tris_mono"] = goldens.ORACLE_BOUND_PCT
    for name, (_, bound) in goldens.REFERENCE_BOUNDS.items():
        results[name] = goldens.reference_diff_pct(
            name, goldens.REFERENCE_FRAMES, DEV)
        bounds[name] = bound
    over = {k: v for k, v in results.items() if not v <= bounds[k]}
    say(phase="golden", bound_pct=bounds, diff_pct=results, ok=not over)
    if over:
        raise SystemExit(f"golden: over their bounds: {over}")


def main():
    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    say(phase="device", nvidia_smi=smi, torch=torch.__version__,
        cuda=torch.version.cuda)
    phase_build()
    phase_config5()
    phase_soft_devices()
    phase_app()
    phase_dist()
    probe_records, probe_launches = phase_probes()
    phase_kernels(scenes.scene_suzanne, 128, (2, 1))
    launches = phase_render()
    launches |= phase_train()
    # Suzanne: K3 fuses 2 bounces a launch, and 1 in the last
    records = phase_kernels(scenes.scene_suzanne, KERNEL_SIZE, (2, 1),
                            reps=10)
    records += phase_kernels_new()
    records += phase_kernels_train()
    # dragon, the large-scene branch: 1563 chunks, morton key, 1 bounce a
    # launch.  The plain versions loop over the chunks in Python, a chunk's
    # 32 triangles at once on the card
    records += phase_kernels(scenes.scene_dragon, KERNEL_SIZE, (1,), reps=3)
    records += phase_kernels_record()
    records += probe_records
    launches |= probe_launches
    phase_golden()
    phase_oracle()

    # one entry per kernel: timed where the Suzanne path (K2, K3: 2 fused
    # bounces on the sorted stream after bounce 0) or its own path launches
    # it; max_abs_err over every comparison of that kernel above
    kernels = []
    for r in records:
        if "ms" not in r or any(k["name"] == r["name"] for k in kernels):
            continue
        worst = max(x["max_abs_err"] for x in records
                    if x["name"] == r["name"])
        kernels.append({k: r[k] for k in (
            "name", "route", "source", "replaces", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")}
            | {"max_abs_err": worst, "launches": launches[r["name"]]})
    say(phase="done", seconds=time.perf_counter() - t_start)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dist-worker"]:
        dist_worker(sys.argv[2])
    else:
        main()
