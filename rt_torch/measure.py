"""Measurements of the port on the card, one JSON line each.

    python -m rt_torch.measure tiles [PATH]       # tile-shape sweep
    python -m rt_torch.measure breakdown [PATH]   # where a frame's time goes
    python -m rt_torch.measure fit [FIT]          # ms per record and per step
    python -m rt_torch.measure oracle [PATH]      # ms per frame, oracle
    python -m rt_torch.measure kernels [GROUP]    # ms per launch, K2-K10b
    python -m rt_torch.measure occupancy [PATH]   # live rays, tiles, warps
    python -m rt_torch.measure occupancy lucy_512 # the recorder's work per
                                                  # bounce (or dragon_512)

GROUP is ``wave`` (K2, K3, K10a, K10b), ``frame`` (the whole-frame kernels
K5-K9), ``depth`` (K6 and K7 cut to fewer bounces) or ``all`` (the
default: wave and frame).  PATH names one of the port's render paths
(``PATHS`` below, the table ``chip_smoke.py`` drives too; default
``suzanne``: Suzanne 512x512, 8 bounces, 1 sample per pixel per frame;
``occupancy``: ``sphere_cover``; ``occupancy`` also takes the sorted-stream
recorder's fits ``lucy_512`` and ``dragon_512``), FIT one of its training
paths (``FITS``; default ``suzanne_1080p``).  All run on ``cuda:0`` and fail
without a card.  Every line carries the card's name and power limit as
``nvidia-smi`` reports them.

A wall time is taken over a window of at least ``MIN_WINDOW_S`` seconds that
ends in a synchronise: a path whose frame is a few tens of microseconds is
not read off a few milliseconds.

``kernels`` uses only wrappers that every version of the port has, so it
also runs an older tree's kernels: unpack that tree, copy this file over
its ``rt_torch/measure.py`` and run it there (the paired protocol: parent,
change, change, parent in one call, README).
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from types import SimpleNamespace
from typing import NamedTuple

import torch

from rt_torch.core.sphere import SphereArray
from rt_torch.grad import replay
from rt_torch.grad.params import SphereParams, TriangleParams
from rt_torch.grad.train import fit_replay
from rt_torch.kernels import _build, dispatch, sphere_kernel, tris_kernel
from rt_torch.render.renderer import ProgressiveRenderer
from rt_torch.scene import scenes


class Path(NamedTuple):
    scene_id: int | str  # an id of scenes.SCENE_BY_ID, or a scenes function
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
    # the whole frame in one launch: no stream, no sort
    "suzanne_mono": Path(5, 512, 512, dict(bounces=8, tris_path="mono"),
                         {"tris_mono": 1}, 32),
    # the JAX package's BENCH_CONFIGS config1 and config2 at their own
    # sizes (tools/bench_configs.py): K5 at 16 and 64 samples a pixel
    "rtiow_one_sphere": Path("scene_rtiow_one_sphere", 400, 225,
                             dict(bounces=4, samples_per_frame=16),
                             {"spheres": 1}, 64),
    "rtiow_three_spheres": Path("scene_rtiow_three_spheres", 800, 450,
                                dict(bounces=10, samples_per_frame=64),
                                {"spheres": 1}, 8),
}


class Fit(NamedTuple):
    """A training path: the scene's own render at time 1000 is the target,
    ``wrong`` (row -> albedo) overwrites rows of the albedo table (per
    material for a mesh, per sphere else), and ``fit_replay`` recovers
    them."""
    scene_id: int
    width: int
    height: int
    wrong: dict
    steps: int
    rerecord_every: int
    learning_rate: float
    kernel: str         # the recorder's launch count: one per record


FITS = {
    # the JAX package's BASELINE config 5: Suzanne 1920x1080 at the scene's
    # own bounces, material 0 set to red, 40 steps with one re-record
    "suzanne_1080p": Fit(5, 1920, 1080, {0: (0.8, 0.1, 0.1)}, 40, 20, 5e-2,
                         "tris_record"),
    "sphere_simple": Fit(1, 512, 512, {1: (0.1, 0.9, 0.1),
                                       2: (0.9, 0.2, 0.6)}, 20, 10, 5e-2,
                         "spheres_record"),
    # the large meshes at the scenes' own 512x512 and 5 bounces, the
    # statue's (dragon's) material 0 wrong: the sorted-stream recorder,
    # K10a once and K10b once per later bounce a record
    "lucy_512": Fit(6, 512, 512, {0: (0.9, 0.2, 0.1)}, 20, 10, 5e-2,
                    "wave_record"),
    "dragon_512": Fit(7, 512, 512, {0: (0.2, 0.4, 0.9)}, 20, 10, 5e-2,
                      "wave_record"),
}
MIN_WINDOW_S = 0.3
TILES = [(4, 8), (8, 8), (8, 16), (8, 32), (16, 32), (32, 32)]

# published peaks of one H100 SXM (NVIDIA data sheet): a bound is stated
# against these whatever the card's power limit, which is printed beside it
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12     # dense, tensor cores
# f32 operations of the scan, from the source: Moeller-Trumbore per (ray,
# triangle) = 2 cross (9 each) + 4 dot (5 each) + 1 divide + 3 subtract
# + 3 multiply + 1 add; box test per (ray, chunk or group) = 6 subtract
# + 6 multiply + 12 min/max
FLOPS_PER_PAIR = 46
FLOPS_PER_BOX = 24
# ray-sphere pair (spheres.cu scan_sphere): 3 subtract + 2 dot (5 each)
# + 2*dot + r*r + subtract + b*b + 4a*cc + subtract + sqrt + negate
# + subtract + divide
FLOPS_PER_SPHERE_PAIR = 23
# a hit of the sphere kernels, resolved and scattered: resolve_hit
# (spheres.cu: the point 6, the normal 6, the face test 6, the attenuation
# 6) and scatter's Lambertian arm (rt_device.cuh: 3 RNG floats 6, the
# hemisphere's normalisation 9, its side 6) — the least of the three arms
# (metal adds a reflection and a normalisation, a dielectric ~37-60 of its
# own), so a bound that counts it stays a lower bound
FLOPS_PER_SPHERE_HIT = 45
# one primary ray (rt_device.cuh generate_ray): 5 RNG floats (convert and
# divide), 2 two-vector and 2 four-vector normalisations, uv, make_ray,
# defocus
FLOPS_PER_RAYGEN = 102
# a hit bounce of the replay kernel (replay.cu replay_loss_kernel): the
# known triangle's t and point (cross 9, dot 5, the guards 4, divide 1,
# o - a 3, cross 9, dot 5, multiply 1, the point 6, the face test 6 = 49),
# scatter's Lambertian arm (21, the least of the three arms), the
# attenuation 6 and the gradient's columns carried through it (3 x
# Suzanne's 5 materials, and the bounce's own 6 = 21)
FLOPS_PER_REPLAY_BOUNCE = 97
# a pixel of the replay kernel besides its primary ray: the sky of the
# colour and of the gradient (2 x 15), the loss 11, the colour's
# cotangent 6 and its product with Suzanne's 15 columns
FLOPS_PER_REPLAY_PIXEL = 62
# the epilogue of the probe's Woop intersection per (ray, triangle)
# (probes.cu woop_mma_kernel): reciprocal, negate, 3 multiply, 2 add, u + v,
# 5 compare, select, min
FLOPS_PER_WOOP_PAIR = 15


def bound(counts, nbytes, per_pair=tris_kernel.CHUNK * FLOPS_PER_PAIR,
          extra_flops=0):
    """(bound ms, what bounds it, operations): the larger of ``nbytes``
    over the memory peak and the f32 operations over the f32 peak, the
    operations from a plain version's counts of this run's data ([pairs or
    chunk scans, box tests, ...] per bounce, ``per_pair`` operations a
    scan) plus ``extra_flops``."""
    flops = extra_flops + sum(s * per_pair + b * FLOPS_PER_BOX
                              for s, b, *_ in counts)
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes", flops)


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def scene_def(path: str, device="cuda", **config):
    """The named path's SceneDef at its size, with its config overrides
    and ``config`` set over the scene's own."""
    p = PATHS[path]
    if isinstance(p.scene_id, str):
        sd = getattr(scenes, p.scene_id)(p.width, p.height, device=device)
    else:
        sd = scenes.build_scene(p.scene_id, p.width, p.height, device=device)
    return dataclasses.replace(sd, config=dataclasses.replace(
        sd.config, **{**p.overrides, **config}))


def renderer(path: str, tile=None, device="cuda",
             backend: str = "kernels") -> ProgressiveRenderer:
    """A ProgressiveRenderer of the named path's scene, size and config."""
    return ProgressiveRenderer(
        scene_def(path, device, tile=tile, backend=backend), device=device)


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


def run_oracle(path: str = "suzanne", frames: int = 1) -> dict:
    """Wall ms per frame of the named path's scene, size and config through
    the oracle backend (after one warm-up frame), and the kernel launches it
    made (none)."""
    r = renderer(path, backend="oracle")
    r.set_time(1000)
    r.draw()                                              # warm-up
    r.reset_frame_count()
    torch.cuda.synchronize()
    dispatch.reset_launch_counts()
    t0 = time.perf_counter()
    r.draw_frames(frames)
    image = r.image                       # device -> host: waits for the card
    ms = (time.perf_counter() - t0) * 1e3 / frames
    c = r.config
    return {"path": path, "backend": "oracle", "size": [c.width, c.height],
            "bounces": c.bounces, "frames": frames, "ms_per_frame": ms,
            "image_finite": bool(torch.isfinite(torch.from_numpy(image))
                                 .all()),
            "launches": {k: v for k, v in dispatch.launch_counts().items()
                         if v}}


def oracle(path: str = "suzanne"):
    print(json.dumps({"measure": "oracle", "card": _card()}
                     | run_oracle(path)), flush=True)


def fit_setup(name: str, device="cuda"):
    """(scene with the wrong albedos, camera, config, target image) of the
    named training path."""
    f = FITS[name]
    sd = scenes.build_scene(f.scene_id, f.width, f.height, device=device)
    target = dispatch.render_color(sd.scene, sd.camera, sd.config, 1000,
                                   device)
    field = "mat_albedo" if sd.kind == "triangles" else "albedo"
    albedo = getattr(sd.scene, field).clone()
    for row, rgb in f.wrong.items():
        albedo[row] = albedo.new_tensor(rgb)
    return sd.scene._replace(**{field: albedo}), sd.camera, sd.config, target


def _event_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over ``reps`` calls after one
    warm-up call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def run_fit(name: str = "suzanne_1080p") -> dict:
    """The named training path on the card: the whole ``fit_replay`` by the
    host clock (records included), one record by CUDA events, and the parts
    of one step (row gather, forward, backward) on their own."""
    f = FITS[name]
    (scene, camera, config, target), loss_fn, params, hits = _step_setup(name)
    kw = dict(time=1000, rerecord_every=f.rerecord_every,
              learning_rate=f.learning_rate)
    fit_replay(scene, camera, config, target, steps=2, **kw)    # warm-up

    record_ms = _event_ms(
        lambda: replay.record_hits(scene, camera, config, 1000), 5)
    tris = not isinstance(scene, SphereArray)
    forward_ms = _event_ms(lambda: loss_fn(params), 5)
    step_ms = _event_ms(lambda: loss_fn(params).backward(), 5)
    gather_ms = 0.0
    if tris:
        tab = replay._tris_replay_tables(scene)[0]
        gather_ms = _event_ms(lambda: replay._gather_tri_rows(tab, hits), 5)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launch_counts()
    t0 = time.perf_counter()
    _, losses = fit_replay(scene, camera, config, target, steps=f.steps, **kw)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = dispatch.launch_counts()
    records = launches[f.kernel]
    hit_bytes = hits.numel() * 4
    return {
        "fit": name, "scene_id": f.scene_id, "size": [f.width, f.height],
        "bounces": config.bounces, "steps": f.steps,
        "rerecord_every": f.rerecord_every, "records": records,
        "wall_ms": wall_ms, "ms_per_step_incl_records": wall_ms / f.steps,
        "ms_per_record": record_ms,
        "ms_per_step": (wall_ms - records * record_ms) / f.steps,
        "steps_per_s": f.steps / (wall_ms * 1e-3),
        "forward_ms": forward_ms, "forward_backward_ms": step_ms,
        "row_gather_ms_per_record": gather_ms,
        "hits_bytes": hit_bytes,
        "pre_gathered_rows_bytes": hit_bytes * 13 if tris else 0,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "first_loss": losses[0], "last_loss": losses[-1],
        "losses_finite": all(math.isfinite(v) for v in losses),
        "launches": launches}


def _step_setup(name: str):
    """(``fit_setup``'s tuple, loss function over one record's hits, start
    parameters as leaves, hits) of the named training path."""
    setup = scene, camera, config, target = fit_setup(name)
    _, hits = replay.record_hits(scene, camera, config, 1000)
    loss_fn = replay.replay_loss_fn(scene, camera, config, target, hits, 1000)
    start = (SphereParams if isinstance(scene, SphereArray)
             else TriangleParams).from_scene(scene)
    params = type(start)(*(None if v is None else v.clone().requires_grad_()
                           for v in start))
    return setup, loss_fn, params, hits


def fit(name: str = "suzanne_1080p"):
    """``run_fit``, then one forward + backward step under torch.profiler:
    the device time of its eight dearest operators, and the share of the
    unprofiled step (``forward_backward_ms``) the device sat idle."""
    from torch.profiler import ProfilerActivity, profile

    result = run_fit(name)
    _, loss_fn, params, _ = _step_setup(name)
    loss_fn(params).backward()                            # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        loss_fn(params).backward()
        torch.cuda.synchronize()
    ops = {ev.key: ev.self_device_time_total / 1e3
           for ev in prof.key_averages() if ev.key.startswith("aten::")}
    busy_ms = sum(ops.values())
    top = sorted(ops, key=ops.get, reverse=True)[:8]
    print(json.dumps({"measure": "fit", "card": _card()} | result | {
        "device_busy_ms": busy_ms,
        "device_idle_share": max(
            0.0, 1.0 - busy_ms / result["forward_backward_ms"]),
        "top_operators_ms": {k: ops[k] for k in top}}), flush=True)


def wave_state(make_scene, size: int, device="cuda") -> SimpleNamespace:
    """K2's inputs on one frame of ``make_scene`` at size x size (the
    tables, tile, flags and eye order the scene's wave path gives it), K2's
    output ``first``, and K3's inputs on the sorted stream after bounce 0
    (``pay0``, ``state0``, ``active0``, ``tile_order``) under the path's
    coherence key."""
    sd = make_scene(size, size, device=device)
    kw = dispatch.wave_params(sd.scene, sd.config)
    th, tw = kw["th"], kw["tw"]
    packed = dispatch.pack_scene(sd.scene)
    cam_row = dispatch.pack_camera(sd.camera)
    eye = torch.from_numpy(cam_row[0, 0:3].copy()).to(device)
    order = tris_kernel.chunk_order(packed.centroid, eye)
    times = torch.tensor([1000], dtype=torch.int32, device=device)
    first_kw = dict(height=size, width=size, height_pad=size, width_pad=size,
                    th=th, tw=tw,
                    normalize_defocus_dir=kw["normalize_defocus_dir"])
    first = tris_kernel.wave_first(packed, order, cam_row, times, 0,
                                   kw["flags"], **first_kw)
    payf, state, active, wch = first
    bounds = (tris_kernel.scene_bounds(packed.chunks)
              if kw["key_mode"] == "morton" else None)
    key, perm = torch.sort(
        tris_kernel.stream_key(payf, active, wch, kw["key_mode"], bounds),
        stable=True)
    pay0 = payf[0:9][:, perm].contiguous()
    return SimpleNamespace(
        sd=sd, kw=kw, th=th, tw=tw, flags=kw["flags"], packed=packed,
        cam_row=cam_row, order=order, times=times, first_kw=first_kw,
        first=first, pay0=pay0, state0=state[perm].contiguous(),
        active0=(key != tris_kernel.DEAD_KEY).to(torch.int32),
        tile_order=tris_kernel.tile_chunk_order(packed, pay0, th * tw))


def raygen_state(size: int, device="cuda") -> SimpleNamespace:
    """K3's inputs as the paths of more than one sample per pixel launch
    it first: Suzanne's primary rays from K4 at size x size, every ray
    alive, in pixel order."""
    sd = scenes.scene_suzanne(size, size, device=device)
    kw = dispatch.wave_params(sd.scene, sd.config)
    th, tw = kw["th"], kw["tw"]
    packed = dispatch.pack_scene(sd.scene)
    times = torch.tensor([1000], dtype=torch.int32, device=device)
    od, _, state = tris_kernel.wave_raygen(
        dispatch.pack_camera(sd.camera), times, 0, height=size, width=size,
        height_pad=size, width_pad=size, th=th, tw=tw,
        normalize_defocus_dir=kw["normalize_defocus_dir"])
    pay0 = torch.cat([od, torch.ones_like(od[0:3])])
    return SimpleNamespace(
        sd=sd, th=th, tw=tw, flags=kw["flags"], packed=packed, pay0=pay0,
        state0=state, active0=torch.ones_like(state),
        tile_order=tris_kernel.tile_chunk_order(packed, pay0, th * tw))


def _bounce_ms(st, n_bounces: int, reps: int):
    """Mean ms of one K3 launch from ``st``'s stream state, each launch on
    a fresh copy (the kernel updates in place)."""
    bufs = iter([(st.pay0.clone(), st.state0.clone(), st.active0.clone())
                 for _ in range(reps + 1)])
    return _event_ms(lambda: tris_kernel.wave_bounce(
        st.packed, st.tile_order, *next(bufs), st.flags, n_bounces=n_bounces,
        th=st.th, tw=st.tw), reps)


def _wave_ms(make_scene, size: int, bounces_fused, reps: int) -> dict:
    """ms of K2 and of K3 at each fused count on ``wave_state``'s stream."""
    st = wave_state(make_scene, size)
    out = {"K2": _event_ms(lambda: tris_kernel.wave_first(
        st.packed, st.order, st.cam_row, st.times, 0, st.flags,
        **st.first_kw), reps)}
    for nb in bounces_fused:
        out[f"K3 b{nb}"] = _bounce_ms(st, nb, reps)
    return out


def _mono_ms(width: int, height: int, bounces: int, record_: bool,
             reps: int) -> float:
    """K7 (K9 with ``record_``) on Suzanne at the default tile: the
    profiler's device time."""
    sd = scenes.scene_suzanne(width, height, device="cuda")
    packed = dispatch.pack_scene(sd.scene)
    th, tw = dispatch.DEFAULT_TILE
    kw = dict(height=height, width=width, height_pad=height, width_pad=width,
              bounces=bounces, normalize_defocus_dir=True,
              flags=dispatch.trace_flags(sd.config), th=th, tw=tw)
    fn = (tris_kernel.render_color_tris_record if record_
          else tris_kernel.render_color_tris)
    cam_row = dispatch.pack_camera(sd.camera)
    return _profiled_ms(lambda: fn(packed, cam_row, 1000, **kw), reps,
                        "tris_mono_kernel")


def record_state(make_scene, size: int, device="cuda") -> SimpleNamespace:
    """K10a's inputs on one frame of ``make_scene`` at size x size, over the
    tables the recorder packs (no split_big) and the eye's order, K10a's
    output ``first``, and K10b's inputs on the morton-sorted stream after
    bounce 0."""
    sd = make_scene(size, size, device=device)
    th, tw = dispatch.DEFAULT_TILE
    flags = dispatch.trace_flags(sd.config)
    packed = tris_kernel.pack_tri_table(sd.scene)
    cam_row = dispatch.pack_camera(sd.camera)
    order = tris_kernel.eye_chunk_order(packed, cam_row)
    times = torch.tensor([1000], dtype=torch.int32, device=device)
    first_kw = dict(height=size, width=size, height_pad=size, width_pad=size,
                    th=th, tw=tw, track_idx=True,
                    normalize_defocus_dir=sd.config.normalize_defocus_dir)
    first = tris_kernel.wave_first(packed, order, cam_row, times, 0, flags,
                                   **first_kw)
    payf, state, active, _, _ = first
    key, perm = torch.sort(tris_kernel.ray_sort_key(
        payf, active, *tris_kernel.scene_bounds(packed.chunks)), stable=True)
    pay0 = payf[0:9][:, perm].contiguous()
    return SimpleNamespace(
        sd=sd, th=th, tw=tw, flags=flags, packed=packed, cam_row=cam_row,
        order=order, times=times, first_kw=first_kw, first=first, pay0=pay0,
        state0=state[perm].contiguous(),
        active0=(key != tris_kernel.DEAD_KEY).to(torch.int32),
        tile_order=tris_kernel.tile_chunk_order(packed, pay0, th * tw))


def _record_first_ms(make_scene, size: int, reps: int) -> float:
    """K10a by events (``record_state``), as the rows before the profiler's
    reads of a record (``_recorder_ms``) were taken."""
    st = record_state(make_scene, size)
    return _event_ms(lambda: tris_kernel.wave_first(
        st.packed, st.order, st.cam_row, st.times, 0, st.flags,
        **st.first_kw), reps)


def _recorder_ms(make_scene, size: int, reps: int) -> dict:
    """K10a and each K10b launch of the recorder's own record (one frame at
    size x size, the scene's bounces) as the glue launches them, from the
    profiler's device time of each kernel over ``reps`` records, and the
    K10b launches' sum."""
    from torch.profiler import ProfilerActivity

    st = record_state(make_scene, size)
    cfg = st.sd.config
    kw = dict(height=size, width=size, height_pad=size, width_pad=size,
              bounces=cfg.bounces, flags=st.flags, th=st.th, tw=st.tw,
              normalize_defocus_dir=cfg.normalize_defocus_dir)

    def run():
        return tris_kernel.render_color_tris_wave_record(
            st.packed, st.cam_row, 1000, **kw)

    per = cfg.bounces - 1
    first, bounce = [], []
    for prof in _record_profiles(run, reps, per, (ProfilerActivity.CUDA,)):
        kernels = _device_events(prof, ("wave_first_kernel",
                                        "wave_bounce_kernel"))
        first += [ms for name, ms in kernels if "wave_first_kernel" in name]
        bounce.append([ms for name, ms in kernels
                       if "wave_bounce_kernel" in name])
    out = {"K10a (record)": sum(first) / reps}
    for b in range(per):
        out[f"K10b b{b + 1} (record)"] = sum(r[b] for r in bounce) / reps
    out["K10b sum (record)"] = sum(map(sum, bounce)) / reps
    return out


def _device_events(prof, names):
    """The profiled kernels whose name holds one of ``names``, in launch
    order: [(name, device ms)]."""
    evs = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and any(k in e.name for k in names)]
    evs.sort(key=lambda e: e.time_range.start)
    return [(e.name, e.time_range.elapsed_us() / 1e3) for e in evs]


def _record_profiles(run, reps: int, bounces: int, activities):
    """torch.profiler sessions of ``reps`` calls of ``run`` (a wave record
    of 1 + ``bounces`` launches), one call a session, after one unprofiled;
    a session whose K10a and K10b launches the profiler did not all see is
    run again (up to ``reps`` times in all)."""
    from torch.profiler import profile

    run()
    torch.cuda.synchronize()
    out, retries = [], 0
    while len(out) < reps:
        with profile(activities=list(activities)) as prof:
            run()
            torch.cuda.synchronize()
        kernels = _device_events(prof, ("wave_first_kernel",
                                        "wave_bounce_kernel"))
        if len(kernels) == 1 + bounces:
            out.append(prof)
        elif retries == reps:
            raise SystemExit(f"profiler saw {len(kernels)} of the "
                             f"{1 + bounces} launches of a record, "
                             f"{retries} times")
        else:
            retries += 1
    return out


PROFILE_SESSIONS = 4


def _profiled_ms(fn, reps: int, kernel: str, prepare=None) -> float:
    """Mean device ms of one launch of the kernel whose name holds
    ``kernel``, from torch.profiler over ``reps`` calls of fn after one:
    the kernel alone, without the wrapper's work on the host or the card.
    The profiler now and then misses a launch of a session; such a session
    is run again, up to ``PROFILE_SESSIONS`` sessions in all, and if none
    saw every launch the calls are timed by CUDA events instead (the
    wrapper's own work on the card included; said on stderr).  ``prepare``
    (if given) runs before the first call and before each session, outside
    it: fresh inputs for a kernel that updates its own in place."""
    from torch.profiler import ProfilerActivity, profile

    prepare = prepare or (lambda: None)
    prepare()
    fn()
    for session in range(PROFILE_SESSIONS):
        prepare()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        hits = [ev for ev in prof.key_averages() if kernel in ev.key]
        count = sum(ev.count for ev in hits)
        if count == reps:
            return sum(ev.self_device_time_total for ev in hits) / count / 1e3
        print(f"profiler saw {count} launches of {kernel} in session "
              f"{session + 1}, expected {reps}", file=sys.stderr)
    print(f"{kernel}: timed by CUDA events", file=sys.stderr)
    prepare()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _graph_ms(fn, reps: int) -> float:
    """Mean device ms of one fn() from a CUDA graph of ``reps`` calls,
    replayed three times after one (``chip_smoke.py`` reads the kernels of
    some tens of microseconds so: the launches run back to back)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    return _event_ms(graph.replay, 3) / reps


def raygen_args(size: int = 512, device="cuda") -> SimpleNamespace:
    """K4's arguments as ``chip_smoke.py`` gives them: Suzanne's camera at
    size x size, one frame at time 1000, the default tile (which the
    kernel's own grid ignores)."""
    sd = scenes.scene_suzanne(size, size, device=device)
    th, tw = dispatch.DEFAULT_TILE
    times = torch.tensor([1000], dtype=torch.int32, device=device)
    kw = dict(height=size, width=size, height_pad=size, width_pad=size,
              th=th, tw=tw,
              normalize_defocus_dir=sd.config.normalize_defocus_dir)
    return SimpleNamespace(sd=sd, cam_row=dispatch.pack_camera(sd.camera),
                           times=times, kw=kw)


def raygen_bound(n: int):
    """(bound ms, what bounds it, operations) of K4 on n pixels: the 8
    planes it writes, the camera row and a time read once, and the
    FLOPS_PER_RAYGEN operations of each primary ray."""
    return bound([], 20 * 4 + 4 + 8 * n * 4, extra_flops=n * FLOPS_PER_RAYGEN)


def empty_ms(blocks: int, threads: int, reps: int = 50) -> float:
    """Device ms of an empty kernel on a grid of ``blocks`` x ``threads``
    from a CUDA graph (``_graph_ms``): the fixed cost of such a launch."""
    lib = _build.load()

    def launch():
        _build.check(lib, lib.rt_empty(
            blocks, threads, torch.cuda.current_stream().cuda_stream),
            "empty")
    return _graph_ms(launch, reps)


def sphere_frame_args(path: str, device="cuda", **config):
    """(packed tables, camera row, keyword arguments) of one frame of the
    named sphere path's kernel at the default tile, the frame padded to
    it as the dispatch pads it; ``config`` set over the path's."""
    sd = scene_def(path, device, tile=dispatch.DEFAULT_TILE, **config)
    cfg = sd.config
    packed = dispatch.pack_scene(sd.scene, cfg)
    kw = dict(bounces=cfg.bounces, spp=cfg.samples_per_frame,
              normalize_defocus_dir=cfg.normalize_defocus_dir,
              flags=dispatch.trace_flags(cfg), **dispatch.frame_geometry(cfg))
    return packed, dispatch.pack_camera(sd.camera), kw


def _sphere_ms(path: str, reps: int, bounces: int | None = None) -> float:
    """K5 (a CUDA graph), K6 (the profiler's device time) or, with path
    ``"record"``, K8 (a graph) on the named sphere path's frame at the
    default tile."""
    record_ = path == "record"
    packed, cam_row, kw = sphere_frame_args(
        "sphere_simple" if record_ else path,
        **({"bounces": bounces} if bounces else {}))
    if record_:
        kw.pop("spp")
        return _graph_ms(lambda: sphere_kernel.render_color_spheres_record(
            packed.tab, packed.kinds, cam_row, 1000, n_spheres=packed.n,
            **kw), reps)
    if packed.chunks is None:
        return _graph_ms(lambda: sphere_kernel.render_color_spheres(
            packed.tab, packed.kinds, cam_row, 1000, n_spheres=packed.n,
            **kw), reps)
    return _profiled_ms(lambda: sphere_kernel.render_color_spheres_chunked(
        packed, cam_row, 1000, **kw), reps, "spheres_chunked_kernel")


KERNEL_GROUPS = ("all", "wave", "frame", "depth")


def kernels(group: str = "all", reps: int = 20):
    """ms per launch of the hand-written render and record kernels over
    ``reps`` launches after one, at ``chip_smoke.py``'s shapes: by CUDA
    events around the wrappers (K2, K3, K10a), from a CUDA graph of 50
    (K5, K8), or the profiler's device time of the kernel (K6, K7, K9: an
    older wrapper of theirs waits on a copy to the card).  ``wave``: K2 and
    K3 (2 and 1 fused bounces) on Suzanne 128x128 and 512x512, K3 (2
    bounces) on K4's primary rays, K2 and K3 (1 bounce) on dragon 512x512,
    K10a on lucy and dragon 512x512, and the profiler's device time of
    K10a and of each K10b launch of a whole record there
    (``_recorder_ms``).  ``frame``: K5 on
    sphere_simple 512x512 b10 and on the rtiow paths (400x225 spp 16 b4,
    800x450 spp 64 b10, padded to the tile), K8 on sphere_simple 512x512
    b10, K6 on cover 1280x720 b10, K7 on
    Suzanne 512x512 b8, K9 on Suzanne 1920x1080 b5.  Also each kernel's
    registers and shared memory from the build."""
    card = _card()
    ms = {}
    if group in ("all", "wave"):
        for name, make, size, fused in (
                ("suzanne 128", scenes.scene_suzanne, 128, (2, 1)),
                ("suzanne 512", scenes.scene_suzanne, 512, (2, 1)),
                ("dragon 512", scenes.scene_dragon, 512, (1,))):
            for k, v in _wave_ms(make, size, fused, reps).items():
                ms[f"{k} {name}"] = v
        ms["K3 b2 suzanne 512 from K4"] = _bounce_ms(raygen_state(512), 2,
                                                     reps)
        for name, make in (("lucy 512", scenes.scene_lucy),
                           ("dragon 512", scenes.scene_dragon)):
            ms[f"K10a {name}"] = _record_first_ms(make, 512, reps)
            for k, v in _recorder_ms(make, 512, reps).items():
                ms[f"{k} {name}"] = v
    if group == "depth":
        # the marginal cost of a bounce: K6 and K7 cut to fewer bounces
        for b in (1, 2, 4, 10):
            ms[f"K6 cover 1280x720 b{b}"] = _sphere_ms("sphere_cover", reps,
                                                       bounces=b)
        for b in (1, 2, 4, 8):
            ms[f"K7 suzanne 512 b{b}"] = _mono_ms(512, 512, b, False, reps)
    if group in ("all", "frame"):
        ms["K5 sphere_simple 512 b10"] = _sphere_ms("sphere_simple", 50)
        ms["K5 rtiow_one_sphere 400x225 spp16 b4"] = _sphere_ms(
            "rtiow_one_sphere", 20)
        ms["K5 rtiow_three_spheres 800x450 spp64 b10"] = _sphere_ms(
            "rtiow_three_spheres", 5)
        ms["K8 sphere_simple 512 b10"] = _sphere_ms("record", 50)
        ms["K6 cover 1280x720 b10"] = _sphere_ms("sphere_cover", reps)
        ms["K7 suzanne 512 b8"] = _mono_ms(512, 512, 8, False, reps)
        ms["K9 suzanne 1920x1080 b5"] = _mono_ms(1920, 1080, 5, True,
                                                 max(2, reps // 4))
    lib = _build.load()
    print(json.dumps({
        "measure": "kernels", "card": card, "group": group, "reps": reps,
        "ms_per_launch": ms,
        "ptxas": _build.ptxas_usage(lib.build_log)}), flush=True)


def _occupancy_counts(active, scans: int) -> dict:
    """Lane occupancy of one bounce from the carry's ``active`` plane
    (n_tiles, th*tw) in tile order: what a kernel with one thread a ray and
    32 rays a warp holds, and what it would hold with each tile's live rays
    packed into its first warps; ``scans`` pairs of this bounce."""
    alive = active > 0
    n_tiles, tile = alive.shape
    live = alive.sum(dim=1)
    warps = alive.reshape(n_tiles, tile // 32, 32).any(dim=2).sum()
    packed = ((live + 31) // 32).sum()
    n = alive.numel()
    return {"live_rays": int(live.sum()) / n,
            "tiles_with_live": int((live > 0).sum()) / n_tiles,
            "warps_with_live": int(warps) / (n // 32),
            "packed_warps": int(packed) / (n // 32),
            "lanes_per_live_warp": int(live.sum()) / max(1, int(warps)),
            "pairs_per_pixel": scans / n}


def _group_counts(packed, carry) -> dict:
    """What the wave kernels' group test leaves of one bounce's box tests
    (``tris_kernel.group_box_tests``): per live ray, the group boxes tested
    and entered and the chunk boxes still tested."""
    _, o, d, _, active = carry
    tested, entered, chunk_tests = tris_kernel.group_box_tests(
        packed, o, d, active > 0)
    live = max(1, int((active > 0).sum()))
    return {"groups_tested": tested / live,
            "groups_entered_per_live_ray": entered / live,
            "chunk_tests_per_live_ray": chunk_tests / live}


def _record_occupancy(name: str, device="cuda"):
    """Per bounce of one record of the named fit (the sorted-stream
    recorder, ``render_color_tris_wave_record``, through the plain versions
    on the card, at the fit's size and tile, over the recorder's tables):
    the tiles with a live ray, per such tile the chunks some live ray
    enters at t >= 0 (the kernel's candidates: staged and voted on) and the
    chunks it scans, the heaviest tile's scans, the box tests' share of the
    box and pair operations (24 and 46 each) without the group boxes
    (every ray of a tile with a live ray against every chunk) and with
    them, and what the group boxes leave of the box tests
    (``_group_counts``); and the launch's bound as ``chip_smoke.py``
    computes it (``bound``: these counts, with the group boxes, plus K10a's
    raygen; the bytes of the tables, the visit orders and the planes read
    and written once)."""
    scene, camera, config, _ = fit_setup(name, device)
    geo = dispatch.frame_geometry(config)
    packed = tris_kernel.pack_tri_table(scene)
    table_bytes = sum(t.numel() * 4 for t in (packed.tab, packed.mats,
                                              packed.chunks, packed.groups)
                      if t is not None)
    rows = []
    plain = tris_kernel.trace_bounce

    def counted(packed_, order, carry, flags, **kw):
        kw.pop("scan_counts", None)
        counts = []
        out = plain(packed_, order, carry, flags, scan_counts=counts, **kw)
        (scans, boxes, visits, cand, tile_scans, heaviest,
         every_box) = counts[0]
        tiles = visits // packed_.n_chunks
        pair_ops = scans * tris_kernel.CHUNK * FLOPS_PER_PAIR
        rays = carry[4].numel()
        first = not rows
        # K10a: one visit order, raygen, 14 words a ray written; K10b: a
        # visit order a tile launched, 11 words a ray read and 13 written
        nbytes = table_bytes + 4 * (
            packed_.n_chunks + 14 * rays if first
            else carry[4].shape[0] * packed_.n_chunks + 24 * rays)
        ms, by, _ = bound(counts, nbytes, extra_flops=(
            rays * FLOPS_PER_RAYGEN if first else 0))
        row = {"live_tiles": tiles, "tiles": carry[4].shape[0],
               "live_rays": int((carry[4] > 0).sum()),
               "candidates_per_live_tile": cand / max(1, tiles),
               "scans_per_live_tile": tile_scans / max(1, tiles),
               "heaviest_tile_scans": heaviest,
               "ray_chunk_scans": scans, "box_tests": every_box,
               "box_share": every_box * FLOPS_PER_BOX / max(
                   1, every_box * FLOPS_PER_BOX + pair_ops),
               "bound_ms": ms, "bound_by": by}
        if packed_.groups is not None:
            row |= _group_counts(packed_, carry)
            row["box_tests_with_groups"] = boxes
            row["box_share_with_groups"] = boxes * FLOPS_PER_BOX / max(
                1, boxes * FLOPS_PER_BOX + pair_ops)
        rows.append(row)
        return out

    saved = (tris_kernel.trace_bounce, tris_kernel.wave_first,
             tris_kernel.wave_bounce)
    tris_kernel.trace_bounce = counted
    tris_kernel.wave_first = tris_kernel.wave_first_plain
    tris_kernel.wave_bounce = tris_kernel.wave_bounce_plain
    try:
        tris_kernel.render_color_tris_wave_record(
            packed, dispatch.pack_camera(camera), 1000,
            bounces=config.bounces, flags=dispatch.trace_flags(config),
            normalize_defocus_dir=config.normalize_defocus_dir,
            sky_from_final_dir=config.sky_from_final_dir, **geo)
    finally:
        (tris_kernel.trace_bounce, tris_kernel.wave_first,
         tris_kernel.wave_bounce) = saved
    print(json.dumps({
        "measure": "occupancy", "fit": name, "card": _card(),
        "size": [config.width, config.height],
        "tile": [geo["th"], geo["tw"]], "n_chunks": packed.n_chunks,
        "bounces": rows}), flush=True)


def _flat_occupancy(path: str, device="cuda"):
    """The flat sphere kernel's lanes on one frame of the named path
    (``sphere_schedule``, from its plain version at the path's size and
    samples): segments (a bounce's scan, and the hit's resolve and
    scatter) a sample per pixel, mean and most, and their histogram; the
    warp turns and lane efficiency of a thread a pixel of an 8x16 tile
    with the samples in step (``tile_schedule``) and with each lane's
    samples back to back in one loop (``merged_schedule``), the factor of
    fewer turns that gives, and the factor that a schedule without idle
    lanes would reach at best."""
    from rt_torch.kernels import sphere_schedule

    card = _card()
    packed, cam_row, kw = sphere_frame_args(path, device)
    scans = sphere_schedule.sample_scans(
        packed.tab, packed.kinds, cam_row, 1000, n_spheres=packed.n,
        **kw).cpu()
    th, tw = kw["th"], kw["tw"]
    tile = sphere_schedule.tile_schedule(scans, th, tw)
    merged = sphere_schedule.merged_schedule(scans, th, tw)
    print(json.dumps({
        "measure": "occupancy", "path": path, "card": card,
        "size": [kw["width"], kw["height"]],
        "padded": [kw["width_pad"], kw["height_pad"]], "spp": kw["spp"],
        "bounces": kw["bounces"], "n_spheres": packed.n,
        "segments_per_sample": {
            "mean": float(scans.float().mean()), "most": int(scans.max()),
            "histogram": torch.bincount(scans.reshape(-1).long()).tolist()},
        "tile": [th, tw], "tile_schedule": tile,
        "merged_schedule": merged,
        "merged_fewer_turns": tile["warp_turns"] / merged["warp_turns"],
        "fewer_turns_at_best": 1 / tile["lane_efficiency"]}), flush=True)


def occupancy(path: str = "sphere_cover", device="cuda"):
    """Per bounce of one frame of the named path (its whole-frame kernel's
    plain version, at the path's size and the default tile): the share of
    rays alive, of tiles with a live ray and of warps with a live lane,
    the warps the live rays would fill packed, and the (ray, primitive)
    pairs a pixel; then the pairs weighted by one over the lane occupancy,
    as the warps issue them with a thread a ray, unpacked and packed,
    against the pairs.  A fit of the sorted-stream recorder (``lucy_512``,
    ``dragon_512``) gives ``_record_occupancy``'s counts instead."""
    if path not in PATHS:
        if FITS[path].kernel != "wave_record":
            raise SystemExit(f"occupancy: {path} does not record through "
                             "the sorted stream (lucy_512, dragon_512)")
        return _record_occupancy(path, device)
    p = PATHS[path]
    which = set(p.launches)
    if which == {"spheres"}:
        return _flat_occupancy(path, device)
    if which not in ({"spheres_chunked"}, {"tris_mono"}):
        raise SystemExit(f"occupancy: {path} runs no whole-frame kernel "
                         "(sphere_simple, rtiow_one_sphere, "
                         "rtiow_three_spheres, sphere_cover, suzanne_mono)")
    card = _card()
    r = renderer(path, device=device)
    cfg = r.config
    th, tw = dispatch.DEFAULT_TILE
    geometry = dispatch.frame_geometry(dataclasses.replace(
        cfg, tile=(th, tw)))
    kw = dict(bounces=cfg.bounces, spp=1, flags=dispatch.trace_flags(cfg),
              normalize_defocus_dir=cfg.normalize_defocus_dir,
              sky_from_final_dir=cfg.sky_from_final_dir, **geometry)
    cam_row = dispatch.pack_camera(r.scene_def.camera)
    packed = dispatch.pack_scene(r.scene_def.scene, cfg)
    module, name = ((sphere_kernel, "sphere_bounce_chunked")
                    if which == {"spheres_chunked"}
                    else (tris_kernel, "trace_bounce"))
    per_pair = 1 if module is sphere_kernel else tris_kernel.CHUNK
    bounce = getattr(module, name)
    rows = []

    def counted(packed_, order, carry, flags, **kw_):
        kw_.pop("scan_counts", None)
        counts = []
        out = bounce(packed_, order, carry, flags, scan_counts=counts, **kw_)
        rows.append(_occupancy_counts(carry[4], counts[0][0] * per_pair))
        return out

    setattr(module, name, counted)
    try:
        if module is sphere_kernel:
            sphere_kernel.render_color_spheres_chunked_plain(
                packed, cam_row, 1000, **kw)
        else:
            tris_kernel.render_color_tris_plain(packed, cam_row, 1000, **kw)
    finally:
        setattr(module, name, bounce)
    pairs = sum(b["pairs_per_pixel"] for b in rows)
    unpacked = sum(b["pairs_per_pixel"] * b["warps_with_live"]
                   / b["live_rays"] for b in rows if b["live_rays"])
    packed_ = sum(b["pairs_per_pixel"] * b["packed_warps"] / b["live_rays"]
                  for b in rows if b["live_rays"])
    print(json.dumps({
        "measure": "occupancy", "path": path, "card": card,
        "size": [cfg.width, cfg.height], "tile": [th, tw],
        "bounces": rows, "pairs_per_pixel": pairs,
        "issued_over_pairs_unpacked": unpacked / pairs,
        "issued_over_pairs_packed": packed_ / pairs}), flush=True)


_GROUPS = (
    ("kernel_wave_first", ("wave_first_kernel",)),
    ("kernel_wave_bounce", ("wave_bounce_kernel",)),
    ("kernel_wave_raygen", ("wave_raygen_kernel",)),
    ("kernel_spheres", ("spheres_kernel",)),
    ("kernel_spheres_chunked", ("spheres_chunked_kernel",)),
    ("kernel_tris_mono", ("tris_mono_kernel",)),
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
    what = {"tiles": tiles, "breakdown": breakdown, "fit": fit,
            "oracle": oracle, "kernels": kernels, "occupancy": occupancy}
    names = (FITS if argv[:1] == ["fit"]
             else KERNEL_GROUPS if argv[:1] == ["kernels"]
             else {**PATHS, **FITS} if argv[:1] == ["occupancy"] else PATHS)
    if (len(argv) not in (1, 2) or argv[0] not in what
            or (len(argv) == 2 and argv[1] not in names)):
        print(__doc__, file=sys.stderr)
        print(f"paths: {', '.join(PATHS)}; fits: {', '.join(FITS)}",
              file=sys.stderr)
        return 2
    what[argv[0]](*argv[1:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
