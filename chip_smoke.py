#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written kernels from rt_torch/kernels/csrc, holds each
against its plain PyTorch version on the card, drives the port's main path
(Suzanne, 512x512, 8 bounces, 1 sample per pixel per progressive frame)
through ``scene_suzanne -> ProgressiveRenderer -> draw_frames``, and checks
the quad, cube and suzanne goldens.  Every phase prints one JSON line; any
failure raises, so the exit code is non-zero and no result line is printed.
Needs no network and starts no process that outlives it.

Tolerance of kernel against plain version: none.  The kernels are compiled
with -fmad=false and use IEEE division and square root, so every output
element must be bit-equal (max_abs_err 0, no ray differs).
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: torch.cuda.is_available() is False; this script "
             "needs one CUDA device")

import numpy as np  # noqa: E402

from rt_torch.kernels import _build, dispatch, tris_kernel  # noqa: E402
from rt_torch.render.ppm import compare_ppm, render_ppm  # noqa: E402
from rt_torch.render.renderer import ProgressiveRenderer  # noqa: E402
from rt_torch.scene import scenes  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
DEV = torch.device("cuda", 0)

# published peaks of one H100 SXM (NVIDIA data sheet): the bound is stated
# against these whatever the card's power limit, which is printed beside it
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# f32 operations of the scan, from the source: Moeller-Trumbore per (ray,
# triangle) = 2 cross (9 each) + 4 dot (5 each) + 1 divide + 3 subtract
# + 3 multiply + 1 add; box test per (ray, chunk) = 6 subtract + 6 multiply
# + 12 min/max
FLOPS_PER_PAIR = 46
FLOPS_PER_BOX = 24

RENDER_SIZE, RENDER_BOUNCES, RENDER_FRAMES = 512, 8, 32
GOLDEN_BOUND_PCT = 0.05


def say(**kw):
    print(json.dumps(kw), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def phase_build():
    t0 = time.perf_counter()
    lib = _build.load()
    dt = time.perf_counter() - t0
    usage = [ln.strip() for ln in lib.build_log.splitlines()
             if "registers" in ln or "Compiling entry" in ln
             or "spill" in ln]
    say(phase="build", seconds=round(dt, 2), ptxas=usage)


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


def _bound(counts, nbytes):
    flops = sum(s * tris_kernel.CHUNK * FLOPS_PER_PAIR + b * FLOPS_PER_BOX
                for s, b in counts)
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes", flops)


def compare_kernels(size: int, bounces_fused=(2, 1), reps: int = 0):
    """K2 and K3 against their plain versions on Suzanne at size x size, at
    the tile shape and in the stream state the main path gives them.  With
    reps > 0 also times them.  Returns one record per kernel."""
    sd = scenes.scene_suzanne(size, size, device=DEV)
    kw = dispatch.wave_params(sd.scene, sd.config)
    th, tw, flags = kw["th"], kw["tw"], kw["flags"]
    packed = dispatch.pack_scene(sd.scene)
    cam_row = dispatch.pack_camera(sd.camera)
    eye = torch.from_numpy(cam_row[0, 0:3].copy()).to(DEV)
    order = tris_kernel.chunk_order(packed.centroid, eye)
    times = torch.tensor([1000], dtype=torch.int32, device=DEV)
    first_kw = dict(height=size, width=size, height_pad=size, width_pad=size,
                    th=th, tw=tw,
                    normalize_defocus_dir=kw["normalize_defocus_dir"])
    table_bytes = sum(t.numel() * 4 for t in
                      (packed.tab, packed.mats, packed.chunks))
    n = size * size
    records = []

    # ---- K2 ----
    k_out = tris_kernel.wave_first(packed, order, cam_row, times, 0, flags,
                                   **first_kw)
    torch.cuda.synchronize()
    counts = []
    t0 = time.perf_counter()
    p_out = tris_kernel.wave_first_plain(packed, order, cam_row, times, 0,
                                         flags, scan_counts=counts,
                                         **first_kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err, frac = _diff(k_out, p_out)
    rec = dict(name="wave_first", route="cuda",
               source="rt_torch/kernels/csrc/tris_wave.cu",
               replaces="rt/kernels/tris_kernel.py:583", size=size,
               tile=[th, tw], max_abs_err=err, rays_differ=frac,
               plain_ms=plain_ms, library_ms=None)
    if reps:
        rec["ms"] = _timed(lambda i: tris_kernel.wave_first(
            packed, order, cam_row, times, 0, flags, **first_kw), reps)
        nbytes = table_bytes + order.numel() * 4 + 13 * n * 4
        rec["bound_ms"], rec["bound_by"], rec["flops"] = _bound(counts,
                                                                nbytes)
    records.append(rec)

    # ---- K3 on the sorted stream after bounce 0 ----
    payf, state, active, wch = k_out
    key, perm = torch.sort(tris_kernel.stream_key(payf, active, wch),
                           stable=True)
    pay0 = payf[0:9][:, perm].contiguous()
    state0 = state[perm].contiguous()
    active0 = (key != tris_kernel.DEAD_KEY).to(torch.int32)
    tile = th * tw
    mo = pay0[0:3].reshape(3, n // tile, tile).mean(dim=2)
    tile_order = tris_kernel.chunk_order(packed.centroid, mo.T).reshape(-1)

    for nb in bounces_fused:
        def fresh():
            return pay0.clone(), state0.clone(), active0.clone()

        kp, ks, ka = fresh()
        kw_ = tris_kernel.wave_bounce(packed, tile_order, kp, ks, ka, flags,
                                      n_bounces=nb, th=th, tw=tw)
        torch.cuda.synchronize()
        pp, ps, pa = fresh()
        counts = []
        t0 = time.perf_counter()
        pw = tris_kernel.wave_bounce_plain(packed, tile_order, pp, ps, pa,
                                           flags, n_bounces=nb, th=th, tw=tw,
                                           scan_counts=counts)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err, frac = _diff((kp, ks, ka, kw_), (pp, ps, pa, pw))
        rec = dict(name="wave_bounce", route="cuda",
                   source="rt_torch/kernels/csrc/tris_wave.cu",
                   replaces="rt/kernels/tris_kernel.py:657", size=size,
                   tile=[th, tw], n_bounces=nb, max_abs_err=err,
                   rays_differ=frac, plain_ms=plain_ms, library_ms=None)
        if reps:
            bufs = [fresh() for _ in range(reps)]
            rec["ms"] = _timed(lambda i: tris_kernel.wave_bounce(
                packed, tile_order, *bufs[i], flags, n_bounces=nb, th=th,
                tw=tw), reps)
            nbytes = table_bytes + tile_order.numel() * 4 + (11 + 12) * n * 4
            rec["bound_ms"], rec["bound_by"], rec["flops"] = _bound(counts,
                                                                    nbytes)
        records.append(rec)
    return records


def phase_kernels(size: int, reps: int = 0):
    records = compare_kernels(size, reps=reps)
    say(phase="kernels", kernels=["wave_first", "wave_bounce"], size=size,
        limit="bit-equal: max_abs_err 0 and rays_differ 0", results=records)
    for r in records:
        if r["max_abs_err"] != 0.0 or r["rays_differ"] != 0.0:
            raise SystemExit(f"kernel {r['name']} disagrees with its plain "
                             f"version: {r}")
    return records


def phase_render():
    """The main path, through the entry points a user calls."""
    sd = scenes.scene_suzanne(RENDER_SIZE, RENDER_SIZE, device=DEV)
    sd = dataclasses.replace(sd, config=dataclasses.replace(
        sd.config, bounces=RENDER_BOUNCES))
    r = ProgressiveRenderer(sd, device=DEV)
    r.set_time(1000)
    r.draw_frames(2)                      # warm-up: allocator, first launch
    r.reset_frame_count()
    r.set_time(1000)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in tris_kernel.LAUNCHES:
        tris_kernel.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    r.draw_frames(RENDER_FRAMES, 10)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(tris_kernel.LAUNCHES)
    image = r.image
    ok = (image.shape == (RENDER_SIZE, RENDER_SIZE, 3)
          and bool(np.isfinite(image).all())
          and float(image.max() - image.min()) > 0.05
          and r.frame_count == RENDER_FRAMES)
    segs = RENDER_SIZE * RENDER_SIZE * RENDER_BOUNCES * RENDER_FRAMES
    say(phase="render", scene="suzanne", size=RENDER_SIZE,
        bounces=RENDER_BOUNCES, frames=RENDER_FRAMES, seconds=dt,
        frames_per_s=RENDER_FRAMES / dt, ray_segments_per_s=segs / dt,
        ms_per_frame=dt / RENDER_FRAMES * 1e3, launches=launches,
        peak_memory_bytes=torch.cuda.max_memory_allocated(),
        image_min=float(image.min()), image_max=float(image.max()),
        image_mean=float(image.mean()), ok=ok)
    if not ok:
        raise SystemExit("render: image is not finite, constant, or of the "
                         "wrong shape")
    want = {"wave_first": RENDER_FRAMES, "wave_bounce": 4 * RENDER_FRAMES}
    if launches != want:
        raise SystemExit(f"render: kernel launches {launches}, expected "
                         f"{want} (1 first + 4 bounce launches per frame)")
    return launches


def phase_golden():
    """128x128, 8 frames from time 1000 against tests/golden_tris under the
    0.05 % mean-absolute-difference bound."""
    results = {}
    for name, builder in (("quad", scenes.scene_quad),
                          ("cube", scenes.scene_cube),
                          ("suzanne", scenes.scene_suzanne)):
        r = ProgressiveRenderer(builder(128, 128, device=DEV), device=DEV)
        r.set_time(1000)
        r.draw_frames(8)
        with open(os.path.join(ROOT, "tests", "golden_tris",
                               f"{name}.ppm")) as f:
            golden = f.read()
        _, pct = compare_ppm(render_ppm(r.image), golden, GOLDEN_BOUND_PCT)
        results[name] = pct
    ok = all(p <= GOLDEN_BOUND_PCT for p in results.values())
    say(phase="golden", bound_pct=GOLDEN_BOUND_PCT, diff_pct=results, ok=ok)
    if not ok:
        raise SystemExit(f"golden: over the {GOLDEN_BOUND_PCT}% bound: "
                         f"{results}")


def main():
    smi = nvidia_smi_line()
    say(phase="device", nvidia_smi=smi, torch=torch.__version__,
        cuda=torch.version.cuda)
    phase_build()
    phase_kernels(128)
    launches = phase_render()
    records = phase_kernels(RENDER_SIZE, reps=10)
    phase_golden()

    # one record per kernel: K3 as the main path launches it most (2 fused
    # bounces on the sorted stream after bounce 0)
    kernels = []
    for r in records:
        if r["name"] == "wave_bounce" and r["n_bounces"] != 2:
            continue
        kernels.append({k: r[k] for k in (
            "name", "route", "source", "replaces", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")}
            | {"launches": launches[r["name"]]})
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
