"""Other shapes of the port's kernels, timed in turns with the kernels as
built: the record behind a redesign's choice (PERF.md).  On the card only;
nothing here is on a render, training or probe path.

    python -m rt_torch.variants raygen [512 1024]
    python -m rt_torch.variants p2 SOURCE... [--chunks 64 301 600]

``raygen``: K4 (``wave_raygen``) as its earlier tile launch, as a flat
grid and as strips of a row, at 1, 2 or 4 pixels a thread and several
block sizes (``kernels/variants/raygen.cu``), each held bit-equal to the
wrapper's planes, then timed from CUDA graphs of 50 launches in four turns
(forward, backward), with the wrapper itself, an empty kernel on the tile
grid and a fill of the same bytes.

``p2``: each SOURCE a whole ``probes.cu`` (this tree's, or an older one
unpacked with ``git archive``), built as its own library; P2a
(``rt_mt_scan``) and P2b (``rt_woop_mma``) of every build at each chunk
count, A held bit-equal to ``r5_mxu.mt_scan_plain`` and B to
``woop_agreement``, then timed from graphs in turns (six at 64 chunks, two
above); registers of each instance and the launch shape each build
reports.  ``--launch-pieces`` adds, for a source whose launcher picks an
instance by its piece count, a build that always launches the piece loop.

Each line is one JSON object; the card's name and power limit come first.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import torch

from rt_torch import measure
from rt_torch.kernels import _build, tris_kernel
from rt_torch.probes import r5_mxu

VARIANTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "kernels", "variants")
OUT = os.path.join(_build.BUILD_DIR, "variants")
GRAPH_REPS = 50
# (pixels a thread, threads a block) of each shape raygen.cu builds
FLAT = ((1, 128), (1, 256), (2, 128), (2, 256), (4, 128), (4, 256))
FLAT_CAPS = (0, 2, 4, 8)          # blocks an SM at most; 0: every pixel
STRIP = ((1, 64), (1, 128), (1, 256), (1, 512), (2, 32), (2, 64), (2, 128),
         (2, 256), (4, 32), (4, 64), (4, 128))
_P, _I = ctypes.c_void_p, ctypes.c_int


def _library(source: str, name: str):
    """``source`` built with the kernels' flags (csrc on the include path)
    into OUT/name.so; (library, its kernels' ptxas lines)."""
    os.makedirs(OUT, exist_ok=True)
    out = os.path.join(OUT, name + ".so")
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS,
                           "-I", _build.CSRC, "-o", out, source],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc {source}:\n{proc.stderr[-4000:]}")
    return ctypes.CDLL(out), _build.ptxas_usage(proc.stderr)


def _in_turns(fns: dict, turns: int, reps: int = GRAPH_REPS) -> dict:
    """ms of each fn from a CUDA graph, ``turns`` times, every other turn
    in reverse order."""
    ms = {k: [] for k in fns}
    items = list(fns.items())
    for turn in range(turns):
        for name, fn in (items if turn % 2 == 0 else items[::-1]):
            ms[name].append(measure._graph_ms(fn, reps))
    return ms


def _stream():
    return torch.cuda.current_stream().cuda_stream


def raygen(sizes=(512, 1024)) -> None:
    lib, usage = _library(os.path.join(VARIANTS, "raygen.cu"), "raygen")
    lib.rv_tile.argtypes = [_I] * 2 + [_P] * 5 + [_I] * 6 + [_P]
    lib.rv_flat.argtypes = [_I] * 3 + [_P] * 5 + [_I] * 6 + [_P]
    lib.rv_strip.argtypes = [_I] * 2 + [_P] * 5 + [_I] * 6 + [_P]
    print(json.dumps({"registers": {
        u["kernel"]: u["registers"] for u in usage
        if "rt_variants" in u["kernel"]}}), flush=True)
    dev = torch.device("cuda")
    for size in sizes:
        a = measure.raygen_args(size)
        kw, n = a.kw, size * size
        od, pdy, state = tris_kernel.wave_raygen(a.cam_row, a.times, 0, **kw)
        want = torch.cat([od, pdy[None], state.view(torch.float32)[None]])
        cam = tris_kernel._cam_array(a.cam_row)
        planes = torch.empty((8, n), dtype=torch.float32, device=dev)
        b = planes.data_ptr()
        args = (cam.ctypes.data, a.times.data_ptr(), b, b + 24 * n,
                b + 28 * n, size, size, size, size, 1,
                int(kw["normalize_defocus_dir"]))
        th, tw = kw["th"], kw["tw"]
        fns = {f"tile {th}x{tw}": lambda: lib.rv_tile(th, tw, *args,
                                                      _stream())}
        for p, t in FLAT:
            for cap in FLAT_CAPS:
                fns[f"flat P{p} T{t} cap{cap}"] = (
                    lambda p=p, t=t, cap=cap: lib.rv_flat(p, t, cap, *args,
                                                          _stream()))
        for p, t in STRIP:
            fns[f"strip P{p} T{t}"] = (
                lambda p=p, t=t: lib.rv_strip(p, t, *args, _stream()))
        differ = []
        for name, fn in fns.items():
            planes.fill_(-7.0)
            if fn() != 0:
                raise RuntimeError(f"raygen variant {name} did not launch")
            if not torch.equal(planes.view(torch.int32),
                               want.view(torch.int32)):
                differ.append(name)
        if differ:
            raise SystemExit(f"raygen variants differ from K4: {differ}")
        fns["K4 (wave_raygen)"] = lambda: tris_kernel.wave_raygen(
            a.cam_row, a.times, 0, **kw)
        ms = _in_turns(fns, 4)
        ms["empty kernel, tile grid"] = [
            measure.empty_ms(n // (th * tw), th * tw) for _ in range(2)]
        buf = torch.empty(8 * n, device=dev)
        ms["fill of 8 planes"] = [measure._graph_ms(lambda: buf.fill_(1.0),
                                                    GRAPH_REPS)
                                  for _ in range(2)]
        print(json.dumps({"raygen": size, "bit_equal": True, "ms": ms}),
              flush=True)


def _p2_builds(sources, launch_pieces: bool) -> dict:
    builds = {}
    for i, path in enumerate(sources):
        srcs = {path: path}
        if launch_pieces:
            text = open(path).read()
            if "return s.pieces > 1" in text:
                forced = os.path.join(OUT, f"probes_{i}_pieces.cu")
                os.makedirs(OUT, exist_ok=True)
                with open(forced, "w") as f:
                    f.write(text.replace("return s.pieces > 1",
                                         "return true"))
                srcs[path + " (piece loop always)"] = forced
        for label, src in srcs.items():
            lib, usage = _library(src, f"probes_{len(builds)}")
            for fn, sig in _build._SIGNATURES["probes"].items():
                if hasattr(lib, fn):
                    getattr(lib, fn).argtypes = sig
            builds[label] = lib
            print(json.dumps({"build": label, "registers": {
                u["kernel"]: u["registers"] for u in usage
                if u["kernel"].startswith(("mt_scan", "woop"))}}),
                flush=True)
    return builds


def p2(sources, chunks=(64,), launch_pieces=False) -> None:
    builds = _p2_builds(sources, launch_pieces)
    dev = torch.device("cuda")
    for n in chunks:
        a = r5_mxu.to_device(r5_mxu.inputs(n), dev)
        want_a = r5_mxu.mt_scan_plain(a["tri"], a["o"], a["d"]).reshape(-1)
        want_b, win = r5_mxu.woop_plain(a["w"], a["x"], winner=True)
        fns, checks, shapes = {}, {}, {}
        for label, lib in builds.items():
            oa = torch.empty(r5_mxu.R, device=dev)
            ob = torch.empty((r5_mxu.R, 1), device=dev)
            run_a = (lambda lib=lib, oa=oa: lib.rt_mt_scan(
                a["tri"].data_ptr(), a["o"].data_ptr(), a["d"].data_ptr(),
                oa.data_ptr(), r5_mxu.R, n, _stream()))
            run_b = (lambda lib=lib, ob=ob: lib.rt_woop_mma(
                a["w"].data_ptr(), a["x"].data_ptr(), ob.data_ptr(),
                r5_mxu.R, n, _stream()))
            for kernel, run in (("A", run_a), ("B", run_b)):
                code = run()
                torch.cuda.synchronize()
                if code:           # an older build refuses this size
                    checks[f"{kernel} {label}"] = f"refused ({code})"
                    continue
                if kernel == "A":
                    ok = torch.equal(oa.view(torch.int32),
                                     want_a.view(torch.int32))
                else:
                    ok = r5_mxu.woop_agreement(ob, want_b, a["w"], a["x"],
                                               win)["ok"]
                if not ok:
                    raise SystemExit(f"p2: {kernel} of {label} at {n} "
                                     "chunks disagrees with its plain "
                                     "version")
                checks[f"{kernel} {label}"] = "equal" if kernel == "A" \
                    else "in agreement"
                fns[f"{kernel} {label}"] = run
                vals = (ctypes.c_int * 9)()
                if lib.rt_probe_shape("AB".index(kernel), r5_mxu.R, n,
                                      vals) == 0:
                    shapes[f"{kernel} {label}"] = list(vals)
        ms = _in_turns(fns, 6 if n == 64 else 2, GRAPH_REPS if n == 64
                       else 10)
        print(json.dumps({"p2_chunks": n, "checks": checks,
                          "launch_shape": shapes, "ms": ms}), flush=True)


def main(argv) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("rt_torch.variants runs on a CUDA card")
    print(measure._card(), flush=True)
    what, rest = argv[0], argv[1:]
    if what == "raygen":
        raygen(tuple(int(s) for s in rest) or (512, 1024))
    elif what == "p2":
        chunks = (64,)
        if "--chunks" in rest:
            i = rest.index("--chunks")
            chunks = tuple(int(c) for c in rest[i + 1:])
            rest = rest[:i]
        pieces = "--launch-pieces" in rest
        p2([s for s in rest if s != "--launch-pieces"], chunks, pieces)
    else:
        raise SystemExit(f"unknown variant set {what!r}: raygen, p2")


if __name__ == "__main__":
    main(sys.argv[1:])
