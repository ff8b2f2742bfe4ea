"""One run of one cell: set up, measure, check, report.

    python3 benchmark/run.py --workload CELL --seed N --seconds S --trace 0|1

The cell, its configuration (``benchmark/configs/<name>.json``), its
traffic mix (``benchmark/traffic/<name>.json``), its limits
(``benchmark/limits/<cell>.json``) and the per-layer metrics
(``benchmark/metrics/<name>.py``, else the file of the name's part before
its first dot) are found by the names in ``BENCHMARK.json``.

``--trace 0`` measures the cell's end-to-end metrics over a window of
``--seconds``; ``--trace 1`` runs such a window untraced (for the host's
spans), then ``trace_requests`` requests under ``torch.profiler``
recording the device's activity only, and reports the per-layer
metrics.  Both then check what
the window produced against the plain reference (``check``) and print one
JSON line last on standard output, and each compared number beside its
limit last on standard error.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time
from collections import Counter
from types import SimpleNamespace

import torch

from benchmark import check, loops, roofline
from benchmark.devtrace import DeviceTrace
from benchmark.reference import scene as ref_scene

FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "rt")
# time uniform of a window's first frame: 1000 + the seed modulo this, so
# that no frame's uniform wraps past 2**32
TIME_SPAN = 2_000_000_000


def load_json(root: str, *parts: str) -> dict:
    with open(os.path.join(root, *parts)) as f:
        return json.load(f)


def cell_spec(root: str, name: str):
    """(BENCHMARK.json, the cell, its configuration, its traffic)."""
    bench = load_json(root, "BENCHMARK.json")
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = load_json(root, entry["file"])
    traffic = load_json(root, "benchmark", "traffic",
                        f"{cell['traffic']}.json")
    return bench, cell, config, traffic


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def metric_reader(root: str, name: str):
    """The ``read`` function of a per-layer metric's file."""
    folder = os.path.join(root, "benchmark", "metrics")
    for stem in (name, name.split(".")[0]):
        path = os.path.join(folder, f"{stem}.py")
        if os.path.exists(path):
            spec = importlib.util.spec_from_file_location(
                f"benchmark_metric_{stem.replace('.', '_')}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise SystemExit(f"no reader for metric {name!r} under {folder}")


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the run may not load,
    compared whole (``rt_torch`` is not ``rt``)."""
    loaded = {name.split(".")[0] for name in sys.modules}
    return sorted(loaded.intersection(FORBIDDEN_MODULES))


def card() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def _roofline_work(config, traffic, rec, scene, cam, counts_fit, launches):
    """(f32 operations, bytes, kernel names) of the traced window's work of
    the cell's kernels, counted on the same rays by the reference."""
    from benchmark.reference import tracer

    w, h = traffic["width"], traffic["height"]
    spp = traffic.get("spp", 1)
    pixels = w * h
    if rec["entry"] == "fit":
        c = counts_fit
        records = launches.get("tris_record", 0) + launches.get(
            "spheres_record", 0)
        return (roofline.operations(c) * records,
                roofline.frame_bytes(pixels, config["bounces"]) * records,
                ("tris_mono_kernel", "spheres_kernel"))
    dev = scene.param.device
    ys, xs = torch.meshgrid(torch.arange(h, device=dev),
                            torch.arange(w, device=dev), indexing="ij")
    c = Counter()
    samples = spp if config["kind"] == "spheres" else 1
    tracer.render(scene, cam, xs.reshape(-1), ys.reshape(-1),
                  [rec["time0"]], height=h, width=w, spp=samples,
                  bounces=config["bounces"], counts=c)
    frames = rec["frames"]
    if config["kind"] == "spheres":
        return (roofline.operations(c) * frames,
                roofline.frame_bytes(pixels) * frames, ("spheres_kernel",))
    if spp == 1:
        return (roofline.operations(c) * frames,
                roofline.wave_bytes(c, pixels) * frames,
                ("wave_first_kernel", "wave_bounce_kernel"))
    raygen = c["primary_rays"] * roofline.FLOPS_PER_RAYGEN
    flops = raygen + spp * (roofline.operations(c) - raygen)
    nbytes = (4.0 * roofline.PLANES_RAYGEN * pixels
              + spp * roofline.sample_bytes(c))
    return (flops * frames, nbytes * frames,
            ("wave_raygen_kernel", "wave_bounce_kernel"))


def _unit(rec: dict) -> tuple:
    """(the unit of a window's work, how many of it the window did)."""
    if rec["entry"] == "fit":
        return "step", rec["steps"]
    if rec["reset"]:
        return "image", rec["requests"]
    return "frame", rec["frames"]


def _side_by_side(t) -> dict:
    """[traced, untraced] of the units of work, each span's host ms a unit
    and the wall ms a unit; and the traced window's own idle share."""
    u = t.untraced
    out = {"units": [t.units, u.units]}
    for name in sorted(set(t.spans) | set(u.spans)):
        out[f"{name}_ms_per_{t.unit}"] = [
            1e3 * sum(s.get(name, ())) / n
            for s, n in ((t.spans, t.units), (u.spans, u.units))]
    out[f"wall_ms_per_{t.unit}"] = [1e3 * t.window_s / t.units,
                                    1e3 * u.window_s / u.units]
    if t.busy_s:
        out["idle_share_traced"] = 100.0 * (1.0 - t.busy_s / t.window_s)
    return out


class Cell:
    """One cell's program and reference, set up once: ``prepare`` the
    seed's inputs and warm up, run a ``window``, judge what it produced
    (``numbers``)."""

    def __init__(self, root: str, name: str, device="cuda",
                 traffic_overrides=None):
        from benchmark import program

        self.root, self.name, self.device = root, name, device
        self.bench, self.cell, self.config, traffic = cell_spec(root, name)
        self.traffic = {**traffic, **(traffic_overrides or {})}
        self.render = self.traffic["entry"] == "render"
        self.setup_parts = {}
        t0 = time.perf_counter()
        sd = program.scene_def(self.config, self.traffic, root, device)
        t1 = time.perf_counter()
        self.program = (program.renderer(sd, device) if self.render
                        else program.Fit(sd, self.traffic, device))
        self.setup_parts |= dict(scene_s=t1 - t0,
                                 program_s=time.perf_counter() - t1)

    def prepare(self, seed: int):
        """The seed's time uniform and sampled pixels, and the warm-up of
        every shape the window uses (a fit renders its target here)."""
        t = self.traffic
        t0 = time.perf_counter()
        self.seed, self.time0 = seed, 1000 + seed % TIME_SPAN
        if self.render:
            self.pixels = check.sample_pixels(seed, t["width"], t["height"],
                                              t["check_pixels"])
            self.window(loops.stop_after(requests=t["warmup_requests"]))
        else:
            self.program.prepare(self.time0)
            self.program.run(t["warmup_steps"])
        if self.device != "cpu":
            torch.cuda.synchronize()
        self.setup_parts["warmup_s"] = time.perf_counter() - t0

    def window(self, stop) -> dict:
        if self.render:
            return loops.render_window(self.program, self.traffic,
                                       self.time0, stop, self.pixels,
                                       self.device)
        return loops.fit_window(self.program, stop, self.device)

    def numbers(self, rec: dict, counts=None, dt=torch.float32,
                program=None) -> dict:
        """The compared numbers of a window's output.  With ``dt`` below
        float32 the reference at that precision is judged in the
        program's place (the control); a fit's ``program`` may give the
        (losses, first gradient, parameters after step 3) judged."""
        args = (self.config, self.traffic, rec)
        if self.render:
            prog = None if dt == torch.float32 else check.reference_images(
                *args, check.compared_requests(rec, self.seed), self.pixels,
                self.root, self.device, dt)
            return check.check_render(*args, self.seed, self.pixels,
                                      self.root, self.device,
                                      program_images=prog)
        if dt != torch.float32:
            program = check.reference_fit(self.config, self.traffic,
                                          self.time0, self.root,
                                          self.device, dt)
        return check.check_fit(*args, self.time0, self.root, self.device,
                               counts=counts, program=program)


def run_cell(root: str, name: str, seed: int, seconds: float, trace: bool,
             device="cuda", t_process=None, traffic_overrides=None) -> dict:
    """One run of a cell; returns the result line as a dict (its
    ``checks`` last), or raises."""
    from benchmark import program

    t_process = time.perf_counter() if t_process is None else t_process
    t_cell = time.perf_counter()
    c = Cell(root, name, device, traffic_overrides)
    c.prepare(seed)
    bench, config, traffic = c.bench, c.config, c.traffic
    if device != "cpu":
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_process

    prof = untraced = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        # host times and the idle share read a window of their own: the
        # profiler slows the host, even recording the device's activity
        # only (about 20 us a launch in the fit)
        untraced = c.window(loops.stop_after(seconds=seconds))
        launches0 = program.launch_counts()
        acts = ([ProfilerActivity.CUDA] if device != "cpu"
                else [ProfilerActivity.CPU])
        with profile(activities=acts) as prof:
            rec = c.window(loops.stop_after(
                requests=traffic["trace_requests"]))
    else:
        launches0 = program.launch_counts()
        rec = c.window(loops.stop_after(seconds=seconds))
    launches = Counter(program.launch_counts())
    launches.subtract(launches0)
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0

    found = forbidden_modules()
    if found:
        raise RuntimeError(f"modules loaded that the run may not load: "
                           f"{', '.join(found)}")
    # the program's state goes before the reference runs on the device
    c.program = None
    if device != "cpu":
        torch.cuda.empty_cache()

    counts_fit = Counter() if (trace and not c.render) else None
    numbers = c.numbers(rec, counts=counts_fit)
    correct, checks = check.judge(numbers, check.load_limits(root, name))

    result = dict(correct=correct, attempted=rec["requests"], failed=0)
    dev_info = dict(platform="gpu" if device != "cpu" else "cpu",
                    kind=(torch.cuda.get_device_name(0) if device != "cpu"
                          else "cpu"),
                    count=c.cell["chips"], memory_peak_bytes=int(peak))
    if not trace:
        e2e = loops.end_to_end(rec) | {"setup_s": setup_s}
        result["metrics"] = {m["name"]: {"value": e2e[m["name"]],
                                         "unit": m["unit"]}
                             for m in bench["end_to_end"]
                             if applies(m, name) and m["name"] in e2e}
    else:
        dtrace = DeviceTrace(prof, rec["span_ns"])
        scene = check.reference_scene(config, root, device, torch.float32,
                                      chunks=True)
        cam = ref_scene.camera_row(ref_scene.look_at(config["camera"]))
        flops, nbytes, kernels = _roofline_work(config, traffic, rec, scene,
                                                cam, counts_fit, launches)
        unit, units = _unit(rec)
        t = SimpleNamespace(
            entry=rec["entry"], unit=unit, units=units,
            requests=rec["requests"], window_s=rec["seconds"],
            busy_s=dtrace.busy_s(), group_ms=dtrace.ms_by_group(),
            kernel_ms=dtrace.kernel_ms, spans=rec["spans"],
            untraced=SimpleNamespace(units=_unit(untraced)[1],
                                     window_s=untraced["seconds"],
                                     spans=untraced["spans"]),
            launches=dict(launches),
            roofline=dict(least_ms=roofline.least_ms(flops, nbytes),
                          flops=flops, kernels=kernels))
        values = {}
        for m in bench["per_layer"]:
            if applies(m, name):
                v = metric_reader(root, m["name"])(t)
                if v is not None:
                    values[m["name"]] = {"value": v, "unit": m["unit"]}
        result["metrics"] = values
        dev_info |= dict(busy_s=t.busy_s, window_s=t.window_s)
        result["breakdown"] = dict(device_ops=dtrace.top_ops(),
                                   idle_gaps=dtrace.idle_gaps())
        result["traced_against_untraced"] = _side_by_side(t)
    result["device"] = dev_info
    result["card"] = card() if device != "cpu" else "cpu"
    result["launches"] = {k: v for k, v in launches.items() if v}
    result["setup_parts"] = dict(imports_s=t_cell - t_process,
                                 **c.setup_parts)
    result["checks"] = checks
    return result


def main(argv, t_process: float) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    _, cell, _, _ = cell_spec(root, args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"the cell needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    result = run_cell(root, args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", t_process)
    found = forbidden_modules()
    if found:
        print(f"modules loaded that the run may not load: {', '.join(found)}",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    return 0
