"""The benchmark's metric arithmetic on synthetic timings: rates over the
whole window, the 95th percentile over all frames, the device's busy time
and idle share, idle gaps by host range, and the roofline from counts."""

import importlib.util
import os
import time
from types import SimpleNamespace

import numpy as np
import pytest

from benchmark import loops, roofline
from benchmark.devtrace import DeviceTrace


def reader(root, name):
    path = os.path.join(root, "benchmark", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"m_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def trace(ops, host=()):
    t = DeviceTrace.__new__(DeviceTrace)
    t.ops = sorted(ops, key=lambda r: r[1])
    t.host = list(host)
    return t


class StubRenderer:
    """draw_frames sleeps a fixed time a frame; image is an array."""

    def __init__(self, frame_s):
        self.frame_s, self.frames = frame_s, 0

    def reset_frame_count(self):
        pass

    def set_time(self, t):
        pass

    def draw_frames(self, n, step):
        time.sleep(self.frame_s * n)
        self.frames += n

    @property
    def image(self):
        return np.zeros((4, 4, 3), np.float32)


@pytest.mark.parametrize("reset,frames_per_request", [(False, 1), (True, 3)])
def test_rate_is_over_the_whole_window(reset, frames_per_request):
    traffic = dict(frames_per_request=frames_per_request,
                   reset_each_request=reset)
    r = StubRenderer(0.01)
    rec = loops.render_window(r, traffic, 1000, loops.stop_after(0.1),
                              (np.array([0]), np.array([0])), "cpu")
    assert rec["frames"] == r.frames == rec["requests"] * frames_per_request
    # the window holds every request it counts, and ends with the last
    assert rec["seconds"] >= sum(rec["latencies"])
    assert rec["seconds"] >= 0.1
    e2e = loops.end_to_end(rec)
    assert e2e["frames_per_s"] == pytest.approx(rec["frames"] / rec["seconds"])
    if reset:
        assert e2e["images_per_s"] == pytest.approx(
            rec["requests"] / rec["seconds"])


@pytest.mark.parametrize("frames_per_request", [1, 8])
def test_p95_is_over_all_requests(frames_per_request):
    lat = [i / 1000 for i in range(1, 201)]
    rec = dict(entry="render", frames=200 * frames_per_request,
               requests=200, seconds=1.0, reset=False,
               frames_per_request=frames_per_request, latencies=lat)
    assert loops.end_to_end(rec)["frame_ms_p95"] == pytest.approx(
        np.percentile(np.arange(1, 201), 95) / frames_per_request)


def test_stop_after_counts_at_least_one_request():
    stop = loops.stop_after(seconds=0.0)
    assert not stop(0, 5.0) and stop(1, 0.0)
    assert loops.stop_after(requests=3)(3, 0.0)


def test_busy_idle_and_gaps(root):
    t = trace([("wave_bounce_kernel", 0, 10), ("sort", 5, 20),
               ("Memcpy DtoH", 30, 40)],
              host=[("bench.draw", 0, 100), ("aten::sort", 19, 31)])
    assert t.busy_s() == pytest.approx(30e-6)
    g = t.ms_by_group()
    assert g["kernel_wave_bounce"] == pytest.approx(0.010)
    assert g["sort"] == pytest.approx(0.015)
    assert g["copy"] == pytest.approx(0.010)
    assert t.kernel_ms(("wave_bounce_kernel",)) == pytest.approx(0.010)
    # the gap 20..30 us lies inside aten::sort, the innermost range
    assert t.idle_gaps() == [["aten::sort", pytest.approx(10e-6)]]
    # idle over the untraced window: 3 us busy a unit, 10 units in 40 us
    ns = SimpleNamespace(busy_s=t.busy_s(), window_s=1.0, units=10,
                         untraced=SimpleNamespace(units=10, window_s=40e-6))
    assert reader(root, "idle_share")(ns) == pytest.approx(25.0)


class FakeProfile:
    """A profile's events (µs from the trace's start) and its start on the
    wall clock (ns)."""

    def __init__(self, events, start_ns):
        self._events = events
        results = SimpleNamespace(trace_start_ns=lambda: start_ns)
        self.profiler = SimpleNamespace(kineto_results=results)

    def events(self):
        return self._events


def test_gaps_are_labelled_by_the_benchmarks_spans():
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    ev = lambda name, t0, t1: SimpleNamespace(
        name=name, device_type=cuda, time_range=SimpleNamespace(
            start=t0, end=t1), is_user_annotation=False)
    start = 1_000_000_000
    prof = FakeProfile([ev("wave_bounce_kernel", 0, 10),
                        ev("Memcpy DtoH", 30, 40), ev("k", 100, 110)], start)
    # spans on the wall clock: the gap 10..30 us inside "readback", the gap
    # 40..100 us outside every span
    t = DeviceTrace(prof, [("draw", start, start + 9_000),
                           ("readback", start + 9_000, start + 41_000)])
    assert t.idle_gaps() == [["between requests", pytest.approx(60e-6)],
                             ["readback", pytest.approx(20e-6)]]
    assert t.busy_s() == pytest.approx(30e-6)


def test_side_by_side_of_traced_and_untraced():
    from benchmark.harness import _side_by_side

    t = SimpleNamespace(
        unit="frame", units=10, window_s=0.1, busy_s=0.04,
        spans={"draw": [0.004] * 10},
        untraced=SimpleNamespace(units=100, window_s=0.5,
                                 spans={"draw": [0.003] * 100}))
    s = _side_by_side(t)
    assert s["draw_ms_per_frame"] == [pytest.approx(4.0), pytest.approx(3.0)]
    assert s["wall_ms_per_frame"] == [pytest.approx(10.0), pytest.approx(5.0)]
    assert s["idle_share_traced"] == pytest.approx(60.0)


def test_roofline_from_counts(root):
    c = dict(chunk_scans=1000, box_tests=500, primary_rays=10)
    flops = roofline.operations(c)
    assert flops == 1000 * 32 * 46 + 500 * 24 + 10 * 102
    assert roofline.least_ms(flops, 0) == pytest.approx(
        flops / 67e12 * 1e3)
    assert roofline.least_ms(0, 3.35e9) == pytest.approx(1.0)
    least = roofline.least_ms(flops, 1e3)
    ns = SimpleNamespace(
        roofline=dict(least_ms=least, flops=flops,
                      kernels=("wave_bounce_kernel",)),
        kernel_ms=lambda keys: 4 * least, unit="frame", window_s=1.0)
    assert reader(root, "kernel_roofline")(ns) == pytest.approx(25.0)
    assert reader(root, "mfu")(ns) == pytest.approx(
        100 * flops / 67e12)


def test_readers_return_nothing_without_data(root):
    empty = SimpleNamespace(unit="image", units=1, spans={}, busy_s=0.0,
                            window_s=1.0, roofline=None,
                            group_ms={"sort": 0.0},
                            untraced=SimpleNamespace(units=1, spans={},
                                                     window_s=1.0))
    for name in ("glue_ms_per_image", "replay_ms_per_step",
                 "kernel_roofline", "idle_share", "mfu"):
        assert reader(root, name)(empty) is None


def test_glue_and_replay_readers(root):
    g = {"kernel_wave_first": 1.0, "kernel_wave_bounce": 4.0, "sort": 2.0,
         "gather_scatter": 1.0, "other_torch": 3.0, "copy": 5.0,
         "kernel_tris_mono": 7.0, "kernel_spheres": 0.0}
    image = SimpleNamespace(unit="image", units=2, group_ms=g)
    assert reader(root, "glue_ms_per_image")(image) == pytest.approx(3.0)
    assert reader(root, "glue_ms_per_image")(
        SimpleNamespace(unit="frame", units=2, group_ms=g)) is None
    step = SimpleNamespace(unit="step", units=4, group_ms=g)
    assert reader(root, "replay_ms_per_step")(step) == pytest.approx(
        (1 + 4 + 2 + 1 + 3) / 4)
