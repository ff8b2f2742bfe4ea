"""The program's own spans and counters (``rt_torch.utils.profiling``): off
by default and then free of records, nested on the host's wall clock, one
a step or a block of ``fit_replay``, one a bounce of the wave path as
``bounce_schedule`` lays the bounces out, and no change to an image or a
loss.  On a card: the spans lie on ``torch.profiler``'s clock.

This file imports only ``torch`` and ``rt_torch``; the card's test runs
alone with

    python -m pytest tests/test_torch_tracing.py --noconftest -q -m gpu
"""

import dataclasses
import time
from collections import Counter

import pytest
import torch

from rt_torch.grad import record_hits
from rt_torch.grad.train import fit_replay
from rt_torch.kernels import dispatch
from rt_torch.kernels import tris_kernel as ttk
from rt_torch.render.renderer import ProgressiveRenderer
from rt_torch.scene import scenes
from rt_torch.utils import profiling
from _torch_threads import one_torch_thread  # noqa: F401

TIME = 1000


@pytest.fixture(autouse=True)
def _spans_off():
    profiling.disable()
    profiling.take()
    yield
    profiling.disable()
    profiling.take()


def _traced(fn):
    """(fn's result, its spans' names counted, the counters' change)."""
    before = profiling.counters()
    profiling.enable()
    try:
        out = fn()
    finally:
        profiling.disable()
    names = Counter(name for name, _, _ in profiling.take())
    after = profiling.counters()
    return out, names, {k: after[k] - before[k] for k in after}


def test_spans_off_record_nothing_and_are_one_object():
    a, b = profiling.span("render.frame"), profiling.span("fit.backward")
    assert a is b
    with a:
        with b:
            pass
    assert profiling.take() == []


def test_spans_nest_on_the_wall_clock_and_take_clears():
    profiling.enable()
    t0 = time.time_ns()
    with profiling.span("outer"):
        with profiling.span("inner"):
            time.sleep(0.002)
    t1 = time.time_ns()
    profiling.disable()
    (n_in, a_in, b_in), (n_out, a_out, b_out) = profiling.take()
    assert (n_in, n_out) == ("inner", "outer")
    assert t0 <= a_out <= a_in < b_in <= b_out <= t1
    assert b_in - a_in >= 2_000_000
    assert profiling.take() == []


def test_counters_read_the_launches_with_the_programs_counters():
    c = profiling.counters()
    assert c.keys() == (dispatch.launch_counts().keys()
                        | {"sort_keys", "readback_bytes", "host_waits",
                           "replay_kernel_steps", "replay_autograd_steps",
                           "wave_rays", "wave_chunk_scans",
                           "wave_box_tests"})
    profiling.count("sort_keys", 7)
    assert profiling.counters()["sort_keys"] == c["sort_keys"] + 7


# ---------------------------------------------------------------------------
# the fit: a span a record, a step's three, a block's wait and readback
# ---------------------------------------------------------------------------

STEPS, REREC = 5, 2


@pytest.fixture(scope="module")
def fit_runs():
    sd = scenes.scene_suzanne(16, 16, device="cpu")
    cfg = dataclasses.replace(sd.config, bounces=3)
    target, _ = record_hits(sd.scene, sd.camera, cfg, TIME, device="cpu")
    albedo = sd.scene.mat_albedo.clone()
    albedo[0] = albedo.new_tensor([0.8, 0.1, 0.1])
    bad = sd.scene._replace(mat_albedo=albedo)

    def fit():
        return fit_replay(bad, sd.camera, cfg, target, time=TIME,
                          steps=STEPS, rerecord_every=REREC,
                          learning_rate=5e-2, device="cpu")

    profiling.disable()
    off = fit()
    on, names, counts = _traced(fit)
    return off, on, names, counts


def test_fit_replay_spans_each_record_step_and_block(fit_runs):
    _, _, names, counts = fit_runs
    blocks = -(-STEPS // REREC)
    assert names == Counter({"fit.record": blocks, "fit.forward": STEPS,
                             "fit.backward": STEPS, "fit.optimizer": STEPS,
                             "fit.wait": blocks, "fit.readback": blocks})
    assert counts["host_waits"] == blocks


def test_fit_replay_losses_bit_equal_with_spans_on_and_off(fit_runs):
    (p_off, l_off), (p_on, l_on), _, _ = fit_runs
    assert l_off == l_on
    assert torch.equal(p_off["scene"].mat_albedo, p_on["scene"].mat_albedo)


# ---------------------------------------------------------------------------
# the wave path: a span a launch, a sort and its gathers as scheduled
# ---------------------------------------------------------------------------

W, H = 32, 16


@pytest.fixture(scope="module", params=[1, 2], ids=["spp1", "spp2"])
def wave_runs(request):
    sd = scenes.scene_suzanne(W, H, device="cpu")
    sd = dataclasses.replace(sd, config=dataclasses.replace(
        sd.config, samples_per_frame=request.param))

    def frame():
        r = ProgressiveRenderer(sd, device="cpu")
        r.draw_frames(1)
        return r.image

    profiling.disable()
    off = frame()
    on, names, counts = _traced(frame)
    return sd.config, off, on, names, counts


def test_wave_spans_follow_the_bounce_schedule(wave_runs):
    cfg, _, _, names, counts = wave_runs
    kw = dispatch.wave_params(scenes.scene_suzanne(W, H, "cpu").scene, cfg)
    spp = cfg.samples_per_frame
    sched = ttk.bounce_schedule(cfg.bounces, kw["sort_every"],
                                kw["skip_last_sort"], 1 if spp == 1 else 0)
    sorts = spp * sum(s for _, _, s in sched)
    launches = spp * len(sched)
    assert names == Counter({
        "render.frame": 1, "render.accumulate": 1, "render.wait": 1,
        "render.readback": 1, "wave.first" if spp == 1 else "wave.raygen": 1,
        "wave.sort": sorts, "wave.gather": sorts,
        "wave.chunk_order": launches, "wave.bounce": launches,
        "wave.restore": spp})
    th, tw = kw["th"], kw["tw"]
    n = -(-H // th) * th * -(-W // tw) * tw
    assert counts["sort_keys"] == n * sorts > 0


def test_readback_counts_the_images_bytes_and_one_wait(wave_runs):
    _, _, _, _, counts = wave_runs
    assert counts["readback_bytes"] == H * W * 3 * 4
    assert counts["host_waits"] == 1


def test_wave_image_bit_equal_with_spans_on_and_off(wave_runs):
    _, off, on, _, _ = wave_runs
    assert off.tobytes() == on.tobytes()


def test_sphere_frame_spans_its_launch():
    sd = scenes.scene_sphere_simple(16, 16, device="cpu")

    def frames():
        r = ProgressiveRenderer(sd, device="cpu")
        r.draw_frames(2)
        return r.image

    off = frames()
    on, names, counts = _traced(frames)
    assert names == Counter({"spheres.frame": 2, "render.frame": 2,
                             "render.accumulate": 2, "render.wait": 1,
                             "render.readback": 1})
    assert counts["readback_bytes"] == 16 * 16 * 3 * 4
    assert off.tobytes() == on.tobytes()


# ---------------------------------------------------------------------------
# on a card: the spans on the profiler's clock
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_spans_lie_on_the_profilers_clock():
    """The profiler records the card's activity only, as the benchmark's
    traced window does.  Three times a span around 20 ms of the host
    spinning, then a kernel: mapped through the trace's start
    (``trace_start_ns``), each idle gap of the device before a kernel lies
    inside its span to within 0.5 ms at both ends.  The host spins rather
    than sleeps, so that no core wakes up slowly; the first launches under
    the profiler (which take milliseconds to set up) come before the
    spans."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones(1 << 20, device="cuda")
    x.add_(1.0)
    torch.cuda.synchronize()
    profiling.enable()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            x.add_(1.0)
            torch.cuda.synchronize()
        for _ in range(3):
            with profiling.span("spin"):
                t_end = time.perf_counter() + 0.02
                while time.perf_counter() < t_end:
                    pass
            x.add_(1.0)
            torch.cuda.synchronize()
    profiling.disable()
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    spans = [((a - start_ns) / 1e3, (b - start_ns) / 1e3)
             for _, a, b in profiling.take()]
    ops = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and not getattr(e, "is_user_annotation", False))
    # idle gaps of 20 ms or more, in us from the trace's start
    gaps = [(a[1], b[0]) for a, b in zip(ops, ops[1:]) if b[0] - a[1] >= 20e3]
    assert len(gaps) == len(spans) == 3
    for (gap0, gap1), (span0, span1) in zip(gaps, spans):
        assert abs(gap0 - span0) <= 500 and abs(gap1 - span1) <= 500
