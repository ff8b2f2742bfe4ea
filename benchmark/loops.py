"""The one traffic generator: a closed loop of one client that waits for
each result before it asks for the next.

A traffic mix names its ``entry`` and the parameters of the loop:

- ``render``: a request is ``frames_per_request`` progressive frames drawn
  with ``ProgressiveRenderer.draw_frames`` and the image read back to the
  host (``ProgressiveRenderer.image``), as a viewer reads it.  With
  ``reset_each_request`` every request starts from an empty accumulator
  (a converged image); without, the frames fold into one image that the
  client watches converge.  Frame k of the window has the time uniform
  time0 + k * ``time_step``.
- ``fit``: a request is one whole material fit (``fit_replay``), each from
  the same wrong albedo.

A window starts no request after its deadline (``stop``) and ends when the
last one has come back, so every request it counts lies wholly inside it.
Host spans around the calls (``spans``) go to the per-layer metrics.
"""

from __future__ import annotations

import time
import weakref
from collections import defaultdict

import numpy as np
import torch


class Spans:
    """Host-clock durations by name (``seconds``), and each span's
    (name, start, end) on the wall clock in ns (``ns``), the clock that
    the profiler's timestamps count on."""

    def __init__(self):
        self.seconds = defaultdict(list)
        self.ns = []

    def __call__(self, name: str, fn):
        w0, t0 = time.time_ns(), time.perf_counter()
        out = fn()
        self.seconds[name].append(time.perf_counter() - t0)
        self.ns.append((name, w0, time.time_ns()))
        return out


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def render_window(r, traffic: dict, time0: int, stop, pixels, device):
    """One window of the render loop from an empty accumulator.  Returns
    the window's record: requests, frames, seconds, latencies, spans, and
    the sampled pixels of each request's image as read back (``images``,
    request index -> (P, 3)), with its first frame index."""
    f = traffic["frames_per_request"]
    step = traffic.get("time_step", 10)
    reset = traffic["reset_each_request"]
    ys, xs = pixels
    spans = Spans()
    latencies, images, first = [], {}, []
    r.reset_frame_count()
    r.set_time(time0)
    frames = 0
    _sync(device)
    t_start = time.perf_counter()
    img = None
    while not stop(len(latencies), time.perf_counter() - t_start):
        t0 = time.perf_counter()
        if reset:
            r.reset_frame_count()
        spans("draw", lambda: r.draw_frames(f, step))
        img = spans("readback", lambda: r.image)
        latencies.append(time.perf_counter() - t0)
        first.append(frames)
        frames += f
        if reset:
            images[len(latencies) - 1] = img[ys, xs]
    seconds = time.perf_counter() - t_start
    if not reset and img is not None:
        images[len(latencies) - 1] = img[ys, xs]
    return dict(entry="render", requests=len(latencies), frames=frames,
                seconds=seconds, latencies=latencies, spans=spans.seconds,
                span_ns=spans.ns, images=images, first_frame=first, time0=time0,
                frames_per_request=f, time_step=step, reset=reset)


class StepCapture:
    """A post-hook on every optimizer's ``step``: per fit (one optimizer
    each), the gradient the optimizer got at its first step and the
    parameters after its third.  It reads the program's state and changes
    nothing."""

    def __init__(self):
        self.steps = weakref.WeakKeyDictionary()
        self.fits = []
        self.handle = None

    def __enter__(self):
        from torch.optim.optimizer import register_optimizer_step_post_hook

        self.handle = register_optimizer_step_post_hook(self._hook)
        return self

    def __exit__(self, *exc):
        self.handle.remove()

    def _hook(self, opt, args, kwargs):
        n = self.steps.get(opt, 0) + 1
        self.steps[opt] = n
        leaves = [p for g in opt.param_groups for p in g["params"]]
        if n == 1:
            self.fits.append({"grad1": [p.grad.detach().clone()
                                        for p in leaves]})
        elif n == 3:
            self.fits[-1]["p3"] = [p.detach().clone() for p in leaves]


def fit_window(fit, stop, device):
    """One window of the fit loop.  Returns the window's record: fits,
    steps, seconds, latencies, spans, and the last fit's losses, captured
    first steps and recovered albedo."""
    spans = Spans()
    latencies, steps, last = [], 0, None
    with StepCapture() as cap:
        _sync(device)
        t_start = time.perf_counter()
        while not stop(len(latencies), time.perf_counter() - t_start):
            t0 = time.perf_counter()
            albedo, losses = spans("fit", fit.run)
            latencies.append(time.perf_counter() - t0)
            steps += len(losses)
            last = dict(losses=losses, final=albedo.detach().clone(),
                        **cap.fits[-1])
        seconds = time.perf_counter() - t_start
    return dict(entry="fit", requests=len(latencies), steps=steps,
                seconds=seconds, latencies=latencies, spans=spans.seconds,
                span_ns=spans.ns, last_fit=last)


def end_to_end(rec: dict) -> dict:
    """The end-to-end readings of a window, by metric name."""
    out = {}
    if rec["entry"] == "render":
        out["frames_per_s"] = rec["frames"] / rec["seconds"]
        if rec["reset"]:
            out["images_per_s"] = rec["requests"] / rec["seconds"]
        # a request's time a frame it drew, at the 95th percentile of all
        # the window's requests: a viewer's hitch
        out["frame_ms_p95"] = 1e3 * float(np.percentile(
            rec["latencies"], 95)) / rec["frames_per_request"]
    else:
        out["steps_per_s"] = rec["steps"] / rec["seconds"]
    return out


def stop_after(seconds: float | None = None, requests: int | None = None):
    """A stop condition: so many requests done, or the deadline passed
    after at least one."""
    def stop(done: int, elapsed: float) -> bool:
        if requests is not None:
            return done >= requests
        return done > 0 and elapsed >= seconds
    return stop
