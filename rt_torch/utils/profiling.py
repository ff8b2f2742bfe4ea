"""Profiling, stats and logging — counterpart of ``rt/utils/profiling.py``.

- ``Timer`` / ``device_sync``: wall-clock timing that waits for the card's
  work (``torch.cuda.synchronize`` on the device of each CUDA tensor given);
- ``RenderStats``: running frames, camera rays/s and ray segments/s, one
  update a frame batch (the CLI's ``--stats`` line);
- ``profile_trace``: a ``torch.profiler`` context that writes a Chrome
  trace (Perfetto-viewable) into ``logdir``;
- ``setup_logging``: the standard library's logging, configured once.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from dataclasses import dataclass, field

import torch

log = logging.getLogger("rt_torch")


def setup_logging(level=logging.INFO) -> None:
    logging.basicConfig(
        level=level,
        format="%(asctime)s %(name)s %(levelname).1s %(message)s",
        datefmt="%H:%M:%S")


def device_sync(*tensors) -> None:
    """Wait for the work that feeds ``tensors``: a synchronize of each CUDA
    device among them (CPU tensors are ready when they exist)."""
    for dev in {t.device for t in tensors
                if isinstance(t, torch.Tensor) and t.is_cuda}:
        torch.cuda.synchronize(dev)


class Timer:
    """``with Timer(x) as t: ...; t.seconds`` — syncs the given tensors'
    devices on exit so their work is included."""

    def __init__(self, *sync_tensors):
        self._sync = sync_tensors

    def __enter__(self):
        self.seconds = 0.0
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        device_sync(*self._sync)
        self.seconds = time.perf_counter() - self._t0
        return False


@dataclass
class RenderStats:
    """Running throughput accounting: one update a frame batch."""

    width: int
    height: int
    bounces: int
    samples_per_frame: int = 1
    frames: int = 0
    seconds: float = 0.0
    history: list = field(default_factory=list)

    def update(self, n_frames: int, seconds: float) -> None:
        self.frames += n_frames
        self.seconds += seconds
        self.history.append((n_frames, seconds))

    @property
    def pixels(self) -> int:
        return self.width * self.height

    @property
    def camera_rays_per_s(self) -> float:
        return (self.pixels * self.samples_per_frame * self.frames
                / self.seconds) if self.seconds else 0.0

    @property
    def ray_segments_per_s(self) -> float:
        """One segment a sample and bounce (the fixed-depth loop)."""
        return self.camera_rays_per_s * self.bounces

    @property
    def fps(self) -> float:
        return self.frames / self.seconds if self.seconds else 0.0

    def summary(self) -> str:
        return (f"{self.frames} frames in {self.seconds:.3f}s: "
                f"{self.fps:.1f} fps, "
                f"{self.camera_rays_per_s:.3e} camera rays/s, "
                f"{self.ray_segments_per_s:.3e} ray segments/s")


@contextlib.contextmanager
def profile_trace(logdir: str):
    """Profile the block with ``torch.profiler`` (CPU activity, and the
    card's where one is present) and export a Chrome trace to
    ``logdir/trace.json``.  Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
