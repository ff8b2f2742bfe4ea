"""Profiling, stats, spans and counters — counterpart of
``rt/utils/profiling.py``.

- ``Timer`` / ``device_sync``: wall-clock timing that waits for the card's
  work (``torch.cuda.synchronize`` on the device of each CUDA tensor given);
- ``RenderStats``: running frames, camera rays/s and ray segments/s, one
  update a frame batch (the CLI's ``--stats`` line);
- ``profile_trace``: a ``torch.profiler`` context that writes a Chrome
  trace (Perfetto-viewable) into ``logdir``;
- ``span`` / ``enable`` / ``disable`` / ``take``: the program's own host
  spans, off by default.  An enabled span records ``(name, start_ns,
  end_ns)`` on the clock of ``time.time_ns()``, the wall clock that
  ``torch.profiler``'s trace start is stamped on, so a reader can lay the
  spans over the device's timeline.  A span reads the host's clock only
  and never waits for the device;
- ``count`` / ``counters``: plain integer counters, always on, read with
  the kernels' launch counts (``dispatch.launch_counts``) by
  ``counters()``;
- the wave path's scan counters, counted only while spans are on: the
  render launches of the first and the bounce kernel (K2, K3) then run
  their counting instances, which add to an int64 accumulator on the card
  (``device_counts``), and their plain versions add to ``COUNTS``.
  ``counters()`` sums both, a wait for the card.  Per bounce of a ray,
  as ``tris_kernel.trace_bounce``'s ``scan_counts`` entries 0 and 1
  define them: ``wave_rays`` the live rays traced; ``wave_chunk_scans``
  the ray-chunk scans (every live ray of a tile scans each chunk some
  live ray of the tile enters nearer than its best hit);
  ``wave_box_tests`` the box tests, on a table with group boxes each live
  ray's group boxes and the chunk boxes of the groups it enters and of
  every chunk past ``MAX_GROUPS`` groups (``group_box_tests``), without
  them every chunk box for each ray of a tile that holds a live ray;
- ``wait``: the program's explicit waits on the device, counted.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass

import torch

# the program's counters besides the kernels' launches: elements sorted by
# the stream sorts, bytes read back to the host, explicit waits on the
# device, and ``fit_replay``'s steps by the path they took (the replay
# kernel, or autograd through the replay)
COUNTS = {"sort_keys": 0, "readback_bytes": 0, "host_waits": 0,
          "replay_kernel_steps": 0, "replay_autograd_steps": 0,
          "wave_rays": 0, "wave_chunk_scans": 0, "wave_box_tests": 0}
# the counters the counting kernels add to on the card, in the order of the
# slots of a device's accumulator
DEVICE_COUNTS = ("wave_rays", "wave_chunk_scans", "wave_box_tests")
_device_counts: dict = {}

_enabled = False
_records: list = []


class _NoSpan:
    """What ``span`` hands out while spans are off: one shared object whose
    ``with`` does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "start_ns")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        _records.append((self.name, self.start_ns, time.time_ns()))
        return False


def span(name: str):
    """``with span("fit.backward"): ...`` records the block's host time
    while spans are on; while off it returns one shared no-op object."""
    return _Span(name) if _enabled else _NO_SPAN


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def enabled() -> bool:
    """Whether spans record, and the wave kernels count their scans."""
    return _enabled


def take() -> list:
    """The spans closed since the last ``take()``, as (name, start_ns,
    end_ns) in the order they closed (an inner span before its outer
    one); clears them."""
    out = _records[:]
    del _records[:len(out)]
    return out


def count(name: str, n: int = 1) -> None:
    COUNTS[name] += n


def device_counts(device) -> torch.Tensor:
    """The (len(DEVICE_COUNTS),) int64 accumulator that the counting
    kernels on ``device`` add to, made zero at its first use."""
    device = torch.device(device)
    if device not in _device_counts:
        _device_counts[device] = torch.zeros(
            (len(DEVICE_COUNTS),), dtype=torch.int64, device=device)
    return _device_counts[device]


def counters() -> dict:
    """The kernels' launches so far by wrapper name, and the program's
    counters with what the counting kernels added on each card (a wait
    for the card where one has counted)."""
    from rt_torch.kernels import dispatch

    out = dispatch.launch_counts() | COUNTS
    for acc in _device_counts.values():
        for name, n in zip(DEVICE_COUNTS, acc.tolist()):
            out[name] += n
    return out


def device_sync(*tensors) -> None:
    """Wait for the work that feeds ``tensors``: a synchronize of each CUDA
    device among them (CPU tensors are ready when they exist)."""
    for dev in {t.device for t in tensors
                if isinstance(t, torch.Tensor) and t.is_cuda}:
        torch.cuda.synchronize(dev)


def wait(*tensors) -> None:
    """An explicit wait of the program on the work that feeds ``tensors``
    (``device_sync``), counted in ``host_waits``."""
    count("host_waits")
    device_sync(*tensors)


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

    def update(self, n_frames: int, seconds: float) -> None:
        self.frames += n_frames
        self.seconds += seconds

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
