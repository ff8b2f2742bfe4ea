"""What a traced window reads from ``torch.profiler``: device time by
kernel name and by kind of work, the device's busy time (the union of its
operations' intervals), and the idle gaps between them by what the host
was doing (the benchmark's spans)."""

from __future__ import annotations

from collections import defaultdict

import numpy as np
import torch

# kinds of device work by kernel name (a frozen copy of the groups of the
# program's own breakdown, plus the copies); the first match wins
GROUPS = (
    ("kernel_wave_first", ("wave_first_kernel",)),
    ("kernel_wave_bounce", ("wave_bounce_kernel",)),
    ("kernel_wave_raygen", ("wave_raygen_kernel",)),
    ("kernel_spheres", ("spheres_kernel",)),
    ("kernel_spheres_chunked", ("spheres_chunked_kernel",)),
    ("kernel_tris_mono", ("tris_mono_kernel",)),
    ("copy", ("Memcpy", "Memset", "memcpy", "memset")),
    ("sort", ("sort", "Sort", "radix", "Radix")),
    ("gather_scatter", ("index", "gather", "scatter")),
)
OTHER = "other_torch"
# gaps the host attribution looks at, longest first
GAPS_LABELLED = 500


def group_of(name: str) -> str:
    return next((g for g, keys in GROUPS if any(k in name for k in keys)),
                OTHER)


def short_name(name: str) -> str:
    """A kernel's name up to its argument list."""
    name = name.replace("(anonymous namespace)::", "")
    return name.split("(")[0].strip() or name


class DeviceTrace:
    """The device operations of a profile, (name, start us, end us) from
    the trace's start, and the host's ranges on the same clock: the
    benchmark's own spans, (name, start ns, end ns) on the wall clock,
    which the profiler's timestamps count on too."""

    def __init__(self, prof, spans_ns=()):
        dev = []
        for e in prof.events():
            # a host range mirrored on the device timeline is no work
            if (e.device_type == torch.autograd.DeviceType.CUDA
                    and not getattr(e, "is_user_annotation", False)):
                dev.append((e.name, e.time_range.start, e.time_range.end))
        self.ops = sorted(dev, key=lambda r: r[1])
        try:
            start_ns = prof.profiler.kineto_results.trace_start_ns()
        except AttributeError:
            start_ns = None
        self.host = ([] if start_ns is None else
                     [(name, (t0 - start_ns) / 1e3, (t1 - start_ns) / 1e3)
                      for name, t0, t1 in spans_ns])

    def ms_by_name(self) -> dict:
        out = defaultdict(float)
        for name, t0, t1 in self.ops:
            out[name] += (t1 - t0) / 1e3
        return dict(out)

    def ms_by_group(self) -> dict:
        out = {g: 0.0 for g, _ in GROUPS} | {OTHER: 0.0}
        for name, ms in self.ms_by_name().items():
            out[group_of(name)] += ms
        return out

    def kernel_ms(self, keys) -> float:
        return sum(ms for name, ms in self.ms_by_name().items()
                   if any(k in name for k in keys))

    def _merged(self):
        merged = []
        for _, t0, t1 in self.ops:
            if merged and t0 <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t1)
            else:
                merged.append([t0, t1])
        return merged

    def busy_s(self) -> float:
        return sum(t1 - t0 for t0, t1 in self._merged()) / 1e6

    def top_ops(self, n: int = 10) -> list:
        """[[name, seconds]] of the ``n`` dearest operations, a kernel's
        name without its argument list."""
        s = defaultdict(float)
        for name, ms in self.ms_by_name().items():
            s[short_name(name)] += ms / 1e3
        top = sorted(s, key=s.get, reverse=True)[:n]
        return [[k, s[k]] for k in top]

    def idle_gaps(self, n: int = 10) -> list:
        """The device's idle gaps between its first and last operation,
        summed by the innermost host span open at each gap's middle
        ("between requests" where none is), the longest ``GAPS_LABELLED``
        gaps looked at."""
        m = self._merged()
        gaps = [(b[0] - a[1], (a[1] + b[0]) / 2) for a, b in zip(m, m[1:])
                if b[0] > a[1]]
        gaps.sort(reverse=True)
        if not self.host:
            return []
        names = [h[0] for h in self.host]
        t0 = np.array([h[1] for h in self.host])
        t1 = np.array([h[2] for h in self.host])
        out = defaultdict(float)
        for length, mid in gaps[:GAPS_LABELLED]:
            inside = np.nonzero((t0 <= mid) & (t1 >= mid))[0]
            label = ("between requests" if inside.size == 0 else
                     names[inside[np.argmin(t1[inside] - t0[inside])]])
            out[label] += length / 1e6
        top = sorted(out, key=out.get, reverse=True)[:n]
        return [[k, out[k]] for k in top]
