"""Probe P1: the cost of a per-lane dynamic gather from one row of a table —
counterpart of ``tools/exp_lane_gather.py`` (``_probe_kernel``, ``run``,
``main``).

    out[r, c] = sum over i < iters of tab[r, (idx[r, c] + i) % tw]

summed in f32 in order from i = 0.  It is the primitive of a per-ray exact
"windowed lane-gather" traversal.  On the TPU it is a ``tpu.dynamic_gather``
across the lanes of a vector register; here it is an indexed load from the
row staged in shared memory (``csrc/probes.cu:lane_gather_kernel``).

``lane_gather`` launches the kernel on a CUDA tensor and runs
``lane_gather_plain`` on a CPU tensor; ``LAUNCHES`` counts kernel launches,
nothing else.  The kernel, the plain version, the NumPy reference and the
TPU kernel add in the same order, so all four are bit-equal.

``main`` runs what the tool's ``main`` runs: the shapes ``SHAPES`` at
``ITERS`` iterations, inputs drawn from ``np.random.default_rng(0)`` in the
tool's order.  It times the call by CUDA events around the launches (the
tool times one call through a host readback) and prints the tool's line
without its TPU-only ns/vreg column; ``correct`` is bit-equality with the
NumPy reference (the tool's is ``allclose`` at 1e-4).  A launch takes a few
microseconds, less than the wrapper costs the host, so that time is mostly
the host's; ``chip_smoke.py`` reads the kernel alone from a CUDA graph.
"""

from __future__ import annotations

import numpy as np
import torch

from rt_torch.kernels.tris_kernel import _require
from rt_torch.probes import device_line, timed_ms

SHAPES = ((8, 128), (32, 128), (32, 256))
ITERS = 512
MAX_WIDTH = 1024          # one thread per column, one block per row
TIMED_REPS = 20

LAUNCHES = {"lane_gather": 0}


def inputs(th: int, tw: int, seed: int = 0):
    """(tab_row (tw,) f32, tab (th, tw) f32: the row broadcast, idx (th, tw)
    int32 in [0, tw)) as NumPy, drawn as the tool draws them."""
    rng = np.random.default_rng(seed)
    tab_row = rng.random(tw, dtype=np.float32)
    tab = np.broadcast_to(tab_row, (th, tw)).copy()
    idx = rng.integers(0, tw, size=(th, tw), dtype=np.int32)
    return tab_row, tab, idx


def reference(tab_row: np.ndarray, idx: np.ndarray, iters: int):
    """The tool's NumPy reference."""
    ref = np.zeros(idx.shape, np.float32)
    for i in range(iters):
        ref += tab_row[(idx + i) % tab_row.shape[0]]
    return ref


def lane_gather_plain(tab: torch.Tensor, idx: torch.Tensor, iters: int):
    """Plain version: (th, tw) f32."""
    tw = tab.shape[1]
    idx = idx.to(torch.int64)
    acc = torch.zeros_like(tab)
    for i in range(iters):
        acc = acc + torch.gather(tab, 1, (idx + i) % tw)
    return acc


def lane_gather(tab: torch.Tensor, idx: torch.Tensor, iters: int):
    """(th, tw) f32: out[r, c] = sum over i < iters of
    tab[r, (idx[r, c] + i) % tw].  tab (th, tw) f32, idx (th, tw) int32; the
    column is taken modulo tw with the divisor's sign, as ``%`` does."""
    if tab.device.type == "cpu":
        return lane_gather_plain(tab, idx, iters)
    from rt_torch.kernels import _build

    th, tw = tab.shape
    if not 0 < tw <= MAX_WIDTH or th < 1 or iters < 0:
        raise ValueError(f"lane_gather: tab {th}x{tw}, iters {iters}: need "
                         f"1 to {MAX_WIDTH} columns, a row, iters >= 0")
    _require(tab, "tab", torch.float32, (th, tw))
    _require(idx, "idx", torch.int32, (th, tw))
    out = torch.empty_like(tab)
    lib = _build.load()
    code = lib.rt_lane_gather(tab.data_ptr(), idx.data_ptr(), out.data_ptr(),
                              th, tw, iters,
                              torch.cuda.current_stream(tab.device)
                              .cuda_stream)
    _build.check(lib, code, "lane_gather")
    LAUNCHES["lane_gather"] += 1
    return out


def run(th: int, tw: int, iters: int, device) -> dict:
    """One shape: launch, compare with the NumPy reference, time, print."""
    device = torch.device(device)
    tab_row, tab_np, idx_np = inputs(th, tw)
    tab = torch.from_numpy(tab_np).to(device)
    idx = torch.from_numpy(idx_np).to(device)
    out = lane_gather(tab, idx, iters).cpu().numpy()
    ok = bool(np.array_equal(out.view(np.int32),
                             reference(tab_row, idx_np, iters).view(np.int32)))
    ms = timed_ms(lambda: lane_gather(tab, idx, iters), TIMED_REPS, device)
    per = ms * 1e6 / iters
    print(f"(th={th:3d}, tw={tw:3d}) iters={iters}: correct={ok} "
          f"{ms:.4f} ms total, {per:.2f} ns/gather-plane", flush=True)
    return dict(th=th, tw=tw, iters=iters, correct=ok, ms=ms,
                ns_per_gather_plane=per)


def main(device="cuda", iters: int = ITERS) -> list:
    """The tool's ``main``: every shape of ``SHAPES`` at ``iters``
    iterations.  Returns one result per shape."""
    print(device_line(torch.device(device)), flush=True)
    return [run(th, tw, iters, device) for th, tw in SHAPES]
