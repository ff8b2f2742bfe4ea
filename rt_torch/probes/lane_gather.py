"""Probe P1: the cost of a per-lane dynamic gather from one row of a table —
counterpart of ``tools/exp_lane_gather.py`` (``_probe_kernel``, ``run``,
``main``).

    out[r, c] = sum over i < iters of tab[r, (idx[r, c] + i) % tw]

summed in f32 in order from i = 0.  It is the primitive of a per-ray exact
"windowed lane-gather" traversal.  On the TPU it is a ``tpu.dynamic_gather``
across the lanes of a vector register; here it is an indexed load from the
row staged in shared memory (``csrc/probes.cu:lane_gather_kernel``): a
block is one warp, ``THREADS`` columns of one row (``column_split``), and
each block stages its row, in four copies shifted by 0-3 where the width is
a multiple of 4 (``copies``), so that a lane reads four elements with one
aligned 128-bit load.  Any (th, tw) up to ``MAX_WIDTH`` columns, the row
once in a block's shared memory.

``lane_gather`` launches the kernel on a CUDA tensor and runs
``lane_gather_plain`` on a CPU tensor; ``LAUNCHES`` counts kernel launches,
nothing else.  The kernel, the plain version, the NumPy reference and the
TPU kernel add in the same order, so all four are bit-equal.

``bound_parts`` gives the least time of the work on the card: one thread's
chain of ``iters`` dependent adds at the latency ``chain_link`` measures,
or the shared-memory wavefronts of the gathers counted from ``idx`` (for
each warp and i, the most lanes on one bank) over the multiprocessors in
use, whichever is longer.

``main`` runs what the tool's ``main`` runs: the shapes ``SHAPES`` at
``ITERS`` iterations, inputs drawn from ``np.random.default_rng(0)`` in the
tool's order.  Each line has ``correct`` (bit-equality with the NumPy
reference; the tool's is ``allclose`` at 1e-4), the time of a call by CUDA
events around the wrapper (the tool times one call through a host
readback; a launch takes a few microseconds, less than the wrapper costs
the host), and on the card the kernel alone from a CUDA graph with its ns
per dependent gather (kernel time / iters: the tool's ns/gather-plane, its
ns/vreg having no counterpart here).
"""

from __future__ import annotations

import numpy as np
import torch

from rt_torch.kernels.tris_kernel import _require
from rt_torch.probes import SMEM_OPTIN, device_line, timed_ms

SHAPES = ((8, 128), (32, 128), (32, 256))
ITERS = 512
THREADS = 32              # csrc/probes.cu LG_THREADS: a block's columns
MAX_WIDTH = SMEM_OPTIN // 4   # the row once in a block's shared memory
MAX_ROWS = 65535              # the grid's y
TIMED_REPS = 20
GRAPH_REPS = 50

LAUNCHES = {"lane_gather": 0}


def copies(tw: int) -> int:
    """Copies of the row a block stages: 4 (shifted by 0-3, read in
    aligned 128-bit loads) where tw is a multiple of 4 and they fit, else
    1."""
    return 4 if tw % 4 == 0 and 4 * tw * 4 <= SMEM_OPTIN else 1


def grid(th: int, tw: int) -> tuple:
    """The kernel's grid: (blocks a row, rows)."""
    return -(-tw // THREADS), th


def column_split(th: int, tw: int) -> np.ndarray:
    """The (row, column) each thread of the grid takes, as the kernel
    computes it (block (x, r), thread t: column x * THREADS + t of row r,
    none past tw), in block and thread order: (threads that take one, 2)
    int64."""
    bx, by = grid(th, tw)
    x, r, t = np.meshgrid(np.arange(bx), np.arange(by), np.arange(THREADS),
                          indexing="ij")
    c = (x * THREADS + t).reshape(-1)
    r = r.reshape(-1)
    keep = c < tw
    return np.stack([r[keep], c[keep]], axis=1)


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
    if not 0 < tw <= MAX_WIDTH or not 0 < th <= MAX_ROWS or iters < 0:
        raise ValueError(f"lane_gather: tab {th}x{tw}, iters {iters}: need "
                         f"1 to {MAX_WIDTH} columns, 1 to {MAX_ROWS} rows, "
                         f"iters >= 0")
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


def chain_link(device="cuda", n: int = 1 << 20) -> dict:
    """The latency of one link of a dependent f32 add chain on the card:
    one thread adds n times to one sum (``csrc/probes.cu:fadd_chain_kernel``)
    between two reads of the SM's cycle counter and of the global
    nanosecond timer.  Returns cycles a link and the SM clock over the
    chain (cycles / nanoseconds)."""
    from rt_torch.kernels import _build

    dev = torch.device(device)
    x = torch.tensor([0.0, 1e-30], dtype=torch.float32, device=dev)
    out = torch.empty(1, dtype=torch.float32, device=dev)
    spans = torch.zeros(2, dtype=torch.int64, device=dev)
    lib = _build.load()
    for _ in range(2):          # the first launch warms up
        code = lib.rt_probe_fadd_chain(
            x.data_ptr(), out.data_ptr(), spans.data_ptr(), n,
            torch.cuda.current_stream(dev).cuda_stream)
        _build.check(lib, code, "chain_link")
    cycles, ns = spans.tolist()
    return dict(adds=n, cycles_per_add=cycles / n,
                clock_mhz=cycles / ns * 1e3)


def bound_parts(idx: np.ndarray, iters: int, cycles_per_add: float,
                clock_mhz: float, sms: int) -> dict:
    """The least time of ``lane_gather`` on (th, tw) = idx.shape at these
    iterations, in ms: ``chain_ms``, one thread's ``iters`` dependent adds
    at ``cycles_per_add`` a link; ``wavefront_ms``, the shared-memory
    wavefronts of the gathers from one staged row, counted from idx (for
    each warp of ``column_split`` and each i, the most lanes on one of the
    32 banks), one a cycle on each multiprocessor in use (the grid's
    blocks, at most ``sms``); ``bound_ms``, the larger.  Also the
    wavefronts without conflicts (one a warp and i) and their time."""
    th, tw = idx.shape
    bx, _ = grid(th, tw)
    j0 = np.mod(idx.astype(np.int64), tw)
    lanes = np.full((th, bx * THREADS), -1, np.int64)
    lanes[:, :tw] = j0
    lanes = lanes.reshape(-1, THREADS)                 # (warps, 32)
    warps = lanes.shape[0]
    live = lanes >= 0
    total = 0
    for i0 in range(0, iters, 64):
        i = np.arange(i0, min(iters, i0 + 64))
        bank = np.mod(lanes[:, :, None] + i[None, None, :], tw) % 32
        key = (np.arange(warps)[:, None, None] * len(i)
               + np.arange(len(i))[None, None, :]) * 32 + bank
        counts = np.bincount(key[np.broadcast_to(live[:, :, None],
                                                 key.shape)],
                             minlength=warps * len(i) * 32)
        total += int(counts.reshape(-1, 32).max(axis=1).sum())
    in_use = min(sms, bx * th)
    hz = clock_mhz * 1e6
    chain_ms = iters * cycles_per_add / hz * 1e3
    wave_ms = total / in_use / hz * 1e3
    free = warps * iters
    return dict(chain_ms=chain_ms, wavefront_ms=wave_ms, wavefronts=total,
                wavefronts_per_gather=total / free,
                conflict_free_wavefronts=free,
                conflict_free_ms=free / in_use / hz * 1e3,
                sms_in_use=in_use, bound_ms=max(chain_ms, wave_ms),
                bound_by="chain" if chain_ms >= wave_ms else "wavefronts")


def run(th: int, tw: int, iters: int, device) -> dict:
    """One shape: launch, compare with the NumPy reference, time, print."""
    device = torch.device(device)
    tab_row, tab_np, idx_np = inputs(th, tw)
    tab = torch.from_numpy(tab_np).to(device)
    idx = torch.from_numpy(idx_np).to(device)
    out = lane_gather(tab, idx, iters).cpu().numpy()
    ok = bool(np.array_equal(out.view(np.int32),
                             reference(tab_row, idx_np, iters).view(np.int32)))
    call = lambda: lane_gather(tab, idx, iters)
    ms = timed_ms(call, TIMED_REPS, device)
    if device.type == "cuda":
        from rt_torch.measure import _graph_ms

        kernel_ms = _graph_ms(call, GRAPH_REPS)
    else:
        kernel_ms = ms
    per = kernel_ms * 1e6 / max(iters, 1)
    what = "kernel" if device.type == "cuda" else "plain"
    print(f"(th={th:3d}, tw={tw:3d}) iters={iters}: correct={ok} "
          f"{ms:.4f} ms a call, {what} {kernel_ms:.4f} ms, "
          f"{per:.2f} ns/dependent-gather", flush=True)
    return dict(th=th, tw=tw, iters=iters, correct=ok, ms=ms,
                kernel_ms=kernel_ms, ns_per_dependent_gather=per)


def main(device="cuda", iters: int = ITERS) -> list:
    """The tool's ``main``: every shape of ``SHAPES`` at ``iters``
    iterations.  Returns one result per shape."""
    print(device_line(torch.device(device)), flush=True)
    return [run(th, tw, iters, device) for th, tw in SHAPES]
