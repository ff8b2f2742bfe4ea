"""Measurement probes — counterparts of the two probes under ``tools/`` that
are TPU kernels of their own:

- ``lane_gather`` (P1) ↔ ``tools/exp_lane_gather.py``: the cost of a
  per-lane dynamic gather from one 128- or 256-entry row;
- ``r5_mxu`` (P2) ↔ ``tools/exp_r5_mxu.py``: the Möller–Trumbore scan on the
  CUDA cores (A) against a bf16 Woop-transform product on the tensor cores
  (B), per ray-triangle pair.

Run them with ``python -m rt_torch.probes lane_gather|r5_mxu`` (on the card;
``--device cpu`` runs the plain versions).  The kernels are in
``rt_torch/kernels/csrc/probes.cu``; each wrapper launches its kernel on a
CUDA tensor and runs its plain version on a CPU tensor.
"""

from __future__ import annotations

import time

import torch

# the shared memory one block may hold on an H100
# (cudaDevAttrMaxSharedMemoryPerBlockOptin): the probes' launchers size
# their staging by the card's own value, and these mirrors by this one
SMEM_OPTIN = 232448


def launch_counts() -> dict:
    """Kernel launches of the probes so far, by wrapper name."""
    from rt_torch.probes import lane_gather, r5_mxu

    return lane_gather.LAUNCHES | r5_mxu.LAUNCHES


def reset_launch_counts() -> None:
    from rt_torch.probes import lane_gather, r5_mxu

    for table in (lane_gather.LAUNCHES, r5_mxu.LAUNCHES):
        for name in table:
            table[name] = 0


def device_line(device: torch.device) -> str:
    """What a probe ran on, printed before its results."""
    if device.type == "cuda":
        return f"device={device} {torch.cuda.get_device_name(device)}"
    return f"device={device} (the plain versions)"


def timed_ms(fn, reps: int, device: torch.device) -> float:
    """Mean milliseconds of one ``fn()`` over ``reps`` calls after one
    warm-up call: by CUDA events around the launches on the card, by the
    host clock on the CPU."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / reps
