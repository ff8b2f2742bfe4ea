"""The renderer's per-pixel PCG RNG — counterpart of ``rt/core/rng.py`` and
``rt/kernels/plane_math.py:30-61``.

torch has no uint32 add/shift/multiply on the CPU, so the plain form carries
the state as int64 masked with ``0xFFFFFFFF`` after every wrapping op.  Every
intermediate stays below 2**62 (state < 2**32, multiplier < 2**29), so int64
never overflows.  Tensors that cross a kernel boundary hold the state as
int32 bit patterns (``to_i32`` / ``from_i32``); the CUDA kernels reinterpret
those as ``uint32_t``.
"""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
_INC = (747796405 + 2891336453) & MASK
_MULT = 277803737
_DENOM = 4294967296.0          # f32(0xffffffffu) rounds to 2**32


def seed(x: torch.Tensor, y: torch.Tensor, height: int,
         time: torch.Tensor | int) -> torch.Tensor:
    """Per-pixel seed ``(x * height + y) * time`` with u32 wrap.  x, y and
    time are int64 holding u32 values.  The product of two u32 values can
    pass 2**63, so ``time`` is split into 16-bit halves."""
    a = (x * height + y) & MASK
    lo = a * (time & 0xFFFF)
    hi = ((a * (time >> 16)) & MASK) << 16
    return (lo + hi) & MASK


def step(s: torch.Tensor) -> torch.Tensor:
    """One rng_int step on an int64 tensor of u32 values."""
    old = (s + _INC) & MASK
    shift = (old >> 28) + 4
    word = (((old >> shift) ^ old) * _MULT) & MASK
    return (word >> 22) ^ word


def u32_to_f32(s: torch.Tensor) -> torch.Tensor:
    """Round-to-nearest-even u32 -> f32 (int64 -> f32 is exact rounding for
    values below 2**32; the kernels use ``__uint2float_rn``)."""
    return s.to(torch.float32)


def next_float(s: torch.Tensor):
    """rng_float: (new_state, f32 in [0, 1])."""
    s = step(s)
    return s, u32_to_f32(s) / _DENOM


def to_i32(s: torch.Tensor) -> torch.Tensor:
    """int64 u32 values -> int32 bit patterns."""
    return (((s + 0x80000000) & MASK) - 0x80000000).to(torch.int32)


def from_i32(s: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 u32 values."""
    return s.to(torch.int64) & MASK
