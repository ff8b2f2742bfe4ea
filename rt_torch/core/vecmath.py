"""Vector math on tuples of component tensors — counterpart of
``rt/core/vecmath.py`` and ``rt/kernels/plane_math.py:68-147``.

A vector is a tuple of same-shaped f32 tensors, one per component (the
layout the kernels use: one ray per lane).  Every expression keeps the
operation order of the JAX package, so results agree bit for bit:
division (never reciprocal-multiply), no zero guard in normalize (NaN on a
zero vector, like the GPU reference), left-to-right dot products, and a
correctly rounded square root (``sqrt`` below).
"""

from __future__ import annotations

import torch


def sqrt(x):
    """Correctly rounded f32 square root.  ``torch.sqrt`` on a CPU float32
    tensor goes through a vector math library that is off by 1 ULP on
    about 0.6 % of inputs; the f64 root rounded to f32 is exact, as are
    XLA's and CUDA's ``sqrtf``."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def add3(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def sub3(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def mul3(a, b):
    return (a[0] * b[0], a[1] * b[1], a[2] * b[2])


def scale3(a, k):
    return (a[0] * k, a[1] * k, a[2] * k)


def neg3(a):
    return (-a[0], -a[1], -a[2])


def where3(m, a, b):
    return (torch.where(m, a[0], b[0]), torch.where(m, a[1], b[1]),
            torch.where(m, a[2], b[2]))


def normalize3(a):
    ln = sqrt(dot3(a, a))
    return (a[0] / ln, a[1] / ln, a[2] / ln)


def normalize2(a):
    ln = sqrt(a[0] * a[0] + a[1] * a[1])
    return (a[0] / ln, a[1] / ln)


def cross3(a, b):
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def reflect3(v, n):
    k = 2.0 * dot3(v, n)
    return sub3(v, scale3(n, k))


def refract3(uv, n, ir):
    cos_theta = torch.clamp(dot3(neg3(uv), n), max=1.0)
    perp = scale3(add3(uv, scale3(n, cos_theta)), ir)
    ln = sqrt(dot3(perp, perp))
    par_k = -sqrt(torch.abs(1.0 - ln * ln))
    return add3(perp, scale3(n, par_k))


def schlick(cosine, ref_idx):
    """Schlick reflectance.  The fifth power is the multiply chain
    ``(x*x)*(x*x)*x`` — what XLA's integer power computes; ``torch.pow``
    and CUDA ``powf`` round differently."""
    r0 = (1.0 - ref_idx) / (1.0 + ref_idx)
    r0 = r0 * r0
    x = 1.0 - cosine
    x2 = x * x
    return r0 + (1.0 - r0) * (x2 * x2 * x)


def fract(x):
    return x - torch.floor(x)


def dot4(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2] + a[3] * b[3]


def normalize4(a):
    ln = sqrt(dot4(a, a))
    return (a[0] / ln, a[1] / ln, a[2] / ln, a[3] / ln)


# ---------------------------------------------------------------------------
# the same on (..., 3) or (..., 4) tensors — counterpart of
# ``rt/core/vecmath.py``, for the differentiable replay graph
# (``rt_torch/grad``).  Sums run left to right over the components, as the
# tuple forms above do, so both forms give the same primary rays.
# ---------------------------------------------------------------------------

def dot(a, b):
    p = a * b
    out = p[..., 0]
    for c in range(1, p.shape[-1]):
        out = out + p[..., c]
    return out


def normalize(v):
    """v / length(v), no zero guard (NaN on a zero vector)."""
    return v / sqrt(dot(v, v))[..., None]


def cross(a, b):
    return torch.stack(cross3((a[..., 0], a[..., 1], a[..., 2]),
                              (b[..., 0], b[..., 1], b[..., 2])), dim=-1)


def reflect(v, n):
    return v - (2.0 * dot(v, n))[..., None] * n


def refract(uv, n, etai_over_etat):
    """``refract3`` with both square roots guarded for the backward pass: a
    ray exactly antiparallel to the normal makes the perpendicular part
    zero, and grazing incidence on a unit direction makes ``1 - ln*ln``
    zero; the root's derivative there is infinite and would poison the
    cotangents even on lanes whose scatter output is masked away.  The
    forward values are those of the unguarded form."""
    cos_theta = torch.clamp(dot(-uv, n), max=1.0)
    perp = etai_over_etat[..., None] * (uv + cos_theta[..., None] * n)
    lnsq = dot(perp, perp)
    pos = lnsq > 0.0
    ln = torch.where(pos, sqrt(torch.where(pos, lnsq, 1.0)), 0.0)
    x = 1.0 - ln * ln
    nz = x != 0.0
    sq = torch.where(nz, sqrt(torch.abs(torch.where(nz, x, 1.0))), 0.0)
    return perp - sq[..., None] * n


schlick_reflectance = schlick
