"""Material scatter on (..., 3) tensors — counterpart of
``rt/core/materials.py``, for the differentiable replay graph
(``rt_torch/grad``).  All three material programs are evaluated on every
lane and selected with ``torch.where``; autograd then routes gradients
through the taken arm only.

The kernels' plain versions use ``kernels.tracer_common.scatter`` instead
(component planes, arms skipped by scene flags, bit-equal to the CUDA
kernels); nothing differentiates through that one.

RNG stream: lambertian and metal consume 3 draws; dielectric consumes 1
unless total internal reflection, then none; unknown material ids take the
dielectric arm.
"""

from __future__ import annotations

import torch

from rt_torch.config import MAT_LAMBERTIAN, MAT_METAL
from rt_torch.core import rng
from rt_torch.core import vecmath as vm


def random_on_hemisphere_values(f3, normal):
    """Normalised positive-octant draw ``f3``, sign-flipped against the
    normal (uniform over a biased set, not cosine-weighted)."""
    v = vm.normalize(f3)
    return torch.where((vm.dot(v, normal) > 0.0)[..., None], v, -v)


def scatter(state, ray_origin, ray_dir, hit, *, normalize_reflect_in: bool):
    """Returns (new_state, new_origin, new_direction).

    state: int64 tensor of u32 values.  hit: dict with keys point, normal,
    front_face, mat_param, mat_kind.
    """
    normal = hit["normal"]
    kind = hit["mat_kind"]
    param = hit["mat_param"]

    s1, f1 = rng.next_float(state)
    s2, f2 = rng.next_float(s1)
    s3, f3 = rng.next_float(s2)
    hemi = random_on_hemisphere_values(torch.stack([f1, f2, f3], dim=-1),
                                       normal)

    lam_dir = hemi

    refl_in = vm.normalize(ray_dir) if normalize_reflect_in else ray_dir
    met_dir = vm.normalize(vm.reflect(refl_in, normal)
                           + param[..., None] * hemi)

    # Gradient guard: lambertian and metal lanes still evaluate the
    # dielectric arm, and their parameter is a fuzz (often 0), so ir would
    # be 1/0 and the NaN of the untaken arm would poison the cotangents
    # (0 * NaN).  With ir pinned to 1 there the selected forward values are
    # unchanged and the backward pass stays finite.
    is_lam = kind == MAT_LAMBERTIAN
    is_met = kind == MAT_METAL
    param_die = torch.where(is_lam | is_met, torch.ones_like(param), param)
    ir = torch.where(hit["front_face"], 1.0 / param_die, param_die)
    cos_theta = torch.clamp(vm.dot(-ray_dir, normal), max=1.0)
    sin_theta = vm.sqrt(1.0 - cos_theta * cos_theta)
    cannot_refract = ir * sin_theta > 1.0
    use_reflect = cannot_refract | (vm.schlick_reflectance(cos_theta, ir)
                                    > vm.fract(f1))
    die_dir = torch.where(use_reflect[..., None],
                          vm.normalize(vm.reflect(ray_dir, normal)),
                          vm.normalize(vm.refract(ray_dir, normal, ir)))
    die_state = torch.where(cannot_refract, state, s1)

    new_dir = torch.where(is_lam[..., None], lam_dir,
                          torch.where(is_met[..., None], met_dir, die_dir))
    new_state = torch.where(is_lam | is_met, s3, die_state)
    return new_state, hit["point"], new_dir
