"""Plain PyTorch versions of the tracer stages every kernel shares: camera
ray generation, the three-way material scatter, the sky and the sample loop
of the whole-frame kernels — counterpart of
``rt/kernels/tracer_common.py``.  The CUDA form of the same stages is
``csrc/rt_device.cuh``; the two must stay operation for operation alike.

Camera scalars travel as one float32 row:
  [0:4) eye  [4:8) direction  [8:12) up  [12:16) right
  [16] focal_length  [17] focal_blur  [18] fov  [19] tan(fov/2)
Slot 19 is padding in the JAX package.  The port stores ``tan(fov*0.5)``
there, computed once on the host (``dispatch.pack_camera``): CUDA ``tanf``,
torch and XLA are three implementations, so neither the kernel nor the
plain version evaluates it.
"""

from __future__ import annotations

import torch

from rt_torch.config import BLUE, SKY
from rt_torch.core import rng
from rt_torch.core import vecmath as vm

CAM_EYE, CAM_DIR, CAM_UP, CAM_RIGHT = 0, 4, 8, 12
CAM_FL, CAM_BLUR, CAM_FOV, CAM_TAN = 16, 17, 18, 19
CAM_WIDTH = 20


def generate_rays(cam, x, y, *, height: int, width: int, time,
                  normalize_defocus_dir: bool):
    """Seed + AA jitter + uv + make_ray.

    cam: sequence of CAM_WIDTH Python floats (each exactly an f32 value).
    x, y: int64 pixel-coordinate tensors; time: int64 tensor of u32 values,
    broadcastable to x.  Returns (state int64, o3, d4).
    """
    x_f = x.to(torch.float32)
    y_f = y.to(torch.float32)
    state = rng.seed(x, y, height, time)

    # AA jitter: pos + normalize(rng_vec2)
    state, jx = rng.next_float(state)
    state, jy = rng.next_float(state)
    jx, jy = vm.normalize2((jx, jy))
    px = x_f + 0.5 + jx
    py = y_f + 0.5 + jy

    # uv = (2*pos/(res-1) - 1) * (aspect, -1).  The divisors are 0-dim
    # tensors on the device: torch's CUDA division by a Python scalar
    # multiplies by the scalar's reciprocal, which is not the IEEE quotient.
    f32 = lambda v: torch.tensor(float(v), dtype=torch.float32,
                                 device=x.device)
    ux = px / f32(width - 1)
    uy = py / f32(height - 1)
    aspect = (f32(width) / f32(height)).item()
    uvx = (2.0 * ux - 1.0) * aspect
    uvy = -(2.0 * uy - 1.0)

    # make_ray: 4-vec normalize with a live w
    k = cam[CAM_TAN]
    kx = uvx * k
    ky = uvy * k
    d4 = tuple(cam[CAM_RIGHT + c] * kx + cam[CAM_UP + c] * ky
               + cam[CAM_DIR + c] for c in range(4))
    d4 = vm.normalize4(d4)

    zero = torch.zeros_like(x_f)
    o4 = tuple(zero + cam[CAM_EYE + c] for c in range(4))
    fl = cam[CAM_FL]
    focus = tuple(o4[c] + d4[c] * fl for c in range(4))

    # random_on_disk: always 3 draws
    state, vx = rng.next_float(state)
    state, vy = rng.next_float(state)
    vx, vy = vm.normalize2((vx, vy))
    state, r = rng.next_float(state)
    r = r * cam[CAM_BLUR]
    o4 = (o4[0] + vx * r, o4[1] + vy * r, o4[2], o4[3] + 1.0)

    d4 = tuple(focus[c] - o4[c] for c in range(4))
    if normalize_defocus_dir:
        d4 = vm.normalize4(d4)
    return state, (o4[0], o4[1], o4[2]), d4


def scatter(state, d, point, normal, front_face, albedo, param, kind, *,
            normalize_reflect_in: bool, has_metal: bool = True,
            has_dielectric: bool = True):
    """Masked three-way material scatter.  Returns (new_state, new_dir3).

    RNG draws: lambertian and metal consume 3; dielectric consumes 1 unless
    total internal reflection, then none; unknown kinds take the dielectric
    arm.  Arms for material kinds the scene lacks are skipped.
    """
    s1, f1 = rng.next_float(state)
    s2, f2 = rng.next_float(s1)
    s3, f3 = rng.next_float(s2)
    hemi = vm.normalize3((f1, f2, f3))
    hemi = vm.where3(vm.dot3(hemi, normal) > 0.0, hemi, vm.neg3(hemi))
    lam_dir = hemi

    if has_metal:
        refl_in = vm.normalize3(d) if normalize_reflect_in else d
        met_dir = vm.normalize3(
            vm.add3(vm.reflect3(refl_in, normal), vm.scale3(hemi, param)))

    if has_dielectric:
        ir = torch.where(front_face, 1.0 / param, param)
        cos_theta = torch.clamp(vm.dot3(vm.neg3(d), normal), max=1.0)
        sin_theta = vm.sqrt(1.0 - cos_theta * cos_theta)
        cannot_refract = ir * sin_theta > 1.0
        use_reflect = cannot_refract | (vm.schlick(cos_theta, ir)
                                        > vm.fract(f1))
        die_dir = vm.where3(use_reflect,
                            vm.normalize3(vm.reflect3(d, normal)),
                            vm.normalize3(vm.refract3(d, normal, ir)))
        die_state = torch.where(cannot_refract, state, s1)

    is_lam = kind == 1
    if has_metal and has_dielectric:
        is_met = kind == 2
        new_dir = vm.where3(is_lam, lam_dir,
                            vm.where3(is_met, met_dir, die_dir))
        new_state = torch.where(is_lam | is_met, s3, die_state)
    elif has_metal:
        new_dir = vm.where3(is_lam, lam_dir, met_dir)
        new_state = s3
    elif has_dielectric:
        new_dir = vm.where3(is_lam, lam_dir, die_dir)
        new_state = torch.where(is_lam, s3, die_state)
    else:
        new_dir = lam_dir
        new_state = s3
    return new_state, new_dir


def sky_times_atten(primary_dy, atten):
    """color = atten * mix(SKY, BLUE, dir.y*0.5+0.5), unclamped, on the
    PRIMARY direction.  atten: three tensors; returns three tensors."""
    t = primary_dy * 0.5 + 0.5
    return tuple(atten[c] * (SKY[c] * (1.0 - t) + BLUE[c] * t)
                 for c in range(3))


def sample_loop(bounce, state, o, d0, primary_dy, *, bounces: int, spp: int,
                sky_from_final_dir: bool):
    """The sample loop of one frame: the same primary ray traced ``spp``
    times with the RNG state carried across samples, then a true divide.
    bounce: carry -> carry.  A dead ray passes through a bounce unchanged,
    so the kernels' early exits (a thread at its own miss, a block when all
    its rays are dead) only skip work, and so does the ``break`` here."""
    one = torch.ones_like(o[0])
    zero = torch.zeros_like(o[0])
    acc = (zero, zero, zero)
    for _ in range(spp):
        carry = (state, o, d0, (one, one, one),
                 torch.ones_like(state, dtype=torch.int32))
        for _ in range(bounces):
            if not bool((carry[4] > 0).any()):
                break
            carry = bounce(carry)
        state, _, d, atten, _ = carry
        col = sky_times_atten(d[1] if sky_from_final_dir else primary_dy,
                              atten)
        acc = vm.add3(acc, col) if spp > 1 else col
    if spp > 1:
        # a tensor divisor: CUDA division by a Python scalar multiplies by
        # its reciprocal, which is not the IEEE quotient
        n = torch.tensor(float(spp), dtype=torch.float32, device=o[0].device)
        acc = (acc[0] / n, acc[1] / n, acc[2] / n)
    return acc


def index_planes(planes, bounces: int, like):
    """(bounces, ...) int32 from the index planes of the bounces a recorder
    ran; the bounces after every ray died read -1."""
    miss = torch.full_like(like, -1, dtype=torch.int32)
    return torch.stack(planes + [miss] * (bounces - len(planes)))
