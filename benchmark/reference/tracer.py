"""The plain reference path tracer: what decides ``correct``.

The transport of the reference app's shaders, written out in plain PyTorch
on any device and in any float dtype (float32 is the configurations'
precision; the control runs it in bfloat16): the per-pixel PCG stream,
anti-aliased primary rays with the vec4 camera and the defocus disk, the
closest hit by testing EVERY primitive (no chunks, no boxes, no sort, no
tiles), the three-way material scatter, attenuation ``albedo * 0.7`` a hit,
and the sky of the primary direction.  Each arithmetic expression keeps
the order of operations of the app's shaders, so a sound program gives
the same bits except where two primitives tie for the closest hit.

Lanes are (frame time, pixel) pairs; only live lanes are traced at each
bounce.  ``counts`` gathers the work the roofline yardstick is made of.
"""

from __future__ import annotations

import numpy as np
import torch

MASK = 0xFFFFFFFF
_INC = (747796405 + 2891336453) & MASK
_MULT = 277803737
_DENOM = 4294967296.0
EPS_TRIS = float(np.float32(1e-4))
FLT_MAX = float(np.float32(3.40282e38))
SKY = (0.54, 0.86, 0.92)
BLUE = (0.54, 0.7, 0.98)
CAM_EYE, CAM_DIR, CAM_UP, CAM_RIGHT = 0, 4, 8, 12
CAM_FL, CAM_BLUR, CAM_TAN = 16, 17, 19
# (ray, primitive) pairs a block of the brute-force scan holds at once
PAIRS_PER_BLOCK = 1 << 24


def far(dt) -> float:
    """The t of a miss: FLT_MAX, or the dtype's largest where that is
    smaller."""
    return min(FLT_MAX, torch.finfo(dt).max)


# ---------------------------------------------------------------- the RNG

def rng_seed(x, y, height: int, time):
    """(x * height + y) * time with u32 wrap, on int64 tensors."""
    a = (x * height + y) & MASK
    lo = a * (time & 0xFFFF)
    hi = ((a * (time >> 16)) & MASK) << 16
    return (lo + hi) & MASK


def rng_step(s):
    old = (s + _INC) & MASK
    shift = (old >> 28) + 4
    word = (((old >> shift) ^ old) * _MULT) & MASK
    return (word >> 22) ^ word


def rng_float(s, dt):
    s = rng_step(s)
    return s, s.to(dt) / _DENOM


# ----------------------------------------------------- vectors as tuples

def sqrt(x):
    """Correctly rounded square root in x's dtype."""
    return torch.sqrt(x.to(torch.float64)).to(x.dtype)


def dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def cross3(a, b):
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def where3(m, a, b):
    return tuple(torch.where(m, a[c], b[c]) for c in range(3))


def normalize3(a):
    ln = sqrt(dot3(a, a))
    return (a[0] / ln, a[1] / ln, a[2] / ln)


def normalize2(a, b):
    ln = sqrt(a * a + b * b)
    return a / ln, b / ln


def normalize4(a):
    ln = sqrt(a[0] * a[0] + a[1] * a[1] + a[2] * a[2] + a[3] * a[3])
    return tuple(c / ln for c in a)


def reflect3(v, n):
    k = 2.0 * dot3(v, n)
    return tuple(v[c] - n[c] * k for c in range(3))


def refract3(uv, n, ir):
    cos_theta = torch.clamp(dot3(tuple(-c for c in uv), n), max=1.0)
    perp = tuple((uv[c] + n[c] * cos_theta) * ir for c in range(3))
    ln = sqrt(dot3(perp, perp))
    par_k = -sqrt(torch.abs(1.0 - ln * ln))
    return tuple(perp[c] + n[c] * par_k for c in range(3))


def schlick(cosine, ref_idx):
    r0 = (1.0 - ref_idx) / (1.0 + ref_idx)
    r0 = r0 * r0
    x = 1.0 - cosine
    x2 = x * x
    return r0 + (1.0 - r0) * (x2 * x2 * x)


# ------------------------------------------------------- rays and scatter

def primary_rays(cam, x, y, time, *, height: int, width: int,
                 normalize_defocus_dir: bool, dt):
    """(state, origin, direction) of the camera rays of pixels (x, y) at
    time uniforms ``time`` (int64 tensors of one shape)."""
    x_f, y_f = x.to(dt), y.to(dt)
    state = rng_seed(x, y, height, time)
    state, jx = rng_float(state, dt)
    state, jy = rng_float(state, dt)
    jx, jy = normalize2(jx, jy)
    px = x_f + 0.5 + jx
    py = y_f + 0.5 + jy
    # tensor divisors: a division by a Python scalar may run as a multiply
    # by its reciprocal, which is not the quotient
    scalar = lambda v: torch.tensor(float(v), dtype=dt, device=x.device)
    ux = px / scalar(width - 1)
    uy = py / scalar(height - 1)
    aspect = (scalar(width) / scalar(height)).item()
    uvx = (2.0 * ux - 1.0) * aspect
    uvy = -(2.0 * uy - 1.0)
    k = cam[CAM_TAN]
    kx, ky = uvx * k, uvy * k
    d4 = normalize4(tuple(cam[CAM_RIGHT + c] * kx + cam[CAM_UP + c] * ky
                          + cam[CAM_DIR + c] for c in range(4)))
    zero = torch.zeros_like(x_f)
    o4 = tuple(zero + cam[CAM_EYE + c] for c in range(4))
    focus = tuple(o4[c] + d4[c] * cam[CAM_FL] for c in range(4))
    state, vx = rng_float(state, dt)
    state, vy = rng_float(state, dt)
    vx, vy = normalize2(vx, vy)
    state, r = rng_float(state, dt)
    r = r * cam[CAM_BLUR]
    o4 = (o4[0] + vx * r, o4[1] + vy * r, o4[2], o4[3] + 1.0)
    d4 = tuple(focus[c] - o4[c] for c in range(4))
    if normalize_defocus_dir:
        d4 = normalize4(d4)
    return state, o4[:3], d4[:3]


def scatter(state, d, point, normal, front_face, param, kind, *,
            normalize_reflect_in: bool):
    """(new state, new direction): lambertian and metal draw 3 floats, a
    dielectric 1 (none on total internal reflection)."""
    dt = d[0].dtype
    s1, f1 = rng_float(state, dt)
    s2, f2 = rng_float(s1, dt)
    s3, f3 = rng_float(s2, dt)
    hemi = normalize3((f1, f2, f3))
    hemi = where3(dot3(hemi, normal) > 0.0, hemi, tuple(-c for c in hemi))
    refl_in = normalize3(d) if normalize_reflect_in else d
    refl = reflect3(refl_in, normal)
    met_dir = normalize3(tuple(refl[c] + hemi[c] * param for c in range(3)))
    ir = torch.where(front_face, 1.0 / param, param)
    cos_theta = torch.clamp(dot3(tuple(-c for c in d), normal), max=1.0)
    sin_theta = sqrt(1.0 - cos_theta * cos_theta)
    cannot_refract = ir * sin_theta > 1.0
    use_reflect = cannot_refract | (schlick(cos_theta, ir)
                                    > f1 - torch.floor(f1))
    die_dir = where3(use_reflect, normalize3(reflect3(d, normal)),
                     normalize3(refract3(d, normal, ir)))
    die_state = torch.where(cannot_refract, state, s1)
    is_lam, is_met = kind == 1, kind == 2
    new_dir = where3(is_lam, hemi, where3(is_met, met_dir, die_dir))
    return torch.where(is_lam | is_met, s3, die_state), new_dir


def sky(dy, atten):
    t = dy * 0.5 + 0.5
    return tuple(atten[c] * (SKY[c] * (1.0 - t) + BLUE[c] * t)
                 for c in range(3))


# ------------------------------------------------------------- the scenes

class Triangles:
    """A triangle table on a device in dtype ``dt``: columns a, e1, e2,
    normal, and each row's material; the material table."""

    normalize_defocus_dir = True
    normalize_reflect_in = False

    def __init__(self, tris: dict, device, dt, chunks=None):
        col = lambda k: torch.from_numpy(tris[k]).to(device, dt)
        self.cols = torch.cat([col("a"), col("e1"), col("e2"),
                               col("normal")], dim=1).T.contiguous()
        self.mat_id = torch.from_numpy(tris["mat_id"]).to(device).long()
        self.albedo = torch.from_numpy(tris["albedo"]).to(device, dt)
        self.param = torch.from_numpy(tris["param"]).to(device, dt)
        self.kind_of = torch.from_numpy(tris["kind"]).to(device).long()
        self.m = self.cols.shape[1]
        self.chunks = (None if chunks is None
                       else torch.from_numpy(chunks).to(device, torch.float32))

    def closest(self, o, d):
        """(t, winning row or -1) of rays o, d against every triangle: the
        least valid t, the first row of that t."""
        n = o[0].shape[0]
        dev, dt = o[0].device, o[0].dtype
        best_t = torch.full((n,), far(dt), dtype=dt, device=dev)
        best_i = torch.full((n,), -1, dtype=torch.int64, device=dev)
        c = [self.cols[k][None, :] for k in range(12)]
        rows = torch.arange(self.m, device=dev)
        step = max(1, PAIRS_PER_BLOCK // max(self.m, 1))
        for lo in range(0, n, step):
            hi = min(n, lo + step)
            oo = tuple(v[lo:hi, None] for v in o)
            dd = tuple(v[lo:hi, None] for v in d)
            e1, e2 = c[3:6], c[6:9]
            h = cross3(dd, e2)
            det = dot3(e1, h)
            inv_det = 1.0 / det
            s = (oo[0] - c[0], oo[1] - c[1], oo[2] - c[2])
            u = inv_det * dot3(s, h)
            q = cross3(s, e1)
            v = inv_det * dot3(dd, q)
            t = inv_det * dot3(e2, q)
            valid = torch.abs(det) >= EPS_TRIS
            valid &= (u >= 0.0) & (u <= 1.0)
            valid &= (v >= 0.0) & (u + v <= 1.0)
            valid &= (t >= EPS_TRIS) & (t < FLT_MAX)
            t = torch.where(valid, t, torch.inf)
            tmin = t.amin(dim=1)
            first = torch.where(valid & (t == tmin[:, None]), rows,
                                self.m).amin(dim=1)
            won = first < self.m
            best_t[lo:hi] = torch.where(won, tmin, best_t[lo:hi])
            best_i[lo:hi] = torch.where(won, first, best_i[lo:hi])
        return best_t, best_i

    def resolve(self, o, d, t, idx):
        """(point, normal, front face, albedo, parameter, kind) of the
        winners; a miss reads row 0 and is masked by the caller."""
        i = torch.clamp(idx, min=0)
        n = tuple(self.cols[9 + k][i] for k in range(3))
        mid = self.mat_id[i]
        point = tuple(o[k] + d[k] * t for k in range(3))
        return (point, n, dot3(n, d) > 0.0,
                tuple(self.albedo[mid, k] for k in range(3)),
                self.param[mid], self.kind_of[mid])

    def material_of(self, idx):
        return self.mat_id[torch.clamp(idx, min=0)]

    def chunk_scans(self, o, d, t):
        """Per ray, the chunk boxes it enters before its closest hit: the
        chunks any chunk-culled scan has to scan, whatever its order."""
        if self.chunks is None:
            return None
        f = lambda v: v.to(torch.float32)[:, None]
        o, d, t = tuple(map(f, o)), tuple(map(f, d)), f(t)
        ch = self.chunks
        tmin = tmax = None
        for k in range(3):
            inv = 1.0 / d[k]
            t0 = (ch[None, :, k] - o[k]) * inv
            t1 = (ch[None, :, 3 + k] - o[k]) * inv
            lo, hi = torch.fmin(t0, t1), torch.fmax(t0, t1)
            tmin = lo if tmin is None else torch.fmax(tmin, lo)
            tmax = hi if tmax is None else torch.fmin(tmax, hi)
        return ((tmin <= tmax) & (tmax >= 0.0) & (tmin < t)).sum(dim=1)


class Spheres:
    """A sphere table on a device in dtype ``dt``."""

    normalize_defocus_dir = False
    normalize_reflect_in = True

    def __init__(self, sph: dict, device, dt):
        self.center = torch.from_numpy(sph["center"]).to(device, dt).T
        self.radius = torch.from_numpy(sph["radius"]).to(device, dt)
        self.albedo = torch.from_numpy(sph["albedo"]).to(device, dt)
        self.param = torch.from_numpy(sph["param"]).to(device, dt)
        self.kind_of = torch.from_numpy(sph["kind"]).to(device).long()
        self.m = self.radius.shape[0]

    def closest(self, o, d):
        """(t, winning sphere or -1): the least t with 0 < t < FLT_MAX, the
        first sphere of that t."""
        a = dot3(d, d)
        two_a, four_a = (2.0 * a)[:, None], (4.0 * a)[:, None]
        oo = tuple(v[:, None] for v in o)
        dd = tuple(v[:, None] for v in d)
        oc = tuple(oo[k] - self.center[k][None, :] for k in range(3))
        b = 2.0 * dot3(oc, dd)
        r = self.radius[None, :]
        cc = dot3(oc, oc) - r * r
        disc = b * b - four_a * cc
        sq = sqrt(torch.where(disc < 0.0, torch.zeros_like(disc), disc))
        t = (-b - sq) / two_a
        t = torch.where(disc < 0.0, torch.full_like(t, -1.0), t)
        valid = (t > 0.0) & (t < FLT_MAX)
        t = torch.where(valid, t, torch.inf)
        tmin = t.amin(dim=1)
        rows = torch.arange(self.m, device=t.device)
        first = torch.where(valid & (t == tmin[:, None]), rows,
                            self.m).amin(dim=1)
        won = first < self.m
        return (torch.where(won, tmin, torch.full_like(tmin, far(tmin.dtype))),
                torch.where(won, first, -1))

    def resolve(self, o, d, t, idx):
        i = torch.clamp(idx, min=0)
        c = tuple(self.center[k][i] for k in range(3))
        r = self.radius[i]
        point = tuple(o[k] + d[k] * t for k in range(3))
        n = tuple((point[k] - c[k]) / r for k in range(3))
        front = dot3(d, n) < 0.0
        n = where3(front, n, tuple(-v for v in n))
        return (point, n, front, tuple(self.albedo[i, k] for k in range(3)),
                self.param[i], self.kind_of[i])

    def material_of(self, idx):
        return idx

    def chunk_scans(self, o, d, t):
        return None


# ------------------------------------------------------------ the tracer

def trace_sample(scene, state, o, d, bounces: int, counts=None,
                 record=None):
    """One sample of every lane: ``bounces`` bounces from (state, o, d),
    live lanes only.  Returns (state, attenuation).  record: a list that
    gets, per bounce, the primitive each lane hit (-1 on a miss and from
    then on)."""
    n = state.shape[0]
    dev, dt = o[0].device, o[0].dtype
    one = torch.ones(n, dtype=dt, device=dev)
    atten = [one, one.clone(), one.clone()]
    o, d = list(o), list(d)
    lanes = torch.arange(n, device=dev)
    for _ in range(bounces):
        if record is not None:
            plane = torch.full((n,), -1, dtype=torch.int64, device=dev)
        if lanes.numel():
            lo, ld = tuple(v[lanes] for v in o), tuple(v[lanes] for v in d)
            t, idx = scene.closest(lo, ld)
            hit = idx >= 0
            point, nrm, front, alb, par, kind = scene.resolve(lo, ld, t, idx)
            ns, nd = scatter(state[lanes], ld, point, nrm, front, par, kind,
                             normalize_reflect_in=scene.normalize_reflect_in)
            if counts is not None:
                n_live = lanes.numel()
                counts["live_rays"] += n_live
                scans = scene.chunk_scans(lo, ld, t)
                if scans is not None:
                    counts["chunk_scans"] += int(scans.sum())
                    counts["box_tests"] += n_live * scene.chunks.shape[0]
                else:
                    counts["sphere_pairs"] += n_live * scene.m
                    counts["sphere_hits"] += int(hit.sum())
            keep = lanes[hit]
            state[keep] = ns[hit]
            for k in range(3):
                o[k][keep] = point[k][hit]
                d[k][keep] = nd[k][hit]
                atten[k][keep] = (atten[k][keep] * alb[k][hit]) * 0.7
            if record is not None:
                plane[keep] = idx[hit]
            lanes = keep
        if record is not None:
            record.append(plane)
    return state, tuple(atten)


def render(scene, cam, xs, ys, times, *, height: int, width: int, spp: int,
           bounces: int, dt=torch.float32, counts=None, record=None):
    """(len(times), len(xs), 3) colors of pixels (xs, ys) in the frames
    of u32 time uniforms ``times``: ``spp`` samples of the same camera ray
    with the RNG stream carried from one to the next, their sum divided by
    ``spp`` (one sample: the sample itself)."""
    dev = scene.param.device
    f, p = len(times), xs.shape[0]
    t = torch.as_tensor(np.asarray(times, np.int64) & MASK, device=dev)
    x = xs.to(dev).long()[None, :].expand(f, p).reshape(-1)
    y = ys.to(dev).long()[None, :].expand(f, p).reshape(-1)
    t = t[:, None].expand(f, p).reshape(-1)
    state, o, d = primary_rays(
        cam, x, y, t, height=height, width=width,
        normalize_defocus_dir=scene.normalize_defocus_dir, dt=dt)
    if counts is not None:
        counts["primary_rays"] += x.numel()
    acc = None
    for _ in range(spp):
        state, atten = trace_sample(scene, state, tuple(c.clone() for c in o),
                                    tuple(c.clone() for c in d), bounces,
                                    counts, record)
        col = sky(d[1], atten)
        acc = col if acc is None else tuple(acc[k] + col[k] for k in range(3))
    if spp > 1:
        n = torch.tensor(float(spp), dtype=dt, device=dev)
        acc = tuple(c / n for c in acc)
    return torch.stack(acc, dim=-1).reshape(f, p, 3)


def ema(colors, start: int = 0, sample_frame: int = 1000):
    """The progressive accumulator after folding ``colors`` (F, P, 3) in
    order into a zero image whose frame count is ``start``:
    w = 1 / (min(count, sample_frame) + 1), image = image * (1 - w) +
    color * w, the weights f32 values."""
    img = torch.zeros_like(colors[0])
    for k in range(colors.shape[0]):
        fc = min(start + k, sample_frame)
        w = np.float32(1.0) / (np.float32(fc) + np.float32(1.0))
        img = img * float(np.float32(1.0) - w) + colors[k] * float(w)
    return img
