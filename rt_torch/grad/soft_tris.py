"""Soft-visibility relaxation for triangle scenes: pose recovery on meshes —
counterpart of ``rt/grad/soft_tris.py``.

The replay's pose gradients are right but useless for recovery: the visible
mismatch under a pose error is a discrete reassignment of pixels.  So the
pose is recovered on a SMOOTH first-bounce approximation, and the materials
are then polished with the exact path-replay objective
(``grad.train.fit_replay``).

Per ray (soft rasterisation in ray space, one Moeller-Trumbore per ray and
triangle, its t/u/v reused as the smooth quantities):

  margin_i = min((1-u-v)*h_A, u*h_B, v*h_C) / t   angular edge distance
             (h_X: the altitude from vertex X, so w_X*h_X is the world
             distance to the opposite edge; over the depth it is an angle,
             so tau is in radians of view whatever the triangle's size)
  cov_i    = sigmoid(margin_i / tau) * sigmoid(t_i / tau_depth)
  w_i      = cov_i * exp(-(t_i - shift) / tau_depth)   occlusion softmin
  color    = total_cov * (sum w_i albedo_i / sum w_i) * 0.7 * sky(d)
             + (1 - total_cov) * sky(d),   total_cov = clip(sum cov_i, 0, 1)

Defocus is ignored (one shared origin), so every Moeller-Trumbore term is a
per-triangle constant dotted with the ray direction: a chunk of triangles
costs three (C, 3) x (3, H*W) products.  Plain tensor code on the scene's
device (the JAX package computes these products outside any Pallas kernel
too); the chunks are a Python loop, each chunk under
``torch.utils.checkpoint`` so the backward pass recomputes its (C, H, W)
planes instead of keeping them.

Differentiable in the camera's pose and fov and in the material albedos.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from rt_torch.config import MAT_DIELECTRIC, RenderConfig
from rt_torch.core import vecmath as vm
from rt_torch.core.trace import sky_color
from rt_torch.core.triangle import TriangleScene
from rt_torch.grad.params import CameraParams, look_at
from rt_torch.grad.soft import mask_grads
from rt_torch.grad.train import _adam, _as_leaves, _detached

# The reference's AA jitter normalize(rng_vec2) is a UNIT first-quadrant
# vector, not zero-mean: every target's expected sample position is
# pixel + 0.5 + E[jitter], about 0.6478 in both axes.  Without it the
# recovered pose carries a ~1 px offset.
JITTER_MEAN = 0.6478


def _f32(v, device):
    """A 0-d or 1-d f32 tensor of ``v`` on ``device`` (tensors keep their
    graph)."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32)
    return torch.tensor(np.asarray(v, np.float32), device=device)


def _pixel_axis(n, n_full, device):
    """(n,) f32 sample positions along one image axis: pixel centres plus
    the jitter mean, or for a target average-pooled from ``n_full`` samples
    the mean of each pooled block's full-resolution positions."""
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    pos = torch.arange(n, dtype=torch.float32, device=device)
    if n_full is not None:
        f = n_full // n
        pos = pos * f32(f) + f32((f - 1) * 0.5)
    return pos + f32(0.5) + f32(JITTER_MEAN)


def _directions(camera, config: RenderConfig, full_res, device):
    """(H, W, 3) clean ray directions: make_ray without jitter or defocus
    (the vec4 normalize over the camera's w components included)."""
    h, w = config.height, config.width
    hf, wf = full_res if full_res is not None else (h, w)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    y = _pixel_axis(h, hf if full_res is not None else None, device)[:, None]
    x = _pixel_axis(w, wf if full_res is not None else None, device)[None, :]
    uvx = (2.0 * x / f32(wf - 1) - 1.0) * (f32(wf) / f32(hf))
    uvy = -(2.0 * y / f32(hf - 1) - 1.0)
    k = torch.tan(_f32(camera.fov, device) * 0.5)
    d4 = (_f32(camera.right, device)[None, None, :] * (uvx * k)[..., None]
          + _f32(camera.up, device)[None, None, :] * (uvy * k)[..., None]
          + _f32(camera.direction, device)[None, None, :])   # (H, W, 4)
    return vm.normalize(d4)[..., :3]


def _triangle_terms(scene: TriangleScene, eye):
    """Per-triangle constants of the shared-origin Moeller-Trumbore:
    det = -d.n_raw, u = -(d.se2)/det, v = (d.q)/det, t = t_num/det; the
    albedo and the three altitudes.  Dielectric triangles get n_raw = 0
    (det = 0, coverage 0): the target shows the background through them,
    and an opaque surrogate would paint phantom silhouettes."""
    a = scene.a.to(torch.float32)
    e1 = scene.b.to(torch.float32) - a
    e2 = scene.c.to(torch.float32) - a
    n_raw = vm.cross(e1, e2)
    n_mats = scene.mat_kind.shape[0]
    mid = torch.clamp(scene.mat_id.long(), 0, n_mats - 1)
    opaque = (scene.mat_kind[mid] != MAT_DIELECTRIC).to(torch.float32)
    n_raw = n_raw * opaque[:, None]
    s = eye[None, :] - a
    se2 = vm.cross(s, e2)
    q = vm.cross(s, e1)
    t_num = vm.dot(e2, q)
    alb = scene.mat_albedo[
        torch.clamp(scene.mat_id.long(), 0, scene.mat_albedo.shape[0] - 1)]
    # w_A*h_A (etc.) is the world distance from the hit to the edge opposite
    # vertex A: 2*area / the opposite edge's length
    area2 = vm.sqrt(vm.dot(n_raw, n_raw))
    elen = lambda e: vm.sqrt(vm.dot(e, e) + 1e-20)
    alt = torch.stack([area2 / elen(e2 - e1), area2 / elen(e2),
                       area2 / elen(e1)], dim=-1)
    return n_raw, se2, q, t_num, alb, alt


def _chunk_sums(d, n_c, se2_c, q_c, tn_c, alb_c, alt_c, shift, inv_tau,
                inv_td):
    """One chunk's (sum w, sum w*albedo, sum cov) over its C triangles."""
    det = -torch.einsum("hwk,ck->chw", d, n_c)
    valid = torch.abs(det) > 1e-12
    inv = 1.0 / torch.where(valid, det, torch.ones_like(det))
    u = -torch.einsum("hwk,ck->chw", d, se2_c) * inv
    v = torch.einsum("hwk,ck->chw", d, q_c) * inv
    t = tn_c[:, None, None] * inv
    # angular edge distance: min over the edges of (barycentric weight x
    # altitude) over the depth
    margin = torch.minimum(
        torch.minimum(u * alt_c[:, 1, None, None], v * alt_c[:, 2, None, None]),
        (1.0 - u - v) * alt_c[:, 0, None, None]) / torch.clamp(t, min=1e-2)
    cov = (torch.sigmoid(margin * inv_tau) * torch.sigmoid(t * inv_td)
           * valid.to(torch.float32))
    # near-parallel rays give huge |t|: the clamp keeps exp finite where
    # cov is ~0 anyway
    wgt = cov * torch.exp(torch.clamp(-(t - shift) * inv_td, -30.0, 30.0))
    return (torch.sum(wgt, dim=0), torch.einsum("chw,cz->hwz", wgt, alb_c),
            torch.sum(cov, dim=0))


def soft_render_tris(scene: TriangleScene, camera, config: RenderConfig,
                     time=1000, tau: float = 0.02, tau_depth: float = 0.5,
                     chunk: int = 128, return_aux: bool = False,
                     full_res=None):
    """Smooth (H, W, 3) render of a triangle scene, differentiable in the
    camera and the material albedos everywhere.

    tau: silhouette softness in radians of view.  chunk: triangles a step
    of the scan; it bounds the live (chunk, H, W) planes, with the sums
    carried from chunk to chunk.  full_res: (h, w) of a full-resolution
    target that was average-pooled to this size; the rays then go through
    the mean of each pooled block's sample positions (the uv mapping
    pos / (res - 1) does not commute with pooling).  ``time`` is unused:
    the rays are clean pixel rays, no jitter (the reference's jitter turns
    the surrogate's own silhouettes into noise).

    return_aux: also return the (H, W) total coverage, a soft foreground
    mask when the scene holds only the subject meshes."""
    device = scene.a.device
    d = _directions(camera, config, full_res, device)
    eye = _f32(camera.eye, device)[:3]
    n_raw, se2, q, t_num, alb, alt = _triangle_terms(scene, eye)

    m = n_raw.shape[0]
    pad = (-m) % chunk
    if pad:
        # padding triangles have n_raw = 0: det = 0, masked invalid
        z = lambda x: torch.cat([x, x.new_zeros((pad,) + x.shape[1:])])
        n_raw, se2, q, t_num, alb, alt = map(z, (n_raw, se2, q, t_num, alb,
                                                 alt))

    # occlusion weights are exp(-(t - shift)/tau_depth): the constant shift
    # cancels in the normalisation and keeps magnitudes near e^(+-few)
    shift = _f32(camera.focal_length, device)
    inv_tau = 1.0 / tau
    inv_td = 1.0 / tau_depth

    h, w = config.height, config.width
    wsum = torch.zeros((h, w), dtype=torch.float32, device=device)
    csum = torch.zeros((h, w, 3), dtype=torch.float32, device=device)
    covsum = torch.zeros((h, w), dtype=torch.float32, device=device)
    remat = torch.is_grad_enabled()
    for c0 in range(0, m + pad, chunk):
        part = tuple(x[c0:c0 + chunk] for x in (n_raw, se2, q, t_num, alb,
                                                alt))
        args = (d, *part, shift, inv_tau, inv_td)
        sums = (checkpoint(_chunk_sums, *args, use_reentrant=False) if remat
                else _chunk_sums(*args))
        wsum = wsum + sums[0]
        csum = csum + sums[1]
        covsum = covsum + sums[2]

    sky = sky_color(d)
    total_cov = torch.clamp(covsum, 0.0, 1.0)
    mean_alb = csum / (wsum[..., None] + 1e-9)
    surf = mean_alb * 0.7 * sky * total_cov[..., None]
    img = surf + (1.0 - total_cov)[..., None] * sky
    if return_aux:
        return img, total_cov
    return img


def downsample(img, factor: int):
    """Average-pool an (H, W, C) image by ``factor`` (rows and columns past
    a multiple of it are dropped).  The block's samples are summed row by
    row, left to right, then divided: the JAX package's order."""
    img = torch.as_tensor(img, dtype=torch.float32)
    h = img.shape[0] // factor * factor
    w = img.shape[1] // factor * factor
    blocks = img[:h, :w].reshape(h // factor, factor, w // factor, factor,
                                 img.shape[-1])
    total = blocks[:, 0, :, 0]
    for k in range(1, factor * factor):
        total = total + blocks[:, k // factor, :, k % factor]
    return total / torch.tensor(float(factor * factor), device=img.device)


def _image_grads(img):
    """Horizontal and vertical finite differences of an (H, W, 3) image."""
    return img[:, 1:] - img[:, :-1], img[1:] - img[:-1]


def subject_roi(scene: TriangleScene, camera, config: RenderConfig, *,
                subject_mat_ids, tau: float = 0.05, threshold: float = 0.2,
                dilate: int = 31):
    """(H, W) 0/1 region of interest: the soft coverage of the SUBJECT
    meshes (by material id) at the given camera, above ``threshold``,
    dilated by a ``dilate`` x ``dilate`` window.  In an enclosed scene the
    full-frame loss is dominated by the walls' colour bias; restricting it
    to the subject's neighbourhood keeps the silhouettes."""
    ids = torch.as_tensor(list(subject_mat_ids), device=scene.mat_id.device,
                          dtype=scene.mat_id.dtype)
    idx = torch.nonzero(torch.isin(scene.mat_id, ids))[:, 0]
    # bmin/bmax stay the full scene's: the soft path never walks the BVH,
    # so the filtered scene is valid for it only
    fg = scene._replace(a=scene.a[idx], b=scene.b[idx], c=scene.c[idx],
                        normal=scene.normal[idx], mat_id=scene.mat_id[idx])
    with torch.no_grad():
        _, cov = soft_render_tris(fg, camera, config, tau=tau,
                                  return_aux=True)
    mask = (cov > threshold).to(torch.float32)
    k = dilate
    # max over a k x k window centred as XLA's "SAME": (k-1)//2 before,
    # k//2 after, padded with -inf
    padded = F.pad(mask[None, None], ((k - 1) // 2, k // 2, (k - 1) // 2,
                                      k // 2), value=float("-inf"))
    return F.max_pool2d(padded, k, stride=1)[0, 0]


def make_soft_tris_loss(scene: TriangleScene, config: RenderConfig, target,
                        time=1000, tau: float = 0.02, tau_depth: float = 0.5,
                        chunk: int = 128, loss_mode: str = "mse",
                        grad_pool: int = 1, weight=None, full_res=None):
    """loss(CameraParams, mat_albedo or None) -> scalar against an (H, W, 3)
    target (the exact render at the true pose, downsampled to this size).

    loss_mode: ``"mse"`` (the image), ``"grad"`` (its finite differences:
    in an enclosed scene the surrogate's smooth colour bias against the
    multi-bounce target dominates a plain MSE and drags the pose away;
    edges are where the surrogate is faithful) or ``"mse+grad"``.
    grad_pool: average-pool both images by this factor before the finite
    differences (grad modes), which damps the target's sample noise.
    weight: optional (H, W) loss weights (``subject_roi``); weighted means
    then replace the plain ones."""
    device = scene.a.device
    target = torch.as_tensor(target, dtype=torch.float32, device=device)
    tpool = downsample(target, grad_pool) if grad_pool > 1 else target
    tdx, tdy = _image_grads(tpool)
    wpool = None
    if weight is not None:
        weight = torch.as_tensor(weight, dtype=torch.float32, device=device)
        wpool = (downsample(weight[..., None], grad_pool)[..., 0]
                 if grad_pool > 1 else weight)

    def wmean(sq, wgt):
        if wgt is None:
            return torch.mean(sq)
        return (torch.sum(sq * wgt[..., None])
                / (torch.sum(wgt) * sq.shape[-1] + 1e-9))

    def loss(cp: CameraParams, mat_albedo=None):
        sc = scene if mat_albedo is None else scene._replace(
            mat_albedo=mat_albedo)
        img = soft_render_tris(sc, look_at(cp), config, time, tau=tau,
                               tau_depth=tau_depth, chunk=chunk,
                               full_res=full_res)
        out = 0.0
        if loss_mode in ("mse", "mse+grad"):
            out = out + wmean((img - target) ** 2, weight)
        if loss_mode in ("grad", "mse+grad"):
            ipool = downsample(img, grad_pool) if grad_pool > 1 else img
            dx, dy = _image_grads(ipool)
            wx = wy = None
            if wpool is not None:
                wx, wy = wpool[:, 1:], wpool[1:]
            out = (out + wmean((dx - tdx) ** 2, wx)
                   + wmean((dy - tdy) ** 2, wy))
        return out

    return loss


class OrbitParams(NamedTuple):
    """The reference's orbit-camera degrees of freedom:
    eye = target + radius * (sin(phi)cos(theta), cos(phi), sin(phi)sin(theta)).
    Optimising the pose in these coordinates makes the radius/fov
    dolly-zoom gauge an explicit axis that can be frozen.  Fields are 0-d
    f32 tensors."""

    radius: torch.Tensor
    theta: torch.Tensor
    phi: torch.Tensor
    fov: torch.Tensor

    @staticmethod
    def create(radius, theta, phi, fov, device="cuda") -> "OrbitParams":
        f = lambda v: torch.tensor(np.float32(v), device=device)
        return OrbitParams(f(radius), f(theta), f(phi), f(fov))

    @staticmethod
    def from_eye(eye, target, fov, device="cuda") -> "OrbitParams":
        v = np.asarray(eye, np.float64) - np.asarray(target, np.float64)
        r = float(np.linalg.norm(v))
        phi = float(np.arccos(np.clip(v[1] / r, -1.0, 1.0)))
        theta = float(np.arctan2(v[2], v[0]))
        return OrbitParams.create(r, theta, phi, float(fov), device=device)

    def to_camera_params(self, look_target, focal_length,
                         focal_blur) -> CameraParams:
        dev = self.fov.device
        t = _f32(look_target, dev)
        sp, cp = torch.sin(self.phi), torch.cos(self.phi)
        st, ct = torch.sin(self.theta), torch.cos(self.theta)
        eye = t + self.radius * torch.stack([sp * ct, cp, sp * st])
        return CameraParams(eye, t, _f32(focal_length, dev),
                            _f32(focal_blur, dev), self.fov)


def recover_orbit_tris(scene: TriangleScene, config: RenderConfig, target,
                       init_orbit: OrbitParams, look_target, *,
                       focal_length, focal_blur=0.0, steps: int = 160,
                       learning_rate: float = 1e-2,
                       taus=(0.06, 0.02, 0.008, 0.003), time=1000,
                       tau_depth: float = 0.5,
                       optimize_fields=("theta", "phi", "fov"),
                       chunk: int = 128, loss_mode: str = "mse",
                       grad_pool: int = 1, weight=None, full_res=None,
                       return_best: bool = True, log_every: int = 0):
    """Annealed pose recovery in orbit coordinates, a fresh Adam a tau.
    Returns (OrbitParams, losses).  With ``return_best`` the result is the
    iterate of the final tau stage with the least loss: the parameters the
    loss was evaluated at, before that step's update (losses of different
    taus are not comparable).  The default fields freeze ``radius``, the
    dolly-zoom gauge axis."""
    fields = set(optimize_fields)
    op = _as_leaves({"p": init_orbit}, init_orbit.fov.device)["p"]
    losses = []
    best = None
    for stage, tau in enumerate(taus):
        loss0 = make_soft_tris_loss(scene, config, target, time=time,
                                    tau=tau, tau_depth=tau_depth,
                                    chunk=chunk, loss_mode=loss_mode,
                                    grad_pool=grad_pool, weight=weight,
                                    full_res=full_res)
        opt = _adam({"p": op}, learning_rate)
        for i in range(max(1, steps // len(taus))):
            opt.zero_grad(set_to_none=True)
            value = loss0(op.to_camera_params(look_target, focal_length,
                                              focal_blur))
            value.backward()
            losses.append(float(value.detach()))
            if (return_best and stage == len(taus) - 1
                    and (best is None or losses[-1] < best[0])):
                best = (losses[-1], OrbitParams(*(v.detach().clone()
                                                  for v in op)))
            mask_grads(op, fields)
            opt.step()
            if log_every and (i + 1) % log_every == 0:
                print(f"  tau={tau} step {i + 1}: loss {losses[-1]:.3e}",
                      flush=True)
    if return_best and best is not None:
        return best[1], losses
    return _detached({"p": op})["p"], losses


def recover_camera_tris(scene: TriangleScene, config: RenderConfig, target,
                        init_params: CameraParams, *, steps: int = 150,
                        learning_rate: float = 2e-2,
                        taus=(0.06, 0.02, 0.008), time=1000,
                        tau_depth: float = 0.5,
                        optimize_fields=("eye", "fov"),
                        optimize_albedo: bool = False, chunk: int = 128,
                        log_every: int = 0):
    """Annealed mesh-scene pose recovery, optionally with the material
    albedos jointly.  Returns (CameraParams, mat_albedo or None, losses).
    ``optimize_fields`` freezes the rest of the pose."""
    fields = set(optimize_fields)
    cp = _as_leaves({"c": init_params}, scene.a.device)["c"]
    params = {"camera": cp}
    albedo = None
    if optimize_albedo:
        albedo = scene.mat_albedo.detach().to(torch.float32,
                                              copy=True).requires_grad_()
        params["albedo"] = (albedo,)
    losses = []
    for tau in taus:
        loss = make_soft_tris_loss(scene, config, target, time=time, tau=tau,
                                   tau_depth=tau_depth, chunk=chunk)
        opt = _adam(params, learning_rate)
        for i in range(max(1, steps // len(taus))):
            opt.zero_grad(set_to_none=True)
            value = loss(cp, albedo)
            value.backward()
            mask_grads(cp, fields)
            opt.step()
            losses.append(float(value.detach()))
            if log_every and (i + 1) % log_every == 0:
                print(f"  tau={tau} step {i + 1}: loss {losses[-1]:.3e}")
    return (_detached({"c": cp})["c"],
            None if albedo is None else albedo.detach(), losses)
