"""Soft-visibility relaxation for pose and geometry recovery on sphere
scenes — counterpart of ``rt/grad/soft.py``.

Under the reference transport *which* sphere a ray hits is a discrete event,
so the replay's camera and geometry gradients cannot see visibility edges.
This is the smooth single-bounce surrogate of the same transport: visibility
is a sigmoid of the ray-sphere signed distance and occlusion a softmin over
hit depths.  It is only the optimisation surrogate: optimise pose or
geometry on it (annealing tau), then validate against the exact renderer.

color(ray) = sum_i alpha_i * albedo_i * 0.7 * sky(d) + (1 - sum_i alpha_i) * sky(d)
  cov_i = sigmoid((r_i - dist_i(ray)) / (tau * r_i))     visibility edge
  alpha = cov weighted by softmax(-t_i / tau_depth)      occlusion ordering

Plain tensor code on the scene's device; no kernel.
"""

from __future__ import annotations

import torch

from rt_torch.config import RenderConfig
from rt_torch.core import camera as camera_mod
from rt_torch.core import vecmath as vm
from rt_torch.core.sphere import SphereArray
from rt_torch.core.trace import sky_color
from rt_torch.grad.params import (CameraParams, SphereParams, apply_params,
                                  look_at)
from rt_torch.grad.train import _adam, _as_leaves, _detached


def soft_render(scene: SphereArray, camera, config: RenderConfig, time,
                tau: float = 0.05, tau_depth: float = 0.5):
    """Smooth (H, W, 3) render, differentiable in the camera and in the
    sphere centers, radii and albedos everywhere."""
    _, origin, direction = camera_mod.generate_primary_rays(
        camera, config.width, config.height, time,
        config.normalize_defocus_dir, device=scene.center.device)

    d2 = vm.dot(direction, direction)
    center = scene.center[:, None, None, :]
    oc = center - origin[None]                               # (N, H, W, 3)
    t_ca = vm.dot(oc, direction[None]) / d2                  # depth on ray
    closest = origin[None] + t_ca[..., None] * direction[None]
    e = closest - center
    dist = vm.sqrt(vm.dot(e, e) + 1e-12)

    r = scene.radius[:, None, None]
    # visibility: smooth in (r - dist); spheres behind the camera fade out
    cov = torch.sigmoid((r - dist) / (tau * torch.clamp(r, min=1e-3)))
    cov = cov * torch.sigmoid(t_ca / tau_depth)

    # occlusion: nearer surfaces dominate (softmin over depth among covered)
    depth_logit = -t_ca / tau_depth + torch.log(cov + 1e-9)
    # jax.nn.softmax's own steps (ATen's softmax multiplies by 1/sum)
    e = torch.exp(depth_logit
                  - torch.amax(depth_logit, dim=0, keepdim=True).detach())
    w = e / torch.sum(e, dim=0, keepdim=True)
    total_cov = torch.clamp(torch.sum(cov, dim=0), 0.0, 1.0)
    alpha = w * total_cov[None]                              # (N, H, W)

    sky = sky_color(direction)                               # (H, W, 3)
    surf = torch.einsum("nhw,nc->hwc", alpha, scene.albedo * 0.7) * sky
    return surf + (1.0 - total_cov)[..., None] * sky


def _mse(img, target):
    d = img - target
    return torch.mean(d * d)


def make_soft_loss(scene: SphereArray, config: RenderConfig, target,
                   time=1000, tau: float = 0.05, tau_depth: float = 0.5):
    """loss(CameraParams) -> scalar against any (H, W, 3) target (typically
    the exact renderer's image at the true pose)."""
    target = torch.as_tensor(target, dtype=torch.float32,
                             device=scene.center.device)

    def loss(cp: CameraParams):
        img = soft_render(scene, look_at(cp), config, time, tau=tau,
                          tau_depth=tau_depth)
        return _mse(img, target)

    return loss


def make_soft_geom_loss(base_scene: SphereArray, camera, config: RenderConfig,
                        target, time=1000, tau: float = 0.05,
                        tau_depth: float = 0.5):
    """loss(SphereParams) -> scalar: the geometry twin of ``make_soft_loss``,
    differentiable in sphere centers and radii (and albedos) everywhere,
    across silhouettes too."""
    target = torch.as_tensor(target, dtype=torch.float32,
                             device=base_scene.center.device)

    def loss(p: SphereParams):
        img = soft_render(apply_params(base_scene, p), camera, config, time,
                          tau=tau, tau_depth=tau_depth)
        return _mse(img, target)

    return loss


def recover_geometry(scene: SphereArray, camera, config: RenderConfig,
                     target, init_params: SphereParams, *, sphere_index: int,
                     steps: int = 180, learning_rate: float = 3e-2,
                     taus=(0.2, 0.05, 0.02), time=1000):
    """Annealed geometry recovery: optimise ONE sphere's center and radius
    on the soft surrogate, coarse to fine tau.  Returns (SphereParams,
    losses).  Only the ``sphere_index`` row gets a gradient; the rest of
    the scene is known.  A fresh Adam (``optax.adam``'s settings) a tau, as
    in the JAX package."""
    params = _as_leaves({"p": init_params}, scene.center.device)["p"]
    losses = []
    for tau in taus:
        loss = make_soft_geom_loss(scene, camera, config, target, time=time,
                                   tau=tau)
        opt = _adam({"p": params}, learning_rate)
        for _ in range(steps // len(taus)):
            opt.zero_grad(set_to_none=True)
            value = loss(params)
            value.backward()
            with torch.no_grad():
                for v in params:
                    if v is not None and v.grad is not None:
                        keep = torch.zeros_like(v.grad)
                        keep[sphere_index] = 1.0
                        v.grad.mul_(keep)
            opt.step()
            losses.append(float(value.detach()))
    return _detached({"p": params})["p"], losses


def mask_grads(params, fields) -> None:
    """Zero the gradients of the fields not in ``fields`` (a zero gradient
    from step 0 leaves an Adam parameter where it was)."""
    for name, v in zip(params._fields, params):
        if name not in fields and v is not None and v.grad is not None:
            v.grad.zero_()


def recover_camera(scene: SphereArray, config: RenderConfig, target,
                   init_params: CameraParams, *, steps: int = 200,
                   learning_rate: float = 3e-2, taus=(0.2, 0.05, 0.02),
                   time=1000, optimize_fields=("eye",), log_every: int = 0):
    """Annealed pose recovery on the soft surrogate, coarse to fine tau.
    Returns (CameraParams, losses).  ``optimize_fields`` names the unknown
    degrees of freedom; the rest of the pose stays frozen (the full
    parameterisation is gauge-ambiguous)."""
    fields = set(optimize_fields)
    params = _as_leaves({"p": init_params}, scene.center.device)["p"]
    losses = []
    for tau in taus:
        loss = make_soft_loss(scene, config, target, time=time, tau=tau)
        opt = _adam({"p": params}, learning_rate)
        for i in range(steps // len(taus)):
            opt.zero_grad(set_to_none=True)
            value = loss(params)
            value.backward()
            mask_grads(params, fields)
            opt.step()
            losses.append(float(value.detach()))
            if log_every and (i + 1) % log_every == 0:
                print(f"  tau={tau} step {i + 1}: loss {losses[-1]:.3e}")
    return _detached({"p": params})["p"], losses
