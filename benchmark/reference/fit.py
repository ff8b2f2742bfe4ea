"""The reference of a material fit on recorded paths.

With the paths frozen (the hit sequence recorded once) and the albedo the
only parameter, a pixel's replayed color is

    sky(primary dy) * prod over its hits b of (albedo[material_b] * 0.7)

(the attenuation ``(atten * albedo) * 0.7`` a hit, in that order): the
replayed geometry, normals and scatter directions do not depend on the
albedo.  So the reference records the materials hit with the plain tracer
and takes the loss, its gradient and Adam on that product alone, in plain
PyTorch.  The target is the plain tracer's own render at the true albedo.
"""

from __future__ import annotations

import torch
from torch.nn.functional import embedding

from benchmark.reference import tracer


def record(scene, cam, *, width: int, height: int, bounces: int, time: int,
           dt=torch.float32, counts=None):
    """(color (H, W, 3), materials hit (bounces, H*W) int64 with -1 on a
    miss, primary dy (H*W,)) of one frame at one sample a pixel."""
    dev = scene.param.device
    ys, xs = torch.meshgrid(torch.arange(height, device=dev),
                            torch.arange(width, device=dev), indexing="ij")
    xs, ys = xs.reshape(-1), ys.reshape(-1)
    hits = []
    color = tracer.render(scene, cam, xs, ys, [time], height=height,
                          width=width, spp=1, bounces=bounces, dt=dt,
                          counts=counts, record=hits)[0]
    t = torch.full_like(xs, time & tracer.MASK)
    _, _, d = tracer.primary_rays(
        cam, xs, ys, t, height=height, width=width,
        normalize_defocus_dir=scene.normalize_defocus_dir, dt=dt)
    mats = torch.stack([torch.where(h >= 0, scene.material_of(h), -1)
                        for h in hits])
    return color.reshape(height, width, 3), mats, d[1]


def replay(albedo, mats, dy):
    """(H*W, 3) colors of the frozen paths under the albedo table."""
    atten = torch.ones(dy.shape[0], 3, dtype=albedo.dtype, device=dy.device)
    for m in mats:
        row = embedding(torch.clamp(m, min=0), albedo)
        atten = torch.where((m >= 0)[:, None], atten * row * 0.7, atten)
    t = (dy * 0.5 + 0.5)[:, None]
    sky = torch.tensor(tracer.SKY, dtype=albedo.dtype, device=dy.device)
    blue = torch.tensor(tracer.BLUE, dtype=albedo.dtype, device=dy.device)
    return atten * (sky * (1.0 - t) + blue * t)


def fit(albedo0, record, target, *, learning_rate: float, steps: int,
        rerecord_every: int, betas=(0.9, 0.999), eps: float = 1e-8):
    """Adam (no weight decay) from ``albedo0`` for ``steps`` steps on the
    image MSE of the frozen paths, which ``record(albedo)`` -> (materials
    hit, primary dy) records anew at the current albedo before every
    ``rerecord_every`` steps, as the program's fit does.  Returns (losses,
    first gradient, parameters after step 3, parameters after the last
    step)."""
    p = albedo0.detach().clone()
    m = torch.zeros_like(p)
    v = torch.zeros_like(p)
    target = target.reshape(-1, 3)
    losses, grad1, p3 = [], None, None
    for k in range(1, steps + 1):
        if (k - 1) % rerecord_every == 0:
            mats, dy = record(p)
        leaf = p.detach().requires_grad_()
        d = replay(leaf, mats, dy) - target[:dy.shape[0]]
        loss = torch.mean(d * d)
        (g,) = torch.autograd.grad(loss, leaf)
        losses.append(float(loss.detach()))
        grad1 = g.clone() if grad1 is None else grad1
        m = betas[0] * m + (1.0 - betas[0]) * g
        v = betas[1] * v + (1.0 - betas[1]) * g * g
        m_hat = m / (1.0 - betas[0] ** k)
        v_hat = v / (1.0 - betas[1] ** k)
        p = p - learning_rate * m_hat / (torch.sqrt(v_hat) + eps)
        if k == min(3, steps):
            p3 = p
    return losses, grad1, p3, p
