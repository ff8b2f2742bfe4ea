"""Finite-difference check of rendering gradients — counterpart of
``rt/grad/fd.py``: central differences on a few sampled coordinates,
compared with ``torch.autograd``.

Parameters are a tensor, a NamedTuple of tensors (fields left ``None``
hold no coordinate: ``CameraParams``, ``SphereParams``,
``TriangleParams``) or a dict of those; coordinates are counted over the
leaves in the order the JAX package flattens the same structure (dict keys
sorted, NamedTuple fields in order), so one seed samples the same
coordinates in both packages.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def _flatten(params):
    """(leaves, rebuild(leaves) -> params)."""
    if params is None:
        return [], lambda leaves: None
    if isinstance(params, torch.Tensor):
        return [params], lambda leaves: leaves[0]
    if isinstance(params, dict):
        keys = sorted(params)
        parts = [_flatten(params[k]) for k in keys]
    elif isinstance(params, tuple) and hasattr(params, "_fields"):
        parts = [_flatten(v) for v in params]
    else:
        raise TypeError(f"parameters of type {type(params)}")
    sizes = [len(p[0]) for p in parts]

    def rebuild(leaves):
        out, at = [], 0
        for (_, sub), k in zip(parts, sizes):
            out.append(sub(leaves[at:at + k]))
            at += k
        if isinstance(params, dict):
            return dict(zip(keys, out))
        return type(params)(*out)

    return [x for p in parts for x in p[0]], rebuild


def finite_difference_check(loss_fn: Callable, params, *, eps: float = 1e-3,
                            num_coords: int = 8, seed: int = 0,
                            rtol: float = 0.15, atol: float = 1e-4):
    """Compare the autograd gradient of ``loss_fn(params)`` with central
    differences on up to ``num_coords`` coordinates sampled over the
    parameters.  Returns (max relative error, [(leaf, coordinate, autograd,
    finite difference, relative error)]); raises AssertionError where a
    sampled coordinate disagrees beyond both tolerances.

    eps must clear the float32 noise of the image: |dL| ~ eps * g has to be
    well above 1e-6 of the loss (1e-3 suits albedo, fuzz and camera)."""
    leaves, rebuild = _flatten(params)
    def loss32(p):
        with torch.no_grad():
            return float(loss_fn(p))

    grad_in = [x.detach().clone().requires_grad_() for x in leaves]
    grads = torch.autograd.grad(loss_fn(rebuild(grad_in)), grad_in,
                                allow_unused=True)
    grads = [np.zeros(x.shape, np.float32) if g is None
             else g.detach().cpu().numpy() for x, g in zip(leaves, grads)]

    sizes = [int(np.prod(x.shape)) if x.dim() else 1 for x in leaves]
    rng = np.random.default_rng(seed)
    picks = rng.choice(sum(sizes), size=min(num_coords, sum(sizes)),
                       replace=False)

    base = loss32(params)
    max_rel = 0.0
    checks = []
    for flat in np.sort(picks):
        li, off = 0, int(flat)
        while off >= sizes[li]:
            off -= sizes[li]
            li += 1
        leaf = leaves[li].detach().cpu().numpy().astype(np.float64)
        coord = np.unravel_index(off, leaf.shape) if leaf.shape else ()

        def perturbed(delta):
            moved = leaf.copy()
            if leaf.shape:
                moved[coord] += delta
            else:
                moved = moved + delta
            new = list(leaves)
            new[li] = torch.as_tensor(moved, dtype=leaves[li].dtype,
                                      device=leaves[li].device)
            return rebuild(new)

        fd = (loss32(perturbed(+eps)) - loss32(perturbed(-eps))) / (2.0 * eps)
        ad = float(grads[li][coord])
        rel = abs(fd - ad) / max(abs(fd), abs(ad), atol)
        max_rel = max(max_rel, rel)
        checks.append((li, coord, ad, fd, rel))
        assert rel <= rtol or abs(fd - ad) <= atol, (
            f"grad mismatch at leaf {li}{coord}: autodiff={ad:.6g} "
            f"fd={fd:.6g} rel={rel:.3f} (loss base {base:.6g})")
    return max_rel, checks
