"""The inverse-rendering loop: recover material (and camera or vertex)
parameters from a target image by gradient descent — counterpart of
``rt/grad/train.py:fit_replay``.

A training step is: replay the recorded paths differentiably -> image loss
-> gradients (``torch.autograd``) -> Adam update.
"""

from __future__ import annotations

from typing import Optional

import torch

from rt_torch.config import RenderConfig
from rt_torch.core.sphere import SphereArray
from rt_torch.grad.loss import image_mse
from rt_torch.grad.params import (SphereParams, TriangleParams, apply_params,
                                  apply_tri_params, camera_from_params)
from rt_torch.grad.replay import (_gather_tri_rows, _tris_replay_tables,
                                  record_hits, replay_color)


def _tri_scene_params(base_scene, scene_fields) -> TriangleParams:
    """The sphere-flavoured ``scene_fields`` keys mapped onto
    ``TriangleParams.from_scene``, so that the knob is honoured for triangle
    scenes and not silently ignored; an unknown key that is switched on
    raises."""
    key_map = {"albedo": "albedo", "mat_param": "param", "param": "param",
               "vertices": "vertices"}
    kwargs = {}
    for k, v in scene_fields.items():
        if k not in key_map:
            if v:
                raise ValueError(
                    f"scene_fields key {k!r} is not supported for triangle "
                    f"scenes (supported: albedo, mat_param/param, vertices)")
            continue
        kwargs[key_map[k]] = bool(v)
    return TriangleParams.from_scene(base_scene, **kwargs)


def _as_leaves(params: dict, device) -> dict:
    """A copy of the parameter tuples whose set fields are fresh leaf
    tensors on ``device`` that require a gradient (the caller's tensors are
    never updated in place)."""
    leaf = lambda v: (None if v is None else v.detach().to(
        device=device, dtype=torch.float32, copy=True).requires_grad_())
    return {k: type(p)(*(leaf(v) for v in p)) for k, p in params.items()}


def fit_replay(base_scene, base_camera, config: RenderConfig, target,
               *, time: int = 1000, steps: int = 120,
               rerecord_every: int = 20, learning_rate: float = 2e-2,
               scene_fields=dict(albedo=True, mat_param=False),
               init_params: Optional[dict] = None,
               frozen_geometry: bool = True, log_every: int = 0,
               loss_weight=None, device="cuda"):
    """Path-replay inverse rendering — the production loop.

    Outer loop: record the Monte-Carlo path structure at the current
    parameters with the recording kernels (``record_hits``).  Inner loop:
    ``rerecord_every`` Adam steps on the frozen-path replay objective; the
    losses stay on the device until the block ends, so the host reads back
    once per block.  Returns (params dict, losses list).

    ``init_params``: optional {"scene": SphereParams | TriangleParams,
    "camera": CameraParams} to start from; without a "scene" entry the
    scene's own values of ``scene_fields`` are the start.

    ``loss_weight``: optional (H, W) per-pixel weights on the image MSE (an
    edge-downweighted mask keeps a residual misalignment of silhouettes from
    dragging the materials off: interiors alone identify an albedo).

    Adam as ``optax.adam`` sets it: b1 0.9, b2 0.999, eps 1e-8, no weight
    decay.
    """
    is_tris = not isinstance(base_scene, SphereArray)
    params = dict(init_params) if init_params else {}
    if "scene" not in params:
        params["scene"] = (_tri_scene_params(base_scene, scene_fields)
                           if is_tris else
                           SphereParams.from_scene(base_scene, **scene_fields))
    sp = params["scene"]
    if (is_tris and frozen_geometry and isinstance(sp, TriangleParams)
            and sp.has_vertices):
        raise ValueError("vertex optimization needs frozen_geometry=False: "
                         "the frozen-geometry fast path detaches the "
                         "triangle rows, so vertex gradients would be "
                         "silently zero")

    params = _as_leaves(params, device)
    leaves = [v for p in params.values() for v in p if v is not None]
    optimizer = torch.optim.Adam(leaves, lr=learning_rate, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=0.0)
    target = torch.as_tensor(target, dtype=torch.float32, device=device)
    lw = None
    if loss_weight is not None:
        lw = torch.as_tensor(loss_weight, dtype=torch.float32, device=device)
        lw_norm = torch.sum(lw) * 3.0 + 1e-9

    def apply_scene(p):
        sp = p["scene"]
        return (apply_tri_params(base_scene, sp)
                if isinstance(sp, TriangleParams)
                else apply_params(base_scene, sp))

    def loss_of(p, hits, pre_rows):
        img = replay_color(apply_scene(p),
                           camera_from_params(p.get("camera"), base_camera),
                           config, time, hits,
                           frozen_geometry=frozen_geometry,
                           _pre_rows=pre_rows)
        if lw is None:
            return image_mse(img, target)
        d = img - target
        return torch.sum(d * d * lw[..., None]) / lw_norm

    pre_tab = (_tris_replay_tables(base_scene)[0]
               if is_tris and frozen_geometry else None)

    losses = []
    done = 0
    while done < steps:
        k = min(rerecord_every, steps - done)
        with torch.no_grad():
            _, hits = record_hits(
                apply_scene(params),
                camera_from_params(params.get("camera"), base_camera),
                config, time, device=device)
            pre_rows = (None if pre_tab is None
                        else _gather_tri_rows(pre_tab, hits))
        block = []
        for _ in range(k):
            optimizer.zero_grad(set_to_none=True)
            loss = loss_of(params, hits, pre_rows)
            loss.backward()
            optimizer.step()
            block.append(loss.detach())
        losses.extend(torch.stack(block).tolist())
        done += k
        if log_every:
            print(f"  step {done}/{steps}: loss {losses[-1]:.6g}")
    return ({k: type(p)(*(None if v is None else v.detach() for v in p))
             for k, p in params.items()}, losses)
