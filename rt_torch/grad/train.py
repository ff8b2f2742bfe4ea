"""The inverse-rendering loops: recover material (and camera or vertex)
parameters from a target image by gradient descent — counterpart of
``rt/grad/train.py``.

``fit_replay`` (the production loop): record the paths, then replay them
differentiably -> image loss -> gradients (``torch.autograd``) -> Adam.
``fit`` / ``make_train_step``: the same step on the full differentiable
renderer (``grad.diff_render``), which re-intersects every step.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from rt_torch.config import RenderConfig
from rt_torch.core.sphere import SphereArray
from rt_torch.dist.sharding import all_reduce
from rt_torch.grad.diff_render import render_image_diff
from rt_torch.grad.loss import image_mse, replay_mse
from rt_torch.grad.params import (SphereParams, TriangleParams, apply_params,
                                  apply_tri_params, camera_from_params,
                                  host_camera)
from rt_torch.grad.replay import (_gather_tri_rows, _tris_replay_tables,
                                  record_hits, record_hits_oracle,
                                  replay_color)
from rt_torch.kernels import replay_kernel
from rt_torch.kernels.tris_kernel import material_table, pack_tri_table
from rt_torch.utils import profiling
from rt_torch.utils.profiling import span, wait


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


def _adam(params: dict, learning_rate: float) -> torch.optim.Adam:
    """Adam over the set fields of the parameter tuples, as ``optax.adam``
    sets it: b1 0.9, b2 0.999, eps 1e-8, no weight decay."""
    leaves = [v for p in params.values() for v in p if v is not None]
    return torch.optim.Adam(leaves, lr=learning_rate, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=0.0)


def _detached(params: dict) -> dict:
    return {k: type(p)(*(None if v is None else v.detach() for v in p))
            for k, p in params.items()}


def _apply_scene(base_scene, params: dict):
    """The base scene with the "scene" entry's set fields over it."""
    sp = params.get("scene")
    if sp is None:
        return base_scene
    return (apply_tri_params(base_scene, sp) if isinstance(sp, TriangleParams)
            else apply_params(base_scene, sp))


def make_train_step(base_scene, base_camera, config: RenderConfig,
                    times: Sequence[int], optimizer: torch.optim.Optimizer,
                    *, remat: bool = True) -> Callable:
    """The step on the full differentiable renderer: ``step(params,
    target) -> loss`` renders ``times`` progressively
    (``render_image_diff``), takes the image MSE, back-propagates and lets
    ``optimizer`` (built over the parameters' leaves) update them in place.

    ``params`` is a dict with optional keys "scene" (SphereParams or
    TriangleParams) and "camera" (CameraParams) of leaf tensors; absent keys
    stay at the base values."""
    times = tuple(int(t) for t in times)

    def step(params: dict, target) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        camera = camera_from_params(params.get("camera"), base_camera)
        img = render_image_diff(_apply_scene(base_scene, params), camera,
                                config, times, remat=remat)
        loss = image_mse(img, target)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def fit(base_scene, base_camera, config: RenderConfig, target,
        *, times: Sequence[int] = (1000,), steps: int = 200,
        learning_rate: float = 2e-2, optimize_scene: bool = True,
        optimize_camera: bool = False,
        scene_fields=dict(albedo=True, mat_param=False),
        init_params: Optional[dict] = None, remat: bool = True,
        log_every: int = 0, device="cuda"):
    """The recovery loop on the full differentiable renderer; returns
    (params dict, losses list).  Adam as in ``fit_replay``."""
    params = dict(init_params) if init_params else {}
    if optimize_scene and "scene" not in params:
        params["scene"] = (
            SphereParams.from_scene(base_scene, **scene_fields)
            if isinstance(base_scene, SphereArray)
            else _tri_scene_params(base_scene, scene_fields))
    if optimize_camera and "camera" not in params:
        raise ValueError("optimize_camera requires init_params['camera'] "
                         "(a CameraParams initial guess)")
    params = _as_leaves(params, device)
    step = make_train_step(base_scene, base_camera, config, times,
                           _adam(params, learning_rate), remat=remat)
    target = torch.as_tensor(target, dtype=torch.float32, device=device)
    losses = []
    for i in range(steps):
        losses.append(float(step(params, target)))
        if log_every and (i + 1) % log_every == 0:
            print(f"  step {i + 1}/{steps}: loss {losses[-1]:.6g}")
    return _detached(params), losses


def _as_leaves(params: dict, device) -> dict:
    """A copy of the parameter tuples whose set fields are fresh leaf
    tensors on ``device`` that require a gradient (the caller's tensors are
    never updated in place)."""
    leaf = lambda v: (None if v is None else v.detach().to(
        device=device, dtype=torch.float32, copy=True).requires_grad_())
    return {k: type(p)(*(leaf(v) for v in p)) for k, p in params.items()}


def _albedo_is_the_only_leaf(scene) -> bool:
    """Whether a triangle scene's material albedo is the one of its tensors
    that requires a gradient."""
    return scene.mat_albedo.requires_grad and not any(
        t.requires_grad for k, t in scene._asdict().items()
        if k != "mat_albedo")


def _all_reduce_grads(mesh, leaves) -> None:
    """The gradients of ``leaves`` summed over the mesh's ranks in one
    ``all_reduce``; a leaf this rank's band did not reach counts zero."""
    flat = torch.cat([torch.zeros_like(p).reshape(-1) if p.grad is None
                      else p.grad.reshape(-1) for p in leaves])
    all_reduce(mesh, flat)
    at = 0
    for p in leaves:
        p.grad = flat[at:at + p.numel()].view_as(p)
        at += p.numel()


def fit_replay(base_scene, base_camera, config: RenderConfig, target,
               *, time: int = 1000, steps: int = 120,
               rerecord_every: int = 20, learning_rate: float = 2e-2,
               scene_fields=dict(albedo=True, mat_param=False),
               init_params: Optional[dict] = None,
               frozen_geometry: bool = True, recorder: str = "kernels",
               log_every: int = 0, loss_weight=None, device="cuda",
               mesh=None):
    """Path-replay inverse rendering — the production loop.

    Outer loop: record the Monte-Carlo path structure at the current
    parameters.  ``recorder``: ``"kernels"`` (``record_hits``: the
    recording kernels on a card, their plain versions on the CPU; the
    sorted-stream recorder above 8192 triangles) or ``"oracle"``
    (``record_hits_oracle``: plain tensor code, the BVH walk for a mesh).
    Neither is ever swapped for the other.  The recorder's tables are
    packed once a fit (the materials' table swapped in at each record)
    unless the vertices are parameters.  Inner loop:
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

    ``mesh``: an optional ``dist.Mesh`` — data parallelism with pixels as
    the batch, on the mesh's device.  Each rank records the whole frame
    and keeps its row band of the hits, the pre-gathered rows, the target
    and ``loss_weight``; its loss is the band's sum over the frame's count
    (H*W*3, or the whole weight's sum), so the ranks' gradients add up to
    the unsharded one: one ``all_reduce(SUM)`` of them a step, before
    ``optimizer.step()``.  Parameters and the Adam state stay replicated.
    A block's losses are summed across the ranks once, at its end.  The
    losses match the unsharded loop's up to the order of the sums.

    Two paths compute a step's loss and gradients, chosen once a fit by
    what the parameters hold.  For a triangle scene with
    ``frozen_geometry``, no "camera" entry and the material albedo as the
    scene's only leaf, one hand-written kernel computes the loss and the
    albedo's gradient in one pass over the recorded paths
    (``kernels.replay_kernel.replay_loss``, its plain version on the CPU).
    Every other set of leaves runs autograd through ``replay_color``.  The
    counters ``replay_kernel_steps`` and ``replay_autograd_steps``
    (``utils.profiling``) count the steps of each.
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

    if recorder not in ("kernels", "oracle"):
        raise ValueError(f"recorder {recorder!r}: kernels or oracle")
    record = record_hits if recorder == "kernels" else record_hits_oracle

    if mesh is not None:
        device = mesh.device
    row0, rows = ((0, config.height) if mesh is None
                  else mesh.band(config.height))
    band = slice(row0, row0 + rows)
    params = _as_leaves(params, device)
    optimizer = _adam(params, learning_rate)
    leaves = optimizer.param_groups[0]["params"]
    target = torch.as_tensor(target, dtype=torch.float32,
                             device=device)[band]
    lw = None
    if loss_weight is not None:
        lw = torch.as_tensor(loss_weight, dtype=torch.float32, device=device)
        lw_norm = torch.sum(lw) * 3.0 + 1e-9
        lw = lw[band]
    # the frame's count as a tensor divisor (CUDA division by a Python
    # scalar multiplies by its reciprocal)
    count = torch.tensor(float(config.height * config.width * 3),
                         dtype=torch.float32, device=device)

    use_kernel = (is_tris and frozen_geometry and "camera" not in params
                  and _albedo_is_the_only_leaf(_apply_scene(base_scene,
                                                            params)))
    # the loss's divisor: None for the mean, else the frame's count or the
    # whole weight's sum
    norm = (None if lw is None and mesh is None
            else count if lw is None else lw_norm)
    if use_kernel:
        tables = replay_kernel.pack_replay_tables(base_scene,
                                                  host_camera(base_camera))
        target = target.contiguous()
        lw = None if lw is None else lw.contiguous()

    def loss_of(p, hits, pre_rows):
        if use_kernel:
            return replay_kernel.replay_loss(
                _apply_scene(base_scene, p), base_camera, config, time, hits,
                target, lw, norm, row0=row0, tables=tables)
        img = replay_color(_apply_scene(base_scene, p),
                           camera_from_params(p.get("camera"), base_camera),
                           config, time, hits,
                           frozen_geometry=frozen_geometry,
                           _pre_rows=pre_rows, row0=row0)
        return replay_mse(img, target, lw, norm)

    pre_tab = (_tris_replay_tables(base_scene)[0]
               if is_tris and frozen_geometry and not use_kernel else None)
    # the recorder's tables: packed once a fit while the geometry is fixed;
    # each record then swaps in the current material table
    packed = None
    if is_tris and recorder == "kernels" and not (
            isinstance(sp, TriangleParams) and sp.has_vertices):
        with torch.no_grad():
            packed = pack_tri_table(base_scene)

    losses = []
    done = 0
    while done < steps:
        k = min(rerecord_every, steps - done)
        with span("fit.record"), torch.no_grad():
            scene = _apply_scene(base_scene, params)
            kw = ({} if packed is None else
                  dict(packed=packed._replace(mats=material_table(scene))))
            _, hits = record(
                scene, camera_from_params(params.get("camera"), base_camera),
                config, time, device=device, **kw)
            if mesh is not None:
                hits = hits[:, band]
            hits = hits.contiguous()
            pre_rows = (None if pre_tab is None
                        else _gather_tri_rows(pre_tab, hits))
        block = []
        for _ in range(k):
            with span("fit.forward"):
                optimizer.zero_grad(set_to_none=True)
                loss = loss_of(params, hits, pre_rows)
            # on this thread: a hand-off to autograd's device thread and
            # back costs more than the kernel path's whole backward
            with span("fit.backward"), \
                    torch.autograd.set_multithreading_enabled(False):
                loss.backward()
            profiling.count("replay_kernel_steps" if use_kernel
                            else "replay_autograd_steps")
            if mesh is not None:
                _all_reduce_grads(mesh, leaves)
            with span("fit.optimizer"):
                optimizer.step()
            block.append(loss.detach())
        block = torch.stack(block)
        if mesh is not None:
            all_reduce(mesh, block)
        with span("fit.wait"):
            wait(block)
        with span("fit.readback"):
            losses.extend(block.tolist())
        done += k
        if log_every:
            print(f"  step {done}/{steps}: loss {losses[-1]:.6g}")
    return _detached(params), losses
