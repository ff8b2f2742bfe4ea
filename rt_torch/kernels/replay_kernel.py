"""The frozen-path replay's loss and albedo gradient in one pass
(``csrc/replay.cu``): for a triangle scene whose only leaf is the (K, 3)
material albedo table, the recorded paths replayed as ``grad.replay.
replay_color`` replays them, ``fit_replay``'s loss (``grad.loss.
replay_mse``) and its gradient by the albedo, with no autograd graph.

- ``replay_loss_grad``: (loss, gradient (K, 3)[, colour]) — the kernel on a
  CUDA tensor, ``replay_loss_grad_plain`` (autograd through
  ``replay_color``, the reference) on a CPU tensor;
- ``replay_loss``: the same loss as a ``torch.autograd.Function`` of the
  scene's albedo, whose backward is the saved gradient times the loss's
  cotangent;
- ``pack_replay_tables``: the triangle table by scene triangle id (a,
  b - a, c - a, normal, material id), the materials' parameters and kinds
  and the camera row, packed once a fit.

The kernel's colour is bit-equal to ``replay_color``'s: it is compiled with
-fmad=false and uses K0's raygen and scatter (``csrc/rt_device.cuh``).  Its
gradient is the chain rule written out: the albedo enters a pixel's colour
only as the product of its hit bounces' ``albedo * 0.7``.  ``LAUNCHES``
counts the kernel's launches (one a call: the pass and its fixed-order sum
of the blocks), nothing else.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from rt_torch.core import rng
from rt_torch.kernels.tris_kernel import _cam_array, _require

LAUNCHES = {"replay_loss": 0}
BLOCK = 128            # csrc/replay.cu REPLAY_BLOCK: pixels a block
CHUNK = 16             # REPLAY_CHUNK: materials a block's columns hold
MAX_CHUNKS = 65535     # the grid's y, one chunk each


class ReplayTables(NamedTuple):
    """What a replay reads besides the albedo and the hits, fixed over a
    fit."""

    tri: torch.Tensor    # (m, 13) f32 by scene triangle id: a, b - a, c - a,
    #                      normal, material id (clamped to the table) as f32
    param: torch.Tensor  # (K,) f32 fuzz or index of refraction
    kind: torch.Tensor   # (K,) int32 material kind
    cam: np.ndarray      # (20,) f32 host camera row (dispatch.pack_camera)


def pack_replay_tables(scene, camera) -> ReplayTables:
    """A TriangleScene's replay tables (detached) and the camera's row; the
    camera's fields on the host (``grad.params.host_camera``)."""
    from rt_torch.kernels import dispatch

    with torch.no_grad():
        n_mats = scene.mat_albedo.shape[0]
        f32 = lambda t: t.to(torch.float32)
        a = f32(scene.a)
        mat = torch.clamp(scene.mat_id, 0, n_mats - 1)
        tri = torch.cat([a, f32(scene.b) - a, f32(scene.c) - a,
                         f32(scene.normal), f32(mat)[:, None]],
                        dim=1).contiguous()
        return ReplayTables(tri, f32(scene.mat_param).contiguous(),
                            scene.mat_kind.to(torch.int32).contiguous(),
                            _cam_array(dispatch.pack_camera(camera)))


def replay_loss_grad_plain(scene, camera, config, time: int, hits, target,
                           weight=None, norm=None, *, row0: int = 0,
                           tables=None, want_color=False):
    """Plain version of ``replay_loss_grad``: autograd through
    ``replay_color`` and ``replay_mse`` (``tables`` is not read)."""
    from rt_torch.grad.loss import replay_mse
    from rt_torch.grad.replay import replay_color

    with torch.enable_grad():
        leaf = scene.mat_albedo.detach().requires_grad_()
        color = replay_color(scene._replace(mat_albedo=leaf), camera, config,
                             time, hits, row0=row0)
        loss = replay_mse(color, target, weight, norm)
        (grad,) = torch.autograd.grad(loss, leaf)
    loss, color = loss.detach(), color.detach()
    return (loss, grad, color) if want_color else (loss, grad)


def _launch(scene, camera, config, time: int, hits, target, weight=None,
            norm=None, *, row0: int = 0, tables=None, want_color=False):
    from rt_torch.kernels import _build

    if tables is None:
        tables = pack_replay_tables(scene, camera)
    n_bounces, rows, width = hits.shape
    n_mats, n_tris = scene.mat_albedo.shape[0], tables.tri.shape[0]
    if (width != config.width or not 0 < n_mats <= CHUNK * MAX_CHUNKS
            or n_tris == 0):
        raise ValueError(f"replay_loss: hits of width {width} for width "
                         f"{config.width}, {n_mats} materials (1 to "
                         f"{CHUNK * MAX_CHUNKS}), {n_tris} triangles")
    albedo = scene.mat_albedo.detach().contiguous()
    _require(albedo, "albedo", torch.float32, (n_mats, 3))
    _require(tables.tri, "tri", torch.float32, (n_tris, 13))
    _require(tables.param, "param", torch.float32, (n_mats,))
    _require(tables.kind, "kind", torch.int32, (n_mats,))
    _require(hits, "hits", torch.int32)
    _require(target, "target", torch.float32, (rows, width, 3))
    if weight is not None:
        _require(weight, "weight", torch.float32, (rows, width))
    if norm is not None:
        _require(norm, "norm", torch.float32)
        if norm.numel() != 1:
            raise ValueError("norm: need one element")
    dev = hits.device
    n_blocks = -(-rows * width // BLOCK)
    partial = torch.empty((1 + 3 * n_mats) * n_blocks, dtype=torch.float32,
                          device=dev)
    loss = torch.empty((), dtype=torch.float32, device=dev)
    grad = torch.empty((n_mats, 3), dtype=torch.float32, device=dev)
    color = (torch.empty((rows, width, 3), dtype=torch.float32, device=dev)
             if want_color else None)
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = _build.load()
    code = lib.rt_replay_loss(
        tables.tri.data_ptr(), albedo.data_ptr(), tables.param.data_ptr(),
        tables.kind.data_ptr(), hits.data_ptr(), target.data_ptr(),
        ptr(weight), ptr(norm), partial.data_ptr(), loss.data_ptr(),
        grad.data_ptr(), ptr(color), tables.cam.ctypes.data,
        int(time) & rng.MASK, row0, rows, config.height, width, n_bounces,
        n_mats, n_tris, int(config.normalize_defocus_dir),
        int(config.normalize_reflect_in), int(config.sky_from_final_dir),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, code, "replay_loss")
    LAUNCHES["replay_loss"] += 1
    return (loss, grad, color) if want_color else (loss, grad)


def replay_loss_grad(scene, camera, config, time: int, hits, target,
                     weight=None, norm=None, *, row0: int = 0, tables=None,
                     want_color=False):
    """(loss (), gradient by ``scene.mat_albedo`` (K, 3)[, colour (rows, W,
    3)]) of the recorded paths ``hits`` (bounces, rows, W) int32 scene
    triangle ids (-1: no hit) of the frame's rows from ``row0``, against
    ``target`` (rows, W, 3).

    scene: a TriangleScene; camera: its camera, fields on the host for the
    kernel; config: the RenderConfig (frame size and transport flags).
    weight: None or (rows, W) per-pixel weights; norm: None (the loss is
    the mean) or a 1-element f32 tensor, the divisor of the (weighted) sum.
    tables: ``pack_replay_tables(scene, camera)``, packed here when None.
    want_color: also return the replayed colour."""
    run = replay_loss_grad_plain if hits.device.type == "cpu" else _launch
    return run(scene, camera, config, time, hits, target, weight, norm,
               row0=row0, tables=tables, want_color=want_color)


class _ReplayLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, albedo, scene, args, kw):
        loss, grad = replay_loss_grad(scene._replace(mat_albedo=albedo),
                                      *args, **kw)
        ctx.save_for_backward(grad)
        return loss

    @staticmethod
    def backward(ctx, grad_output):
        (grad,) = ctx.saved_tensors
        return grad_output * grad, None, None, None


def replay_loss(scene, camera, config, time: int, hits, target, weight=None,
                norm=None, *, row0: int = 0, tables=None):
    """``replay_loss_grad``'s loss as a differentiable function of
    ``scene.mat_albedo``: its backward hands the saved gradient on to
    whatever made the albedo."""
    return _ReplayLoss.apply(
        scene.mat_albedo, scene,
        (camera, config, time, hits, target, weight, norm),
        dict(row0=row0, tables=tables))
