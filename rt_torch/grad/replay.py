"""Path-replay backprop — counterpart of ``rt/grad/replay.py``.

The expensive part of the forward render is FINDING the hits (intersection
scans, chunk-culled traversal), but the hit decisions are discrete and
detached from gradients anyway.  So:

1. **Record** (CUDA kernels on the card): the recording kernels
   (``render_color_spheres_record``, ``render_color_tris_record``, and the
   sorted-stream ``render_color_tris_wave_record`` for large meshes) write
   the winning primitive's index per pixel and bounce (-1 on a miss) beside
   the color — the whole Monte-Carlo path structure of the frame.  The
   oracle records the same without a kernel (``record_hits_oracle``).
2. **Replay** (plain tensor code, differentiable): recompute the transport
   with the hit sequence FROZEN — per bounce, fetch the known primitive's
   row and recompute (t, normal, scatter) directly.  The cost is O(pixels x
   bounces) with no intersection scan; the backward pass is
   ``torch.autograd`` through this graph.

This is the path-replay structure of Vicini et al. 2021, specialised to the
reference's transport.  At the recording parameters the replayed color is
the recorded one; as parameters move, the decisions stay frozen until the
next record, like any detached-sampling estimator.

Rows are fetched with a row lookup (``gather_rows``) whose backward pass is
a scatter-add into the table.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from rt_torch.config import EPSILON_TRIS, RenderConfig
from rt_torch.core import camera as camera_mod
from rt_torch.core import vecmath as vm
from rt_torch.core.hits import gather_rows
from rt_torch.core.materials import scatter
from rt_torch.core.sphere import SphereArray, intersect_sphere_t
from rt_torch.core.trace import sky_color, trace
from rt_torch.grad.loss import image_mse
from rt_torch.grad.params import (SphereParams, apply_params,
                                  apply_tri_params, camera_from_params,
                                  host_camera)
from rt_torch.kernels import dispatch, sphere_kernel, tris_kernel
from rt_torch.render import oracle

# ---------------------------------------------------------------------------
# Recording
# ---------------------------------------------------------------------------


def record_hits(scene, camera, config: RenderConfig, time, device="cuda",
                tris_backend: str = "auto", packed=None):
    """(color (H, W, 3), hits (bounces, H, W) int32 scene-order primitive
    ids, -1 on a miss) from the recording kernels on a card, their plain
    versions on the CPU.

    tris_backend: ``"mono"`` (the single-launch recorder, K9), ``"wave"``
    (the sorted-stream recorder, K10a then one K10b per bounce: what makes
    lucy- and dragon-sized meshes recordable) or ``"auto"`` (wave above the
    8192 triangles at which the render dispatch changes branch, mono up to
    them).

    packed: for a triangle scene, its tables from ``pack_tri_table``
    (without ``split_big``) with ``mats`` current; a fit that changes only
    materials packs once and swaps ``mats`` (``fit_replay``).  None packs
    the scene here.
    """
    geo = dispatch.frame_geometry(config)
    common = dict(bounces=config.bounces,
                  normalize_defocus_dir=config.normalize_defocus_dir,
                  flags=dispatch.trace_flags(config),
                  sky_from_final_dir=config.sky_from_final_dir, **geo)
    cam_row = dispatch.pack_camera(host_camera(camera))

    if isinstance(scene, SphereArray):
        tab, kinds, n = dispatch.pack_spheres_table(scene)
        dispatch.check_device(tab, device)
        if 0 < config.n_active_spheres < n:
            n = config.n_active_spheres
        color, idx = sphere_kernel.render_color_spheres_record(
            tab.detach(), kinds, cam_row, int(time), n_spheres=n, **common)
    else:
        if tris_backend == "auto":
            tris_backend = ("wave" if scene.m > dispatch.SMALL_SCENE_MAX_TRIS
                            else "mono")
        if tris_backend not in ("mono", "wave"):
            raise ValueError(f"tris_backend {tris_backend!r}: auto, mono "
                             "or wave")
        dispatch.check_device(scene.a, device)
        if packed is None:
            with torch.no_grad():
                # both recorders pack as the JAX package's do: no split_big
                packed = tris_kernel.pack_tri_table(scene)
        record = (tris_kernel.render_color_tris_wave_record
                  if tris_backend == "wave"
                  else tris_kernel.render_color_tris_record)
        color, idx_tab, order = record(packed, cam_row, int(time), **common)
        # rows of the Morton-clustered table back to scene triangle ids
        safe = torch.clamp(idx_tab, min=0).long()
        idx = torch.where(idx_tab >= 0, order[safe].to(torch.int32), -1)

    h, w = config.height, config.width
    return color.permute(1, 2, 0)[:h, :w], idx[:, :h, :w]


def record_hits_oracle(scene, camera, config: RenderConfig, time,
                       device="cuda"):
    """(color (H, W, 3), hits (bounces, H, W) int32 scene-order primitive
    ids, -1 on a miss) through the oracle (``render.oracle``): every
    sphere, or the BVH walk, per bounce, plain tensor code on ``device``.
    The counterpart of the JAX package's ``record_hits_oracle``."""
    dispatch.check_device(scene[0], device)
    intersect, hit_rec = oracle.scene_functions(scene)
    hits = []
    with torch.no_grad():
        state, origin, direction = camera_mod.generate_primary_rays(
            camera, config.width, config.height, time,
            config.normalize_defocus_dir, device=device)
        _, color = trace(intersect, hit_rec, state, origin, direction,
                         bounces=config.bounces,
                         normalize_reflect_in=config.normalize_reflect_in,
                         sky_from_final_dir=config.sky_from_final_dir,
                         hits=hits)
    return color, torch.stack(hits).to(torch.int32)


# ---------------------------------------------------------------------------
# Replay (differentiable)
# ---------------------------------------------------------------------------


def _sphere_replay_table(scene):
    """One (N, 9) table so that each bounce costs one row gather: [center(3),
    radius, albedo(3), param, kind].  Built from the (differentiable) scene
    tensors inside the loss, so the table's gradient splits back onto
    center, radius, albedo and param; the kind column is discrete."""
    return torch.cat([
        scene.center.to(torch.float32),
        scene.radius.to(torch.float32)[:, None],
        scene.albedo.to(torch.float32),
        scene.mat_param.to(torch.float32)[:, None],
        scene.mat_kind.to(torch.float32)[:, None],
    ], dim=1)


def _sphere_replay_hit(scene, tab, o, d, idx, row=None):
    """(t, hit record) recomputed for the KNOWN sphere per lane: the
    differentiable chain of the shader's intersection without the scan."""
    row = gather_rows(tab, torch.clamp(idx, 0, scene.count - 1))
    center = row[..., 0:3]
    radius = row[..., 3]
    t = intersect_sphere_t(o, d, center, radius)
    # a recorded hit has a positive root; guard the replays whose parameter
    # drifted so far that the hit vanished
    t = torch.where(t > 0.0, t, 1.0)
    point = o + t[..., None] * d
    normal = (point - center) / radius[..., None]
    front_face = vm.dot(d, normal) < 0.0
    normal = torch.where(front_face[..., None], normal, -normal)
    return {
        "point": point,
        "normal": normal,
        "front_face": front_face,
        "albedo": row[..., 4:7],
        "mat_param": row[..., 7],
        "mat_kind": row[..., 8].to(torch.int32),
    }


def _tris_replay_tables(scene):
    """(triangle table (m, 13), material table (K, 5)) for the replay
    gather: tri = [a(3), b(3), c(3), normal(3), mat_id], mat = [albedo(3),
    param, kind].  Geometry and normal columns stay differentiable; the id
    columns are discrete."""
    n_mats = scene.mat_albedo.shape[0]
    tri = torch.cat([
        scene.a.to(torch.float32),
        scene.b.to(torch.float32),
        scene.c.to(torch.float32),
        scene.normal.to(torch.float32),
        torch.clamp(scene.mat_id, 0, n_mats - 1).to(torch.float32)[:, None],
    ], dim=1)
    mat = torch.cat([
        scene.mat_albedo.to(torch.float32),
        scene.mat_param.to(torch.float32)[:, None],
        scene.mat_kind.to(torch.float32)[:, None],
    ], dim=1)
    return tri, mat


def _gather_tri_rows(tri_tab, hits):
    """The winning triangles' rows, (..., 13); a miss fetches row 0 and is
    masked by the caller."""
    return gather_rows(tri_tab, torch.clamp(hits, 0, tri_tab.shape[0] - 1))


def _tris_replay_hit(scene, tabs, o, d, idx, row=None):
    """(t, hit record) recomputed for the KNOWN triangle per lane
    (Moeller-Trumbore restricted to the winner).

    row: optionally the PRE-GATHERED (..., 13) triangle rows — the
    frozen-geometry fast path fetches them once per record, which leaves
    only the small differentiable material gather per bounce and step."""
    tri_tab, mat_tab = tabs
    if row is None:
        row = _gather_tri_rows(tri_tab, idx)
    a = row[..., 0:3]
    edge1 = row[..., 3:6] - a
    edge2 = row[..., 6:9] - a
    h = vm.cross(d, edge2)
    det = vm.dot(edge1, h)
    # gradient guard: a miss lane fetches an arbitrary triangle whose det
    # can be ~0; the division's inf would poison the cotangents through the
    # masked selects downstream (the lane's forward value is discarded)
    ok = torch.abs(det) >= EPSILON_TRIS
    inv_det = 1.0 / torch.where(ok, det, 1.0)
    s = o - a
    q = vm.cross(s, edge1)
    t = inv_det * vm.dot(edge2, q)
    t = torch.where(ok & (t > 0.0), t, 1.0)
    normal = row[..., 9:12]
    mrow = gather_rows(mat_tab, row[..., 12])
    return {
        "point": o + t[..., None] * d,
        "normal": normal,
        "front_face": vm.dot(normal, d) > 0.0,
        "albedo": mrow[..., 0:3],
        "mat_param": mrow[..., 3],
        "mat_kind": mrow[..., 4].to(torch.int32),
    }


def replay_color(scene, camera, config: RenderConfig, time, hits,
                 remat: bool = True, frozen_geometry: bool = True,
                 _pre_rows=None, row0: int = 0):
    """Differentiable (H, W, 3) color with the hit sequence FROZEN.

    hits: (bounces, H, W) int32 scene-order primitive ids (-1 = miss) on the
    scene's device, or the band (bounces, rows, W) of the frame's rows
    from ``row0``: the color is then that band's (rows, W, 3), bit for bit
    those rows of the frame's.  Gradients flow through the continuous
    transport (t, point, normal, scatter, attenuation, sky) to the scene
    tensors and the camera; the discrete path structure is fixed.

    remat: checkpoint each bounce (``torch.utils.checkpoint``): the backward
    pass recomputes a bounce's intermediates instead of keeping them.

    frozen_geometry (triangle scenes only): fetch the winning triangles'
    rows once, detached, instead of once per bounce inside the graph.  Valid
    while triangle vertices are not optimised; pass False to keep geometry
    in the graph.  Camera gradients are unaffected (the recompute against
    the constant rows stays in the graph).
    """
    state, origin, direction = camera_mod.generate_primary_rays(
        camera, config.width, config.height, time,
        config.normalize_defocus_dir, device=hits.device, row0=row0,
        rows=hits.shape[1])

    rows = None
    if isinstance(scene, SphereArray):
        tabs = _sphere_replay_table(scene)
        replay_hit = _sphere_replay_hit
    else:
        tabs = _tris_replay_tables(scene)
        replay_hit = _tris_replay_hit
        if _pre_rows is not None:
            rows = _pre_rows.detach()
        elif frozen_geometry:
            rows = _gather_tri_rows(tabs[0], hits).detach()

    def body(state, o, d, atten, idx, row):
        hm = idx >= 0
        hit = replay_hit(scene, tabs, o, d, idx, row=row)
        ns, no, nd = scatter(state, o, d, hit,
                             normalize_reflect_in=config.normalize_reflect_in)
        m3 = hm[..., None]
        return (torch.where(hm, ns, state), torch.where(m3, no, o),
                torch.where(m3, nd, d),
                torch.where(m3, atten * hit["albedo"] * 0.7, atten))

    o, d, atten = origin, direction, torch.ones_like(origin)
    for b in range(hits.shape[0]):
        args = (state, o, d, atten, hits[b],
                None if rows is None else rows[b])
        if remat and torch.is_grad_enabled():
            state, o, d, atten = checkpoint(body, *args, use_reentrant=False)
        else:
            state, o, d, atten = body(*args)
    sky_dir = d if config.sky_from_final_dir else direction
    return atten * sky_color(sky_dir)


def replay_loss_fn(base_scene, camera, config: RenderConfig, target, hits,
                   time, frozen_geometry: bool = True):
    """loss(params: SphereParams | TriangleParams | None, camera_params |
    None) on the replay graph — the inverse-rendering objective.

    For a triangle scene with ``frozen_geometry`` the winning triangles'
    rows are gathered ONCE here and closed over as constants, so a step's
    graph holds no gather from the triangle table at all.
    """
    target = torch.as_tensor(target, dtype=torch.float32, device=hits.device)
    is_tris = not isinstance(base_scene, SphereArray)

    pre_rows = None
    if frozen_geometry and is_tris:
        pre_rows = _gather_tri_rows(_tris_replay_tables(base_scene)[0],
                                    hits).detach()

    def loss(params, camera_params=None):
        if params is None:
            sc = base_scene
        elif isinstance(params, SphereParams):
            sc = apply_params(base_scene, params)
        else:
            if frozen_geometry and params.has_vertices:
                raise ValueError(
                    "TriangleParams with vertex fields need "
                    "replay_loss_fn(..., frozen_geometry=False): the "
                    "frozen-geometry fast path detaches the triangle rows, "
                    "so vertex gradients would be silently zero")
            sc = apply_tri_params(base_scene, params)
        cam = camera_from_params(camera_params, camera)
        img = replay_color(sc, cam, config, time, hits,
                           frozen_geometry=frozen_geometry,
                           _pre_rows=pre_rows)
        return image_mse(img, target)

    return loss
