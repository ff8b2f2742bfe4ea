"""The triangle-scene container and the oracle's triangle intersection —
counterpart of ``rt/core/triangle.py``.

- ``moller_trumbore``: one triangle per lane, EPSILON_TRIS = 1e-4, accept
  t >= EPSILON and t < best;
- ``intersect_node_mask``: the slab test with NaN-forgiving min/max
  (``torch.fmin``/``fmax``: the non-NaN operand wins, as WGSL's min/max);
- ``intersect_all_bvh``: the stackless implicit-heap walk from node 1
  (descend to i*2 on a box hit, leaf j = i - n, ascend by stripping the
  trailing 1-bits of i and adding 1), at most BVH_MAX_STEPS steps, every
  lane with its own node pointer and done flag;
- ``intersect_all_bruteforce``: every triangle, blocked, for the
  differentiable renderer (``grad.diff_render``);
- ``hit_record``: flat normal, NO flip, inverted front_face convention.

The u32 node index is carried as int64 masked with 0xFFFFFFFF, as the RNG
state is (``core.rng``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rt_torch.config import BVH_MAX_STEPS, EPSILON_TRIS, FLT_MAX
from rt_torch.core import vecmath as vm
from rt_torch.core.hits import closest_hit, gather_rows

MASK = 0xFFFFFFFF
# lanes of the walk are tested for all-done every this many steps: one host
# sync each; a finished lane is frozen, so extra steps change nothing
DONE_CHECK_EVERY = 8
# triangles per block of the brute-force scan
SCAN_BLOCK = 32


class TriangleScene(NamedTuple):
    """SoA mesh + implicit-heap BVH boxes + material table, as tensors on
    one device.  Triangles are in the BVH build's BFS-median order."""

    a: torch.Tensor           # (m, 3) f32 vertex A
    b: torch.Tensor           # (m, 3)
    c: torch.Tensor           # (m, 3)
    normal: torch.Tensor      # (m, 3) flat face normal
    mat_id: torch.Tensor      # (m,)  i32
    bmin: torch.Tensor        # (n, 3) node AABB minima (node 0 unused)
    bmax: torch.Tensor        # (n, 3)
    mat_albedo: torch.Tensor  # (K, 3)
    mat_param: torch.Tensor   # (K,)
    mat_kind: torch.Tensor    # (K,) i32

    @property
    def n(self) -> int:
        return self.bmin.shape[0]

    @property
    def m(self) -> int:
        return self.a.shape[0]

    def to(self, device) -> "TriangleScene":
        return TriangleScene(*(t.to(device) for t in self))


def moller_trumbore(origin, direction, a, b, c, best_t):
    """One triangle per lane (a, b, c: (..., 3), gathered or broadcast).
    Returns (valid, t): valid where every early-exit condition of the
    reference passes and t < best_t."""
    edge1 = b - a
    edge2 = c - a
    h = vm.cross(direction, edge2)
    det = vm.dot(edge1, h)
    inv_det = 1.0 / det
    s = origin - a
    u = inv_det * vm.dot(s, h)
    q = vm.cross(s, edge1)
    v = inv_det * vm.dot(direction, q)
    t = inv_det * vm.dot(edge2, q)
    valid = torch.abs(det) >= EPSILON_TRIS
    valid &= (u >= 0.0) & (u <= 1.0)
    valid &= (v >= 0.0) & (u + v <= 1.0)
    valid &= (t >= EPSILON_TRIS) & (t < best_t)
    return valid, t


def intersect_node_mask(origin, direction, bmin, bmax):
    """Slab test against gathered boxes bmin/bmax (..., 3)."""
    inv_d = 1.0 / direction
    t0 = (bmin - origin) * inv_d
    t1 = (bmax - origin) * inv_d
    tmin = torch.fmin(t0, t1).amax(dim=-1)      # amax/amin: NaN propagates
    tmax = torch.fmax(t0, t1).amin(dim=-1)
    return (tmin <= tmax) & (tmax >= 0.0)


def _trailing_ones(i):
    """Count of the low-order 1-bits of u32 values held in int64: the
    lowest set bit of i + 1 is 2**k, k that count (32 where i + 1 wraps to
    0).  torch has no popcount; the exponent of 2**k is exact."""
    x = (i + 1) & MASK
    low = x & -x
    _, e = torch.frexp(low.to(torch.float64))
    return torch.where(low == 0, 32, e.to(torch.int64) - 1)


def intersect_all_bvh(scene: TriangleScene, origin, direction):
    """The lane-parallel stackless walk.  Returns (t, triangle index int32):
    t == FLT_MAX and index -1 where no triangle was hit.  Not
    differentiable (the JAX walk is a while_loop, which has no reverse
    rule either); runs without a graph."""
    n, m = scene.n, scene.m
    shape = origin.shape[:-1]
    dev = origin.device
    best_t = torch.full(shape, FLT_MAX, dtype=torch.float32, device=dev)
    best_i = torch.full(shape, -1, dtype=torch.int64, device=dev)
    if m == 0:
        return best_t, best_i.to(torch.int32)
    with torch.no_grad():
        boxes = torch.cat([scene.bmin, scene.bmax], dim=1)
        tri = torch.cat([scene.a, scene.b, scene.c], dim=1)
        i = torch.ones(shape, dtype=torch.int64, device=dev)
        done = torch.zeros(shape, dtype=torch.bool, device=dev)
        for step in range(BVH_MAX_STEPS):
            if step % DONE_CHECK_EVERY == 0 and bool(done.all()):
                break
            is_node = i < n
            box = boxes[torch.clamp(i, 0, n - 1)]
            node_hit = intersect_node_mask(origin, direction, box[..., 0:3],
                                           box[..., 3:6])
            descend = ~done & is_node & node_hit

            j = i - n
            at_leaf = ~done & ~is_node
            leaf_oob = at_leaf & (j >= m)        # `break` in the reference
            tj = torch.clamp(j, 0, m - 1)
            row = tri[tj]
            valid, t = moller_trumbore(origin, direction, row[..., 0:3],
                                       row[..., 3:6], row[..., 6:9], best_t)
            take = at_leaf & (j < m) & valid
            best_t = torch.where(take, t, best_t)
            best_i = torch.where(take, tj, best_i)

            # ascent for the lanes that neither descend nor are done
            i_up = i >> _trailing_ones(i)
            asc_root = i_up == 0                 # climbed past the root
            new_done = done | leaf_oob | (~descend & ~done & asc_root)
            i = torch.where(descend, (i * 2) & MASK,
                            torch.where(done | leaf_oob, i, i_up + 1))
            done = new_done
    return best_t, best_i.to(torch.int32)


def intersect_all_bruteforce(scene: TriangleScene, origin, direction,
                             block: int = SCAN_BLOCK):
    """Closest hit by testing every triangle (no BVH, no step cap): the
    differentiable renderer's intersection.  The scan picks the winner
    without a graph; its t is then recomputed from the winner's vertices,
    so the gradient reaches only the winning triangle (the JAX scan's
    ``where`` chain) and the forward value is the scan's bit for bit.
    Returns (t, index int32)."""
    shape = origin.shape[:-1]
    o, d = origin[..., None, :], direction[..., None, :]
    big = torch.tensor(FLT_MAX, dtype=torch.float32, device=origin.device)
    best_t, best_i = closest_hit(
        lambda lo, hi: moller_trumbore(o, d, scene.a[lo:hi], scene.b[lo:hi],
                                       scene.c[lo:hi], big),
        scene.m, shape, origin.device, block)
    hit = best_i >= 0
    row = gather_rows(torch.cat([scene.a, scene.b, scene.c], dim=1),
                torch.clamp(best_i, min=0))
    a = row[..., 0:3]
    edge1 = row[..., 3:6] - a
    edge2 = row[..., 6:9] - a
    det = vm.dot(edge1, vm.cross(direction, edge2))
    # a miss lane's stand-in triangle may be parallel to its ray: 1/0 there
    # would poison the cotangents through the masked select
    inv_det = 1.0 / torch.where(hit, det, 1.0)
    t = inv_det * vm.dot(edge2, vm.cross(origin - a, edge1))
    return torch.where(hit, t, best_t), best_i.to(torch.int32)


def hit_record(scene: TriangleScene, origin, direction, t, idx):
    """The hit-record fields of the winning triangle: flat normal, NO flip,
    front_face = dot(normal, dir) > 0.  A miss lane (t == FLT_MAX) gets
    t = 1 so that its discarded values and their cotangents stay finite."""
    i = torch.clamp(idx, 0, scene.m - 1).long()
    normal = gather_rows(scene.normal, i)
    mid = torch.clamp(scene.mat_id[i], 0, scene.mat_albedo.shape[0] - 1)
    t_safe = torch.where(t == FLT_MAX, 1.0, t)
    return {
        "point": origin + t_safe[..., None] * direction,
        "normal": normal,
        "front_face": vm.dot(normal, direction) > 0.0,
        "albedo": gather_rows(scene.mat_albedo, mid),
        "mat_param": gather_rows(scene.mat_param[:, None], mid)[..., 0],
        "mat_kind": scene.mat_kind[mid.long()],
    }
