"""Implicit-heap BVH builder (host-side NumPy) — counterpart of
``rt/scene/bvh.py``.

The wavefront kernels never walk this tree; they need what the build leaves
behind: the BFS-median triangle ORDER (the Morton sort in
``kernels.tris_kernel.pack_tri_table`` is stable, so ties keep this order)
and the flat face normals.  The node boxes are kept so the scene container
has the JAX package's fields.

Build semantics (the reference's Tree::build): n = next power of two of m;
a BFS queue of (i, j, depth) ranges, each sorting triangles [i, min(j, m))
STABLY by the centroid sum a+b+c along axis depth % 3 and splitting at the
PADDED midpoint; then each triangle's normal = normalize(cross(b-a, c-a)).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from rt_torch.config import MAT_DIELECTRIC, MAT_LAMBERTIAN, MAT_METAL
from rt_torch.core.triangle import TriangleScene
from rt_torch.scene import native_bridge
from rt_torch.scene.objloader import Mesh

F32_MAX = np.float32(3.4028235e38)


def next_power_of_two(m: int) -> int:
    return 1 if m <= 1 else 1 << (m - 1).bit_length()


def _empty3():
    return np.zeros((0, 3), np.float32)


@dataclass
class Tree:
    a: np.ndarray = field(default_factory=_empty3)
    b: np.ndarray = field(default_factory=_empty3)
    c: np.ndarray = field(default_factory=_empty3)
    custom: np.ndarray = field(default_factory=_empty3)
    mat_id: np.ndarray = field(
        default_factory=lambda: np.zeros((0,), np.int32))
    bmin: np.ndarray = field(default_factory=_empty3)
    bmax: np.ndarray = field(default_factory=_empty3)
    materials: list = field(default_factory=list)
    sizes: tuple = (0, 0)

    def add_mesh(self, mesh: Mesh):
        """Append a mesh's triangles; custom = a+b+c (3x centroid)."""
        mat_index = len(self.materials)
        self.materials.append(mesh.material)
        idx = mesh.indices.reshape(-1, 3).astype(np.int64)
        a = mesh.vertices[idx[:, 0]].astype(np.float32)
        b = mesh.vertices[idx[:, 1]].astype(np.float32)
        c = mesh.vertices[idx[:, 2]].astype(np.float32)
        self.a = np.concatenate([self.a, a])
        self.b = np.concatenate([self.b, b])
        self.c = np.concatenate([self.c, c])
        self.custom = np.concatenate(
            [self.custom, (a + b + c).astype(np.float32)])
        self.mat_id = np.concatenate(
            [self.mat_id, np.full(len(a), mat_index, np.int32)])
        return self

    def build(self, use_native: bool = True):
        """use_native: the order and boxes from the C++ build
        (``scene.native_bridge``) where it builds; the same arrays exactly
        as the Python build below."""
        m = len(self.a)
        n = next_power_of_two(m)
        if use_native and m > 0 and native_bridge.available():
            tri_lo = np.minimum(np.minimum(self.a, self.b), self.c)
            tri_hi = np.maximum(np.maximum(self.a, self.b), self.c)
            order, self.bmin, self.bmax = native_bridge.bvh_build(
                self.custom, tri_lo, tri_hi)
            self._reorder(order)
        else:
            self._build_python(m, n)

        # flat face normals
        nrm = np.cross(self.b - self.a, self.c - self.a).astype(np.float32)
        ln = np.sqrt(np.sum(nrm * nrm, axis=-1, dtype=np.float32))
        with np.errstate(invalid="ignore", divide="ignore"):
            self.custom = (nrm / ln[:, None]).astype(np.float32)
        self.sizes = (n, m)
        return self

    def _reorder(self, order):
        self.a, self.b, self.c = self.a[order], self.b[order], self.c[order]
        self.mat_id = self.mat_id[order]

    def _build_python(self, m: int, n: int):
        # BFS median-split sort
        order = np.arange(m)
        queue = [(0, n, 0)]
        while queue:
            i, j, depth = queue.pop(0)
            l, r = i, min(j, m)
            if l + 1 >= r:
                continue
            keys = self.custom[order[l:r], depth % 3]
            order[l:r] = order[l:r][np.argsort(keys, kind="stable")]
            mid = (i + j) // 2
            queue.append((i, mid, depth + 1))
            queue.append((mid, j, depth + 1))
        self._reorder(order)

        # node AABBs, level by level (node k covers leaf slots under it)
        pad = n - m
        lo = np.concatenate([np.minimum(np.minimum(self.a, self.b), self.c),
                             np.full((pad, 3), F32_MAX, np.float32)])
        hi = np.concatenate([np.maximum(np.maximum(self.a, self.b), self.c),
                             np.full((pad, 3), -F32_MAX, np.float32)])
        bmin = np.full((n, 3), F32_MAX, np.float32)
        bmax = np.full((n, 3), -F32_MAX, np.float32)
        size = n // 2
        while size >= 1:
            lo = np.minimum(lo[0::2], lo[1::2])
            hi = np.maximum(hi[0::2], hi[1::2])
            bmin[size:2 * size] = lo
            bmax[size:2 * size] = hi
            size //= 2
        self.bmin, self.bmax = bmin, bmax


def build_tree(meshes) -> Tree:
    t = Tree()
    for mesh in meshes:
        t.add_mesh(mesh)
    return t.build()


def to_triangle_scene(tree: Tree, device) -> TriangleScene:
    """Upload the built tree as a TriangleScene on ``device``."""
    mats = tree.materials or [((0.0, 0.0, 0.0), 0.0, 0)]
    albedo = np.array([m[0] for m in mats], np.float32).reshape(-1, 3)
    param = np.array([m[1] for m in mats], np.float32)
    kind = np.array([m[2] for m in mats], np.int32)
    up = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)
    return TriangleScene(
        a=up(tree.a), b=up(tree.b), c=up(tree.c), normal=up(tree.custom),
        mat_id=up(tree.mat_id), bmin=up(tree.bmin), bmax=up(tree.bmax),
        mat_albedo=up(albedo), mat_param=up(param), mat_kind=up(kind))


def material_lambertian(albedo):
    return (tuple(np.float32(v) for v in albedo), np.float32(0.0),
            MAT_LAMBERTIAN)


def material_metal(albedo, fuzz):
    return (tuple(np.float32(v) for v in albedo), np.float32(fuzz), MAT_METAL)


def material_dielectric(ir):
    return ((1.0, 1.0, 1.0), np.float32(ir), MAT_DIELECTRIC)
