"""The triangle-scene container — counterpart of
``rt/core/triangle.py:35-52``."""

from __future__ import annotations

from typing import NamedTuple

import torch


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
