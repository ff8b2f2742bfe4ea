"""Wavefront OBJ loader — counterpart of ``rt/scene/objloader.py``.

The bundled assets (``load_asset``) go through the C++ parser of
``scene.native_bridge`` where it builds: on each of them it gives the
Python parser's arrays exactly (tests/test_torch_app.py).  Other text goes
through the Python parser (``parse_obj``) unless the caller asks for the
C++ one: on a malformed line (``v 1 2``) the C++ parser reads a zero and
goes on, where the Python one fails and the loader gives the reference's
empty mesh.

Only vertex positions survive; multi-object files merge because OBJ ``f``
indices are global; a parse failure gives an empty mesh, as the reference's
loader does.  The bundled meshes are read from the JAX package's asset
directory by path.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from rt_torch.scene import native_bridge

ASSET_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "rt", "scene", "assets")


@dataclass
class Mesh:
    vertices: np.ndarray  # (V, 3) f32 positions
    indices: np.ndarray   # (3F,) u32
    material: tuple = ()  # (albedo(3,), param, kind)

    @property
    def num_triangles(self) -> int:
        return len(self.indices) // 3


def parse_obj(text: str):
    verts = []
    faces = []
    for line in text.splitlines():
        if line.startswith("v "):
            parts = line.split()
            verts.append((np.float32(parts[1]), np.float32(parts[2]),
                          np.float32(parts[3])))
        elif line.startswith("f "):
            idx = []
            for p in line.split()[1:]:
                k = int(p.split("/")[0])
                # OBJ is 1-based; negative indices count from the end
                idx.append(k - 1 if k > 0 else len(verts) + k)
            for t in range(1, len(idx) - 1):     # fan-triangulate
                faces.extend((idx[0], idx[t], idx[t + 1]))
    return (np.array(verts, np.float32).reshape(-1, 3),
            np.array(faces, np.uint32))


def load_obj(source, material=None, use_native: bool = False) -> Mesh:
    """Load an OBJ from bytes, text or a path; a parse failure gives an
    empty mesh.  use_native: the C++ parser where it builds (for
    well-formed files only, see above)."""
    try:
        if isinstance(source, (bytes, bytearray)):
            text = source.decode("utf-8", errors="replace")
        elif (isinstance(source, str) and "\n" not in source
              and os.path.exists(source)):
            with open(source) as f:
                text = f.read()
        else:
            text = source
        v = None
        if use_native and native_bridge.available():
            try:
                v, f = native_bridge.parse_obj(text)
            except RuntimeError:         # the C++ parser refused the text
                v = None
        if v is None:
            v, f = parse_obj(text)
    except (ValueError, IndexError, AttributeError, OSError):
        v = np.zeros((0, 3), np.float32)
        f = np.zeros((0,), np.uint32)
    return Mesh(vertices=v, indices=f, material=material or ())


def load_asset(name: str, material=None) -> Mesh:
    return load_obj(os.path.join(ASSET_DIR, name), material,
                    use_native=True)
