"""The reference's own scene: OBJ files parsed, triangle and sphere tables,
materials and the camera, all worked out from a configuration file.

Nothing here comes from the program.  The camera is made here and handed to
both sides; the tables are the reference's own (triangles in the OBJ files'
order, not the program's BVH order: a brute-force scan does not depend on
the order except at exact-t ties).
"""

from __future__ import annotations

import math
import os

import numpy as np

MAT_KINDS = {"lambertian": 1, "metal": 2, "dielectric": 3}


def parse_obj(text: str):
    """(vertices (V, 3) f32, indices (3F,) u32): positions only, faces
    fan-triangulated, 1-based and negative indices resolved."""
    verts, faces = [], []
    for line in text.splitlines():
        if line.startswith("v "):
            p = line.split()
            verts.append((np.float32(p[1]), np.float32(p[2]),
                          np.float32(p[3])))
        elif line.startswith("f "):
            idx = []
            for p in line.split()[1:]:
                k = int(p.split("/")[0])
                idx.append(k - 1 if k > 0 else len(verts) + k)
            for t in range(1, len(idx) - 1):
                faces.extend((idx[0], idx[t], idx[t + 1]))
    return (np.array(verts, np.float32).reshape(-1, 3),
            np.array(faces, np.uint32))


def material(spec: dict):
    """(albedo (3,) f32, parameter f32, kind int) of a material entry."""
    kind = MAT_KINDS[spec["kind"]]
    if kind == 3:
        return (np.ones(3, np.float32), np.float32(spec["ir"]), kind)
    param = spec.get("fuzz", 0.0) if kind == 2 else 0.0
    return (np.asarray(spec["albedo"], np.float32), np.float32(param), kind)


def _unit(v):
    return v / np.sqrt(np.sum(v * v, dtype=np.float32))


def look_at(spec: dict) -> dict:
    """The camera of a configuration: eye, direction, up, right as vec4
    with w = 1, focal length, focal blur and fov, all f32."""
    eye = np.asarray(spec["eye"], np.float32)
    target = np.asarray(spec["target"], np.float32)
    d = _unit(target - eye)
    r = _unit(np.cross(d, np.array([0, 1, 0], np.float32)).astype(np.float32))
    u = _unit(np.cross(r, d).astype(np.float32))
    ext = lambda v: np.append(np.asarray(v, np.float32), np.float32(1.0))
    fov = np.float32(np.float32(np.pi) * np.float32(spec["fov_pi"]))
    return dict(eye=ext(eye), direction=ext(d), up=ext(u), right=ext(r),
                focal_length=np.float32(spec["focal_length"]),
                focal_blur=np.float32(spec["focal_blur"]), fov=fov)


def camera_row(cam: dict) -> list:
    """The 20 camera floats the tracer reads: eye, direction, up, right
    (4 each), focal length, focal blur, fov, tan(fov / 2) correctly
    rounded from float64."""
    half = np.float32(cam["fov"]) * np.float32(0.5)
    row = [*cam["eye"], *cam["direction"], *cam["up"], *cam["right"],
           cam["focal_length"], cam["focal_blur"], cam["fov"],
           np.float32(math.tan(float(half)))]
    return [float(np.float32(v)) for v in row]


def triangles(config: dict, root: str) -> dict:
    """The triangle table of a ``triangles`` configuration as f32 NumPy
    columns: a, e1 = b - a, e2 = c - a, the flat normal
    normalize(cross(b - a, c - a)), the material row; and the material
    table (albedo, parameter, kind)."""
    a_s, b_s, c_s, mid = [], [], [], []
    mats = []
    for k, mesh in enumerate(config["meshes"]):
        with open(os.path.join(root, mesh["obj"])) as f:
            v, idx = parse_obj(f.read())
        idx = idx.reshape(-1, 3).astype(np.int64)
        a_s.append(v[idx[:, 0]])
        b_s.append(v[idx[:, 1]])
        c_s.append(v[idx[:, 2]])
        mid.append(np.full(len(idx), k, np.int32))
        mats.append(material(mesh["material"]))
    a, b, c = (np.concatenate(x).astype(np.float32) for x in (a_s, b_s, c_s))
    nrm = np.cross(b - a, c - a).astype(np.float32)
    ln = np.sqrt(np.sum(nrm * nrm, axis=-1, dtype=np.float32))
    with np.errstate(invalid="ignore", divide="ignore"):
        normal = (nrm / ln[:, None]).astype(np.float32)
    return dict(a=a, b=b, c=c, e1=(b - a).astype(np.float32),
                e2=(c - a).astype(np.float32), normal=normal,
                mat_id=np.concatenate(mid),
                albedo=np.stack([m[0] for m in mats]),
                param=np.array([m[1] for m in mats], np.float32),
                kind=np.array([m[2] for m in mats], np.int32))


def spheres(config: dict) -> dict:
    """The sphere table of a ``spheres`` configuration: centre, radius,
    albedo, parameter, kind, in the configuration's order."""
    rows = [(np.asarray(s["center"], np.float32), np.float32(s["radius"]),
             *material(s["material"])) for s in config["spheres"]]
    return dict(center=np.stack([r[0] for r in rows]),
                radius=np.array([r[1] for r in rows], np.float32),
                albedo=np.stack([r[2] for r in rows]),
                param=np.array([r[3] for r in rows], np.float32),
                kind=np.array([r[4] for r in rows], np.int32))


def _spread10(v):
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def morton_chunks(tris: dict, chunk: int = 32) -> np.ndarray:
    """(n_chunks, 6) f32 boxes (min xyz, max xyz) of the triangles sorted
    by the 30-bit Morton code of their centroids, ``chunk`` at a time:
    the unit of work the operation counts of ``roofline`` are made of."""
    a, b, c = tris["a"], tris["b"], tris["c"]
    cen = (a + b + c) / np.float32(3.0)
    lo = cen.min(axis=0)
    span = np.maximum(cen.max(axis=0) - lo, np.float32(1e-12))
    q = np.clip((cen - lo) / span * 1023.0, 0, 1023).astype(np.int64)
    code = (_spread10(q[:, 0]) << 2) | (_spread10(q[:, 1]) << 1) \
        | _spread10(q[:, 2])
    order = np.argsort(code, kind="stable")
    verts = np.stack([a, b, c], axis=1)[order]           # (m, 3, 3)
    m = len(order)
    pad = -m % chunk
    lo_v = np.concatenate([verts, np.full((pad, 3, 3), 3e38, np.float32)])
    hi_v = np.concatenate([verts, np.full((pad, 3, 3), -3e38, np.float32)])
    vmin = lo_v.reshape(-1, chunk * 3, 3).min(axis=1)
    vmax = hi_v.reshape(-1, chunk * 3, 3).max(axis=1)
    return np.concatenate([vmin, vmax], axis=1).astype(np.float32)

