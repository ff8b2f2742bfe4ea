"""ctypes bridge to the repo's C++ host runtime (``native/rt_native.cpp``)
— counterpart of ``rt/scene/native_bridge.py``.

At first use the source is compiled with ``g++ -O2 -shared -fPIC`` into
``rt_torch/kernels/_build/`` (git-ignored), under a name that carries the
source's hash, so the port never loads a library another build left
behind.  Where no compiler is found or the build fails, ``available()`` is
False and the callers (the OBJ loader, the BVH build, the PPM writer) take
their Python paths, which give the same results exactly.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCE = os.path.join(_ROOT, "native", "rt_native.cpp")
BUILD_DIR = os.path.join(_ROOT, "rt_torch", "kernels", "_build")

_lib = None
_tried = False


class _ObjResult(ctypes.Structure):
    _fields_ = [("verts", ctypes.POINTER(ctypes.c_float)),
                ("n_verts", ctypes.c_int64),
                ("indices", ctypes.POINTER(ctypes.c_uint32)),
                ("n_idx", ctypes.c_int64)]


def library_path() -> str | None:
    """Where the build of the current source lies (None without one)."""
    if not os.path.exists(SOURCE):
        return None
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"librtnative_{digest}.so")


def _build(out: str) -> bool:
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        return False
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run([cxx, "-O2", "-std=c++17", "-fPIC", "-shared",
                               "-o", tmp, SOURCE], capture_output=True,
                              timeout=300)
    except (OSError, subprocess.TimeoutExpired):
        proc = None
    if proc is None or proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        return False
    os.replace(tmp, out)           # concurrent builds: the last one wins
    return True


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    out = library_path()
    if out is None or not (os.path.exists(out) or _build(out)):
        return None
    try:
        lib = ctypes.CDLL(out)
    except OSError:                # not loadable here: the Python paths
        return None
    lib.rt_parse_obj.restype = ctypes.c_int
    lib.rt_parse_obj.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                 ctypes.POINTER(_ObjResult)]
    lib.rt_free.argtypes = [ctypes.c_void_p]
    lib.rt_free.restype = None
    lib.rt_bvh_build.restype = ctypes.c_int
    lib.rt_bvh_build.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float)]
    lib.rt_render_ppm.restype = ctypes.c_int64
    lib.rt_render_ppm.argtypes = [ctypes.POINTER(ctypes.c_float),
                                  ctypes.c_int64, ctypes.c_int64,
                                  ctypes.POINTER(ctypes.c_char_p)]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def _fp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def parse_obj(text: str):
    """-> (vertices (V, 3) f32, indices (3F,) u32).  Raises RuntimeError
    where the parser reports a failure."""
    lib = _load()
    data = text.encode("utf-8")
    res = _ObjResult()
    if lib.rt_parse_obj(data, len(data), ctypes.byref(res)) != 0:
        raise RuntimeError("rt_parse_obj failed")
    try:
        v = (np.ctypeslib.as_array(res.verts, (res.n_verts * 3,)).copy()
             if res.n_verts else np.zeros((0,), np.float32))
        f = (np.ctypeslib.as_array(res.indices, (res.n_idx,)).copy()
             if res.n_idx else np.zeros((0,), np.uint32))
    finally:
        lib.rt_free(res.verts)
        lib.rt_free(res.indices)
    return v.astype(np.float32).reshape(-1, 3), f.astype(np.uint32)


def bvh_build(centroid3: np.ndarray, tri_lo: np.ndarray, tri_hi: np.ndarray):
    """The BFS median-split order and the node boxes: -> (order (m,) i64,
    bmin (n, 3) f32, bmax (n, 3) f32), n the next power of two of m."""
    lib = _load()
    m = len(centroid3)
    for a in (centroid3, tri_lo, tri_hi):
        if np.shape(a) != (m, 3):
            raise ValueError(f"bvh_build: need ({m}, 3) arrays, got "
                             f"{np.shape(a)}")
    n = 1
    while n < max(m, 1):
        n <<= 1
    centroid3 = np.ascontiguousarray(centroid3, np.float32)
    tri_lo = np.ascontiguousarray(tri_lo, np.float32)
    tri_hi = np.ascontiguousarray(tri_hi, np.float32)
    order = np.zeros(m, np.int64)
    bmin = np.zeros((n, 3), np.float32)
    bmax = np.zeros((n, 3), np.float32)
    rc = lib.rt_bvh_build(_fp(centroid3), _fp(tri_lo), _fp(tri_hi), m,
                          order.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                          _fp(bmin), _fp(bmax))
    if rc != 0:
        raise RuntimeError("rt_bvh_build failed")
    return order, bmin, bmax


def render_ppm(image: np.ndarray) -> str:
    """The P3 text of an (H, W, 3) f32 linear image."""
    lib = _load()
    if image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"render_ppm: need (H, W, 3), got {image.shape}")
    h, w = image.shape[:2]
    img = np.ascontiguousarray(image, np.float32)
    out = ctypes.c_char_p()
    ln = lib.rt_render_ppm(_fp(img), h, w, ctypes.byref(out))
    if ln < 0:
        raise RuntimeError("rt_render_ppm failed")
    try:
        return ctypes.string_at(out, ln).decode("ascii")
    finally:
        lib.rt_free(out)
