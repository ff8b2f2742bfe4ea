"""Builds and loads the hand-written CUDA kernels.

``load()`` compiles every ``csrc/*.cu`` with ``nvcc`` for ``sm_90a`` into a
shared library each under ``rt_torch/kernels/_build/`` (git-ignored) and
opens them with ``ctypes``.  The sources have a plain C interface and
include no PyTorch header, so a build takes seconds.  It runs at the first call that
hands a kernel wrapper a CUDA tensor, never at import.  A failed build
raises; nothing falls back to the plain versions.

Flags: ``-fmad=false`` keeps ``a*b+c`` as two rounded operations, which is
what the plain PyTorch versions compute, so kernel and plain version can be
held to each other bit for bit.  No ``--use_fast_math``: division and square
root stay IEEE.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
NVCC_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_PTR = ctypes.c_void_p
_INT = ctypes.c_int
# C signatures of the launch functions, by source file
_SIGNATURES = {
    "tris_wave": {
        "rt_wave_first": ([_PTR] * 6 + [_INT] + [_PTR] * 5 + [_INT] * 14
                          + [_PTR]),
        "rt_wave_bounce": ([_PTR] * 9 + [ctypes.c_longlong] + [_INT] * 8
                           + [_PTR]),
        "rt_wave_raygen": ([_PTR] * 2 + [_INT] + [_PTR] * 3 + [_INT] * 8
                           + [_PTR]),
    },
    "spheres": {
        "rt_spheres": ([_PTR] * 3 + [ctypes.c_uint] + [_PTR] * 2
                       + [_INT] * 14 + [_PTR]),
        "rt_spheres_chunked": ([_PTR] * 5 + [ctypes.c_uint] + [_PTR]
                               + [_INT] * 15 + [_PTR]),
    },
    "tris_mono": {
        "rt_tris_mono": ([_PTR] * 5 + [ctypes.c_uint, _INT] + [_PTR] * 2
                         + [_INT] * 16 + [_PTR]),
    },
    "probes": {
        "rt_lane_gather": [_PTR] * 3 + [_INT] * 3 + [_PTR],
        "rt_mt_scan": [_PTR] * 4 + [_INT] * 2 + [_PTR],
        "rt_woop_mma": [_PTR] * 3 + [_INT] * 2 + [_PTR],
    },
}


# load()'s result: the launch functions of every built source as attributes,
# the compiler's log (registers, spills per kernel) as ``build_log``
_kernels: SimpleNamespace | None = None


def find_nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found: the rt_torch CUDA kernels are compiled at first "
            "use and need the CUDA toolkit (set CUDA_HOME)")
    return nvcc


def _compile(nvcc: str, source: str) -> tuple[str, str]:
    """Compile one .cu into its own shared library (cached by the hash of
    the sources and flags).  Returns (library path, compiler log)."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC)):
        with open(os.path.join(CSRC, name), "rb") as f:
            digest.update(name.encode() + f.read())
    stem = os.path.splitext(os.path.basename(source))[0]
    out = os.path.join(BUILD_DIR, f"lib{stem}_{digest.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out, "cached"
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, source],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stdout}\n"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stderr


def load() -> SimpleNamespace:
    """The kernels' launch functions, built on first call."""
    global _kernels
    if _kernels is not None:
        return _kernels
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    sources = [os.path.join(CSRC, f"{stem}.cu") for stem in _SIGNATURES]
    # one nvcc per source, all started together
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        built = list(pool.map(lambda s: _compile(nvcc, s), sources))
    k = SimpleNamespace()
    for (stem, functions), (path, _) in zip(_SIGNATURES.items(), built):
        lib = ctypes.CDLL(path)
        for name, argtypes in functions.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = _INT
            setattr(k, name, fn)
        lib.rt_error_string.argtypes = [_INT]
        lib.rt_error_string.restype = ctypes.c_char_p
        k.rt_error_string = lib.rt_error_string
    k.build_log = "\n".join(log for _, log in built)
    _kernels = k
    return k


def check(lib: SimpleNamespace, code: int, what: str) -> None:
    """Raise if a launch was refused (cudaGetLastError() != 0)."""
    if code != 0:
        raise RuntimeError(
            f"{what}: CUDA launch failed: "
            f"{lib.rt_error_string(code).decode()} ({code})")
