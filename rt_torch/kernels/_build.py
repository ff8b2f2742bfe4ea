"""Builds and loads the hand-written CUDA kernels.

``load()`` compiles every ``csrc/*.cu`` with ``nvcc`` for ``sm_90a`` into a
shared library under ``rt_torch/kernels/_build/`` (git-ignored) and opens it
with ``ctypes``.  The sources have a plain C interface and include no
PyTorch header, so a build takes seconds.  It runs at the first call that
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

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
NVCC_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_PTR = ctypes.c_void_p
_INT = ctypes.c_int
# C signatures of csrc/tris_wave.cu
_SIGNATURES = {
    "rt_wave_first": [_PTR] * 6 + [_INT] + [_PTR] * 4 + [_INT] * 14 + [_PTR],
    "rt_wave_bounce": ([_PTR] * 8 + [ctypes.c_longlong] + [_INT] * 8
                       + [_PTR]),
}

_libs: dict = {}


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


def load() -> ctypes.CDLL:
    """The kernels' shared library, built on first call.  The compiler's
    log (registers, spills per kernel) is kept as ``load().build_log``."""
    if "tris_wave" in _libs:
        return _libs["tris_wave"]
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    sources = sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                     if f.endswith(".cu"))
    # one nvcc per source, all started together
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        built = list(pool.map(lambda s: _compile(nvcc, s), sources))
    libs = {os.path.basename(s)[:-3]: ctypes.CDLL(path)
            for s, (path, _) in zip(sources, built)}
    lib = libs["tris_wave"]
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _INT
    lib.rt_error_string.argtypes = [_INT]
    lib.rt_error_string.restype = ctypes.c_char_p
    lib.build_log = "\n".join(log for _, log in built)
    _libs.update(libs)
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch was refused (cudaGetLastError() != 0)."""
    if code != 0:
        raise RuntimeError(
            f"{what}: CUDA launch failed: "
            f"{lib.rt_error_string(code).decode()} ({code})")
