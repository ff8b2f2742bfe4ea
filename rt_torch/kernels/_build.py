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
root stay IEEE.  ``-Xptxas -v`` puts each kernel's registers, shared memory
and spills in the log (``ptxas_usage``); ``sass_summary`` and
``sass_loops`` read the built code back with ``cuobjdump``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
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
        "rt_wave_first": ([_PTR] * 7 + [_INT] + [_PTR] * 5 + [_INT] * 15
                          + [_PTR] * 2),
        "rt_wave_bounce": ([_PTR] * 10 + [ctypes.c_longlong] + [_INT] * 10
                           + [_PTR] * 2),
        "rt_wave_raygen": ([_PTR] * 2 + [_INT] + [_PTR] * 3 + [_INT] * 6
                           + [_PTR]),
        "rt_empty": [_INT, _INT, _PTR],
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
    "replay": {
        "rt_replay_loss": ([_PTR] * 13 + [ctypes.c_uint] + [_INT] * 10
                           + [_PTR]),
    },
    "probes": {
        "rt_lane_gather": [_PTR] * 3 + [_INT] * 3 + [_PTR],
        "rt_mt_scan": [_PTR] * 4 + [_INT] * 2 + [_PTR],
        "rt_woop_mma": [_PTR] * 3 + [_INT] * 2 + [_PTR],
        "rt_probe_shape": [_INT] * 3 + [_PTR],
        "rt_probe_rcp_check": [_PTR] * 2,
        "rt_probe_fadd_chain": [_PTR] * 3 + [_INT, _PTR],
    },
}


# load()'s result: the launch functions of every built source as attributes,
# the compiler's log (registers, spills per kernel) as ``build_log``, each
# library's path by source in ``paths``
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
        # the compiler's log of the build, kept beside the library
        try:
            with open(out + ".log") as f:
                return out, f.read()
        except OSError:
            return out, "cached"
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, source],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stdout}\n"
                           f"{proc.stderr}")
    with open(f"{tmp}.log", "w") as f:
        f.write(proc.stderr)
    os.replace(f"{tmp}.log", out + ".log")
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
    k = SimpleNamespace(paths={})
    for (stem, functions), (path, _) in zip(_SIGNATURES.items(), built):
        k.paths[stem] = path
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


def short_name(mangled: str) -> str:
    """``rt::name<bool or int, ...>`` from the mangled name of a kernel of
    namespace ``rt`` (its bool and int template arguments); anything else
    unchanged."""
    m = re.match(r"_ZN2rt(\d+)", mangled)
    if not m:
        return mangled
    start = m.end()
    name = mangled[start:start + int(m.group(1))]
    args = re.match(r"I((?:L[bi]\d+E)+)E", mangled[start + int(m.group(1)):])
    if args:
        vals = re.findall(r"L([bi])(\d+)E", args.group(1))
        name += "<" + ", ".join(
            v if t == "i" else "true" if v == "1" else "false"
            for t, v in vals) + ">"
    return name


def ptxas_usage(log: str) -> list[dict]:
    """Registers, shared memory, stack and spills of each kernel in a
    ``-Xptxas -v`` log, in the order compiled."""
    out, cur, props = [], None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = dict(kernel=short_name(m.group(1)))
            out.append(cur)
            continue
        m = re.search(r"Function properties for (\w+)", line)
        if m:
            props = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and cur is not None and props is not None \
                and short_name(props) == cur["kernel"]:
            cur.update(stack_bytes=int(m.group(1)),
                       spill_store_bytes=int(m.group(2)),
                       spill_load_bytes=int(m.group(3)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            cur["smem_bytes"] = int(smem.group(1)) if smem else 0
    return out


def _sass(path: str) -> str:
    """``cuobjdump -sass`` of a built library."""
    cuobjdump = os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")
    return subprocess.run([cuobjdump, "-sass", path], capture_output=True,
                          text=True, check=True).stdout


def sass_summary(path: str) -> dict:
    """Per kernel of a built library (``cuobjdump -sass``): instructions,
    and how many are MUFU.RCP (the reciprocal's approximation), FCHK (a full
    IEEE division's range check), CALL (a slow path), BAR (barriers) and
    local-memory loads and stores."""
    text = _sass(path)
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            cur = out.setdefault(short_name(m.group(1)), dict(
                instructions=0, mufu_rcp=0, fchk=0, call=0, bar=0, local=0))
            continue
        if cur is None or not re.search(r"/\*[0-9a-f]{4,}\*/", line):
            continue
        cur["instructions"] += 1
        cur["mufu_rcp"] += "MUFU.RCP" in line
        cur["fchk"] += "FCHK" in line
        cur["call"] += "CALL" in line
        cur["bar"] += bool(re.search(r"\bBAR\.", line))
        cur["local"] += bool(re.search(r"\b(LDL|STL)\b", line))
    return out


def sass_loops(path: str) -> dict:
    """Per kernel of a built library (``cuobjdump -sass``): the instructions
    of each innermost loop (``loops_in_sass``)."""
    return loops_in_sass(_sass(path))


def loops_in_sass(text: str) -> dict:
    """Per kernel of a ``cuobjdump -sass`` listing: each innermost loop (a
    span from a branch's target up to the branch back to it that holds no
    other such span) as ``instructions`` and ``slow_path``, the instructions
    a forward branch inside it skips where they hold a CALL (a slow path
    such as the IEEE division's, not run when that branch is taken), the
    largest loop first."""
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            cur = funcs.setdefault(short_name(m.group(1)),
                                   dict(ops=[], labels={}, branches=[]))
            continue
        if cur is None:
            continue
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            cur["labels"][m.group(1)] = len(cur["ops"])
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if not m:
            continue
        cur["ops"].append((int(m.group(1), 16), m.group(2)))
        br = re.search(r"\bBRA\b.*?(?:`\((\.L_x_\d+)\)|0x([0-9a-f]+))",
                       m.group(2))
        if br:
            cur["branches"].append((len(cur["ops"]) - 1, br.group(1),
                                    br.group(2)))
    out = {}
    for name, f in funcs.items():
        where = {a: i for i, (a, _) in enumerate(f["ops"])}
        jumps = []
        for i, label, addr in f["branches"]:
            j = f["labels"].get(label) if label else where.get(int(addr, 16))
            if j is not None:
                jumps.append((i, j))
        back = [(j, i) for i, j in jumps if j <= i]
        loops = []
        for j, i in back:
            if any(j <= j2 and i2 <= i and (j2, i2) != (j, i)
                   for j2, i2 in back):
                continue
            # the outermost skipped spans that hold a CALL
            skips = sorted((b + 1, t) for b, t in jumps
                           if j <= b < t <= i and any(
                               "CALL" in op for _, op in f["ops"][b + 1:t]))
            slow, end = 0, -1
            for a, t in skips:
                if a >= end:
                    slow += t - a
                    end = t
            loops.append(dict(instructions=i - j + 1, slow_path=slow))
        out[name] = sorted(loops, key=lambda d: -d["instructions"])
    return out


def check(lib: SimpleNamespace, code: int, what: str) -> None:
    """Raise if a launch was refused (cudaGetLastError() != 0)."""
    if code != 0:
        raise RuntimeError(
            f"{what}: CUDA launch failed: "
            f"{lib.rt_error_string(code).decode()} ({code})")
