"""Probe P2: is a relaxed-precision Woop-transform intersection on the
tensor cores at least 2x faster per ray-triangle pair than the production
Möller–Trumbore scan on the CUDA cores? — counterpart of
``tools/exp_r5_mxu.py`` (``kernel_vpu``, ``kernel_mxu``, ``main``).

Both do the same logical job, the closest t over ``n_chunks * 32``
triangles for each of ``R = 8192`` rays:

- A, ``mt_scan`` (``csrc/probes.cu:mt_scan_kernel``): the production M–T
  arithmetic per pair on the CUDA cores, strict ``t < best`` in ascending
  row order.  Bit-equal to ``mt_scan_plain``.
- B, ``woop`` (``csrc/probes.cu:woop_mma_kernel``): per chunk one product
  ``bf16(x) (R, 8) @ W[c] (8, 192)`` on the tensor cores with f32
  accumulation, W's columns grouped per coefficient (ox 0-31, oy 32-63, oz,
  dx, dy, dz), then ``t = -oz * (1 / dz)``, ``u = ox + t dx``,
  ``v = oy + t dy``, the validity window and the least valid t of the
  chunk's 32 columns.  Its plain version ``woop_plain`` sums the eight
  exact bf16 products in order; the tensor cores sum them their own way, so
  B is held to ``woop_plain`` within ``woop_agreement``'s limits.

Both kernels split the chunks among the blocks of a thread-block cluster
that share a group of rays and take the least of the blocks' partial bests
(``launch_shape`` reads the launch).  That is exact: each result is
min(FLT_MAX, least valid t) over its rows in any order, so
``torch.minimum`` of the plain versions over slices of the chunks is the
plain version over all of them, bit for bit.  A slice too large for a
block's shared memory is staged and scanned in pieces (``piece_plan``), by
the same reasoning.

A wrapper launches its kernel on a CUDA tensor and runs its plain version on
a CPU tensor; ``LAUNCHES`` counts kernel launches, nothing else.

``main`` runs what the tool's ``main`` runs: inputs drawn from
``np.random.default_rng(0)`` in the tool's order (``inputs``), A and B timed
over ``reps`` launches each by CUDA events around the launches (the tool
times a scan of ``reps`` calls through a host readback), one line each in
us/pass and Gpairs/s.  The tool's ray count and ray blocking (1024 rays, for
the TPU's VMEM) are not knobs here.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from rt_torch.core import vecmath as vm
from rt_torch.kernels.tris_kernel import _require
from rt_torch.probes import SMEM_OPTIN, device_line, timed_ms

TH, TW = 32, 256
R = TH * TW
CHUNK = 32
EPS = 1e-4
FLT_MAX = 3.40282e38     # the probe's literal: as f32 0x7f7fffee, not f32 max
TRI_COLS = 13            # v0 (cols 0-2), e1 (3-5), e2 (6-8), then unused
WOOP_K = 8
WOOP_COLS = 6 * CHUNK    # ox, oy, oz, dx, dy, dz of each of 32 triangles

_EPS = float(np.float32(EPS))
_FLT_MAX = float(np.float32(FLT_MAX))

# B against its plain version: t within REL_LIMIT relative where both hit
# (or within the rounding bound of the winner's sums, ``woop_agreement``),
# and hit/miss disagreements on at most HIT_MISS_LIMIT of the rays
REL_LIMIT = 1e-5
HIT_MISS_LIMIT = 1e-3
# one f32 sum of eight exact products, in any order, is within 8 units of
# the last place (2**-24) of the sum of their magnitudes; two such sums
# differ by at most twice that
_SUM_ULPS = 16 * 2.0 ** -24

LAUNCHES = {"mt_scan": 0, "woop_mma": 0}

# the kernels' launch (csrc/probes.cu): blocks a cluster, the bytes a
# block stages a chunk and its static shared bytes (the partial bests)
CLUSTER = {"mt_scan": 2, "woop_mma": 8}
CHUNK_BYTES = {"mt_scan": CHUNK * 12 * 4, "woop_mma": 24 * 33 * 4}
STATIC_BYTES = {"mt_scan": 512 * 4, "woop_mma": 64 * 4}


def inputs(n_chunks: int, seed: int = 0) -> dict:
    """The tool's inputs as NumPy f32, drawn in its order: tri
    (n_chunks * 32, 13), o and d (3, 32, 256), w (n_chunks, 8, 192) holding
    bf16 values (the f64 draw rounded to bf16 once), x (8192, 8)."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: a.astype(np.float32)
    tri = f32(rng.normal(size=(n_chunks * CHUNK, TRI_COLS)))
    o = f32(rng.normal(size=(3, TH, TW)))
    d = f32(rng.normal(size=(3, TH, TW)))
    w = torch.from_numpy(rng.normal(size=(n_chunks, WOOP_K, WOOP_COLS))).to(
        torch.bfloat16).to(torch.float32).numpy()
    x = f32(rng.normal(size=(R, WOOP_K)))
    return dict(tri=tri, o=o, d=d, w=w, x=x)


def as_bf16(w: np.ndarray) -> torch.Tensor:
    """f32 NumPy holding bf16 values as a bf16 tensor; raises unless the
    cast is exact."""
    t = torch.from_numpy(np.ascontiguousarray(w, np.float32))
    b = t.to(torch.bfloat16)
    if not torch.equal(b.to(torch.float32).view(torch.int32),
                       t.view(torch.int32)):
        raise ValueError("w: not every value is a bf16 value")
    return b


def to_device(arrays: dict, device) -> dict:
    """``inputs``' arrays as tensors on ``device``, w as bf16."""
    out = {k: torch.from_numpy(v).to(device) for k, v in arrays.items()
           if k != "w"}
    out["w"] = as_bf16(arrays["w"]).to(device)
    return out


# ---------------------------------------------------------------------------
# A: the M-T scan
# ---------------------------------------------------------------------------

def mt_scan_plain(tri: torch.Tensor, o: torch.Tensor, d: torch.Tensor):
    """Plain version of A: o, d (3, ...) f32 planes, tri (n, 13) f32 ->
    closest t (...) f32, the probe's FLT_MAX on a miss.  Rows in ascending
    order, every operation rounded singly, strict t < best."""
    o, d = (o[0], o[1], o[2]), (d[0], d[1], d[2])
    bt = torch.full_like(o[0], _FLT_MAX)
    for row in tri[:, 0:9].tolist():          # the f32 values, exactly
        v0, e1, e2 = row[0:3], row[3:6], row[6:9]
        h = vm.cross3(d, e2)
        det = vm.dot3(e1, h)
        inv_det = 1.0 / det
        s = (o[0] - v0[0], o[1] - v0[1], o[2] - v0[2])
        u = inv_det * vm.dot3(s, h)
        q = vm.cross3(s, e1)
        v = inv_det * vm.dot3(d, q)
        t = inv_det * vm.dot3(e2, q)
        valid = torch.abs(det) >= _EPS
        valid &= (u >= 0.0) & (u <= 1.0)
        valid &= (v >= 0.0) & (u + v <= 1.0)
        valid &= (t >= _EPS) & (t < bt)
        bt = torch.where(valid, t, bt)
    return bt


def mt_scan(tri: torch.Tensor, o: torch.Tensor, d: torch.Tensor):
    """A: closest t (...) f32 of the rays o, d (3, ...) f32 over the rows of
    tri (n_chunks * 32, 13) f32."""
    if tri.device.type == "cpu":
        return mt_scan_plain(tri, o, d)
    from rt_torch.kernels import _build

    n = tri.shape[0]
    if n % CHUNK or tri.dim() != 2 or o.shape[0] != 3:
        raise ValueError(f"mt_scan: tri {tuple(tri.shape)}, o "
                         f"{tuple(o.shape)}: need ({CHUNK}k, {TRI_COLS}) "
                         f"rows and (3, ...) rays")
    _require(tri, "tri", torch.float32, (n, TRI_COLS))
    _require(o, "o", torch.float32)
    _require(d, "d", torch.float32, o.shape)
    out = torch.empty(o.shape[1:], dtype=torch.float32, device=o.device)
    lib = _build.load()
    code = lib.rt_mt_scan(tri.data_ptr(), o.data_ptr(), d.data_ptr(),
                          out.data_ptr(), out.numel(), n // CHUNK,
                          torch.cuda.current_stream(o.device).cuda_stream)
    _build.check(lib, code, "mt_scan")
    LAUNCHES["mt_scan"] += 1
    return out


# ---------------------------------------------------------------------------
# B: the Woop product and its epilogue
# ---------------------------------------------------------------------------

def woop_plain(w: torch.Tensor, x: torch.Tensor, *, winner: bool = False):
    """Plain version of B: w (n_chunks, 8, 192) bf16, x (R, 8) f32 ->
    closest t (R, 1) f32.  The eight products of bf16 values are exact in
    f32 and are summed for k = 0 ... 7 in order.  With winner=True also the
    (R,) int64 column ``chunk * 32 + j`` of each ray's t, -1 on a miss."""
    xb = x.to(torch.bfloat16).to(torch.float32)
    wf = w.to(torch.float32)
    best = torch.full((x.shape[0], 1), _FLT_MAX, dtype=torch.float32,
                      device=x.device)
    win = torch.full((x.shape[0],), -1, dtype=torch.int64, device=x.device)
    for c in range(w.shape[0]):
        y = xb[:, 0:1] * wf[c, 0]
        for k in range(1, WOOP_K):
            y = y + xb[:, k:k + 1] * wf[c, k]
        ox, oy, oz, dx, dy, dz = (y[:, g * CHUNK:(g + 1) * CHUNK]
                                  for g in range(6))
        t = -oz * (1.0 / dz)
        u = ox + t * dx
        v = oy + t * dy
        valid = (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) \
            & (t >= _EPS) & (t < best)
        cand, j = torch.where(valid, t, torch.full_like(t, _FLT_MAX)).min(
            dim=1, keepdim=True)
        win = torch.where(cand[:, 0] < best[:, 0], c * CHUNK + j[:, 0], win)
        best = torch.minimum(best, cand)
    return (best, win) if winner else best


def woop(w: torch.Tensor, x: torch.Tensor):
    """B: closest t (R, 1) f32 of the rays x (R, 8) f32 over the chunks of
    w (n_chunks, 8, 192) bf16."""
    if w.device.type == "cpu":
        return woop_plain(w, x)
    from rt_torch.kernels import _build

    if w.dim() != 3 or x.dim() != 2:
        raise ValueError(f"woop: w {tuple(w.shape)}, x {tuple(x.shape)}: "
                         f"need (n_chunks, {WOOP_K}, {WOOP_COLS}) and "
                         f"(R, {WOOP_K})")
    _require(w, "w", torch.bfloat16, (w.shape[0], WOOP_K, WOOP_COLS))
    _require(x, "x", torch.float32, (x.shape[0], WOOP_K))
    if w.data_ptr() % 16:
        raise ValueError("woop: w must start on a 16-byte boundary (the "
                         "kernel stages it in 16-byte loads)")
    out = torch.empty((x.shape[0], 1), dtype=torch.float32, device=x.device)
    lib = _build.load()
    code = lib.rt_woop_mma(w.data_ptr(), x.data_ptr(), out.data_ptr(),
                           x.shape[0], w.shape[0],
                           torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, code, "woop_mma")
    LAUNCHES["woop_mma"] += 1
    return out


def piece_plan(kernel: str, n_chunks: int,
               smem_optin: int = SMEM_OPTIN) -> tuple:
    """(piece, pieces) as the launcher plans them: a block stages its whole
    slice (at most ceil(n_chunks / cluster) chunks) where it fits in
    ``smem_optin`` bytes beside the static ones, else the slice in
    ``pieces`` turns of at most ``piece`` chunks, as even as they come."""
    most = (smem_optin - STATIC_BYTES[kernel]) // CHUNK_BYTES[kernel]
    slice_ = -(-n_chunks // CLUSTER[kernel])
    pieces = 1 if slice_ <= most else -(-slice_ // most)
    return -(-slice_ // pieces), pieces


def pieces_of(first: int, last: int, piece: int) -> list:
    """The chunks [c0, c1) of each turn of a block whose slice is
    [first, last), ``piece`` at a time (the kernels' piece loop)."""
    return [(c0, min(c0 + piece, last)) for c0 in range(first, last, piece)]


def launch_shape(kernel: str, n_rays: int = R, n_chunks: int = 64,
                 device="cuda") -> dict:
    """The launch of ``mt_scan`` or ``woop_mma`` at these sizes and the
    card's occupancy for it: grid (blocks), cluster (blocks a cluster, each
    a slice of the chunks), threads a block, dynamic shared bytes, resident
    blocks an SM and clusters resident at once (the CUDA occupancy API),
    pairs a thread (lane) takes in one turn of its innermost loop, chunks
    a block stages at once and the turns of staging at most
    (``piece_plan``)."""
    from rt_torch.kernels import _build

    lib = _build.load()
    vals = (ctypes.c_int * 9)()
    with torch.cuda.device(torch.device(device)):
        code = lib.rt_probe_shape({"mt_scan": 0, "woop_mma": 1}[kernel],
                                  n_rays, n_chunks, vals)
    _build.check(lib, code, f"launch_shape({kernel})")
    return dict(zip(("grid", "cluster", "threads", "dynamic_smem_bytes",
                     "blocks_per_sm", "active_clusters", "pairs_per_turn",
                     "piece", "pieces"), vals))


def reciprocal_mismatches(device="cuda") -> int:
    """The floats x (of all 2**32 bit patterns) whose reciprocal as both
    kernels take it, a fast path written out with the slow path's branch
    shared by several x, differs from ``1.0f / x`` compiled with IEEE
    division: 0 for the kernels to be held to their plain versions."""
    from rt_torch.kernels import _build

    dev = torch.device(device)
    bad = torch.zeros(1, dtype=torch.int64, device=dev)
    lib = _build.load()
    code = lib.rt_probe_rcp_check(bad.data_ptr(),
                                  torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, code, "reciprocal_mismatches")
    return int(bad.item())


def woop_agreement(t: torch.Tensor, t_ref: torch.Tensor, w: torch.Tensor,
                   x: torch.Tensor, winner_ref: torch.Tensor) -> dict:
    """B's t (R, 1) against a reference t_ref and its winning columns
    (``woop_plain(w, x, winner=True)``).

    Where both hit, t may differ by REL_LIMIT relative, or by what the
    rounding of the winner's two sums allows where that is more: t =
    -oz / dz, and two f32 sums of the same eight exact products differ by at
    most ``_SUM_ULPS * sum |product|``, so t by ``_SUM_ULPS * (kappa_oz +
    kappa_dz)`` relative, kappa = sum |product| / |sum| (large where the
    products cancel, as they do for the small t that win among 2048).
    ``ok``: no ray over its limit and hit/miss disagreements on at most
    HIT_MISS_LIMIT of the rays."""
    t, t_ref = t[:, 0], t_ref[:, 0]
    hit, hit_ref = t != _FLT_MAX, t_ref != _FLT_MAX
    both = hit & hit_ref
    rel = ((t - t_ref).abs() / t_ref.abs())[both].double()
    win = winner_ref[both]
    xb = x[both].to(torch.bfloat16).double()
    wd = w.double()
    kappa = 0.0
    for g in (2, 5):                                 # oz, dz
        prods = xb * wd[win // CHUNK, :, g * CHUNK + win % CHUNK]  # (n, 8)
        kappa = kappa + prods.abs().sum(dim=1) / prods.sum(dim=1).abs()
    limit = torch.clamp(_SUM_ULPS * kappa, min=REL_LIMIT)
    n_both = int(both.sum())
    res = dict(
        rays=int(t.numel()), hit_share=float(hit_ref.float().mean()),
        hit_miss_differ=float((hit != hit_ref).float().mean()),
        both_hit=n_both, bitwise=float((t.view(torch.int32)
                                        == t_ref.view(torch.int32))
                                       .float().mean()),
        max_rel=float(rel.max()) if n_both else 0.0,
        share_over_rel_limit=float((rel > REL_LIMIT).double().mean())
        if n_both else 0.0,
        max_rel_over_own_limit=float((rel / limit).max()) if n_both else 0.0)
    res["ok"] = (res["hit_miss_differ"] <= HIT_MISS_LIMIT
                 and res["max_rel_over_own_limit"] <= 1.0)
    return res


def main(device="cuda", reps: int = 200, chunks: int = 64) -> None:
    """The tool's ``main``: A and B at ``chunks`` chunks, each timed over
    ``reps`` launches, one line each."""
    dev = torch.device(device)
    print(device_line(dev), flush=True)
    a = to_device(inputs(chunks), dev)
    pairs = R * chunks * CHUNK
    for name, fn in (("A mt_scan", lambda: mt_scan(a["tri"], a["o"], a["d"])),
                     ("B woop_mma", lambda: woop(a["w"], a["x"]))):
        ms = timed_ms(fn, reps, dev)
        shape = ""
        if dev.type == "cuda":
            s = launch_shape(name.split()[1], R, chunks, dev)
            shape = (f"  grid {s['grid']} cluster {s['cluster']} x "
                     f"{s['threads']} threads, {s['blocks_per_sm']} "
                     f"blocks/SM, slices staged in {s['pieces']} piece(s) "
                     f"of <= {s['piece']} chunks")
        print(f"{name}: {ms * 1e3:9.1f} us/pass  {pairs / ms / 1e6:7.2f} "
              f"Gpairs/s{shape}", flush=True)
