"""``rt_torch.probes`` against the two TPU probes under ``tools/``, which are
loaded by path and run as they are: ``exp_lane_gather.probe`` and the
kernels of ``exp_r5_mxu`` in interpret mode, and ``kernel_vpu`` eagerly on
stand-in refs.  The CUDA kernels themselves are held to the plain versions
in ``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""

import functools
import importlib.util
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from rt_torch.probes import __main__ as probes_cli
from rt_torch.probes import lane_gather as tlg
from rt_torch.probes import r5_mxu as tmx
import test_torch_parity_util as U
from _torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


jlg = _load_tool("exp_lane_gather")
jmx = _load_tool("exp_r5_mxu")

_VMEM = pl.BlockSpec(memory_space=pltpu.VMEM)


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


# ---------------------------------------------------------------------------
# constants and inputs
# ---------------------------------------------------------------------------

def test_constants_are_the_tools():
    assert np.float32(jmx.FLT_MAX).view(np.uint32) == 0x7f7fffee
    assert np.float32(tmx._FLT_MAX).view(np.uint32) == 0x7f7fffee
    assert np.float32(tmx._EPS) == np.float32(jmx.EPS)
    assert (tmx.TH, tmx.TW, tmx.R, tmx.CHUNK) == (jmx.TH, jmx.TW, jmx.R,
                                                  jmx.CHUNK)
    with pytest.raises(ValueError):
        tmx.as_bf16(np.array([1.0 + 2.0 ** -10], np.float32))


@pytest.mark.parametrize("th,tw", tlg.SHAPES)
def test_lane_gather_inputs_are_the_tools_bitwise(th, tw, monkeypatch):
    """The port draws the tool's seed-0 table and indices: the tool's run()
    with its probe() replaced by one that keeps its arguments."""
    seen = []

    def keep(tab, idx, **kw):
        seen.append((np.asarray(tab), np.asarray(idx)))
        return jnp.zeros((th, tw), jnp.float32)

    monkeypatch.setattr(jlg, "probe", keep)
    jlg.run(th, tw, 1)
    tab_row, tab, idx = tlg.inputs(th, tw)
    assert np.array_equal(_bits(seen[0][0]), _bits(tab))
    assert np.array_equal(seen[0][1], idx)
    assert np.array_equal(_bits(tab[0]), _bits(tab_row))


def test_r5_inputs_are_the_tools_bitwise(monkeypatch):
    """The port draws the tool's seed-0 arrays at 64 chunks, W's bf16
    rounding included: the tool's main() with jax.jit replaced by one that
    keeps the arguments of run_a and run_b."""
    seen = []

    def keep(fn):
        return lambda *args: seen.append(args) or np.float32(0)

    monkeypatch.setattr(jmx.jax, "jit", keep)
    jmx.main(["--chunks", "64", "--reps", "1"])
    monkeypatch.undo()
    (tri, o, d), (w, x) = seen[0], seen[-1]
    ours = tmx.inputs(64)
    for name, theirs in (("tri", tri), ("o", o), ("d", d), ("x", x)):
        assert np.array_equal(_bits(theirs), _bits(ours[name])), name
    assert w.dtype == jnp.bfloat16
    assert np.array_equal(_bits(np.asarray(w).astype(np.float32)),
                          _bits(ours["w"]))
    assert torch.equal(tmx.as_bf16(ours["w"]).to(torch.float32),
                       torch.from_numpy(ours["w"]))


# ---------------------------------------------------------------------------
# P1
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("th,tw,iters", [(8, 128, 32), (8, 256, 17)])
def test_lane_gather_plain_equals_tpu_probe_and_reference_bitwise(th, tw,
                                                                  iters):
    tab_row, tab, idx = tlg.inputs(th, tw)
    idx[0, 0] = tw - 1              # wraps at i = 1
    idx[1, 0] = tw - iters // 2     # wraps halfway
    out = tlg.lane_gather(torch.from_numpy(tab), torch.from_numpy(idx),
                          iters).numpy()
    jax_out = np.asarray(jlg.probe(jnp.asarray(tab), jnp.asarray(idx),
                                   th=th, tw=tw, iters=iters, interpret=True))
    assert np.array_equal(_bits(out), _bits(jax_out))
    assert np.array_equal(_bits(out), _bits(tlg.reference(tab_row, idx,
                                                          iters)))


@pytest.mark.parametrize("th,tw", [(8, 128), (32, 256), (4, 1500), (3, 7),
                                   (2, 33)])
def test_lane_gather_column_split_takes_every_column_once(th, tw):
    """P1's grid: blocks of THREADS columns of one row each; every column
    of every row is taken by exactly one thread, past one block's width
    too (1500)."""
    taken = tlg.column_split(th, tw)
    assert taken.shape == (th * tw, 2)
    assert np.array_equal(np.unique(taken[:, 0] * tw + taken[:, 1]),
                          np.arange(th * tw))
    bx, by = tlg.grid(th, tw)
    assert by == th and (bx - 1) * tlg.THREADS < tw <= bx * tlg.THREADS
    assert tlg.copies(tw) == (4 if tw % 4 == 0 else 1)
    assert tlg.copies(tlg.MAX_WIDTH) == 1


def _staged_gather(tab, idx, iters):
    """P1 as its kernel reads it: the row staged in V copies, copy k
    holding row[(m + k) % tw] at m; the lane of a column whose run starts
    at j reads copy j % V from j - j % V on in V-element loads that wrap at
    tw, and adds the first iters elements in order (f32)."""
    th, tw = tab.shape
    v = tlg.copies(tw)
    out = np.zeros((th, tw), np.float32)
    for r, c in tlg.column_split(th, tw):
        s = np.empty(v * tw, np.float32)
        for k in range(v):
            s[k * tw + (np.arange(tw) - k) % tw] = tab[r]
        j = int(idx[r, c]) % tw
        k = j % v
        m, acc, taken = j - k, np.float32(0.0), 0
        while taken < iters:
            load = s[k * tw + m:k * tw + m + v]
            for x in load[:iters - taken]:
                acc = np.float32(acc + x)
            taken += v
            m = 0 if m + v == tw else m + v
        out[r, c] = acc
    return out


@pytest.mark.parametrize("th,tw,iters", [(2, 128, 40), (2, 12, 31),
                                         (2, 7, 9), (1, 1500, 6)])
def test_lane_gather_staged_copies_give_the_reference_bitwise(th, tw, iters):
    """The kernel's reads (``_staged_gather``: four shifted copies of the
    row where tw is a multiple of 4, the row once else) sum the same
    elements in the same order as the tool's reference, also where the
    iterations end inside a load and past a wrap; indices below 0 and past
    the width take the divisor's sign."""
    tab_row, tab, idx = tlg.inputs(th, tw)
    idx[0, :4] = [-1, -tw - 3, 2 * tw + 1, tw - 1]
    got = _staged_gather(tab, idx, iters)
    want = tlg.lane_gather(torch.from_numpy(tab), torch.from_numpy(idx),
                           iters).numpy()
    assert np.array_equal(_bits(got), _bits(want))


def test_lane_gather_bound_parts_count_bank_conflicts():
    """The wavefronts of ``bound_parts`` are, for each warp of 32 columns
    and each i, the most lanes on one bank: here lanes 0-3 of the first of
    four warps start 32 apart (four on one bank at every i), every other
    lane on a bank of its own; the chain is iters links."""
    idx = np.tile(np.arange(32, dtype=np.int32), 4)[None, :]
    idx[0, 0:4] = [0, 32, 64, 96]
    parts = tlg.bound_parts(idx, 10, 4.0, 1000.0, 132)
    assert parts["wavefronts"] == 10 * (4 + 3)
    assert parts["conflict_free_wavefronts"] == 10 * 4
    assert parts["sms_in_use"] == 4
    assert parts["chain_ms"] == pytest.approx(10 * 4.0 / 1e9 * 1e3)
    assert parts["wavefront_ms"] == pytest.approx(70 / 4 / 1e9 * 1e3)
    assert parts["bound_by"] == "chain"
    _, _, idx = tlg.inputs(32, 256)
    parts = tlg.bound_parts(idx, 512, 4.0, 1980.0, 132)
    assert 2.0 < parts["wavefronts_per_gather"] < 5.0
    assert parts["bound_by"] == "wavefronts"


# ---------------------------------------------------------------------------
# P2 A
# ---------------------------------------------------------------------------

def _scan_inputs(n_chunks):
    a = tmx.inputs(n_chunks)
    a["tri"][5, 3:6] = 0.0          # e1 = 0: det = 0, inv_det = inf
    return a


def _eager_kernel_vpu(a, n_chunks):
    out = U.FakeRef(np.zeros((tmx.TH, tmx.TW), np.float32))
    with jax.disable_jit():
        jmx.kernel_vpu(U.FakeRef(a["tri"]), U.FakeRef(a["o"]),
                       U.FakeRef(a["d"]), out, n_chunks=n_chunks)
    return out.a


@pytest.mark.parametrize("n_chunks", [1, 2])
def test_mt_scan_plain_equals_kernel_vpu_eager_bitwise(n_chunks):
    """One degenerate row in the table; every operation rounded singly on
    both sides."""
    a = _scan_inputs(n_chunks)
    t = tmx.mt_scan(*(torch.from_numpy(a[k]) for k in ("tri", "o", "d")))
    assert np.array_equal(_bits(t), _bits(_eager_kernel_vpu(a, n_chunks)))
    hit = t.numpy() != np.float32(tmx.FLT_MAX)
    assert 0.1 < hit.mean() < 0.9


def test_mt_scan_plain_close_to_kernel_vpu_interpret():
    """The interpret-mode launch is jitted, and XLA contracts its
    multiply-adds, which the cross and dot products' cancellation magnifies
    (up to 1.2e-5 relative here).  Limits: the hit/miss decision differs on
    at most 0.5 % of the rays, and so does the winning row (t off by more
    than 1e-4 relative)."""
    n_chunks = 2
    a = _scan_inputs(n_chunks)
    call = pl.pallas_call(
        functools.partial(jmx.kernel_vpu, n_chunks=n_chunks),
        out_shape=jax.ShapeDtypeStruct((jmx.TH, jmx.TW), jnp.float32),
        in_specs=[_VMEM] * 3, out_specs=_VMEM, interpret=True)
    jax_t = np.asarray(call(*(jnp.asarray(a[k]) for k in ("tri", "o", "d"))))
    t = tmx.mt_scan(*(torch.from_numpy(a[k])
                      for k in ("tri", "o", "d"))).numpy()
    hit, jax_hit = t != tmx._FLT_MAX, jax_t != tmx._FLT_MAX
    assert (hit != jax_hit).mean() <= 0.005
    both = hit & jax_hit
    rel = np.abs(t[both] - jax_t[both]) / t[both]
    assert (rel > 1e-4).sum() <= 0.005 * t.size
    assert (rel > 0).any()                      # the contraction is real


# ---------------------------------------------------------------------------
# P2 B
# ---------------------------------------------------------------------------

def test_woop_plain_close_to_kernel_mxu_interpret():
    """At 4 chunks, one column with dz = 0: relative difference in t <= 1e-5
    where both hit, hit/miss on at most 0.1 % of the rays; and a t moved by
    1e-3 is caught."""
    n_chunks = 4
    a = tmx.inputs(n_chunks)
    a["w"][1, :, 5 * tmx.CHUNK + 3] = 0.0      # dz = 0: t = -oz * inf
    call = pl.pallas_call(
        functools.partial(jmx.kernel_mxu, n_chunks=n_chunks),
        out_shape=jax.ShapeDtypeStruct((jmx.R, 1), jnp.float32),
        in_specs=[_VMEM] * 2, out_specs=_VMEM, interpret=True)
    jax_t = np.array(call(jnp.asarray(a["w"], jnp.bfloat16),
                          jnp.asarray(a["x"])))
    w, x = tmx.as_bf16(a["w"]), torch.from_numpy(a["x"])
    t, win = tmx.woop_plain(w, x, winner=True)
    assert torch.equal(t, tmx.woop(w, x))
    assert bool(torch.isfinite(t).all())
    agree = tmx.woop_agreement(torch.from_numpy(jax_t), t, w, x, win)
    assert agree["ok"] and agree["max_rel"] <= tmx.REL_LIMIT, agree
    assert agree["hit_miss_differ"] <= tmx.HIT_MISS_LIMIT, agree
    assert 0.1 < agree["hit_share"] < 0.9
    moved = torch.where(t != tmx._FLT_MAX, t * (1 + 1e-3), t)
    assert not tmx.woop_agreement(moved, t, w, x, win)["ok"]


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------

def test_probes_cli_runs_on_the_cpu(capsys):
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-m", "rt_torch.probes", "lane_gather", "--device",
         "cpu", "--iters", "8"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.count("correct=True") == len(tlg.SHAPES)
    assert probes_cli.main(["r5_mxu", "--device", "cpu", "--reps", "1",
                            "--chunks", "1"]) == 0
    out = capsys.readouterr().out
    assert out.count("us/pass") == 2 and "Gpairs/s" in out


def _sum_model(w, x, mode):
    """B with its eight exact products summed in f64 and rounded to f32
    once (``nearest``) or toward zero after aligning each product to the
    largest one's last place (``truncated``, as a tensor core that keeps no
    guard bits would) — two summation orders other than the plain
    version's."""
    xb = x.to(torch.bfloat16).double()
    best = torch.full((x.shape[0], 1), tmx._FLT_MAX)
    for c in range(w.shape[0]):
        prods = xb[:, :, None] * w[c].double()[None]          # (R, 8, 192)
        if mode == "truncated":
            top = prods.abs().amax(dim=1, keepdim=True).clamp(min=1e-300)
            ulp = torch.exp2(torch.floor(torch.log2(top)) - 23)
            prods = torch.trunc(prods / ulp) * ulp
        exact = prods.sum(dim=1)
        y = exact.float()
        if mode == "truncated":
            over = y.double().abs() > exact.abs()
            y = torch.where(over, torch.nextafter(y, torch.zeros_like(y)), y)
        ox, oy, oz, dx, dy, dz = (y[:, g * 32:(g + 1) * 32] for g in range(6))
        t = -oz * (1.0 / dz)
        u, v = ox + t * dx, oy + t * dy
        valid = (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t >= tmx._EPS) \
            & (t < best)
        cand = torch.where(valid, t, torch.full_like(t, tmx._FLT_MAX))
        best = torch.minimum(best, cand.amin(dim=1, keepdim=True))
    return best


@pytest.mark.parametrize("mode", ["nearest", "truncated"])
def test_woop_agreement_takes_other_summation_orders_at_64_chunks(mode):
    """At the probe's 64 chunks the least of 2048 t is small and its oz a
    sum whose products cancel: another order of the same sums moves t by
    more than 1e-5 on a few rays (up to 2.2e-4), within each ray's own
    rounding bound, and flips no hit."""
    a = tmx.to_device(tmx.inputs(64), "cpu")
    t, win = tmx.woop_plain(a["w"], a["x"], winner=True)
    agree = tmx.woop_agreement(_sum_model(a["w"], a["x"], mode), t, a["w"],
                               a["x"], win)
    assert agree["ok"], agree
    assert agree["hit_miss_differ"] == 0.0
    assert 1e-4 < agree["max_rel"] < 1e-3
    assert 0 < agree["share_over_rel_limit"] < 0.005


# ---------------------------------------------------------------------------
# the split both kernels rely on: the least over slices of the chunks
# ---------------------------------------------------------------------------

def _chunk_slices(n_chunks, cluster):
    """The chunks each block of a cluster takes in both kernels
    (``csrc/probes.cu:slice_of``): block r of ``cluster`` takes
    r * n // cluster up to (r + 1) * n // cluster."""
    return [(r * n_chunks // cluster, (r + 1) * n_chunks // cluster)
            for r in range(cluster)]


def _rays_of_2048(a):
    """The first 2048 of the tool's rays: o, d (3, 8, 256), x (2048, 8)."""
    return (torch.from_numpy(a["o"][:, :8].copy()),
            torch.from_numpy(a["d"][:, :8].copy()),
            torch.from_numpy(a["x"][:2048].copy()))


def test_chunk_slices_cover_the_chunks_in_order():
    assert _chunk_slices(64, 8) == [(8 * r, 8 * r + 8) for r in range(8)]
    assert _chunk_slices(7, 8) == [(0, 0), (0, 1), (1, 2), (2, 3),
                                      (3, 4), (4, 5), (5, 6), (6, 7)]
    for n, cl in ((1, 8), (2, 4), (5, 2), (13, 8), (64, 2)):
        s = _chunk_slices(n, cl)
        assert s[0][0] == 0 and s[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(s, s[1:]))
        assert max(b - a for a, b in s) == -(-n // cl)


@pytest.mark.parametrize("n_chunks,cluster", [(7, 8), (8, 8), (5, 2), (3, 4)])
def test_mt_scan_least_over_chunk_slices_is_the_whole_scan_bitwise(n_chunks,
                                                                   cluster):
    """A degenerate row (det = 0), and ray 0 aimed at row 10 at t ~ 1e-3
    with row 10 copied into the last chunk: two rows give its least t
    exactly, in two slices.  torch.minimum over the slices' plain scans
    (FLT_MAX for an empty slice) equals the plain scan of the whole table
    bit for bit."""
    a = tmx.inputs(n_chunks)
    tri = a["tri"]
    tri[5, 3:6] = 0.0
    v0, e1, e2 = tri[10, 0:3], tri[10, 3:6], tri[10, 6:9]
    d0 = np.cross(e1, e2).astype(np.float32)
    a["o"][:, 0, 0] = v0 + np.float32(0.3) * e1 + np.float32(0.3) * e2 \
        - np.float32(1e-3) * d0
    a["d"][:, 0, 0] = d0
    tri[(n_chunks - 1) * tmx.CHUNK + 3] = tri[10]
    o, d, _ = _rays_of_2048(a)
    tri = torch.from_numpy(tri)
    whole = tmx.mt_scan_plain(tri, o, d)
    one = tmx.mt_scan_plain(tri[10:11], o, d)
    assert whole[0, 0] == one[0, 0] and whole[0, 0] < 0.01   # the tie wins
    parts = [tmx.mt_scan_plain(tri[c0 * tmx.CHUNK:c1 * tmx.CHUNK], o, d)
             for c0, c1 in _chunk_slices(n_chunks, cluster)]
    least = functools.reduce(torch.minimum, parts)
    assert torch.equal(least.view(torch.int32), whole.view(torch.int32))
    hit = whole != tmx._FLT_MAX
    assert 0.05 < float(hit.float().mean()) < 0.95
    if n_chunks < cluster:
        assert bool((parts[0] == tmx._FLT_MAX).all())       # empty slice


@pytest.mark.parametrize("n_chunks,cluster", [(7, 8), (8, 8), (5, 2), (3, 4)])
def test_woop_least_over_chunk_slices_is_the_whole_product_bitwise(n_chunks,
                                                                   cluster):
    """A column with dz = 0, and the first hitting ray's winning triangle
    copied into another chunk: the same eight products summed in the same
    order give that ray the same least t twice.  torch.minimum over the slices' plain versions equals
    the plain version over all chunks bit for bit."""
    a = tmx.inputs(n_chunks)
    a["w"][min(1, n_chunks - 1), :, 5 * tmx.CHUNK + 3] = 0.0
    _, _, x = _rays_of_2048(a)
    w = tmx.as_bf16(a["w"])
    whole, win = tmx.woop_plain(w, x, winner=True)
    r = int(torch.nonzero(win >= 0)[0, 0])
    c, j = divmod(int(win[r]), tmx.CHUNK)
    other = (c + n_chunks // 2 + 1) % n_chunks
    if other == c:
        other = (c + 1) % n_chunks
    cols = [g * tmx.CHUNK + j for g in range(6)]
    dup = [g * tmx.CHUNK + (j + 5) % tmx.CHUNK for g in range(6)]
    wd = w.clone()
    wd[other][:, dup] = w[c][:, cols]
    whole = tmx.woop_plain(wd, x)
    again = tmx.woop_plain(wd[other:other + 1], x)
    assert whole[r, 0] == again[r, 0] < tmx._FLT_MAX           # the tie wins
    parts = [tmx.woop_plain(wd[c0:c1], x)
             for c0, c1 in _chunk_slices(n_chunks, cluster)]
    least = functools.reduce(torch.minimum, parts)
    assert torch.equal(least.view(torch.int32), whole.view(torch.int32))
    assert 0.05 < float((whole != tmx._FLT_MAX).float().mean()) < 0.95


def _block_slices(kernel, n_chunks):
    """The slice of each block of a cluster and the pieces it is staged
    and scanned in, as the launcher plans them at n_chunks."""
    piece, pieces = tmx.piece_plan(kernel, n_chunks)
    out = []
    for first, last in _chunk_slices(n_chunks, tmx.CLUSTER[kernel]):
        parts = tmx.pieces_of(first, last, piece)
        assert len(parts) <= pieces
        out.append(((first, last), parts))
    return piece, pieces, out


def test_piece_plan_is_one_piece_where_a_slice_fits():
    """A block's slice stays one piece up to 300 chunks (A: 1536 bytes a
    chunk beside 2048 static, clusters of 2) and 584 (B: 3168 beside 256,
    clusters of 8) in an H100 block's 232448 bytes; past that it comes in
    pieces as even as they come, each under the limit."""
    for kernel, most in (("mt_scan", 300), ("woop_mma", 584)):
        for n in (1, 7, 64, most):
            assert tmx.piece_plan(kernel, n)[1] == 1, (kernel, n)
        for n in (most + 1, 600, 4 * most + 3):
            piece, pieces = tmx.piece_plan(kernel, n)
            assert pieces > 1
            assert piece * tmx.CHUNK_BYTES[kernel] \
                + tmx.STATIC_BYTES[kernel] <= tmx.SMEM_OPTIN
            for (first, last), parts in _block_slices(kernel, n)[2]:
                assert parts[0][0] == first and parts[-1][1] == last
                assert all(a[1] == b[0] for a, b in zip(parts, parts[1:]))
                assert max(b - a for a, b in parts) <= piece


def test_mt_scan_least_over_pieces_is_the_whole_slice_bitwise():
    """F2, A at 301 chunks: the second block's slice (151 chunks) in the
    two pieces the launcher plans; ray 0 aimed at a row of the first piece
    with that row copied into the second.  torch.minimum over the pieces'
    plain scans equals the plain scan of the whole slice bit for bit (256
    rays)."""
    piece, pieces, slices = _block_slices("mt_scan", 301)
    assert (piece, pieces) == (76, 2)
    (first, last), parts = slices[1]
    a = tmx.inputs(1)
    rng = np.random.default_rng(1)
    tri = rng.normal(size=((last - first) * tmx.CHUNK, tmx.TRI_COLS)) \
        .astype(np.float32)
    tri[5, 3:6] = 0.0
    v0, e1, e2 = tri[10, 0:3], tri[10, 3:6], tri[10, 6:9]
    d0 = np.cross(e1, e2).astype(np.float32)
    o = a["o"].reshape(3, -1)[:, :256].copy()
    d = a["d"].reshape(3, -1)[:, :256].copy()
    o[:, 0] = v0 + np.float32(0.3) * e1 + np.float32(0.3) * e2 \
        - np.float32(1e-3) * d0
    d[:, 0] = d0
    tri[(parts[1][0] - first) * tmx.CHUNK + 3] = tri[10]
    tri, o, d = map(torch.from_numpy, (tri, o, d))
    whole = tmx.mt_scan_plain(tri, o, d)
    ts = [tmx.mt_scan_plain(tri[(c0 - first) * tmx.CHUNK:
                                (c1 - first) * tmx.CHUNK], o, d)
          for c0, c1 in parts]
    least = functools.reduce(torch.minimum, ts)
    assert torch.equal(least.view(torch.int32), whole.view(torch.int32))
    assert whole[0] < 0.01
    # some ray takes its least t from each piece
    assert set(torch.stack(ts).argmin(dim=0).tolist()) == {0, 1}


def test_woop_least_over_pieces_is_the_whole_slice_bitwise():
    """F2, B at 600 chunks: a block's slice (75 chunks) in the two pieces
    the launcher plans, the first hitting ray's winning triangle copied
    into the other piece.  torch.minimum over the pieces' plain products
    equals the plain product over the whole slice bit for bit (256
    rays)."""
    piece, pieces, slices = _block_slices("woop_mma", 600)
    assert (piece, pieces) == (38, 2)
    (first, last), parts = slices[3]
    a = tmx.inputs(last - first)
    x = torch.from_numpy(a["x"][:256].copy())
    w = tmx.as_bf16(a["w"])
    whole, win = tmx.woop_plain(w, x, winner=True)
    r = int(torch.nonzero(win >= 0)[0, 0])
    c, j = divmod(int(win[r]), tmx.CHUNK)
    other = (parts[1][0] - first) if c < parts[1][0] - first else 0
    cols = [g * tmx.CHUNK + j for g in range(6)]
    dup = [g * tmx.CHUNK + (j + 5) % tmx.CHUNK for g in range(6)]
    w[other][:, dup] = w[c][:, cols].clone()
    whole = tmx.woop_plain(w, x)
    least = functools.reduce(torch.minimum, [
        tmx.woop_plain(w[c0 - first:c1 - first], x) for c0, c1 in parts])
    assert torch.equal(least.view(torch.int32), whole.view(torch.int32))
    assert whole[r, 0] < tmx._FLT_MAX
    _, win = tmx.woop_plain(w, x, winner=True)
    assert {int(c >= (parts[1][0] - first) * tmx.CHUNK)
            for c in win[win >= 0].tolist()} == {0, 1}


_SASS = """
	code for sm_90a
		Function : _ZN2rt14mt_scan_kernelILi2ELi512ELi2ELi8EEEvPKfS2_S2_Pfii
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS"
        /*0000*/                   LDC R1, c[0x0][0x28] ;        /* 0x00000a00ff017b82 */
                                                                 /* 0x000fe40000000800 */
.L_x_1:
        /*0010*/                   IADD3 R2, R2, 0x1, RZ ;       /* 0x0000000102027810 */
.L_x_0:
        /*0020*/                   LDS.128 R4, [R3] ;            /* 0x0000000003047984 */
        /*0030*/               @P0 BRA `(.L_x_2) ;               /* 0x0000000000f08947 */
        /*0040*/                   MOV R0, R4 ;                  /* 0x0000000000f08947 */
        /*0050*/                   CALL.REL.NOINC `(.L_x_9) ;    /* 0x0000000000f08947 */
        /*0060*/                   BRA `(.L_x_3) ;               /* 0x0000000000f08947 */
.L_x_2:
        /*0070*/                   MUFU.RCP R5, R4 ;             /* 0x0000000000f08947 */
.L_x_3:
        /*0080*/                   FMUL R5, R4, R6 ;             /* 0x0000000604057220 */
        /*0090*/              @!P1 BRA `(.L_x_0) ;               /* 0x0000000000f08947 */
        /*00a0*/               @P1 BRA `(.L_x_1) ;               /* 0x0000000000e81947 */
        /*00b0*/                   EXIT ;                        /* 0x000000000000794d */
.L_x_4:
        /*00c0*/                   BRA `(.L_x_4);                /* 0xfffffffc00fc7947 */
.L_x_9:
        /*00d0*/                   RET.REL.NODEC R2 `(_ZN2rt14mt_scan_kernel) ;
		Function : _ZN2rt15woop_mma_kernelILi8ELi4ELi1ELi1EEEvPKtPKfPfii
        /*0000*/                   MOV R1, c[0x0][0x28] ;        /* 0x00000a0000017a02 */
        /*0010*/                   HMMA.1688.F32.BF16 R4, R8, R12, RZ ;
        /*0020*/                   BRA 0x10 ;                    /* 0xfffffffc00fc7947 */
"""


def test_loops_in_sass_counts_innermost_loops():
    """The innermost loop of each kernel of a listing in cuobjdump's form
    (branch targets as labels or as addresses) and the slow path a branch
    in it skips (the span that holds a CALL); an outer loop and the
    one-instruction trap after EXIT are not the body."""
    from rt_torch.kernels import _build

    loops = _build.loops_in_sass(_SASS)
    assert loops == {
        "mt_scan_kernel<2, 512, 2, 8>": [
            dict(instructions=8, slow_path=3),
            dict(instructions=1, slow_path=0)],
        "woop_mma_kernel<8, 4, 1, 1>": [dict(instructions=2, slow_path=0)]}
