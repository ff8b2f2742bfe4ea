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
