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
