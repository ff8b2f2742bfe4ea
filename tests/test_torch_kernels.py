"""The plain versions of the two wave kernels against the JAX package's
``_wave_first_kernel`` (K2) and ``_wave_bounce_kernel`` (K3).

Two comparisons, on the same padded shapes and (th, tw) as the JAX package
uses (64x32 image padded to 32 rows x 128 columns; th=8 gives four tiles):

- EAGER, bitwise.  The kernel functions run op by op on stand-in refs
  (``test_torch_parity_util.eager_*``): each jnp op is one rounded XLA op, the
  arithmetic the TPU kernel defines.  Payload, RNG state, active mask and
  winning-chunk id must be bit-equal.  Tolerance: none.
- INTERPRET mode, as ``tests/test_kernels.py`` launches the kernels.  XLA's
  CPU compiler fuses the jitted kernel body and contracts multiply-adds, so
  floats agree to a few ULP only and a ray on a branch edge can flip.
  Tolerance: at most 0.5 % of rays may differ in state/active/chunk id or by
  more than 1e-4 in any payload float; all others agree within 1e-4.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rt.kernels import dispatch as jdispatch
from rt.kernels import plane_math as pm
from rt.kernels import tracer_common as jtc
from rt.scene import scenes as jscenes
from rt_torch.kernels import dispatch as tdispatch
from rt_torch.kernels import tracer_common as ttc
from rt_torch.kernels import tris_kernel as ttk
from rt_torch.scene import scenes as tscenes
import test_torch_parity_util as U
from _torch_threads import one_torch_thread  # noqa: F401

W, H, HP, WP, TW = 64, 32, 32, 128, 128
TIME = 1000
FLIP_LIMIT = 0.005
CLOSE = 1e-4


@functools.lru_cache(maxsize=None)
def setup(name):
    jsd = getattr(jscenes, f"scene_{name}")(W, H)
    flags = dict(normalize_reflect_in=jsd.config.normalize_reflect_in,
                 has_metal=2 in jsd.config.mat_kinds,
                 has_dielectric=3 in jsd.config.mat_kinds)
    packed = ttk.pack_tri_table(U.port_scene(jsd.scene))
    cam_row = tdispatch.pack_camera(U.port_camera(jsd.camera))
    order = ttk.chunk_order(packed.centroid,
                            torch.from_numpy(cam_row[0, 0:3].copy()))
    return jsd, flags, packed, cam_row, order


@functools.lru_cache(maxsize=None)
def plain_first(name, th):
    jsd, flags, packed, cam_row, order = setup(name)
    return ttk.wave_first_plain(
        packed, order, cam_row, torch.tensor([TIME], dtype=torch.int32), 0,
        ttk.TraceFlags(**flags), height=H, width=W, height_pad=HP,
        width_pad=WP, th=th, tw=TW, normalize_defocus_dir=True)


def stream_after_first(name, th, sort):
    """The stream K3 gets: K2's plain output, coherence-sorted or not, and
    its per-tile chunk order (computed once, handed to both sides)."""
    _, _, packed, _, _ = setup(name)
    payf, state, active, wch = plain_first(name, th)
    pay = payf[0:9].clone()
    state, active = state.clone(), active.clone()
    if sort:
        key, perm = torch.sort(ttk.stream_key(pay, active, wch), stable=True)
        pay, state = pay[:, perm].contiguous(), state[perm].contiguous()
        active = (key != ttk.DEAD_KEY).to(torch.int32)
    n_tiles = pay.shape[1] // (th * TW)
    mo = pay[0:3].reshape(3, n_tiles, th * TW).mean(dim=2)
    tile_order = ttk.chunk_order(packed.centroid, mo.T).reshape(-1)
    return pay, state, active, tile_order


def bits(x):
    return np.asarray(x).view(np.uint32)


def assert_bitwise(jax_out, torch_out):
    for name, j, t in zip(("payload", "state", "active", "chunk id"),
                          jax_out, torch_out):
        np.testing.assert_array_equal(bits(j), bits(t.numpy()), err_msg=name)


def assert_close(jax_out, torch_out):
    jp, js, ja, jw = jax_out
    tp, ts, ta, tw = (t.numpy() for t in torch_out)
    bad = (js.view(np.int32) != ts) | (ja != ta) | (jw != tw)
    with np.errstate(invalid="ignore"):
        far = ~(np.abs(jp - tp) <= CLOSE) & ~(np.isnan(jp) & np.isnan(tp))
    bad |= far.any(axis=0)
    assert bad.mean() <= FLIP_LIMIT, f"{bad.mean():.3%} of rays differ"


# ---- K2 -------------------------------------------------------------------

@pytest.mark.parametrize("name,th", [("quad", 32), ("cube", 16),
                                     ("suzanne", 8)])
def test_wave_first_plain_equals_jax_kernel_eager_bitwise(name, th):
    jsd, flags, _, cam_row, order = setup(name)
    want = U.eager_wave_first(jsd.scene, cam_row, order.numpy(), TIME,
                              height=H, width=W, hp=HP, wp=WP, th=th, tw=TW,
                              flags=flags)
    assert want[2].sum() > 0                      # some rays hit
    assert_bitwise(want, plain_first(name, th))


@pytest.mark.parametrize("name,th", [("quad", 32), ("suzanne", 32),
                                     ("suzanne", 8)])
def test_wave_first_plain_close_to_jax_kernel_interpret(name, th):
    jsd, flags, _, cam_row, order = setup(name)
    want = U.jax_wave_first(
        jsd.scene, jnp.asarray(cam_row), jnp.asarray(order.numpy())[:, None],
        jnp.full((1, 1), TIME, jnp.uint32), height=H, width=W, hp=HP, wp=WP,
        th=th, tw=TW, flags=flags)
    assert_close(want, plain_first(name, th))


def test_wave_first_cam_row_matches_jax_pack_camera():
    """The eager and interpret launches above read the PORT's camera row;
    it equals the JAX one on every slot the JAX kernel reads."""
    jsd, _, _, cam_row, _ = setup("suzanne")
    want = np.asarray(jdispatch.pack_camera(jsd.camera))
    np.testing.assert_array_equal(cam_row[0, :19], want[0, :19])


# ---- K0: the shared stages, eagerly, on random inputs ----------------------

@pytest.mark.parametrize("has_metal,has_dielectric", [
    (True, True), (True, False), (False, True), (False, False)])
@pytest.mark.parametrize("normalize_reflect_in", [False, True])
def test_scatter_equals_jax_eager_bitwise(has_metal, has_dielectric,
                                          normalize_reflect_in):
    """All three material arms, both front-face cases, total internal
    reflection included (the dielectric arm then draws nothing), new
    direction and RNG state.  Tolerance: none."""
    n = 4000
    g = np.random.default_rng(7)
    f32 = lambda a: np.asarray(a, np.float32)
    unit = lambda v: f32(v / np.linalg.norm(v, axis=0))
    d, normal = unit(g.normal(size=(3, n))), unit(g.normal(size=(3, n)))
    point = f32(g.normal(size=(3, n)))
    albedo = f32(g.random((3, n)))
    state = g.integers(0, 2**32, n, dtype=np.uint64)
    kind = g.integers(1, 4, n).astype(np.int32)
    front = g.random(n) < 0.5
    # lambertian 0, metal fuzz, dielectric indices on both sides of 1
    param = f32(np.where(kind == 1, 0.0, np.where(
        kind == 2, g.random(n), g.choice([0.1, 0.2, 1.5, 2.4], n))))
    kw = dict(normalize_reflect_in=normalize_reflect_in,
              has_metal=has_metal, has_dielectric=has_dielectric)
    jt = lambda a: tuple(jnp.asarray(x) for x in a)
    tt = lambda a: tuple(torch.from_numpy(x.copy()) for x in a)
    js, jd = jtc.scatter(jnp.asarray(state.astype(np.uint32)), jt(d),
                         jt(point), jt(normal), jnp.asarray(front),
                         jt(albedo), jnp.asarray(param), jnp.asarray(kind),
                         **kw)
    ts, td = ttc.scatter(torch.from_numpy(state.astype(np.int64)), tt(d),
                         tt(point), tt(normal), torch.from_numpy(front),
                         tt(albedo), torch.from_numpy(param),
                         torch.from_numpy(kind), **kw)
    np.testing.assert_array_equal(np.asarray(js).astype(np.int64), ts.numpy())
    for c in range(3):
        np.testing.assert_array_equal(bits(jd[c]), bits(td[c].numpy()))
    if has_dielectric:          # the case the draw count hinges on occurs
        s1 = np.asarray(pm.rng_step(jnp.asarray(state.astype(np.uint32))))
        die = kind == 3
        kept = np.asarray(js)[die] == state.astype(np.uint32)[die]
        assert kept.any() and (np.asarray(js)[die][~kept] == s1[die][~kept]
                               ).all()


def test_sky_times_atten_equals_jax_eager_bitwise():
    g = np.random.default_rng(8)
    dy = g.uniform(-1.5, 1.5, 4000).astype(np.float32)
    atten = g.random((3, 4000)).astype(np.float32)
    want = jtc.sky_times_atten(jnp.asarray(dy),
                               tuple(jnp.asarray(a) for a in atten))
    got = ttc.sky_times_atten(torch.from_numpy(dy),
                              tuple(torch.from_numpy(a) for a in atten))
    for w, t in zip(want, got):
        np.testing.assert_array_equal(bits(w), bits(t.numpy()))


# ---- K3 -------------------------------------------------------------------

@pytest.mark.parametrize("name,th,n_bounces,sort", [
    ("quad", 32, 1, False), ("suzanne", 8, 2, True)])
def test_wave_bounce_plain_equals_jax_kernel_eager_bitwise(name, th,
                                                           n_bounces, sort):
    jsd, flags, packed, _, _ = setup(name)
    pay, state, active, tile_order = stream_after_first(name, th, sort)
    want = U.eager_wave_bounce(
        jsd.scene, tile_order.numpy(), pay.numpy(),
        state.numpy().view(np.uint32), active.numpy(), n_bounces=n_bounces,
        th=th, tw=TW, flags=flags)
    wch = ttk.wave_bounce(packed, tile_order, pay, state, active,
                          ttk.TraceFlags(**flags), n_bounces=n_bounces,
                          th=th, tw=TW)
    assert_bitwise(want, (pay, state, active, wch))


@pytest.mark.parametrize("name,th,n_bounces", [("suzanne", 32, 2),
                                               ("suzanne", 8, 2),
                                               ("cube", 16, 1)])
def test_wave_bounce_plain_close_to_jax_kernel_interpret(name, th, n_bounces):
    jsd, flags, packed, _, _ = setup(name)
    pay, state, active, tile_order = stream_after_first(name, th, True)
    want = U.jax_wave_bounce(
        jsd.scene, tile_order.numpy(), pay.numpy(),
        state.numpy().view(np.uint32), active.numpy(), n_bounces=n_bounces,
        th=th, tw=TW, flags=flags)
    wch = ttk.wave_bounce_plain(packed, tile_order, pay, state, active,
                                ttk.TraceFlags(**flags), n_bounces=n_bounces,
                                th=th, tw=TW)
    assert_close(want, (pay, state, active, wch))


def test_all_dead_tile_is_left_alone():
    """A tile with no live ray keeps payload and state, and its chunk plane
    reads -1 (the kernel skips it)."""
    _, flags, packed, _, _ = setup("suzanne")
    pay, state, active, tile_order = stream_after_first("suzanne", 8, True)
    dead_tile = slice(pay.shape[1] - 8 * TW, pay.shape[1])   # sorted last
    assert int(active[dead_tile].sum()) == 0
    before = pay[:, dead_tile].clone(), state[dead_tile].clone()
    wch = ttk.wave_bounce(packed, tile_order, pay, state, active,
                          ttk.TraceFlags(**flags), n_bounces=2, th=8, tw=TW)
    assert torch.equal(pay[:, dead_tile], before[0])
    assert torch.equal(state[dead_tile], before[1])
    assert bool((wch[dead_tile] == -1).all())


# ---- the stream glue --------------------------------------------------------

def _jax_schedule(bounces, sort_every, skip_last_sort):
    """The loop of rt/kernels/tris_kernel.py:958-962, b_start = 1."""
    out = []
    for b in range(1, bounces, sort_every):
        nb = min(sort_every, bounces - b)
        sorts = b > 0 and not (skip_last_sort and b + sort_every >= bounces
                               and bounces - b < sort_every)
        out.append((b, nb, sorts))
    return out


@pytest.mark.parametrize("sort_every", [1, 2, 3])
@pytest.mark.parametrize("skip_last_sort", [False, True])
def test_bounce_schedule_equals_jax_condition(sort_every, skip_last_sort):
    for bounces in range(1, 11):
        assert ttk.bounce_schedule(bounces, sort_every, skip_last_sort) == \
            _jax_schedule(bounces, sort_every, skip_last_sort)


def test_bounce_schedule_main_path():
    """8 bounces, re-sort every 2: [1-2] [3-4] [5-6] sorted, [7] not."""
    assert ttk.bounce_schedule(8, 2, True) == [
        (1, 2, True), (3, 2, True), (5, 2, True), (7, 1, False)]


def test_stream_key_dead_rays_sort_last_and_stable():
    pay = torch.zeros((9, 6))
    pay[3] = torch.tensor([1.0, -1.0, 1.0, 1.0, -1.0, 1.0])
    pay[4] = 1.0
    pay[5] = -1.0
    active = torch.tensor([1, 1, 0, 1, 0, 1], dtype=torch.int32)
    wch = torch.tensor([3, 3, -1, 0, 7, 3], dtype=torch.int32)
    key = ttk.stream_key(pay, active, wch)
    assert key.dtype == torch.int32
    assert key.tolist() == [3 * 8 + 6, 3 * 8 + 2, ttk.DEAD_KEY, 6,
                            ttk.DEAD_KEY, 3 * 8 + 6]
    _, perm = torch.sort(key, stable=True)
    assert perm.tolist() == [3, 1, 0, 5, 2, 4]


def test_wrappers_reject_a_ragged_stream():
    _, flags, packed, _, _ = setup("quad")
    with pytest.raises(ValueError, match="multiple"):
        ttk.wave_bounce(packed, torch.zeros(1, dtype=torch.int32),
                        torch.zeros((9, 100)),
                        torch.zeros(100, dtype=torch.int32),
                        torch.zeros(100, dtype=torch.int32),
                        ttk.TraceFlags(**flags), n_bounces=1, th=8, tw=32)


def test_cuda_entry_points_fail_loudly_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises((RuntimeError, AssertionError)):
        tscenes.scene_quad(16, 8)              # device defaults to "cuda"
    sd = tscenes.scene_quad(16, 8, device="cpu")
    with pytest.raises((RuntimeError, AssertionError, ValueError)):
        tdispatch.render_color(sd.scene, sd.camera, sd.config, TIME)
    # the same through K4 (spp > 1) and for a sphere scene (K5)
    import dataclasses
    spp = dataclasses.replace(sd.config, samples_per_frame=2)
    with pytest.raises((RuntimeError, AssertionError, ValueError)):
        tdispatch.render_color(sd.scene, sd.camera, spp, TIME)
    ss = tscenes.scene_sphere_simple(16, 8, device="cpu")
    with pytest.raises((RuntimeError, AssertionError, ValueError)):
        tdispatch.render_color(ss.scene, ss.camera, ss.config, TIME)
