"""The rest of the port's wave path against the JAX package: the raygen
kernel's plain version (K4), the ``morton`` coherence key, ``split_big``
packing, the bounce schedule from bounce 0, more than one sample per pixel,
and the large-scene branch.

- tables, keys, schedules and the EAGER kernel body: bitwise, tolerance
  none;
- images against ``rt.kernels.dispatch.render_color(..., interpret=True)``:
  XLA's CPU compiler contracts multiply-adds in the jitted kernel bodies, so
  a ray on a branch edge can flip.  A pixel whose channels differ by more
  than 1e-6 counts as flipped; at most 0.5 % of pixels may flip and the
  images must be within 0.05 % mean absolute u8 difference.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rt.core.triangle import TriangleScene as JaxTriangleScene
from rt.kernels import dispatch as jdispatch
from rt.kernels import tris_kernel as jtk
from rt.scene import scenes as jscenes
from rt_torch.kernels import dispatch as tdispatch
from rt_torch.kernels import tris_kernel as ttk
from rt_torch.render import ppm as tppm
from rt_torch.scene import scenes as tscenes
import test_torch_parity_util as U
from _torch_threads import one_torch_thread  # noqa: F401

TIME = 1000
FLIP_ABOVE, FLIP_LIMIT, U8_BOUND_PCT = 1e-6, 0.005, 0.05


def bits(x):
    return np.ascontiguousarray(x).view(np.uint32)


def assert_images_agree(want, got):
    assert want.shape == got.shape and np.isfinite(got).all()
    flips = (np.abs(want - got).max(axis=-1) > FLIP_ABOVE).mean()
    assert flips <= FLIP_LIMIT, f"{flips:.3%} of pixels flipped"
    ok, pct = tppm.compare_ppm(tppm.render_ppm(got), tppm.render_ppm(want),
                               U8_BOUND_PCT)
    assert ok, f"{pct:.4f}% > {U8_BOUND_PCT}%"


# ---- K4 --------------------------------------------------------------------

@pytest.mark.parametrize("name,th", [("suzanne", 8), ("quad", 32)])
def test_wave_raygen_plain_equals_jax_kernel_eager_bitwise(name, th):
    """Primary o/d, primary dy and the post-raygen RNG state, padding
    pixels included (64x32 padded to 32 rows x 128 columns)."""
    jsd = getattr(jscenes, f"scene_{name}")(64, 32)
    cam_row = tdispatch.pack_camera(U.port_camera(jsd.camera))
    want = U.eager_wave_raygen(cam_row, TIME, height=32, width=64, hp=32,
                               wp=128, th=th, tw=128)
    od, pdy, state = ttk.wave_raygen(
        cam_row, torch.tensor([TIME], dtype=torch.int32), 0, height=32,
        width=64, height_pad=32, width_pad=128, th=th, tw=128,
        normalize_defocus_dir=True)
    np.testing.assert_array_equal(bits(want[0]), bits(od.numpy()))
    np.testing.assert_array_equal(bits(want[1]), bits(pdy.numpy()))
    np.testing.assert_array_equal(want[2], state.numpy().view(np.uint32))
    assert torch.equal(pdy, od[4])


def test_wave_raygen_rows_and_frames():
    """row0 shifts the band (bit-identical rays to the full frame's rows)
    and every frame takes its own time uniform."""
    sd = tscenes.scene_quad(32, 16, device="cpu")
    cam_row = tdispatch.pack_camera(sd.camera)
    kw = dict(height=16, width=32, width_pad=32, th=8, tw=32,
              normalize_defocus_dir=True)
    times = torch.tensor([TIME, TIME + 10], dtype=torch.int32)
    full = ttk.wave_raygen(cam_row, times, 0, height_pad=16, **kw)
    band = ttk.wave_raygen(cam_row, times[1:], 8, height_pad=8, **kw)
    n = 16 * 32
    for f, b in zip(full, band):
        assert torch.equal(f[..., n + 8 * 32:], b)
    assert not torch.equal(full[2][:n], full[2][n:])


@pytest.mark.parametrize("n_frames,hp,wp", [
    (1, 32, 128), (1, 8, 512), (3, 16, 70), (2, 48, 200), (3, 64, 69),
    (1, 1, 4)])
def test_raygen_grid_takes_every_pixel_once(n_frames, hp, wp):
    """K4's map from threads to pixels (``raygen_pixels``: a block a strip
    of RAYGEN_THREADS columns of one row of one frame) takes every pixel of
    (F, Hp, Wp) once, each with the (frame, row, column) of its flat
    index, also where the width is not a multiple of the strip (70, 200,
    69: the last strip's threads past Wp take none)."""
    visits = ttk.raygen_pixels(n_frames, hp, wp)
    n = n_frames * hp * wp
    assert torch.equal(visits[:, 0].sort().values, torch.arange(n))
    f, row, col = visits[:, 1], visits[:, 2], visits[:, 3]
    assert torch.equal((f * hp + row) * wp + col, visits[:, 0])
    assert bool(((col < wp) & (row < hp) & (f < n_frames)).all())
    gx, gy, gz = ttk.raygen_grid(n_frames, hp, wp)
    assert (gy, gz) == (hp, n_frames)
    assert (gx - 1) * ttk.RAYGEN_THREADS < wp <= gx * ttk.RAYGEN_THREADS


def test_raygen_pixel_map_gives_the_plain_rays_bitwise():
    """Rays generated at the (frame, row + row0, column) K4's map gives
    each visit, stored at its flat index, are ``wave_raygen_plain``'s bit
    for bit: three frames of 48 x 69 padded pixels of a 69 x 33 image."""
    sd = tscenes.scene_suzanne(69, 33, device="cpu")
    cam_row = tdispatch.pack_camera(sd.camera)
    times = torch.tensor([TIME, TIME + 10, TIME + 20], dtype=torch.int32)
    kw = dict(height=33, width=69, height_pad=48, width_pad=69,
              normalize_defocus_dir=False)
    want = ttk.wave_raygen_plain(cam_row, times, 5, **kw)
    visits = ttk.raygen_pixels(3, 48, 69)
    cam = [float(v) for v in cam_row.reshape(-1)]
    t = times.to(torch.int64)[visits[:, 1]] & 0xFFFFFFFF
    state, o, d = ttk.tc.generate_rays(
        cam, visits[:, 3], visits[:, 2] + 5, height=33, width=69, time=t,
        normalize_defocus_dir=False)
    n = 3 * 48 * 69
    got = torch.empty((8, n), dtype=torch.float32)
    got[:, visits[:, 0]] = torch.stack(
        [*o, *d[0:3], d[1], ttk.rng.to_i32(state).view(torch.float32)])
    assert torch.equal(got[0:6].view(torch.int32),
                       want[0].view(torch.int32))
    assert torch.equal(got[6].view(torch.int32), want[1].view(torch.int32))
    assert torch.equal(got[7].view(torch.int32), want[2])


# ---- the morton key --------------------------------------------------------

@functools.lru_cache(maxsize=None)
def lucy():
    jsd = jscenes.scene_lucy(32, 32)
    return jsd, U.port_scene(jsd.scene)


def test_scene_bounds_and_ray_sort_key_equal_jax_bitwise():
    """Bounds from lucy's chunk boxes; keys of random rays inside and
    outside them, dead rays last; the stable sort gives the same order."""
    jsd, tscene = lucy()
    packed = ttk.pack_tri_table(tscene, split_big=True)
    chunks = jnp.asarray(packed.chunks.numpy())
    jlo = jnp.min(chunks[:, 0:3], axis=0)
    jinv = 1.0 / jnp.maximum(jnp.max(chunks[:, 3:6], axis=0) - jlo, 1e-30)
    lo, inv_span = ttk.scene_bounds(packed.chunks)
    np.testing.assert_array_equal(bits(lo.numpy()), bits(np.asarray(jlo)))
    np.testing.assert_array_equal(bits(inv_span.numpy()),
                                  bits(np.asarray(jinv)))

    g = np.random.default_rng(5)
    n = 5000
    span = 1.0 / np.asarray(jinv)
    o = (np.asarray(jlo)[:, None] + span[:, None]
         * g.uniform(-0.1, 1.1, (3, n))).astype(np.float32)
    d = g.normal(size=(3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0)
    d[:, :50] = np.array([[0.0], [-0.0], [-1e-9]], np.float32)  # near zero
    active = (g.random(n) < 0.8).astype(np.int32)
    want = np.asarray(jtk._ray_sort_key(
        tuple(jnp.asarray(c) for c in o), tuple(jnp.asarray(c) for c in d),
        jlo, jinv, jnp.asarray(active)))
    pay = torch.from_numpy(np.concatenate([o, d, np.ones((3, n), np.float32)]))
    got = ttk.stream_key(pay, torch.from_numpy(active), None, "morton",
                         (lo, inv_span))
    assert got.dtype == torch.int32
    live = active > 0
    np.testing.assert_array_equal(got.numpy()[live].astype(np.uint32),
                                  want[live])
    assert (want[~live] == 0xFFFFFFFF).all()
    assert (got.numpy()[~live] == ttk.DEAD_KEY).all()
    assert int(got.numpy()[live].max()) < 2**27
    _, perm = torch.sort(got, stable=True)
    np.testing.assert_array_equal(
        perm.numpy(), np.asarray(jnp.argsort(jnp.asarray(want), stable=True)))


def test_stream_key_rejects_an_unknown_mode():
    z = torch.zeros((9, 4))
    with pytest.raises(ValueError, match="key_mode"):
        ttk.stream_key(z, torch.ones(4, dtype=torch.int32),
                       torch.zeros(4, dtype=torch.int32), "chunk")


# ---- split_big -------------------------------------------------------------

def assert_tables_equal(jscene, tscene):
    tab, mats, chunks, _, m_pad, n_chunks = jtk.pack_tri_table(
        jscene, split_big=True)
    packed = ttk.pack_tri_table(tscene, split_big=True)
    assert packed.tab.shape == (m_pad, 13) and packed.n_chunks == n_chunks
    np.testing.assert_array_equal(bits(packed.tab.numpy()),
                                  bits(np.asarray(tab)))
    np.testing.assert_array_equal(packed.mats.numpy(), np.asarray(mats))
    np.testing.assert_array_equal(bits(packed.chunks.numpy()),
                                  bits(np.asarray(chunks)))
    return packed


def test_pack_tri_table_split_big_equals_jax_on_lucy():
    jsd, tscene = lucy()
    assert tscene.m > tdispatch.SMALL_SCENE_MAX_TRIS
    packed = assert_tables_equal(jsd.scene, tscene)
    # the floor's two triangles are the oversized ones: last in the table
    plain = ttk.pack_tri_table(tscene)
    assert not torch.equal(packed.tab, plain.tab)
    # and the dispatch packs large scenes that way
    assert torch.equal(tdispatch.pack_scene(tscene).tab, packed.tab)


@pytest.mark.parametrize("m", [6, 7])
def test_pack_tri_table_split_big_median_of_even_and_odd_counts(m):
    """jnp.median averages the two middle values of an even count.  The
    squared areas are 1, 1, 1, 81, 625, X (m = 6): against the mean of the
    middle pair, 41, only X is big; against the lower middle value 625
    would be too, against the upper one nothing would."""
    # on a diagonal, last triangle first in Morton order, then the 5-leg one
    a = np.float32([[2 * (m - i)] * 3 for i in range(m)])
    a[-1] = -10.0
    a[4] = -8.0
    # right triangles with legs s: squared cross product = s^4
    legs = np.array([1.0, 1.0, 1.0, 3.0, 5.0, 3.0, 3.0][:m], np.float32)
    legs[-1] = np.float32((256.0 * (1.0 + 81.0) / 2 * 1.02) ** 0.25)
    b = a + np.stack([legs, 0 * legs, 0 * legs], 1)
    c = a + np.stack([0 * legs, legs, 0 * legs], 1)
    fields = dict(a=a, b=b, c=c,
                  normal=np.tile(np.float32([0, 0, 1]), (m, 1)),
                  mat_id=np.zeros(m, np.int32),
                  bmin=np.zeros((2, 3), np.float32),
                  bmax=np.ones((2, 3), np.float32),
                  mat_albedo=np.full((1, 3), 0.5, np.float32),
                  mat_param=np.zeros(1, np.float32),
                  mat_kind=np.ones(1, np.int32))
    jscene = JaxTriangleScene(**{k: jnp.asarray(v) for k, v in fields.items()})
    from rt_torch import convert
    tscene = convert.scene_from_numpy(fields, device="cpu")
    packed = assert_tables_equal(jscene, tscene)
    first, last = packed.tab[0, 0:3].numpy(), packed.tab[m - 1, 0:3].numpy()
    if m == 6:      # only X is big: it alone moves behind all others
        assert (last == a[-1]).all() and (first == a[4]).all()
    else:           # odd count, median 81: nothing is big, Morton order stays
        assert (first == a[-1]).all()
    got = ttk._median(torch.from_numpy(legs ** 4))
    assert float(got) == float(jnp.median(jnp.asarray(legs ** 4)))


# ---- schedules from bounce 0 -----------------------------------------------

def _jax_schedule(bounces, sort_every, skip_last_sort, start):
    """The loop of rt/kernels/tris_kernel.py:958-962."""
    out = []
    for b in range(start, bounces, sort_every):
        nb = min(sort_every, bounces - b)
        sorts = b > 0 and not (skip_last_sort and b + sort_every >= bounces
                               and bounces - b < sort_every)
        out.append((b, nb, sorts))
    return out


@pytest.mark.parametrize("sort_every", [1, 2, 3])
@pytest.mark.parametrize("start", [0, 1])
def test_bounce_schedule_from_any_start_equals_jax_condition(sort_every,
                                                             start):
    for skip in (False, True):
        for bounces in range(1, 11):
            assert ttk.bounce_schedule(bounces, sort_every, skip, start) == \
                _jax_schedule(bounces, sort_every, skip, start)


def test_bounce_schedules_of_the_new_paths():
    """spp > 1 at 8 bounces, sort every 2: four 2-bounce launches, sorts
    before bounces 2, 4, 6.  Large scenes at 5 bounces, sort every 1 after
    the fused first kernel: four 1-bounce launches, each sorted."""
    assert ttk.bounce_schedule(8, 2, True, 0) == [
        (0, 2, False), (2, 2, True), (4, 2, True), (6, 2, True)]
    assert ttk.bounce_schedule(5, 2, True, 0) == [
        (0, 2, False), (2, 2, True), (4, 1, False)]
    assert ttk.bounce_schedule(5, 1, True, 1) == [
        (b, 1, True) for b in (1, 2, 3, 4)]


@pytest.mark.parametrize("path", ["suzanne", "sphere_simple", "sphere_cover",
                                  "suzanne_spp4", "dragon", "suzanne_mono",
                                  "rtiow_one_sphere", "rtiow_three_spheres"])
def test_measured_paths_state_the_launches_their_schedule_gives(path):
    """``measure.PATHS`` is the one table of the port's paths; the launches
    it states per frame (what ``chip_smoke.py`` checks the counters
    against) follow from the dispatch's own choices."""
    from rt_torch import measure
    from rt_torch.kernels import sphere_kernel as tsk

    assert sorted(measure.PATHS) == sorted(
        ["suzanne", "sphere_simple", "sphere_cover", "suzanne_spp4",
         "dragon", "suzanne_mono", "rtiow_one_sphere",
         "rtiow_three_spheres"])
    p = measure.PATHS[path]
    r = measure.renderer(path, device="cpu")
    cfg = r.config
    assert (cfg.width, cfg.height) == (p.width, p.height)
    if isinstance(r._packed, tsk.PackedSpheres):
        flat = r._packed.chunks is None
        want = {"spheres" if flat else "spheres_chunked": 1}
    elif cfg.tris_path == "mono":
        want = {"tris_mono": 1}                 # the whole frame, any spp
    else:
        kw = tdispatch.wave_params(r._packed, cfg)
        first = cfg.samples_per_frame == 1
        per_sample = len(ttk.bounce_schedule(
            kw["bounces"], kw["sort_every"], kw["skip_last_sort"],
            1 if first else 0))
        want = {"wave_first" if first else "wave_raygen": 1,
                "wave_bounce": per_sample * cfg.samples_per_frame}
    assert p.launches == want and p.smoke_frames > 0


def test_wave_params_small_and_large():
    jsd, tscene = lucy()
    cfg = tscenes.scene_quad(32, 32, device="cpu").config
    large = tdispatch.wave_params(tscene, cfg)
    jl = jdispatch.wave_params(jsd.scene, jsd.config)
    small = tdispatch.wave_params(
        tscenes.scene_quad(32, 32, device="cpu").scene, cfg)
    js = jdispatch.wave_params(jscenes.scene_quad(32, 32).scene, jsd.config)
    for mine, theirs in ((large, jl), (small, js)):
        for k in ("key_mode", "sort_every", "skip_last_sort", "spp",
                  "sky_from_final_dir", "bounces"):
            assert mine[k] == theirs[k], k
    assert large["key_mode"] == "morton" and small["key_mode"] == "chunk_oct"
    assert (large["th"], large["tw"]) == tdispatch.DEFAULT_TILE


# ---- images ----------------------------------------------------------------

def pair(name, w, h, tile, **cfg):
    jsd = getattr(jscenes, f"scene_{name}")(w, h)
    jcfg = dataclasses.replace(jsd.config, backend="pallas", interpret=True,
                               **cfg)
    tcfg = dataclasses.replace(
        getattr(tscenes, f"scene_{name}")(w, h, device="cpu").config,
        tile=tile, **cfg)
    return jsd, jcfg, U.port_scene(jsd.scene), U.port_camera(jsd.camera), tcfg


@pytest.mark.parametrize("name,cfg", [
    ("suzanne", dict(bounces=3, samples_per_frame=3)),
    ("cube", dict(bounces=5, samples_per_frame=2)),
    ("quad", dict(bounces=3, samples_per_frame=2, sky_from_final_dir=True)),
    ("quad", dict(bounces=3, sky_from_final_dir=True)),
])
def test_wave_spp_image_equals_jax_wavefront(name, cfg):
    """64x32 at the JAX package's tile (32, 128): K4, then per sample the
    stream from bounce 0 through K3, state carried in pixel order."""
    jsd, jcfg, tscene, tcam, tcfg = pair(name, 64, 32, (32, 128), **cfg)
    want = np.asarray(jdispatch.render_color(
        jsd.scene, jsd.camera, jcfg, jnp.uint32(TIME), interpret=True))
    for k in ttk.LAUNCHES:
        ttk.LAUNCHES[k] = 0
    got = tdispatch.render_color(tscene, tcam, tcfg, TIME, "cpu").numpy()
    assert not any(ttk.LAUNCHES.values())         # CPU: plain versions only
    assert_images_agree(want, got)


def test_large_branch_image_equals_jax_on_lucy():
    """lucy (about 20K triangles) 32x32, 2 bounces, at the JAX package's
    large-scene tile (16, 128): split_big tables, morton key, a sort before
    every bounce after the first."""
    jsd, jcfg, tscene, tcam, tcfg = pair("lucy", 32, 32, (16, 128),
                                         bounces=2)
    assert jdispatch.wave_params(jsd.scene, jcfg)["th"] == 16
    want = np.asarray(jdispatch.render_color(
        jsd.scene, jsd.camera, jcfg, jnp.uint32(TIME), interpret=True))
    got = tdispatch.render_color(tscene, tcam, tcfg, TIME, "cpu").numpy()
    assert float(got.max() - got.min()) > 0.1
    assert_images_agree(want, got)


def test_bounce_zero_through_raygen_equals_the_fused_first_kernel():
    """K4 then K3 for one bounce is K2: the same rays and the same hits.
    Only the grouping differs (stream tiles of consecutive rays and their
    own chunk order against 2-D pixel tiles and the eye's order), which can
    change a ray only at an exact-t tie or a box-surface rounding: at most
    0.5 % of rays may differ, and the primary dy planes are bit-equal."""
    sd = tscenes.scene_cube(64, 32, device="cpu")
    packed = tdispatch.pack_scene(sd.scene)
    kw = tdispatch.wave_params(packed, sd.config)
    th, tw, flags = kw["th"], kw["tw"], kw["flags"]
    cam_row = tdispatch.pack_camera(sd.camera)
    times = torch.tensor([TIME], dtype=torch.int32)
    geom = dict(height=32, width=64, height_pad=32, width_pad=64, th=th,
                tw=tw, normalize_defocus_dir=True)
    od, pdy, state = ttk.wave_raygen(cam_row, times, 0, **geom)
    eye = torch.from_numpy(cam_row[0, 0:3].copy())
    payf, fstate, factive, _ = ttk.wave_first(
        packed, ttk.chunk_order(packed.centroid, eye), cam_row, times, 0,
        flags, **geom)
    assert torch.equal(payf[9], pdy)
    pay = torch.cat([od, torch.ones_like(od[0:3])])
    active = torch.ones_like(state)
    mo = pay[0:3].reshape(3, -1, th * tw).mean(dim=2)
    tile_order = ttk.chunk_order(packed.centroid, mo.T).reshape(-1)
    ttk.wave_bounce(packed, tile_order, pay, state, active, flags,
                    n_bounces=1, th=th, tw=tw)
    differ = ((pay != payf[0:9]).any(dim=0) | (state != fstate)
              | (active != factive))
    assert 0 < int(active.sum()) < active.numel()
    assert float(differ.float().mean()) <= FLIP_LIMIT
