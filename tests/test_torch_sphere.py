"""The port's sphere path against the JAX package: scene tables, the
Morton-chunked packing, the plain versions of the flat (K5) and chunked (K6)
sphere kernels, and ``render_color`` for sphere scenes.

Three kinds of comparison:

- tables: bitwise, tolerance none;
- EAGER, bitwise: the JAX kernel bodies run op by op on stand-in refs
  (``test_torch_parity_util.eager_sphere_*``), each jnp op one rounded XLA op.
  Carry and image must be bit-equal.  Tolerance: none;
- INTERPRET mode through ``rt.kernels.dispatch.render_color``: XLA's CPU
  compiler contracts multiply-adds in the jitted kernel body, so a ray on a
  branch edge can flip.  A pixel whose channels differ by more than 1e-6
  counts as flipped.  Scenes WITHOUT a dielectric: at most 0.5 % of pixels
  may flip and the images must be within 0.05 % mean absolute u8 difference
  (measured: 0 flips).  Scenes WITH a dielectric: a ray that refracts into
  a sphere starts on its surface, the near root of its next quadratic is
  t ~ 0, and `t > 0` falls either way with the last bit of the
  discriminant, so three roundings of the same arithmetic give three
  images.  The yardstick is taken in the test itself: the JAX package's own
  jitted oracle against its own jitted kernel on the same scene, config and
  time (2.4-7.3 % of pixels, 0.29-1.16 % u8 at this size;
  ``tests/test_kernels.py`` allows that pair 8 % and 1.5 %).  The port may
  differ from the jitted kernel by twice what the oracle does, in flipped
  pixels and in u8 (it reads 1.14-1.27 and 1.22-1.33 times it here, 1.35
  and 1.93 on test_scene_dielectric).  The
  eager comparisons above hold the same arithmetic bitwise, and the goldens
  hold the converged images.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rt.kernels import dispatch as jdispatch
from rt.kernels import sphere_kernel as jsk
from rt.render.renderer import render_color as oracle_render_color
from rt.scene import scenes as jscenes
from rt_torch.kernels import dispatch as tdispatch
from rt_torch.kernels import sphere_kernel as tsk
from rt_torch.kernels import sphere_schedule as tss
from rt_torch.kernels.tris_kernel import TraceFlags
from rt_torch.render import ppm as tppm
from rt_torch.scene import scenes as tscenes
import test_torch_parity_util as U
from _torch_threads import one_torch_thread  # noqa: F401

TIME = 1000
FLIP_ABOVE = 1e-6
STRICT = (0.005, 0.05)         # (share of pixels flipped, u8 bound in %)
DIELECTRIC = "measured"      # limits taken in the test itself, see above
DIELECTRIC_FACTOR = 2.0

APP_SPHERE_SCENES = ["scene_sphere_simple", "scene_sphere_globe",
                     "scene_sphere_cover", "scene_rtiow_one_sphere",
                     "scene_rtiow_three_spheres"]
TEST_SCENES = ["test_scene_lambertian", "test_scene_metal",
               "test_scene_dielectric", "test_scene_camera_position",
               "test_scene_depth_of_field", "test_scene_complex",
               "test_scene_shadow", "test_scene_perf"]


def bits(x):
    return np.ascontiguousarray(x).view(np.uint32)


def flags_of(config):
    return dict(normalize_reflect_in=config.normalize_reflect_in,
                has_metal=2 in config.mat_kinds,
                has_dielectric=3 in config.mat_kinds)


# ---- scenes and tables -----------------------------------------------------

@pytest.mark.parametrize("make_scene", APP_SPHERE_SCENES + TEST_SCENES)
def test_sphere_scene_equals_jax_bitwise(make_scene):
    """Every field of the SphereArray (the globe's and the cover's random
    draws included), the camera and the config's sphere fields."""
    jsd = getattr(jscenes, make_scene)(64, 32)
    tsd = getattr(tscenes, make_scene)(64, 32, device="cpu")
    assert tsd.name == jsd.name and tsd.kind == "spheres"
    for field, want in U.scene_fields(jsd.scene).items():
        got = getattr(tsd.scene, field).numpy()
        assert got.shape == want.shape, field
        np.testing.assert_array_equal(got.astype(want.dtype), want,
                                      err_msg=field)
    for field in jsd.camera._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(jsd.camera, field)),
            np.asarray(getattr(tsd.camera, field)), err_msg=field)
    for field in ("bounces", "n_active_spheres", "mat_kinds",
                  "normalize_defocus_dir", "normalize_reflect_in",
                  "sky_from_final_dir", "samples_per_frame", "sample_frame"):
        assert getattr(tsd.config, field) == getattr(jsd.config, field), field


def test_golden_scenes_table_names_the_same_functions():
    assert sorted(tscenes.GOLDEN_SCENES) == sorted(jscenes.GOLDEN_SCENES)
    for name, fn in tscenes.GOLDEN_SCENES.items():
        assert fn.__name__ == jscenes.GOLDEN_SCENES[name].__name__


@pytest.mark.parametrize("seed", [0, 3])
def test_globe_seed_equals_jax(seed):
    want = jscenes.scene_sphere_globe(64, 32, seed=seed)
    got = tscenes.scene_sphere_globe(64, 32, device="cpu", seed=seed)
    assert got.config.n_active_spheres == want.config.n_active_spheres
    np.testing.assert_array_equal(got.scene.center.numpy(),
                                  np.asarray(want.scene.center))
    np.testing.assert_array_equal(got.scene.mat_param.numpy(),
                                  np.asarray(want.scene.mat_param))


def test_pack_spheres_rejects_too_many_and_pads():
    from rt_torch.core.sphere import pack_spheres
    objs = [tscenes.sph_lambertian((0.0, 0.0, 0.0), 1.0, (1.0, 0.5, 0.2))] * 3
    s = pack_spheres(objs, pad_to=8, device="cpu")
    assert s.count == 8 and s.mat_kind.dtype == torch.int32
    assert s.mat_kind.tolist() == [1, 1, 1, 0, 0, 0, 0, 0]
    assert float(s.radius[3:].abs().max()) == 0.0
    with pytest.raises(ValueError, match="cap"):
        pack_spheres(objs, pad_to=2, device="cpu")


def test_convert_carries_spheres():
    jsd = jscenes.scene_sphere_simple(64, 32)
    got = U.port_spheres(jsd.scene)
    want = tscenes.scene_sphere_simple(64, 32, device="cpu").scene
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    from rt_torch import convert
    with pytest.raises(ValueError, match="missing"):
        convert.spheres_from_numpy({"center": np.zeros((1, 3))}, "cpu")


@pytest.mark.parametrize("make_scene", ["scene_sphere_simple",
                                     "scene_sphere_cover"])
def test_pack_spheres_table_equals_jax(make_scene):
    jsd = getattr(jscenes, make_scene)(64, 32)
    tsd = getattr(tscenes, make_scene)(64, 32, device="cpu")
    jtab, jkinds, jn = jdispatch.pack_spheres_table(jsd.scene)
    tab, kinds, n = tdispatch.pack_spheres_table(tsd.scene)
    assert n == jn and kinds.dtype == torch.int32
    np.testing.assert_array_equal(tab.numpy(), np.asarray(jtab))
    np.testing.assert_array_equal(kinds.numpy(), np.asarray(jkinds)[:, 0])


@functools.lru_cache(maxsize=None)
def cover():
    """(JAX SceneDef, port SceneDef, JAX chunked tables, port PackedSpheres)
    of the cover scene at 64x32."""
    jsd = jscenes.scene_sphere_cover(64, 32)
    tsd = tscenes.scene_sphere_cover(64, 32, device="cpu")
    jtab, jkinds, _ = jdispatch.pack_spheres_table(jsd.scene)
    n = jsd.config.n_active_spheres
    jpacked = jsk.pack_spheres_chunked(jtab, jkinds, n)
    packed = tdispatch.pack_scene(tsd.scene, tsd.config)
    return jsd, tsd, jpacked, packed


def test_pack_spheres_chunked_equals_jax_bitwise():
    """Morton order (stable), padding rows, boxes, and the eye's chunk
    visit order, on the cover scene (more than 128 live spheres: the
    dispatch takes the chunked tables)."""
    jsd, tsd, (sph, kinds, aabbs, n_pad, n_chunks), packed = cover()
    assert tsd.config.n_active_spheres > tsk.FLAT_MAX_SPHERES
    assert tsd.scene.count % 8 == 0 and tsd.scene.count < 496
    assert packed.n == n_pad and packed.n_chunks == n_chunks
    np.testing.assert_array_equal(bits(packed.tab.numpy()),
                                  bits(np.asarray(sph)))
    np.testing.assert_array_equal(packed.kinds.numpy(),
                                  np.asarray(kinds)[:, 0])
    np.testing.assert_array_equal(bits(packed.chunks.numpy()),
                                  bits(np.asarray(aabbs)))
    assert float(packed.tab[n_pad - 1, 3]) == np.float32(-1e30)
    eye = jdispatch.pack_camera(jsd.camera)[0, 0:3]
    centroid = (aabbs[:, 0:3] + aabbs[:, 3:6]) * 0.5
    want = jnp.argsort(jnp.sum((centroid - eye) ** 2, axis=1))
    got = tsk.eye_chunk_order(packed, tdispatch.pack_camera(tsd.camera))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_pack_scene_picks_flat_or_chunked_by_live_spheres():
    sd = tscenes.scene_sphere_simple(64, 32, device="cpu")
    p = tdispatch.pack_scene(sd.scene, sd.config)
    assert p.chunks is None and p.n == 7 and p.tab.shape == (100, 8)
    # without a config the whole padded buffer is live
    assert tdispatch.pack_scene(sd.scene).n == 100
    _, tsd, _, packed = cover()
    assert packed.chunks is not None and packed.tab.shape[0] % 32 == 0
    few = dataclasses.replace(tsd.config, n_active_spheres=100)
    assert tdispatch.pack_scene(tsd.scene, few).chunks is None
    with pytest.raises(TypeError):
        tdispatch.pack_scene(object())


# ---- the bounce bodies, eagerly, bitwise -----------------------------------

TH, TW = 8, 32


def primary_carry(tsd, tiles_h=1):
    """The carry after raygen for tiles_h tiles of (TH, TW) pixels taken
    from the middle of a 64x32 frame, as (n_tiles, TH*TW) tensors."""
    hp, wp = 32, 64
    state, o, d, _ = tsk._primary_rays(
        tdispatch.pack_camera(tsd.camera), TIME, torch.device("cpu"),
        height=32, width=64, height_pad=hp, width_pad=wp,
        normalize_defocus_dir=tsd.config.normalize_defocus_dir)
    r0 = 12
    cut = lambda x: x[r0:r0 + TH * tiles_h, 16:16 + TW].reshape(tiles_h,
                                                                 TH * TW)
    one = torch.ones((tiles_h, TH * TW))
    return (cut(state), tuple(cut(c) for c in o), tuple(cut(c) for c in d),
            (one, one, one), torch.ones((tiles_h, TH * TW),
                                        dtype=torch.int32))


def tile_planes(carry, i):
    """Tile i of a port carry as (TH, TW) NumPy planes."""
    f = lambda x: x[i].reshape(TH, TW).numpy()
    state, o, d, atten, active = carry
    return (f(state), tuple(f(c) for c in o), tuple(f(c) for c in d),
            tuple(f(c) for c in atten), f(active))


def assert_carry_bitwise(want, got_carry, i):
    got = tile_planes(got_carry, i)
    np.testing.assert_array_equal(want[0], got[0], err_msg="state")
    for name, w, g in zip(("o", "d", "atten"), want[1:4], got[1:4]):
        for c in range(3):
            np.testing.assert_array_equal(bits(w[c]), bits(g[c]),
                                          err_msg=f"{name}[{c}]")
    np.testing.assert_array_equal(want[4], got[4], err_msg="active")


@pytest.mark.parametrize("make_scene", ["scene_sphere_simple",
                                     "test_scene_complex"])
def test_sphere_bounce_equals_jax_eager_bitwise(make_scene):
    """Two successive bounces of one tile: primary rays, then the scattered
    ones (all three materials, misses, dead lanes)."""
    tsd = getattr(tscenes, make_scene)(64, 32, device="cpu")
    p = tdispatch.pack_scene(tsd.scene, tsd.config)
    flags = flags_of(tsd.config)
    carry = primary_carry(tsd)
    for _ in range(2):
        want = U.eager_sphere_bounce(p.tab.numpy(), p.kinds.numpy(),
                                     tile_planes(carry, 0), n_spheres=p.n,
                                     flags=flags)
        carry = tsk.sphere_bounce(p.tab, p.kinds, carry, TraceFlags(**flags),
                                  n_spheres=p.n)
        assert_carry_bitwise(want, carry, 0)
    hits = int(carry[4].sum())
    assert 0 < hits < TH * TW


def test_sphere_bounce_chunked_equals_jax_eager_bitwise():
    """Two tiles, two bounces on the cover scene, one order table handed to
    both sides; the tile union decides which chunks a lane scans."""
    _, tsd, _, packed = cover()
    flags = flags_of(tsd.config)
    order = tsk.eye_chunk_order(packed, tdispatch.pack_camera(tsd.camera))
    carry = primary_carry(tsd, tiles_h=2)
    for _ in range(2):
        want = [U.eager_sphere_bounce(
            packed.tab.numpy(), packed.kinds.numpy(), tile_planes(carry, i),
            n_spheres=packed.n, flags=flags,
            chunked=(packed.chunks.numpy(), order.numpy()))
            for i in range(2)]
        counts = []
        carry = tsk.sphere_bounce_chunked(packed, order, carry,
                                          TraceFlags(**flags),
                                          scan_counts=counts)
        for i in range(2):
            assert_carry_bitwise(want[i], carry, i)
        (pairs, boxes), = counts
        assert 0 < pairs < 2 * TH * TW * packed.n
        assert boxes == 2 * TH * TW * packed.n_chunks
    assert 0 < int(carry[4].sum()) < 2 * TH * TW


FLAT_CASES = [
    ("scene_sphere_simple", 3, 1, False, 16),
    ("scene_sphere_simple", 3, 3, False, 16),
    ("scene_sphere_simple", 3, 2, True, 16),
    # the scenes whose goldens the port is furthest from, at full depth: the
    # port's image IS the JAX kernel's when each operation is rounded singly
    ("scene_rtiow_three_spheres", 10, 1, False, 16),
    ("test_scene_dielectric", 10, 1, False, 16),
    # BENCH_CONFIGS config1's scene and depth at 4 samples, 13 rows padded
    # to the 8-row tile: the padding pixels are traced like any other
    ("scene_rtiow_one_sphere", 4, 4, False, 13)]


@pytest.mark.parametrize(
    "make_scene,bounces,spp,sky_from_final_dir,height", FLAT_CASES,
    ids=["-".join(map(str, c[:4])) + ("" if c[4] == 16 else f"-h{c[4]}")
         for c in FLAT_CASES])
def test_flat_kernel_plain_equals_jax_kernel_eager_bitwise(
        make_scene, bounces, spp, sky_from_final_dir, height):
    """The whole frame kernel: raygen, sample loop with the RNG state
    carried across samples, bounce loop, sky, true divide by spp; the
    frame padded to 16 rows."""
    tsd = getattr(tscenes, make_scene)(32, height, device="cpu")
    p = tdispatch.pack_scene(tsd.scene, tsd.config)
    flags = flags_of(tsd.config)
    cam_row = tdispatch.pack_camera(tsd.camera)
    kw = dict(n_spheres=p.n, height=height, width=32, bounces=bounces,
              spp=spp, sky_from_final_dir=sky_from_final_dir)
    want = U.eager_sphere_kernel(p.tab.numpy(), p.kinds.numpy(), cam_row,
                                 TIME, hp=16, wp=32, th=8, tw=32, flags=flags,
                                 **kw)
    got = tsk.render_color_spheres_plain(
        p.tab, p.kinds, cam_row, TIME, height_pad=16, width_pad=32,
        normalize_defocus_dir=False, flags=TraceFlags(**flags), **kw)
    assert np.ptp(want) > 0.1
    np.testing.assert_array_equal(bits(want), bits(got.numpy()))


# ---- chunked == flat in the port -------------------------------------------

@pytest.mark.parametrize("spp", [1, 2])
def test_chunked_equals_flat_scan_over_the_same_table_bitwise(spp):
    """The chunk cull is conservative and ``t < best`` is strict, so the
    chunked scan equals a flat scan over the same Morton-ordered padded
    table (padding rows are deterministic misses).  Tolerance: none."""
    _, tsd, _, packed = cover()
    cam_row = tdispatch.pack_camera(tsd.camera)
    kw = dict(height=32, width=64, height_pad=32, width_pad=64, bounces=4,
              normalize_defocus_dir=False,
              flags=TraceFlags(**flags_of(tsd.config)), spp=spp)
    counts = []
    a = tsk.render_color_spheres_chunked(packed, cam_row, TIME, th=8, tw=16,
                                         **kw)
    b = tsk.render_color_spheres_plain(packed.tab, packed.kinds, cam_row,
                                       TIME, n_spheres=packed.n,
                                       scan_counts=counts, **kw)
    assert torch.isfinite(a).all() and float(a.max() - a.min()) > 0.1
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert len(counts) <= 4 * spp and counts[0][0] == 32 * 64 * packed.n


# ---- render_color against the JAX package in interpret mode ----------------

def image_distance(want, got):
    """(share of pixels flipped, mean absolute u8 difference in %)."""
    flips = (np.abs(want - got).max(axis=-1) > FLIP_ABOVE).mean()
    _, pct = tppm.compare_ppm(tppm.render_ppm(got), tppm.render_ppm(want),
                              100.0)
    return float(flips), pct


def assert_images_agree(want, got, limits):
    flip_limit, u8_bound = limits
    assert want.shape == got.shape and np.isfinite(got).all()
    flips, pct = image_distance(want, got)
    assert flips <= flip_limit, f"{flips:.3%} of pixels flipped"
    assert pct <= u8_bound, f"{pct:.4f}% > {u8_bound}%"


@pytest.mark.parametrize("make_scene,spp,bounces,tile,limits", [
    ("scene_rtiow_one_sphere", 1, 4, (16, 128), STRICT),
    ("test_scene_lambertian", 1, 4, (16, 128), STRICT),
    ("test_scene_metal", 3, 4, (16, 128), STRICT),
    ("scene_sphere_simple", 1, 4, (16, 128), DIELECTRIC),
    ("scene_rtiow_three_spheres", 1, 4, (16, 128), DIELECTRIC),
    ("scene_rtiow_three_spheres", 3, 3, (16, 128), DIELECTRIC),
    # past 128 live spheres the JAX dispatch takes th=32 for the chunked
    # kernel; the tile is the unit of the chunk cull, so the port gets it
    ("scene_sphere_cover", 1, 3, (32, 128), DIELECTRIC),
])
def test_render_color_equals_jax_interpret(make_scene, spp, bounces, tile,
                                           limits):
    jsd = getattr(jscenes, make_scene)(64, 32)
    jcfg = dataclasses.replace(jsd.config, bounces=bounces,
                               samples_per_frame=spp)
    tsd = getattr(tscenes, make_scene)(64, 32, device="cpu")
    tcfg = dataclasses.replace(tsd.config, bounces=bounces,
                               samples_per_frame=spp, tile=tile)
    want = np.asarray(jdispatch.render_color(
        jsd.scene, jsd.camera, jcfg, jnp.uint32(TIME), interpret=True))
    got = tdispatch.render_color(U.port_spheres(jsd.scene),
                                 U.port_camera(jsd.camera), tcfg, TIME,
                                 device="cpu").numpy()
    assert want.shape == (32, 64, 3)
    if limits == DIELECTRIC:
        oracle = np.asarray(oracle_render_color(
            jsd.scene, jsd.camera, jcfg, jnp.uint32(TIME)))
        flips, pct = image_distance(want, oracle)
        assert flips > STRICT[0]      # the JAX pair itself is past STRICT
        limits = (DIELECTRIC_FACTOR * flips, DIELECTRIC_FACTOR * pct)
    assert_images_agree(want, got, limits)


def test_flat_image_does_not_depend_on_the_tile():
    sd = tscenes.scene_sphere_simple(60, 28, device="cpu")
    cfg = dataclasses.replace(sd.config, bounces=3)
    a = tdispatch.render_color(sd.scene, sd.camera, cfg, TIME, "cpu")
    b = tdispatch.render_color(
        sd.scene, sd.camera, dataclasses.replace(cfg, tile=(4, 64)), TIME,
        "cpu")
    assert a.shape == (28, 60, 3) and torch.equal(a, b)


def test_n_active_spheres_limits_the_scan():
    """Only the live prefix is scanned: with one live sphere (the ground)
    the small spheres are gone."""
    sd = tscenes.scene_sphere_simple(64, 32, device="cpu")
    cfg = dataclasses.replace(sd.config, bounces=2)
    full = tdispatch.render_color(sd.scene, sd.camera, cfg, TIME, "cpu")
    one = tdispatch.render_color(
        sd.scene, sd.camera, dataclasses.replace(cfg, n_active_spheres=1),
        TIME, "cpu")
    assert not torch.equal(full, one)
    p = tdispatch.pack_scene(sd.scene, cfg)
    ground = tsk.render_color_spheres_plain(
        p.tab, p.kinds, tdispatch.pack_camera(sd.camera), TIME, n_spheres=1,
        height=32, width=64, height_pad=32, width_pad=64, bounces=2,
        normalize_defocus_dir=False, flags=TraceFlags(**flags_of(cfg)))
    assert torch.equal(one, ground.permute(1, 2, 0))


def test_kernel_operands_must_be_contiguous_cuda_tensors():
    """What the CUDA wrappers check before a launch: a CPU tensor never
    reaches a kernel."""
    with pytest.raises(ValueError, match="CUDA"):
        tsk._require(torch.zeros((4, 8)), "tab", torch.float32, (4, 8))


# ---- the flat kernel's schedule (kernels/sphere_schedule.py) ---------------
# Warp turns over hand-built segment counts: 32 consecutive threads of a
# row-major (th, tw) tile are a warp.  Counts are integers: tolerance none.

def test_merged_schedule_takes_fewer_turns_where_long_paths_fall_apart():
    """Two samples of one 8x16 tile (warps of two rows).  Warp 0's longest
    paths fall in different samples on different lanes: in step it turns
    5 + 4, one loop over both samples 6 (lane 0's 5 + 1).  Warp 3's fall on
    one lane, so both turn 1 + 3.  Segments are the same in both."""
    scans = torch.ones((2, 8, 16), dtype=torch.int32)
    scans[0, 0, 0] = 5          # warp 0, lane 0, sample 0
    scans[1, 0, 1] = 4          # warp 0, lane 1, sample 1
    scans[1, 7, 15] = 3         # warp 3, lane 31, sample 1
    tile = tss.tile_schedule(scans, 8, 16)
    merged = tss.merged_schedule(scans, 8, 16)
    assert tile == {"warp_turns": 9 + 2 + 2 + 4, "segments": 265,
                    "lane_efficiency": 265 / (32 * 17)}
    assert merged == {"warp_turns": 6 + 2 + 2 + 4, "segments": 265,
                      "lane_efficiency": 265 / (32 * 14)}
    for schedule in (tss.tile_schedule, tss.merged_schedule):
        with pytest.raises(ValueError, match="whole warps"):
            schedule(scans, 4, 4)
        with pytest.raises(ValueError, match="whole warps"):
            schedule(scans[:, :6], 8, 16)


def _turns_by_loop(work, th, tw, merged):
    """Warp turns counted warp by warp: in step, the most segments of a
    warp's lanes in each sample, summed; merged, the most of its lanes'
    segments summed over the samples."""
    spp, hp, wp = work.shape
    turns = 0
    for r0 in range(0, hp, th):
        for c0 in range(0, wp, tw):
            tile = work[:, r0:r0 + th, c0:c0 + tw].reshape(spp, -1)
            for w in range(0, th * tw, 32):
                lanes = tile[:, w:w + 32]
                turns += int(lanes.sum(axis=0).max() if merged
                             else lanes.max(axis=1).sum())
    return turns


@pytest.mark.parametrize("spp,th,tw", [(1, 8, 16), (3, 8, 16), (6, 4, 32),
                                       (4, 16, 8)])
def test_schedules_equal_a_count_warp_by_warp(spp, th, tw):
    """Seeded counts of 1 to 10 segments over 2x3 tiles: both schedules'
    turns are the count warp by warp; the merged one never turns more than
    the one in step, equals it at one sample, and no schedule takes fewer
    turns than the segments over 32."""
    g = torch.Generator().manual_seed(1000 + spp)
    scans = torch.randint(1, 11, (spp, 2 * th, 3 * tw), generator=g,
                          dtype=torch.int32)
    tile = tss.tile_schedule(scans, th, tw)
    merged = tss.merged_schedule(scans, th, tw)
    work = scans.numpy()
    assert tile["warp_turns"] == _turns_by_loop(work, th, tw, False)
    assert merged["warp_turns"] == _turns_by_loop(work, th, tw, True)
    assert tile["segments"] == merged["segments"] == int(work.sum())
    assert -(-merged["segments"] // 32) <= merged["warp_turns"]
    assert merged["warp_turns"] <= tile["warp_turns"]
    if spp == 1:
        assert merged == tile
    else:
        assert merged["warp_turns"] < tile["warp_turns"]
