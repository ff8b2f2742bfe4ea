"""The whole-frame kernels' plain versions against the JAX package: the
monolithic triangle tracer (K7, ``_kernel``), its recording variant (K9,
``_kernel_record``) and the sphere recorder (K8, ``_kernel_record`` of
``sphere_kernel.py``).

- EAGER, bitwise: the JAX kernel bodies run op by op on stand-in refs
  (``test_torch_parity_util.eager_*``); color and index planes must be
  bit-equal.  Tolerance: none.
- INTERPRET mode (the jitted body contracts multiply-adds on the CPU): at
  most 0.5 % of pixels may differ by more than 1e-4, and the image as u8 by
  at most 0.05 % — the limits of ``tests/test_torch_slice.py``; the index
  planes may differ on at most 0.5 % of entries.
- Inside the port, bitwise: recorder color == render color; mono == wave up
  to rays that hit two chunks at exactly the same t (none found here).

64x32 images at the JAX package's tile for that size, (16, 128).
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rt.grad import replay as jreplay
from rt.kernels import dispatch as jdispatch
from rt.scene import scenes as jscenes
from rt_torch.config import RenderConfig
from rt_torch.kernels import dispatch as tdispatch
from rt_torch.kernels import sphere_kernel as tsk
from rt_torch.kernels import tris_kernel as ttk
from rt_torch.render.renderer import ProgressiveRenderer
from rt_torch.scene import scenes as tscenes
import test_torch_parity_util as U
from _torch_threads import one_torch_thread  # noqa: F401

W, H, HP, WP, TH, TW = 64, 32, 32, 128, 16, 128
TIME = 1000
FLIP_LIMIT = 0.005
CLOSE = 1e-4
U8_LIMIT_PCT = 0.05


@functools.lru_cache(maxsize=None)
def tris_setup(name):
    jsd = getattr(jscenes, f"scene_{name}")(W, H)
    flags = dict(normalize_reflect_in=jsd.config.normalize_reflect_in,
                 has_metal=2 in jsd.config.mat_kinds,
                 has_dielectric=3 in jsd.config.mat_kinds)
    packed = ttk.pack_tri_table(U.port_scene(jsd.scene))
    cam_row = tdispatch.pack_camera(U.port_camera(jsd.camera))
    return jsd, flags, packed, cam_row


def geometry(**kw):
    return dict(height=H, width=W, height_pad=HP, width_pad=WP, th=TH, tw=TW,
                **kw)


def u8_diff_pct(a, b):
    q = lambda x: np.clip(x * 255.0, 0, 255).astype(np.uint8).astype(float)
    return float(np.abs(q(a) - q(b)).mean() / 255.0 * 100.0)


def assert_close_images(want, got):
    """(3, Hp, Wp) or (H, W, 3) images within the interpret-mode limits."""
    far = np.abs(want - got) > CLOSE
    axis = 0 if want.shape[0] == 3 else -1
    assert far.any(axis=axis).mean() <= FLIP_LIMIT
    assert u8_diff_pct(want, got) <= U8_LIMIT_PCT


# ---------------------------------------------------------------------------
# K7
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,bounces,spp,sky", [
    ("quad", 3, 1, False), ("cube", 3, 1, False), ("cube", 2, 3, True)])
def test_mono_plain_equals_jax_kernel_eager_bitwise(name, bounces, spp, sky):
    """Suzanne's 35 chunks are held through K9 below (same trace, and K9's
    color == K7's bitwise): the eager K7 body takes minutes on them."""
    jsd, flags, packed, cam_row = tris_setup(name)
    order = ttk.eye_chunk_order(packed, cam_row)
    want = U.eager_tris_kernel(
        jsd.scene, cam_row, order.numpy(), TIME, record=False, height=H,
        width=W, hp=HP, wp=WP, th=TH, tw=TW, bounces=bounces, flags=flags,
        spp=spp, sky_from_final_dir=sky)
    got = ttk.render_color_tris(
        packed, cam_row, TIME, bounces=bounces, normalize_defocus_dir=True,
        flags=ttk.TraceFlags(**flags), spp=spp, sky_from_final_dir=sky,
        **geometry()).numpy()
    assert np.array_equal(want.view(np.int32), got.view(np.int32))


def mono_pair(name, **cfg):
    jsd = getattr(jscenes, f"scene_{name}")(W, H)
    jcfg = dataclasses.replace(jsd.config, backend="pallas_mono", **cfg)
    tcfg = dataclasses.replace(
        getattr(tscenes, f"scene_{name}")(W, H, device="cpu").config,
        tile=(TH, TW), tris_path="mono", **cfg)
    return jsd, jcfg, U.port_scene(jsd.scene), U.port_camera(jsd.camera), tcfg


@pytest.mark.parametrize("name,cfg", [
    ("suzanne", dict(bounces=3)),
    ("suzanne", dict(bounces=3, samples_per_frame=3)),
    ("cube", dict(bounces=5, sky_from_final_dir=True))])
def test_mono_image_close_to_jax_mono_interpret(name, cfg):
    """dispatch.render_color with tris_path="mono" against the JAX package's
    backend="pallas_mono" in interpret mode, spp 3 included."""
    jsd, jcfg, tscene, tcam, tcfg = mono_pair(name, **cfg)
    want = np.asarray(jdispatch.render_color(
        jsd.scene, jsd.camera, jcfg, jnp.uint32(TIME), interpret=True))
    got = tdispatch.render_color(tscene, tcam, tcfg, TIME, "cpu").numpy()
    assert got.shape == (H, W, 3)
    assert_close_images(want, got)


@pytest.mark.parametrize("name", ["quad", "cube", "suzanne"])
def test_mono_equals_wave_up_to_exact_ties(name):
    """The port's counterpart of test_wavefront_equals_monolithic: the two
    paths run one trace_bounce per ray and differ only in the chunk visit
    order from bounce 1 on, which decides a hit only between two chunks at
    exactly the same t.  Flip fraction found on these scenes: 0."""
    _, _, tscene, tcam, tcfg = mono_pair(name, bounces=4)
    mono = tdispatch.render_color(tscene, tcam, tcfg, TIME, "cpu").numpy()
    wave = tdispatch.render_color(
        tscene, tcam, dataclasses.replace(tcfg, tris_path="wave"), TIME,
        "cpu").numpy()
    flips = (mono.view(np.int32) != wave.view(np.int32)).any(axis=-1).mean()
    assert flips == 0.0


@pytest.mark.parametrize("name", ["quad", "cube"])
def test_mono_path_holds_the_oracle_goldens(name):
    """tests/golden_tris through the whole-frame path, under the bound the
    wavefront path is held to (suzanne: on a card, in chip_smoke.py)."""
    from rt_torch import goldens

    golden = goldens.ORACLE_GOLDENS[name]
    assert goldens.oracle_diff_pct(name, "cpu", "mono") <= golden.bound_pct


def test_mono_rows_from_row0_are_the_full_frames_rows():
    _, flags, packed, cam_row = tris_setup("cube")
    kw = dict(bounces=3, normalize_defocus_dir=True,
              flags=ttk.TraceFlags(**flags))
    full = ttk.render_color_tris(packed, cam_row, TIME, **kw, **geometry())
    band = ttk.render_color_tris(
        packed, cam_row, TIME, row0=16, **kw,
        **dict(geometry(), height_pad=16))
    assert torch.equal(band, full[:, 16:32])


def test_renderer_and_cli_take_the_mono_path(tmp_path):
    from rt_torch import cli

    sd = tscenes.scene_cube(W, H, device="cpu")
    cfg = dataclasses.replace(sd.config, tile=(TH, TW), bounces=2)
    images = {}
    for path in ("mono", "wave"):
        r = ProgressiveRenderer(dataclasses.replace(
            sd, config=dataclasses.replace(cfg, tris_path=path)), "cpu")
        r.set_time(TIME)
        r.draw_frames(2)
        images[path] = r.image
    assert np.array_equal(images["mono"], images["wave"])
    with pytest.raises(ValueError, match="tris_path"):
        tdispatch.render_color(
            sd.scene, sd.camera,
            dataclasses.replace(cfg, tris_path="sorted"), TIME, "cpu")
    out = tmp_path / "m.ppm"
    assert cli.main(["--scene", "4", "--frames", "1", "--size", "32x16",
                     "--device", "cpu", "--mono", "-o", str(out)]) == 0
    assert out.read_bytes().startswith(b"P3")


# ---------------------------------------------------------------------------
# K9
# ---------------------------------------------------------------------------

def record_tris(name, bounces, sky=False):
    _, flags, packed, cam_row = tris_setup(name)
    return ttk.render_color_tris_record(
        packed, cam_row, TIME, bounces=bounces, normalize_defocus_dir=True,
        flags=ttk.TraceFlags(**flags), sky_from_final_dir=sky, **geometry())


@pytest.mark.parametrize("name,bounces", [("quad", 3), ("cube", 3),
                                          ("suzanne", 2)])
def test_tris_recorder_plain_equals_jax_kernel_eager_bitwise(name, bounces):
    jsd, flags, packed, cam_row = tris_setup(name)
    order = ttk.eye_chunk_order(packed, cam_row)
    want_color, want_idx = U.eager_tris_kernel(
        jsd.scene, cam_row, order.numpy(), TIME, record=True, height=H,
        width=W, hp=HP, wp=WP, th=TH, tw=TW, bounces=bounces, flags=flags)
    color, idx, table_order = record_tris(name, bounces)
    assert np.array_equal(want_color.view(np.int32),
                          color.numpy().view(np.int32))
    assert idx.dtype == torch.int32
    assert np.array_equal(want_idx, idx.numpy())
    # the table rows' scene ids are the JAX package's Morton order
    from rt.kernels.tris_kernel import _morton_order
    jorder = _morton_order((jsd.scene.a + jsd.scene.b + jsd.scene.c) / 3.0)
    assert np.array_equal(np.asarray(jorder), table_order.numpy())


@pytest.mark.parametrize("name,bounces", [("quad", 6), ("cube", 3),
                                          ("suzanne", 3)])
def test_tris_recorder_color_equals_mono_render_bitwise(name, bounces):
    """K9's color is K7's at one sample per pixel; a dead ray's planes read
    -1 (quad at 6 bounces: every ray has left before the last bounce, so the
    plain version stops early and fills the rest)."""
    _, flags, packed, cam_row = tris_setup(name)
    color, idx, _ = record_tris(name, bounces)
    render = ttk.render_color_tris(
        packed, cam_row, TIME, bounces=bounces, normalize_defocus_dir=True,
        flags=ttk.TraceFlags(**flags), **geometry())
    assert torch.equal(color.view(torch.int32), render.view(torch.int32))
    assert idx.shape == (bounces, HP, WP)
    assert int(idx.min()) == -1 and int(idx.max()) < packed.tab.shape[0]
    dead = idx < 0
    assert bool((dead[:-1] <= dead[1:]).all())      # once dead, dead
    if name == "quad":
        assert bool(dead[-1].all())


def test_record_hits_equals_jax_recorder_interpret():
    """record_hits on Suzanne against record_hits_pallas in interpret mode:
    scene-order ids, cropped to (H, W)."""
    from rt_torch.grad import record_hits

    jsd, jcfg, tscene, tcam, tcfg = mono_pair("suzanne", bounces=3)
    jcolor, jhits = jreplay.record_hits_pallas(
        jsd.scene, jsd.camera, jcfg, jnp.uint32(TIME), interpret=True,
        tris_backend="mono")
    color, hits = record_hits(tscene, tcam, tcfg, TIME, device="cpu")
    assert hits.shape == (3, H, W) and hits.dtype == torch.int32
    assert (np.asarray(jhits) != hits.numpy()).mean() <= FLIP_LIMIT
    assert_close_images(np.asarray(jcolor), color.numpy())


# ---------------------------------------------------------------------------
# K8
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def sphere_setup(make_scene):
    jsd = getattr(jscenes, make_scene)(W, H)
    tscene = U.port_spheres(jsd.scene)
    tab, kinds, n = tdispatch.pack_spheres_table(tscene)
    if 0 < jsd.config.n_active_spheres < n:
        n = jsd.config.n_active_spheres
    flags = dict(normalize_reflect_in=True, has_metal=True,
                 has_dielectric=True)
    cam_row = tdispatch.pack_camera(U.port_camera(jsd.camera))
    return jsd, tscene, tab, kinds, n, flags, cam_row


@pytest.mark.parametrize("make_scene,bounces,sky", [
    ("test_scene_metal", 3, False), ("test_scene_dielectric", 3, False),
    ("scene_sphere_simple", 4, True)])
def test_sphere_recorder_plain_equals_jax_kernel_eager_bitwise(make_scene,
                                                               bounces, sky):
    _, _, tab, kinds, n, flags, cam_row = sphere_setup(make_scene)
    want_color, want_idx = U.eager_sphere_record(
        tab.numpy(), kinds.numpy(), cam_row, TIME, n_spheres=n, height=H,
        width=W, hp=HP, wp=WP, th=TH, tw=TW, bounces=bounces, flags=flags,
        sky_from_final_dir=sky)
    color, idx = tsk.render_color_spheres_record(
        tab, kinds, cam_row, TIME, n_spheres=n, bounces=bounces,
        normalize_defocus_dir=False, flags=ttk.TraceFlags(**flags),
        sky_from_final_dir=sky, **geometry())
    assert np.array_equal(want_color.view(np.int32),
                          color.numpy().view(np.int32))
    assert idx.dtype == torch.int32
    assert np.array_equal(want_idx, idx.numpy())


@pytest.mark.parametrize("make_scene", ["test_scene_metal",
                                        "test_scene_complex",
                                        "scene_sphere_cover"])
def test_sphere_recorder_color_equals_flat_render_bitwise(make_scene):
    """K8's color is K5's plain version at one sample per pixel; cover: 486
    rows, more than the render dispatch scans flat."""
    _, _, tab, kinds, n, flags, cam_row = sphere_setup(make_scene)
    kw = dict(n_spheres=n, height=H, width=W, height_pad=HP, width_pad=WP,
              bounces=3, normalize_defocus_dir=False,
              flags=ttk.TraceFlags(**flags))
    color, idx = tsk.render_color_spheres_record(tab, kinds, cam_row, TIME,
                                                 th=TH, tw=TW, **kw)
    render = tsk.render_color_spheres_plain(tab, kinds, cam_row, TIME, **kw)
    assert torch.equal(color.view(torch.int32), render.view(torch.int32))
    assert int(idx.min()) == -1 and 0 <= int(idx.max()) < n
    dead = idx < 0
    assert bool((dead[:-1] <= dead[1:]).all())


@pytest.mark.parametrize("make_scene", ["test_scene_metal",
                                        "test_scene_dielectric"])
def test_record_hits_spheres_against_jax_recorder_interpret(make_scene):
    """Against record_hits_pallas in interpret mode.  Without a dielectric:
    the limits above.  With one, a refracted ray re-hits its sphere at t ~ 0
    and any two arithmetic variants part there: the limit is twice the
    distance of the JAX package's own oracle recorder from its kernel
    recorder on the same frame, read here."""
    from rt_torch.grad import record_hits

    jsd, tscene, *_ = sphere_setup(make_scene)
    jcfg = dataclasses.replace(jsd.config, bounces=3)
    tcfg = RenderConfig.for_spheres(
        W, H, bounces=3, n_active_spheres=jcfg.n_active_spheres,
        tile=(TH, TW))
    t = jnp.uint32(TIME)
    jcolor, jhits = jreplay.record_hits_pallas(jsd.scene, jsd.camera, jcfg, t,
                                               interpret=True)
    color, hits = record_hits(tscene, U.port_camera(jsd.camera), tcfg, TIME,
                              device="cpu")
    differ = (np.asarray(jhits) != hits.numpy()).any(axis=0).mean()
    if make_scene == "test_scene_metal":
        assert differ <= FLIP_LIMIT
        assert_close_images(np.asarray(jcolor), color.numpy())
    else:
        _, ohits = jreplay.record_hits_oracle(jsd.scene, jsd.camera, jcfg, t)
        own = (np.asarray(jhits) != np.asarray(ohits)).any(axis=0).mean()
        assert differ <= max(2 * own, FLIP_LIMIT)


def test_recorders_fail_loudly_without_a_card_and_past_their_limits():
    _, flags, packed, cam_row = tris_setup("cube")
    _, _, tab, kinds, n, sflags, scam = sphere_setup("test_scene_metal")
    before = dict(ttk.LAUNCHES), dict(tsk.LAUNCHES)
    record_tris("cube", 2)
    assert (dict(ttk.LAUNCHES), dict(tsk.LAUNCHES)) == before   # CPU: plain
    with pytest.raises(ValueError, match="multiple of the tile"):
        ttk.render_color_tris(
            packed, cam_row, TIME, bounces=2, normalize_defocus_dir=True,
            flags=ttk.TraceFlags(**flags),
            **dict(geometry(), height_pad=24))
    assert set(tdispatch.launch_counts()) == {
        "wave_first", "wave_bounce", "wave_raygen", "spheres",
        "spheres_chunked", "tris_mono", "tris_record", "spheres_record",
        "wave_record", "wave_record_bounce", "replay_loss"}
