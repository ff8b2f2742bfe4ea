"""The sorted-stream recorder of the port (K10a, K10b and the stream glue
``render_color_tris_wave_record``; ``record_hits(tris_backend="wave")``)
against the JAX package's.  Thumbnails: 64x32 padded to 32 rows x 128
columns, at most 3 bounces.

- The plain K10a/K10b against the JAX kernel bodies run EAGERLY
  (``jax.disable_jit``, stand-in refs): payload, RNG state, active mask,
  winning chunk and index plane bit-equal.  Tolerance: none.
- The recorder against the JAX one jitted in interpret mode: XLA's CPU
  compiler contracts multiply-adds and its sort is not stable, so a ray on a
  branch edge can flip.  At most 0.5 % of pixels may differ by more than
  1e-6 in color, and at most 0.5 % of index entries may differ.
- Inside the port, bit for bit: the recorder's color is the render path's
  with a sort before every bounce on the same tables; the wave record is
  the mono record on the cube, color and ids.
- Replaying a wave record gives its color back within 2e-5 absolute (the
  replay recomputes t from the triangle's vertices in another order of
  operations than the scan).
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rt.grad.replay import record_hits_pallas
from rt.kernels import tris_kernel as jtk
from rt.scene import scenes as jscenes
from rt_torch.config import RenderConfig
from rt_torch.grad import record_hits, replay_color
from rt_torch.kernels import dispatch as tdispatch
from rt_torch.kernels import tris_kernel as ttk
import test_torch_parity_util as U
from _torch_threads import one_torch_thread  # noqa: F401

W, H, HP, WP = 64, 32, 32, 128
TIME = 1000
FLIP_ABOVE, FLIP_LIMIT = 1e-6, 0.005
REPLAY_ATOL = 2e-5


def bits(x):
    return np.ascontiguousarray(x).view(np.uint32)


@functools.lru_cache(maxsize=None)
def setup(name):
    jsd = getattr(jscenes, f"scene_{name}")(W, H)
    flags = dict(normalize_reflect_in=jsd.config.normalize_reflect_in,
                 has_metal=2 in jsd.config.mat_kinds,
                 has_dielectric=3 in jsd.config.mat_kinds)
    packed = ttk.pack_tri_table(U.port_scene(jsd.scene))
    cam_row = tdispatch.pack_camera(U.port_camera(jsd.camera))
    return jsd, flags, packed, cam_row, ttk.eye_chunk_order(packed, cam_row)


def first_kw(th, tw):
    return dict(height=H, width=W, height_pad=HP, width_pad=WP, th=th, tw=tw,
                normalize_defocus_dir=True, track_idx=True)


# ---- K10a, K10b: plain against the eager JAX bodies ------------------------

# (th, tw): the whole 32x128 frame as one tile, or four tiles
TILES = [(32, 128), (8, 128)]


@pytest.mark.parametrize("name", ["cube", "suzanne"])
@pytest.mark.parametrize("th,tw", TILES)
def test_wave_record_first_plain_equals_jax_kernel_eager_bitwise(name, th,
                                                                 tw):
    jsd, flags, packed, cam_row, order = setup(name)
    want = U.eager_wave_first(jsd.scene, cam_row, order.numpy(), TIME,
                              height=H, width=W, hp=HP, wp=WP, th=th, tw=tw,
                              flags=flags, track_idx=True)
    got = ttk.wave_first(packed, order, cam_row,
                         torch.tensor([TIME], dtype=torch.int32), 0,
                         ttk.TraceFlags(**flags), **first_kw(th, tw))
    assert len(got) == 5 and (want[4] >= 0).any() and (want[4] < 0).any()
    for what, j, t in zip(("payload", "state", "active", "chunk", "index"),
                          want, got):
        np.testing.assert_array_equal(bits(j), bits(t.numpy()),
                                      err_msg=what)


def sorted_stream(name, th, tw):
    """The stream K10b gets before bounce 1: K10a's plain output sorted by
    the morton key, and its per-tile chunk order."""
    _, flags, packed, cam_row, order = setup(name)
    payf, state, active, _, _ = ttk.wave_first_plain(
        packed, order, cam_row, torch.tensor([TIME], dtype=torch.int32), 0,
        ttk.TraceFlags(**flags), **first_kw(th, tw))
    key, perm = torch.sort(ttk.ray_sort_key(
        payf, active, *ttk.scene_bounds(packed.chunks)), stable=True)
    pay = payf[0:9][:, perm].contiguous()
    return (pay, state[perm].contiguous(),
            (key != ttk.DEAD_KEY).to(torch.int32),
            ttk.tile_chunk_order(packed, pay, th * tw))


@pytest.mark.parametrize("name,n_bounces", [("cube", 1), ("cube", 2),
                                            ("suzanne", 1)])
@pytest.mark.parametrize("th,tw", TILES)
def test_wave_record_bounce_plain_equals_jax_kernel_eager_bitwise(
        name, th, tw, n_bounces):
    """One bounce a launch as the recorder launches it, and two fused (an
    index plane per bounce; the second bounce skips the all-dead tiles)."""
    jsd, flags, packed, _, _ = setup(name)
    pay, state, active, tile_order = sorted_stream(name, th, tw)
    want = U.eager_wave_bounce(jsd.scene, tile_order.numpy(), pay.numpy(),
                               rng_u32(state), active.numpy(),
                               n_bounces=n_bounces, th=th, tw=tw, flags=flags,
                               track_idx=True)
    _, idx = ttk.wave_bounce(packed, tile_order, pay, state, active,
                             ttk.TraceFlags(**flags), n_bounces=n_bounces,
                             th=th, tw=tw, track_idx=True)
    assert idx.shape == (n_bounces, HP * WP) and (want[3] >= 0).any()
    for what, j, t in zip(("payload", "state", "active", "index"), want,
                          (pay, state, active, idx)):
        np.testing.assert_array_equal(bits(j), bits(t.numpy()),
                                      err_msg=what)


def rng_u32(state):
    return state.numpy().view(np.uint32)


def test_a_skipped_tile_writes_minus_one():
    """A tile whose rays are all dead is skipped: its index planes are -1,
    and its chunk plane too."""
    _, flags, packed, _, _ = setup("cube")
    pay, state, active, tile_order = sorted_stream("cube", 8, 16)
    assert int(active.sum()) > 128                # live rays sort first
    active[:128] = 0                              # the first tile dies
    wch, idx = ttk.wave_bounce(packed, tile_order, pay, state, active,
                               ttk.TraceFlags(**flags), n_bounces=2, th=8,
                               tw=16, track_idx=True)
    assert (idx[:, :128] == -1).all() and (wch[:128] == -1).all()
    assert (idx[0, 128:] >= 0).any()


# ---- the recorder ----------------------------------------------------------

def jax_record(name, th, tw, bounces):
    jsd = setup(name)[0]
    cfg = jsd.config
    color, idx, morton = jtk.render_color_tris_wave_record(
        jsd.scene, jnp.asarray(setup(name)[3]),
        jnp.full((1, 1), TIME, jnp.uint32), height=H, width=W,
        height_pad=HP, width_pad=WP, bounces=bounces,
        normalize_defocus_dir=cfg.normalize_defocus_dir,
        normalize_reflect_in=cfg.normalize_reflect_in, th=th, tw=tw,
        has_metal=2 in cfg.mat_kinds, has_dielectric=3 in cfg.mat_kinds,
        interpret=True)
    return np.asarray(color), np.asarray(idx), np.asarray(morton)


def port_record(name, th, tw, bounces, **kw):
    _, flags, packed, cam_row, _ = setup(name)
    return ttk.render_color_tris_wave_record(
        packed, cam_row, TIME, height=H, width=W, height_pad=HP,
        width_pad=WP, bounces=bounces, normalize_defocus_dir=True,
        flags=ttk.TraceFlags(**flags), th=th, tw=tw, **kw)


@pytest.mark.parametrize("name", ["cube", "suzanne"])
def test_wave_record_equals_jax_recorder_interpret(name):
    want_color, want_idx, want_morton = jax_record(name, 8, 128, 3)
    color, idx, order = port_record(name, 8, 128, 3)
    np.testing.assert_array_equal(order.numpy(), want_morton)
    flips = (np.abs(want_color - color.numpy()).max(axis=0)
             > FLIP_ABOVE).mean()
    assert flips <= FLIP_LIMIT, f"{flips:.3%} of pixels flipped"
    assert (idx.numpy() != want_idx).mean() <= FLIP_LIMIT
    assert (want_idx >= 0).any(axis=(1, 2)).all()     # every bounce hits


@pytest.mark.parametrize("name,sky", [("cube", False), ("suzanne", True)])
def test_wave_record_color_is_the_render_paths_bitwise(name, sky):
    """The recorder's color is ``render_color_tris_wave`` with a sort before
    every bounce, over the same tables: the recording kernels change no
    arithmetic of the render ones."""
    _, flags, packed, cam_row, _ = setup(name)
    color, _, _ = port_record(name, 8, 128, 3, sky_from_final_dir=sky)
    render = ttk.render_color_tris_wave(
        packed, cam_row, torch.tensor([TIME], dtype=torch.int32), height=H,
        width=W, height_pad=HP, width_pad=WP, bounces=3,
        normalize_defocus_dir=True, flags=ttk.TraceFlags(**flags), th=8,
        tw=128, sort_every=1, skip_last_sort=False, key_mode="morton",
        sky_from_final_dir=sky)[0]
    np.testing.assert_array_equal(bits(color.numpy()), bits(render.numpy()))


def test_wave_record_planes_are_in_pixel_order():
    """Each index plane goes back to pixel order through the permutation of
    its own bounce: replaying the planes bounce by bounce from the primary
    rays reproduces every plane's hits (a plane put back with a later
    bounce's permutation would name triangles its rays never reach)."""
    cfg = port_config("suzanne", 3)
    jsd = setup("suzanne")[0]
    scene, cam = U.port_scene(jsd.scene), U.port_camera(jsd.camera)
    color, hits = record_hits(scene, cam, cfg, TIME, device="cpu",
                              tris_backend="wave")
    mono_color, mono_hits = record_hits(scene, cam, cfg, TIME, device="cpu",
                                        tris_backend="mono")
    # wave == mono up to cross-chunk exact-t ties
    assert (hits != mono_hits).float().mean() <= FLIP_LIMIT
    img = replay_color(scene, cam, cfg, TIME, hits)
    assert float((img - color).abs().max()) <= REPLAY_ATOL


def port_config(name, bounces, tile=(8, 128)):
    return RenderConfig.for_triangles(
        W, H, bounces=bounces, tile=tile,
        mat_kinds=tuple(int(k) for k in setup(name)[0].config.mat_kinds))


def test_wave_record_equals_mono_record_on_the_cube():
    jsd = setup("cube")[0]
    scene, cam = U.port_scene(jsd.scene), U.port_camera(jsd.camera)
    cfg = port_config("cube", 3)
    c_m, i_m = record_hits(scene, cam, cfg, TIME, device="cpu",
                           tris_backend="mono")
    c_w, i_w = record_hits(scene, cam, cfg, TIME, device="cpu",
                           tris_backend="wave")
    np.testing.assert_array_equal(bits(c_w.numpy()), bits(c_m.numpy()))
    np.testing.assert_array_equal(i_w.numpy(), i_m.numpy())


# ---- record_hits ------------------------------------------------------------

@pytest.mark.parametrize("name,bounces", [("cube", 2), ("suzanne", 3)])
def test_record_hits_wave_equals_jax_record_hits_pallas(name, bounces):
    """At the tile the JAX recorder picks for 64x32, (16, 128)."""
    jsd = setup(name)[0]
    jcfg = dataclasses.replace(jsd.config, bounces=bounces)
    want_color, want_hits = record_hits_pallas(
        jsd.scene, jsd.camera, jcfg, jnp.uint32(TIME), interpret=True,
        tris_backend="wave")
    color, hits = record_hits(U.port_scene(jsd.scene),
                              U.port_camera(jsd.camera),
                              port_config(name, bounces, (16, 128)), TIME,
                              device="cpu", tris_backend="wave")
    want_color, want_hits = np.asarray(want_color), np.asarray(want_hits)
    assert hits.shape == want_hits.shape == (bounces, H, W)
    flips = (np.abs(want_color - color.numpy()).max(axis=-1)
             > FLIP_ABOVE).mean()
    assert flips <= FLIP_LIMIT, f"{flips:.3%} of pixels flipped"
    assert (hits.numpy() != want_hits).mean() <= FLIP_LIMIT
    # scene-order ids: every hit names a triangle of the scene
    assert hits.max() < jsd.scene.m and (hits >= 0).any()


def test_replay_of_a_wave_record_reproduces_its_color():
    jsd = setup("cube")[0]
    scene, cam = U.port_scene(jsd.scene), U.port_camera(jsd.camera)
    cfg = port_config("cube", 2)
    color, hits = record_hits(scene, cam, cfg, TIME, device="cpu",
                              tris_backend="wave")
    img = replay_color(scene, cam, cfg, TIME, hits)
    assert float((img - color).abs().max()) <= REPLAY_ATOL
