"""The oracle backend of the port and what stands on it — the intersections
(``core.triangle``, ``core.sphere``), the bounce loop (``core.trace``), the
oracle's ``render_color``, ``record_hits_oracle``, the differentiable
renderer (``grad.diff_render``), ``finite_difference_check`` and the loops
``fit`` / ``fit_replay(recorder="oracle")`` — against the JAX package's.
Thumbnails: at most 64x32 and 3 bounces; seeded random rays from numpy.

- EAGER (``jax.disable_jit``: each jnp op one rounded XLA op): the port's
  intersections, hit records, images and hit ids are bit-equal.  Tolerance:
  none.  Gradients (``torch.autograd`` against ``jax.grad``) agree within
  1e-4 of the leaf's largest entry.
- JITTED, as a user runs the JAX oracle: XLA's CPU compiler contracts
  multiply-adds, so a ray on a branch edge can flip.  A pixel whose
  channels differ by more than 1e-6 counts as flipped: at most 0.5 % of
  pixels without a dielectric; with one, twice what the JAX package's own
  jitted oracle and jitted kernel differ by on the same frame (a refracted
  ray re-hits its sphere at t ~ 0, ROADMAP queue 3).  Loss curves of a fit:
  1e-4 relative.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rt.config import FLT_MAX as JFLT_MAX
from rt.core import sphere as jsphere
from rt.core import triangle as jtri
from rt.core.triangle import TriangleScene as JaxTriangleScene
from rt.grad import CameraParams as JCameraParams
from rt.grad import SphereParams as JSphereParams
from rt.grad import TriangleParams as JTriangleParams
from rt.grad import apply_tri_params as japply_tri_params
from rt.grad import finite_difference_check as jfd
from rt.grad import look_at_jnp
from rt.grad.diff_render import render_color_diff as jrender_color_diff
from rt.grad.loss import image_mse as jimage_mse
from rt.grad.replay import record_hits_oracle as jrecord_hits_oracle
from rt.grad.train import fit as jfit
from rt.grad.train import fit_replay as jfit_replay
from rt.kernels import dispatch as jdispatch
from rt.render.renderer import render_color as jrender_color
from rt.scene import scenes as jscenes
from rt_torch import cli, convert
from rt_torch.config import RenderConfig
from rt_torch.core import sphere as tsphere
from rt_torch.core import triangle as ttri
from rt_torch.core.sphere import pack_spheres
from rt_torch.grad import (SphereParams, TriangleParams, apply_params,
                           apply_tri_params, finite_difference_check, fit,
                           fit_replay, image_mse, look_at,
                           record_hits_oracle, render_color_diff,
                           render_image_diff, replay_loss_fn)
from rt_torch.render import oracle
from rt_torch.render.ppm import parse_ppm
from rt_torch.render.renderer import ProgressiveRenderer
from rt_torch.scene import scenes as tscenes
import test_torch_parity_util as U
from _torch_threads import one_torch_thread  # noqa: F401

TIME = 1000
FLIP_ABOVE, FLIP_LIMIT = 1e-6, 0.005
DIELECTRIC_FACTOR = 2.0
GRAD_RTOL = 1e-4
LOSS_RTOL = 1e-4


def bits(x):
    return np.ascontiguousarray(np.asarray(x)).view(np.uint32)


@functools.lru_cache(maxsize=None)
def scene(name, w=64, h=32):
    """(JAX SceneDef, port scene, port camera)."""
    jsd = getattr(jscenes, name)(w, h)
    port = (U.port_spheres(jsd.scene) if hasattr(jsd.scene, "center")
            else U.port_scene(jsd.scene))
    return jsd, port, U.port_camera(jsd.camera)


def port_config(jcfg):
    """The port's RenderConfig of a JAX one (the fields both have)."""
    names = {f.name for f in dataclasses.fields(RenderConfig)}
    return RenderConfig(**{f.name: getattr(jcfg, f.name)
                           for f in dataclasses.fields(jcfg)
                           if f.name in names and f.name != "backend"})


def random_rays(jscene, n, seed):
    """(origin, direction) (n, 3) f32: origins around the scene's box,
    directions toward random points inside it, a few axis-aligned."""
    if hasattr(jscene, "center"):
        c = np.asarray(jscene.center)[np.asarray(jscene.radius) > 0]
        r = np.asarray(jscene.radius)[np.asarray(jscene.radius) > 0]
        lo = np.minimum((c - r[:, None]).min(0), -1.0)
        hi = np.maximum((c + r[:, None]).max(0), 1.0)
        lo, hi = np.maximum(lo, -20.0), np.minimum(hi, 20.0)
    else:
        lo, hi = np.asarray(jscene.bmin)[1], np.asarray(jscene.bmax)[1]
    rs = np.random.RandomState(seed)
    span = hi - lo
    o = lo - 0.5 * span + rs.uniform(0, 2, (n, 3)) * span
    tgt = lo + rs.uniform(0, 1, (n, 3)) * span
    d = tgt - o
    d[: n // 16, rs.randint(3)] = 0.0               # NaN in the slab test
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def both(o, d):
    return (jnp.asarray(o), jnp.asarray(d), torch.from_numpy(o),
            torch.from_numpy(d))


# ---- (d) the intersections --------------------------------------------------

@pytest.mark.parametrize("name", ["scene_cube", "scene_suzanne",
                                  "scene_lucy"])
def test_intersect_all_bvh_equals_jax_eager_bitwise(name):
    jsd, tscene, _ = scene(name, 32, 32)
    jo, jd, to, td = both(*random_rays(jsd.scene, 256, seed=1))
    with jax.disable_jit():
        want_t, want_i = jtri.intersect_all_bvh(jsd.scene, jo, jd)
    t, i = ttri.intersect_all_bvh(tscene, to, td)
    np.testing.assert_array_equal(bits(want_t), bits(t.numpy()))
    np.testing.assert_array_equal(np.asarray(want_i), i.numpy())
    assert 0 < int((i >= 0).sum()) < i.numel()


@pytest.mark.parametrize("name", ["scene_cube", "scene_suzanne"])
def test_intersect_all_bruteforce_equals_jax_eager_bitwise(name):
    jsd, tscene, _ = scene(name)
    jo, jd, to, td = both(*random_rays(jsd.scene, 128, seed=2))
    with jax.disable_jit():
        want_t, want_i = jtri.intersect_all_bruteforce(jsd.scene, jo, jd)
    t, i = ttri.intersect_all_bruteforce(tscene, to, td)
    np.testing.assert_array_equal(bits(want_t), bits(t.numpy()))
    np.testing.assert_array_equal(np.asarray(want_i), i.numpy())
    assert 0 < int((i >= 0).sum()) < i.numel()


def tie_scene():
    """70 triangles: a far wall at z = -3, copies of one near quad at z = -1
    at rows 5, 31, 32 and 60 (ties across the 32-row blocks), the rest
    small and out of the way."""
    rs = np.random.RandomState(4)
    a = rs.uniform(5.0, 6.0, (70, 3)).astype(np.float32)
    b = a + np.float32(0.1)
    c = a + np.array([0.1, 0.0, 0.0], np.float32)
    for k, z, s in [(0, -3.0, 4.0), (5, -1.0, 1.0), (31, -1.0, 1.0),
                    (32, -1.0, 1.0), (60, -1.0, 1.0), (40, -2.0, 2.0),
                    (41, -2.0, 2.0)]:
        a[k], b[k], c[k] = (-s, -s, z), (s, -s, z), (-s, s, z)
    n = np.cross(b - a, c - a)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    fields = dict(a=a, b=b, c=c, normal=n.astype(np.float32),
                  mat_id=np.zeros(70, np.int32),
                  bmin=np.zeros((2, 3), np.float32),
                  bmax=np.zeros((2, 3), np.float32),
                  mat_albedo=np.full((1, 3), 0.5, np.float32),
                  mat_param=np.zeros(1, np.float32),
                  mat_kind=np.ones(1, np.int32))
    return (JaxTriangleScene(**{k: jnp.asarray(v) for k, v in
                                fields.items()}),
            convert.scene_from_numpy(fields, device="cpu"))


@pytest.mark.parametrize("block", [1, 4, 32, 256])
def test_bruteforce_picks_the_sequential_winner_on_exact_t_ties(block):
    """Rays at the near quad meet four identical copies at exactly the same
    t (rows 5, 31, 32, 60), rays beside it two at z = -2 (rows 40, 41): in
    any blocking the first row wins, as in the sequential scan."""
    jscene, tscene = tie_scene()
    rs = np.random.RandomState(5)
    o = np.zeros((64, 3), np.float32)
    o[:, 0:2] = rs.uniform(-1.8, 1.8, (64, 2))
    d = np.tile(np.array([[0.0, 0.0, -1.0]], np.float32), (64, 1))
    jo, jd, to, td = both(o, d)
    with jax.disable_jit():
        want_t, want_i = jtri.intersect_all_bruteforce(jscene, jo, jd)
    t, i = ttri.intersect_all_bruteforce(tscene, to, td, block=block)
    np.testing.assert_array_equal(bits(want_t), bits(t.numpy()))
    np.testing.assert_array_equal(np.asarray(want_i), i.numpy())
    assert {5, 40}.issubset(set(i.tolist()))
    assert not {31, 32, 60, 41} & set(i.tolist())


@pytest.mark.parametrize("name", ["test_scene_metal",
                                  "scene_rtiow_three_spheres",
                                  "scene_sphere_cover"])
def test_intersect_all_spheres_equals_jax_eager_bitwise(name):
    """scene_sphere_cover: 486 spheres, four blocks of the scan."""
    jsd, tscene, _ = scene(name)
    jo, jd, to, td = both(*random_rays(jsd.scene, 128, seed=3))
    with jax.disable_jit():
        want_t, want_i = jsphere.intersect_all_spheres(jsd.scene, jo, jd)
    t, i = tsphere.intersect_all_spheres(tscene, to, td)
    np.testing.assert_array_equal(bits(want_t), bits(t.numpy()))
    np.testing.assert_array_equal(np.asarray(want_i), i.numpy())
    assert 0 < int((i >= 0).sum()) < i.numel()


@pytest.mark.parametrize("name", ["scene_suzanne", "test_scene_metal"])
def test_hit_record_equals_jax_eager_bitwise(name):
    """Every field, on the JAX scan's own (t, idx), misses included."""
    jsd, tscene, _ = scene(name)
    jo, jd, to, td = both(*random_rays(jsd.scene, 128, seed=6))
    spheres = hasattr(jsd.scene, "center")
    jmod, tmod = (jsphere, tsphere) if spheres else (jtri, ttri)
    t, i = (jsphere.intersect_all_spheres if spheres
            else jtri.intersect_all_bruteforce)(jsd.scene, jo, jd)
    with jax.disable_jit():
        want = jmod.hit_record(jsd.scene, jo, jd, t, i)
    got = tmod.hit_record(tscene, to, td, torch.from_numpy(np.array(t)),
                          torch.from_numpy(np.array(i)))
    assert (np.asarray(t) == JFLT_MAX).any()
    for k, v in want.items():
        g = got[k].numpy()
        if g.dtype == np.float32:
            np.testing.assert_array_equal(bits(v), bits(g), err_msg=k)
        else:
            np.testing.assert_array_equal(np.asarray(v).astype(np.int64),
                                          g.astype(np.int64), err_msg=k)


def test_trailing_ones_and_slab_test_equal_jax():
    rs = np.random.RandomState(8)
    i = np.concatenate([rs.randint(0, 2**32, 500, dtype=np.uint64),
                        [0, 1, 2, 3, 7, 2**31 - 1, 2**32 - 2, 2**32 - 1]])
    want = np.asarray(jtri._trailing_ones(jnp.asarray(i.astype(np.uint32))))
    got = ttri._trailing_ones(torch.from_numpy(i.astype(np.int64)))
    np.testing.assert_array_equal(want.astype(np.int64), got.numpy())
    o, d = random_rays(scene("scene_cube")[0].scene, 256, seed=9)
    lo = rs.uniform(-2, 0, (256, 3)).astype(np.float32)
    hi = lo + rs.uniform(0, 2, (256, 3)).astype(np.float32)
    with jax.disable_jit():
        want = jtri.intersect_node_mask(*map(jnp.asarray, (o, d, lo, hi)))
    got = ttri.intersect_node_mask(*map(torch.from_numpy, (o, d, lo, hi)))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


# ---- (e) the oracle's images and records ------------------------------------

def eager_image(name, w, h, bounces):
    jsd, tscene, tcam = scene(name, w, h)
    jcfg = dataclasses.replace(jsd.config, bounces=bounces)
    with jax.disable_jit():
        want = np.asarray(jrender_color(jsd.scene, jsd.camera, jcfg,
                                        jnp.uint32(TIME)))
    got = oracle.render_color(tscene, tcam, port_config(jcfg), TIME, "cpu")
    return want, got.numpy()


@pytest.mark.parametrize("name,w,h,bounces", [
    ("test_scene_metal", 64, 32, 3), ("scene_rtiow_three_spheres", 64, 32, 3),
    ("scene_cube", 32, 16, 2)])
def test_oracle_render_color_equals_jax_eager_bitwise(name, w, h, bounces):
    want, got = eager_image(name, w, h, bounces)
    assert got.shape == (h, w, 3) and float(got.max() - got.min()) > 0.05
    np.testing.assert_array_equal(bits(want), bits(got))


def flipped(want, got):
    return float((np.abs(want - got).max(axis=-1) > FLIP_ABOVE).mean())


@pytest.mark.parametrize("name,dielectric", [
    ("test_scene_metal", False), ("scene_suzanne", False),
    ("scene_rtiow_three_spheres", True)])
def test_oracle_render_color_close_to_jitted_jax(name, dielectric):
    jsd, tscene, tcam = scene(name)
    jcfg = dataclasses.replace(jsd.config, bounces=3)
    want = np.asarray(jrender_color(jsd.scene, jsd.camera, jcfg,
                                    jnp.uint32(TIME)))
    got = oracle.render_color(tscene, tcam, port_config(jcfg), TIME,
                              "cpu").numpy()
    limit = FLIP_LIMIT
    if dielectric:
        kernel = np.asarray(jdispatch.render_color(
            jsd.scene, jsd.camera, dataclasses.replace(
                jcfg, backend="pallas", interpret=True), jnp.uint32(TIME),
            interpret=True))
        limit = DIELECTRIC_FACTOR * flipped(kernel, want)
        assert limit > FLIP_LIMIT         # the JAX pair itself is past it
    assert flipped(want, got) <= limit


@pytest.mark.parametrize("name,w,h,bounces", [
    ("test_scene_metal", 64, 32, 3), ("scene_cube", 32, 16, 2)])
def test_record_hits_oracle_equals_jax_eager_bitwise(name, w, h, bounces):
    jsd, tscene, tcam = scene(name, w, h)
    jcfg = dataclasses.replace(jsd.config, bounces=bounces)
    with jax.disable_jit():
        want_c, want_h = jrecord_hits_oracle(jsd.scene, jsd.camera, jcfg,
                                             jnp.uint32(TIME))
    color, hits = record_hits_oracle(tscene, tcam, port_config(jcfg), TIME,
                                     device="cpu")
    np.testing.assert_array_equal(bits(want_c), bits(color.numpy()))
    np.testing.assert_array_equal(np.asarray(want_h), hits.numpy())
    assert hits.dtype == torch.int32 and (hits >= 0).any()


def test_oracle_backend_through_the_renderer_and_the_cli(tmp_path):
    """``RenderConfig.backend="oracle"`` and ``--oracle``: the renderer
    keeps the scene unpacked and its first frame is the oracle's color; an
    unknown backend is refused."""
    sd = tscenes.scene_cube(32, 16, device="cpu")
    sd = dataclasses.replace(sd, config=dataclasses.replace(
        sd.config, bounces=2, backend="oracle"))
    r = ProgressiveRenderer(sd, device="cpu")
    r.set_time(TIME)
    r.draw()
    want = oracle.render_color(sd.scene, sd.camera, sd.config, TIME, "cpu")
    assert r._packed is sd.scene
    np.testing.assert_array_equal(bits(r.image), bits(want.numpy()))
    out = os.path.join(tmp_path, "o.ppm")
    assert cli.main(["--scene", "1", "--oracle", "--frames", "1", "--size",
                     "16x8", "--device", "cpu", "-o", out]) == 0
    with open(out) as f:
        dims, pixels = parse_ppm(f.read())
    assert dims.split()[:2] == ["16", "8"] and pixels.size == 16 * 8 * 3
    bad = dataclasses.replace(sd, config=dataclasses.replace(
        sd.config, backend="pallas"))
    with pytest.raises(ValueError, match="backend"):
        ProgressiveRenderer(bad, device="cpu").draw()
    with pytest.raises(ValueError, match="asked to render on"):
        oracle.render_color(sd.scene, sd.camera, sd.config, TIME)


# ---- (f) the differentiable renderer ----------------------------------------

def random_target(w=64, h=32, seed=7):
    return np.random.RandomState(seed).uniform(
        0.0, 1.0, (h, w, 3)).astype(np.float32)


@pytest.mark.parametrize("name,bounces", [("test_scene_metal", 3),
                                          ("scene_cube", 2)])
def test_diff_forward_equals_the_oracle(name, bounces):
    """Spheres: the same scan.  The cube: the brute-force scan and the BVH
    walk find the same hits here."""
    jsd, tscene, tcam = scene(name, 32, 16)
    cfg = port_config(dataclasses.replace(jsd.config, bounces=bounces))
    want = oracle.render_color(tscene, tcam, cfg, TIME, "cpu")
    got = render_color_diff(tscene, tcam, cfg, TIME)
    assert torch.equal(want, got.detach())


def numpy_fields(p):
    return {k: (None if v is None else np.array(v))
            for k, v in p._asdict().items()}


def assert_grads_agree(want, got, min_live=1):
    live = 0
    for k, j in want.items():
        j, t = np.asarray(j), got[k].detach().numpy()
        assert np.isfinite(t).all(), f"{k}: gradient not finite"
        scale = np.abs(j).max()
        if scale > 1e-6:
            live += 1
            err = np.abs(t - j).max() / scale
            assert err <= GRAD_RTOL, f"{k}: relative error {err:.2e}"
        else:
            assert np.abs(t).max() <= 2e-6, f"{k}: {np.abs(t).max():.2e}"
    assert live >= min_live, "every gradient is below 1e-6"


def live_spheres(jscene):
    """The JAX SphereArray cut to its live rows: the padding rows are never
    hit, and the eager JAX scan loops over every row in Python."""
    n = int((np.asarray(jscene.radius) > 0).sum())
    return type(jscene)(*(x[:n] for x in jscene))


def diff_losses(name, bounces, sky, w=32, h=16):
    jsd, _, tcam = scene(name, w, h)
    jsd = dataclasses.replace(jsd, scene=live_spheres(jsd.scene))
    tscene = U.port_spheres(jsd.scene)
    jcfg = dataclasses.replace(jsd.config, bounces=bounces,
                               sky_from_final_dir=sky)
    tcfg = port_config(jcfg)
    target = random_target(w, h)

    def jloss(p, cam=None):
        sc = jsd.scene if p is None else jsd.scene._replace(
            **{k: v for k, v in p._asdict().items() if v is not None})
        img = jrender_color_diff(sc, jsd.camera if cam is None
                                 else look_at_jnp(cam), jcfg,
                                 jnp.uint32(TIME), remat=False)
        return jimage_mse(img, jnp.asarray(target))

    def tloss(p, cam=None):
        sc = tscene if p is None else apply_params(tscene, p)
        img = render_color_diff(sc, tcam if cam is None else look_at(cam),
                                tcfg, TIME)
        return image_mse(img, torch.from_numpy(target))

    return jsd, jloss, tloss


def grads_of(loss, params):
    leaves = {k: v for k, v in params._asdict().items() if v is not None}
    out = torch.autograd.grad(loss, list(leaves.values()))
    return dict(zip(leaves, out))


@pytest.mark.parametrize("fields", [
    dict(albedo=True, mat_param=True),
    dict(albedo=False, center=True, radius=True)])
def test_diff_render_sphere_gradients_equal_jax_grad(fields):
    """Albedo and fuzz; centre and radius; under sky_from_final_dir (the
    transport term that sees fuzz and geometry)."""
    jsd, jloss, tloss = diff_losses("test_scene_metal", 2, True)
    jp = JSphereParams.from_scene(jsd.scene, **fields)
    with jax.disable_jit():
        want = jax.grad(jloss)(jp)
    tp = convert.sphere_params_from_numpy(numpy_fields(jp), "cpu")
    assert_grads_agree({k: v for k, v in want._asdict().items()
                        if v is not None}, grads_of(tloss(tp), tp),
                       min_live=len([v for v in fields.values() if v]))


def test_diff_render_camera_gradients_equal_jax_grad():
    jsd, jloss, tloss = diff_losses("test_scene_metal", 2, True)
    fields = dict(eye=(0.04, 0.3, 3.5), target=(0.01, 0.0, 0.0),
                  focal_length=3.5, focal_blur=0.04, fov=np.pi * 0.2)
    with jax.disable_jit():
        want = jax.grad(lambda c: jloss(None, c))(
            JCameraParams.create(**fields))
    tp = convert.camera_params_from_numpy(fields, "cpu")
    assert_grads_agree(want._asdict(), grads_of(tloss(None, tp), tp),
                       min_live=3)


def test_diff_render_vertex_gradients_equal_jax_and_reach_only_winners():
    """The all-metal cube under sky_from_final_dir, normals re-derived from
    the vertices: the reflected direction sees the winning triangle's
    normal.  Vertex gradients equal the JAX ones, and every triangle no ray
    hits gets none (the brute-force scan's ``where`` chain)."""
    jsd, tscene, tcam = scene("scene_cube", 32, 16)
    jscene = jsd.scene._replace(
        mat_kind=jnp.full_like(jsd.scene.mat_kind, 2),
        mat_param=jnp.zeros_like(jsd.scene.mat_param))
    tscene = tscene._replace(mat_kind=torch.full_like(tscene.mat_kind, 2),
                             mat_param=torch.zeros_like(tscene.mat_param))
    jcfg = dataclasses.replace(jsd.config, bounces=1, sky_from_final_dir=True,
                               mat_kinds=(2,))
    target = random_target(32, 16)
    jp = JTriangleParams.from_scene(jscene, albedo=False, vertices=True)
    with jax.disable_jit():
        want = jax.grad(lambda p: jimage_mse(jrender_color_diff(
            japply_tri_params(jscene, p), jsd.camera, jcfg, jnp.uint32(TIME),
            remat=False), jnp.asarray(target)))(jp)
    tp = convert.triangle_params_from_numpy(numpy_fields(jp), "cpu")
    tcfg = port_config(jcfg)
    got = grads_of(image_mse(render_color_diff(
        apply_tri_params(tscene, tp), tcam, tcfg, TIME),
        torch.from_numpy(target)), tp)
    assert_grads_agree({k: getattr(want, k) for k in "abc"}, got,
                       min_live=3)
    _, hits = record_hits_oracle(tscene, tcam, tcfg, TIME, device="cpu")
    never = torch.ones(tscene.m, dtype=torch.bool)
    never[hits[hits >= 0].long()] = False
    assert bool(never.any()) and not bool(never.all())
    for k in "abc":
        assert bool((got[k][never] == 0).all())


def test_finite_difference_check_passes_where_the_jax_one_does():
    """tests/test_grad.py's three cases: albedo, the camera through the sky
    of an empty scene, a triangle material."""
    sd = tscenes.test_scene_metal(64, 32, device="cpu")
    cfg = dataclasses.replace(sd.config, bounces=3)
    target = render_color_diff(sd.scene, sd.camera, cfg, 2000).detach()
    loss = lambda albedo: image_mse(render_color_diff(
        sd.scene._replace(albedo=albedo), sd.camera, cfg, TIME), target)
    max_rel, checks = finite_difference_check(loss, sd.scene.albedo,
                                              eps=1e-2, num_coords=6,
                                              rtol=0.2)
    assert max_rel <= 0.2 and len(checks) == 6

    empty = pack_spheres([], device="cpu")
    cfg2 = dataclasses.replace(cfg, bounces=2)
    target = render_color_diff(empty, sd.camera, cfg2, 2000).detach()
    cp = convert.camera_params_from_numpy(dict(
        eye=(0.0, 0.1, 3.5), target=(0.0, 0.0, 0.0), focal_length=3.5,
        focal_blur=0.04, fov=np.pi * 0.2), "cpu")
    loss = lambda p: image_mse(render_color_diff(empty, look_at(p), cfg2,
                                                 TIME), target)
    max_rel, _ = finite_difference_check(loss, cp, eps=1e-3, num_coords=8,
                                         rtol=0.25)
    assert max_rel <= 0.25

    cube = tscenes.scene_cube(64, 32, device="cpu")
    cfg3 = dataclasses.replace(cube.config, bounces=2)
    target = render_color_diff(cube.scene, cube.camera, cfg3, 2000).detach()
    loss = lambda p: image_mse(render_color_diff(
        apply_tri_params(cube.scene, p), cube.camera, cfg3, TIME), target)
    max_rel, _ = finite_difference_check(
        loss, TriangleParams.from_scene(cube.scene, albedo=True), eps=1e-2,
        num_coords=3, rtol=0.2)
    assert max_rel <= 0.2


def test_finite_difference_check_samples_the_jax_coordinates():
    """Over a dict of parameter tuples, one seed picks the same leaves and
    coordinates in both packages; a wrong gradient is caught."""
    rs = np.random.RandomState(10)
    fields = dict(albedo=rs.uniform(size=(5, 3)).astype(np.float32),
                  mat_param=rs.uniform(size=5).astype(np.float32))
    cam = dict(eye=(0.0, 0.1, 3.5), target=(0.0, 0.0, 0.0),
               focal_length=3.5, focal_blur=0.04, fov=0.6)
    jparams = {"scene": JSphereParams(**{k: jnp.asarray(v)
                                         for k, v in fields.items()}),
               "camera": JCameraParams.create(**cam)}
    tparams = {"scene": convert.sphere_params_from_numpy(fields, "cpu"),
               "camera": convert.camera_params_from_numpy(cam, "cpu")}
    jsq = lambda p: sum(jnp.sum(x * x) for x in jax.tree_util.tree_leaves(p))
    tsq = lambda p: sum(torch.sum(x * x) for d in p.values() for x in d
                        if x is not None)
    _, want = jfd(jsq, jparams, num_coords=9, seed=3)
    _, got = finite_difference_check(tsq, tparams, num_coords=9, seed=3)
    assert [(c[0], tuple(c[1])) for c in got] == \
        [(c[0], tuple(c[1])) for c in want]
    # a loss whose autograd gradient is half the true one
    detached = lambda p: {k: type(v)(*(None if x is None else x.detach()
                                       for x in v)) for k, v in p.items()}
    with pytest.raises(AssertionError, match="grad mismatch"):
        finite_difference_check(lambda p: tsq(p) + tsq(detached(p)),
                                tparams, num_coords=9, seed=3)


def test_replay_gradients_equal_diff_renderer_gradients():
    """At the recording point the replay and the full renderer take the
    same branches: albedo and fuzz gradients; centre and radius under
    sky_from_final_dir (tests/test_replay.py's tolerances there: 5e-6
    absolute, 2e-3 relative)."""
    for fields, sky, tol in [
            (dict(albedo=True, mat_param=True), False, dict(atol=1e-6,
                                                            rtol=1e-4)),
            (dict(albedo=False, center=True, radius=True), True,
             dict(atol=5e-6, rtol=2e-3))]:
        sd = tscenes.test_scene_metal(64, 32, device="cpu")
        cfg = dataclasses.replace(sd.config, bounces=3,
                                  sky_from_final_dir=sky)
        target = render_color_diff(sd.scene, sd.camera, cfg, 2000).detach()
        _, hits = record_hits_oracle(sd.scene, sd.camera, cfg, TIME,
                                     device="cpu")
        rloss = replay_loss_fn(sd.scene, sd.camera, cfg, target, hits, TIME)
        p = SphereParams.from_scene(sd.scene, **fields)
        p = SphereParams(*(None if v is None else v.clone().requires_grad_()
                           for v in p))
        g_r = grads_of(rloss(p), p)
        g_d = grads_of(image_mse(render_color_diff(
            apply_params(sd.scene, p), sd.camera, cfg, TIME), target), p)
        for k in g_r:
            # fuzz reaches the color only through the final direction
            assert k == "mat_param" or float(g_r[k].abs().max()) > 0.0
            np.testing.assert_allclose(g_r[k].numpy(), g_d[k].numpy(), **tol)


# ---- (g) the loops ----------------------------------------------------------

def test_fit_replay_with_the_oracle_recorder_on_lucy_equals_jax():
    """lucy 32x32, 2 bounces: the oracle walks the BVH of 20K triangles;
    three steps with a re-record after two, the mesh's material wrong."""
    jsd, tscene, tcam = scene("scene_lucy", 32, 32)
    jcfg = dataclasses.replace(jsd.config, bounces=2)
    tcfg = port_config(jcfg)
    target, _ = record_hits_oracle(tscene, tcam, tcfg, TIME, device="cpu")
    wrong = np.asarray(jsd.scene.mat_albedo).copy()
    wrong[0] = (0.9, 0.2, 0.1)
    kw = dict(time=TIME, steps=3, rerecord_every=2, learning_rate=5e-2)
    _, jlosses = jfit_replay(
        jsd.scene._replace(mat_albedo=jnp.asarray(wrong)), jsd.camera, jcfg,
        jnp.asarray(target.numpy()), recorder="oracle", gather_mode="take",
        **kw)
    start = tscene._replace(mat_albedo=torch.from_numpy(wrong))
    params, losses = fit_replay(start, tcam, tcfg, target, recorder="oracle",
                                device="cpu", **kw)
    assert losses[-1] < losses[0]
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL, atol=0)
    with pytest.raises(ValueError, match="recorder"):
        fit_replay(start, tcam, tcfg, target, recorder="pallas",
                   device="cpu", steps=1)


def test_fit_on_a_sphere_scene_equals_jax():
    """The full differentiable renderer in the loop: three Adam steps from
    a wrong albedo, two progressive frames a step."""
    jsd, tscene, tcam = scene("test_scene_metal", 32, 16)
    jcfg = dataclasses.replace(jsd.config, bounces=2)
    times = (1000, 1010)
    with torch.no_grad():
        target = render_image_diff(tscene, tcam, port_config(jcfg),
                                   times).numpy()
    wrong = np.asarray(jsd.scene.albedo).copy()
    wrong[1] = (0.1, 0.9, 0.1)
    kw = dict(times=times, steps=3, learning_rate=5e-2, optimize_scene=False)
    _, jlosses = jfit(jsd.scene, jsd.camera, jcfg, jnp.asarray(target),
                      init_params={"scene": JSphereParams(
                          albedo=jnp.asarray(wrong))}, **kw)
    start = convert.sphere_params_from_numpy(dict(albedo=wrong), "cpu")
    params, losses = fit(tscene, tcam, port_config(jcfg), target,
                         init_params={"scene": start}, device="cpu", **kw)
    assert losses[-1] < losses[0]
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL, atol=0)
    assert not params["scene"].albedo.requires_grad
    with pytest.raises(ValueError, match="optimize_camera"):
        fit(tscene, tcam, port_config(jcfg), target, optimize_camera=True,
            steps=1, device="cpu")
