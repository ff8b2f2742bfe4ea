"""The training path of the port against the JAX package's: the replay
forward, its gradients, and ``fit_replay``, from the same hits and the same
converted start state.  64x32 images, at most 3 bounces, fits of 10 steps.

The JAX functions run two ways.  EAGERLY (``jax.disable_jit``), every jnp
op is its own rounded XLA op: the replay forward must then be bit-equal,
and the gradients (``jax.grad`` against ``torch.autograd.grad``) agree
within 1e-4 of the leaf's largest entry, on leaves whose largest entry is
above 1e-6; every entry finite.  JITTED, as a user runs them, XLA's CPU
compiler fuses the scan body and contracts multiply-adds: forward within
1e-5 absolute per channel, a pixel beyond it counts as a flip (a discrete
arm taken the other way by a last-bit difference) and at most 0.5 % of
pixels may flip (2 % with a dielectric).  Geometry gradients amplify those
last bits past 1e-4 (the JAX package holds its own two differentiable
renderers to 2e-3 there, tests/test_replay.py), which is why the gradients
are held to the eager run.  Loss curve of a fit, jitted: 1e-4 relative.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rt.config import MAT_METAL
from rt.grad import CameraParams as JCameraParams
from rt.grad import SphereParams as JSphereParams
from rt.grad import TriangleParams as JTriangleParams
from rt.grad import replay as jreplay
from rt.grad.train import fit_replay as jfit_replay
from rt.scene import scenes as jscenes
from rt_torch import convert
from rt_torch.config import RenderConfig
from rt_torch.grad import (TriangleParams, fit_replay, image_mse,
                           golden_mae_percent, record_hits, replay_color,
                           replay_loss_fn)
from rt_torch.grad.train import _tri_scene_params
from rt_torch.kernels import replay_kernel as rk
from rt_torch.utils import profiling
import test_torch_parity_util as U
from _torch_threads import one_torch_thread  # noqa: F401

W, H, TILE = 64, 32, (16, 128)
TIME = 1000
CLOSE = 1e-5
FLIP_LIMIT = 0.005
# a dielectric takes its reflect-or-refract arm by comparing the Schlick
# reflectance with a draw, and re-hits its own sphere at t ~ 0: last-bit
# differences flip more of its pixels (found: 0.9 % on test_scene_complex,
# 0.3 % on test_scene_dielectric)
DIELECTRIC_FLIP_LIMIT = 0.02
GRAD_RTOL = 1e-4
LOSS_RTOL = 1e-4
# outputs of the jitted JAX fits, kept in tests/jax_refs (the suite does not
# compile a whole fit of the JAX package)
REFS = U.JaxRefs(__file__)


@functools.lru_cache(maxsize=None)
def setup(name, bounces=3, sky=False, all_metal=False):
    """(JAX scene, camera, config; port scene, camera, config; the port
    recorder's hits as int32 NumPy) of one scene."""
    jsd = getattr(jscenes, name)(W, H)
    jscene = jsd.scene
    if all_metal:
        # fuzz-free metal: the scatter is the pure reflect, smooth in the
        # face normal, so vertex gradients are not structurally zero
        jscene = jscene._replace(
            mat_kind=jnp.full_like(jscene.mat_kind, MAT_METAL),
            mat_param=jnp.zeros_like(jscene.mat_param))
    jcfg = dataclasses.replace(jsd.config, bounces=bounces,
                               sky_from_final_dir=sky)
    spheres = hasattr(jscene, "center")
    if spheres:
        tscene = U.port_spheres(jscene)
        tcfg = RenderConfig.for_spheres(
            W, H, bounces=bounces, sky_from_final_dir=sky, tile=TILE,
            n_active_spheres=jcfg.n_active_spheres)
    else:
        tscene = U.port_scene(jscene)
        tcfg = RenderConfig.for_triangles(W, H, bounces=bounces,
                                          sky_from_final_dir=sky, tile=TILE)
    tcam = U.port_camera(jsd.camera)
    _, hits = record_hits(tscene, tcam, tcfg, TIME, device="cpu")
    return jscene, jsd.camera, jcfg, tscene, tcam, tcfg, hits.numpy()


def random_target(seed=7):
    """A target far from every render, so the loss and its gradients are
    large against f32 noise."""
    return np.random.RandomState(seed).uniform(
        0.0, 1.0, (H, W, 3)).astype(np.float32)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,kw,flip_limit", [
    ("test_scene_metal", {}, FLIP_LIMIT),
    ("test_scene_dielectric", {}, DIELECTRIC_FLIP_LIMIT),
    ("test_scene_complex", dict(sky=True), DIELECTRIC_FLIP_LIMIT),
    ("scene_suzanne", {}, FLIP_LIMIT),
    ("scene_cube", dict(sky=True, all_metal=True), FLIP_LIMIT)])
def test_replay_forward_equals_jax_replay(name, kw, flip_limit):
    jscene, jcam, jcfg, tscene, tcam, tcfg, hits = setup(name, **kw)
    jreplay_color = lambda: np.asarray(jreplay.replay_color(
        jscene, jcam, jcfg, jnp.uint32(TIME), jnp.asarray(hits),
        gather_mode="take"))
    with torch.no_grad():
        got = replay_color(tscene, tcam, tcfg, TIME,
                           torch.from_numpy(hits.copy())).numpy()
    assert got.shape == (H, W, 3) and np.isfinite(got).all()
    with jax.disable_jit():
        eager = jreplay_color()
    assert np.array_equal(eager.view(np.int32), got.view(np.int32))
    flips = (np.abs(jreplay_color() - got) > CLOSE).any(axis=-1).mean()
    assert flips <= flip_limit, f"{flips:.4f} of pixels differ"


@pytest.mark.parametrize("name,kw", [
    ("test_scene_metal", {}), ("test_scene_dielectric", {}),
    ("scene_suzanne", {}), ("scene_quad", dict(sky=True))])
def test_replay_reproduces_the_recorders_color(name, kw):
    """At the recording point the replayed transport is the recorded one:
    the same rays, the same winner, the same scatter."""
    *_, tscene, tcam, tcfg, hits = setup(name, **kw)
    color, rec = record_hits(tscene, tcam, tcfg, TIME, device="cpu")
    assert np.array_equal(rec.numpy(), hits)
    with torch.no_grad():
        img = replay_color(tscene, tcam, tcfg, TIME, rec)
        unrolled = replay_color(tscene, tcam, tcfg, TIME, rec, remat=False,
                                frozen_geometry=False)
    assert torch.equal(img, unrolled)
    flips = ((img - color).abs() > CLOSE).any(dim=-1).float().mean()
    assert float(flips) == 0.0


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------

def assert_grads_agree(want: dict, got: dict, min_live=1):
    live = 0
    for k, j in want.items():
        j = np.asarray(j)
        t = got[k].numpy()
        assert np.isfinite(t).all(), f"{k}: gradient not finite"
        scale = np.abs(j).max()
        if scale > 1e-6:
            live += 1
            err = np.abs(t - j).max() / scale
            assert err <= GRAD_RTOL, f"{k}: relative error {err:.2e}"
        else:
            assert np.abs(t).max() <= 2e-6, f"{k}: {np.abs(t).max():.2e}"
    assert live >= min_live, "every gradient is below 1e-6"


def grads_of(loss, params):
    leaves = {k: v for k, v in params._asdict().items() if v is not None}
    out = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return {k: (torch.zeros_like(v) if g is None else g)
            for (k, v), g in zip(leaves.items(), out)}


def both_losses(name, kw, frozen_geometry=True):
    jscene, jcam, jcfg, tscene, tcam, tcfg, hits = setup(name, **kw)
    target = random_target()
    jloss = jreplay.replay_loss_fn(
        jscene, jcam, jcfg, jnp.asarray(target), jnp.asarray(hits),
        TIME, gather_mode="take", frozen_geometry=frozen_geometry)
    tloss = replay_loss_fn(tscene, tcam, tcfg, target,
                           torch.from_numpy(hits.copy()), TIME,
                           frozen_geometry=frozen_geometry)
    return jscene, jloss, tloss


def numpy_fields(p):
    return {k: (None if v is None else np.array(v))
            for k, v in p._asdict().items()}


def eager_grad(f, x):
    with jax.disable_jit():
        return jax.grad(f)(x)


@pytest.mark.parametrize("name,fields", [
    ("test_scene_metal", dict(albedo=True, mat_param=True)),
    ("test_scene_dielectric", dict(albedo=True, mat_param=True)),
    ("test_scene_metal", dict(albedo=False, center=True, radius=True)),
    ("test_scene_complex", dict(albedo=True, mat_param=True, center=True,
                                radius=True))])
def test_sphere_gradients_equal_jax_grad(name, fields):
    """Albedo and fuzz/IOR; centre and radius under sky_from_final_dir (the
    transport term that sees geometry)."""
    kw = dict(sky=True)
    jscene, jloss, tloss = both_losses(name, kw)
    jp = JSphereParams.from_scene(jscene, **fields)
    want = eager_grad(lambda p: jloss(p), jp)
    tp = convert.sphere_params_from_numpy(numpy_fields(jp), "cpu")
    loss = tloss(tp)
    assert abs(float(loss.detach()) - float(jloss(jp))) \
        <= LOSS_RTOL * float(loss.detach())
    assert_grads_agree({k: v for k, v in want._asdict().items()
                        if v is not None}, grads_of(loss, tp),
                       min_live=len([v for v in fields.values() if v]))


def test_material_gradients_equal_jitted_jax_grad():
    """Against the jitted jax.grad, as a user runs it: albedo gradients of
    the metal scene are well conditioned and hold 1e-4 there too."""
    jscene, jloss, tloss = both_losses("test_scene_metal", {})
    jp = JSphereParams.from_scene(jscene, albedo=True)
    want = jax.grad(lambda p: jloss(p))(jp)
    tp = convert.sphere_params_from_numpy(numpy_fields(jp), "cpu")
    assert_grads_agree({"albedo": want.albedo}, grads_of(tloss(tp), tp))


@pytest.mark.parametrize("frozen_geometry", [True, False])
def test_suzanne_material_gradients_equal_jax_grad(frozen_geometry):
    jscene, jloss, tloss = both_losses("scene_suzanne", {}, frozen_geometry)
    jp = JTriangleParams.from_scene(jscene, albedo=True, param=True)
    want = eager_grad(lambda p: jloss(p), jp)
    tp = convert.triangle_params_from_numpy(numpy_fields(jp), "cpu")
    assert_grads_agree({"mat_albedo": want.mat_albedo,
                        "mat_param": want.mat_param},
                       grads_of(tloss(tp), tp))


def test_suzanne_albedo_on_the_replay_kernel_path_equals_jax_grad():
    """``fit_replay``'s path for an albedo alone on triangles
    (``replay_kernel.replay_loss_grad``, its plain version here) against
    the eager jax.grad of the JAX replay loss on the same hits."""
    jscene, jcam, jcfg, tscene, tcam, tcfg, hits = setup("scene_suzanne")
    target = random_target()
    jloss = jreplay.replay_loss_fn(jscene, jcam, jcfg, jnp.asarray(target),
                                   jnp.asarray(hits), TIME,
                                   gather_mode="take")
    jp = JTriangleParams.from_scene(jscene, albedo=True)
    want = eager_grad(lambda p: jloss(p), jp)
    with jax.disable_jit():
        jvalue = float(jloss(jp))
    loss, grad = rk.replay_loss_grad(tscene, tcam, tcfg, TIME,
                                     torch.from_numpy(hits.copy()),
                                     torch.from_numpy(target))
    assert abs(float(loss) - jvalue) <= LOSS_RTOL * jvalue
    assert_grads_agree({"mat_albedo": want.mat_albedo},
                       {"mat_albedo": grad})


def test_frozen_geometry_does_not_change_material_gradients():
    *_, tscene, tcam, tcfg, hits = setup("scene_suzanne")
    target = random_target()
    got = {}
    for fg in (True, False):
        loss = replay_loss_fn(tscene, tcam, tcfg, target,
                              torch.from_numpy(hits.copy()), TIME,
                              frozen_geometry=fg)
        tp = convert.triangle_params_from_numpy(
            dict(mat_albedo=tscene.mat_albedo.numpy(),
                 mat_param=tscene.mat_param.numpy()), "cpu")
        got[fg] = grads_of(loss(tp), tp)
    for k in got[True]:
        assert torch.equal(got[True][k], got[False][k])


def test_vertex_gradients_equal_jax_grad():
    kw = dict(sky=True, all_metal=True, bounces=2)
    jscene, jloss, tloss = both_losses("scene_cube", kw,
                                       frozen_geometry=False)
    jp = JTriangleParams.from_scene(jscene, albedo=False, vertices=True)
    want = eager_grad(lambda p: jloss(p), jp)
    tp = convert.triangle_params_from_numpy(numpy_fields(jp), "cpu")
    assert_grads_agree({k: getattr(want, k) for k in "abc"},
                       grads_of(tloss(tp), tp), min_live=3)
    # a triangle collapsed to a point: the normal's norm clamp keeps the
    # loss finite, the same loss as the JAX package's (the gradient of the
    # collapsed triangle itself is finite in neither package)
    flat = numpy_fields(jp)
    flat["b"][0] = flat["a"][0]
    flat["c"][0] = flat["a"][0]
    with torch.no_grad():
        loss = tloss(convert.triangle_params_from_numpy(flat, "cpu"))
    with jax.disable_jit():
        jflat = float(jloss(JTriangleParams(
            **{k: jnp.asarray(v) for k, v in flat.items() if v is not None})))
    assert torch.isfinite(loss)
    assert abs(float(loss) - jflat) <= LOSS_RTOL * jflat


@pytest.mark.parametrize("name,kw", [
    ("test_scene_metal", dict(sky=True)),
    ("scene_cube", dict(sky=True, all_metal=True, bounces=2))])
def test_camera_gradients_equal_jax_grad(name, kw):
    jscene, jloss, tloss = both_losses(name, kw)
    fields = dict(eye=(0.04, 0.3, 3.5), target=(0.01, 0.0, 0.0),
                  focal_length=3.5, focal_blur=0.04, fov=np.pi * 0.2)
    want = eager_grad(lambda p: jloss(None, p),
                      JCameraParams.create(**fields))
    tp = convert.camera_params_from_numpy(fields, "cpu")
    assert_grads_agree(want._asdict(), grads_of(tloss(None, tp), tp),
                       min_live=3)


# ---------------------------------------------------------------------------
# fit_replay
# ---------------------------------------------------------------------------

def test_fit_replay_loss_curve_equals_jax():
    """Ten steps with one re-record from the same wrong albedos.  The JAX
    side records with its oracle; its hits at the start are the port
    recorder's (compared first)."""
    jscene, jcam, jcfg, tscene, tcam, tcfg, hits = setup("test_scene_metal")
    _, jhits = jreplay.record_hits_oracle(jscene, jcam, jcfg,
                                          jnp.uint32(TIME))
    assert np.array_equal(np.asarray(jhits), hits)
    target, _ = record_hits(tscene, tcam, tcfg, TIME, device="cpu")
    wrong = np.asarray(jscene.albedo).copy()
    wrong[1] = (0.1, 0.9, 0.1)
    wrong[2] = (0.9, 0.2, 0.6)
    kw = dict(time=TIME, steps=10, rerecord_every=5, learning_rate=5e-2)
    jparams, jlosses = jfit_replay(
        jscene, jcam, jcfg, jnp.asarray(target.numpy()),
        init_params={"scene": JSphereParams(albedo=jnp.asarray(wrong))},
        recorder="oracle", gather_mode="take", **kw)
    start = convert.sphere_params_from_numpy(dict(albedo=wrong), "cpu")
    params, losses = fit_replay(tscene, tcam, tcfg, target,
                                init_params={"scene": start}, device="cpu",
                                **kw)
    assert len(losses) == 10 and losses[-1] < 0.5 * losses[0]
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL, atol=0)
    np.testing.assert_allclose(params["scene"].albedo.numpy(),
                               np.asarray(jparams["scene"].albedo),
                               rtol=0, atol=1e-3)
    # the caller's start state is not updated in place
    assert np.array_equal(start.albedo.detach().numpy(), wrong)
    assert not params["scene"].albedo.requires_grad


def test_fit_replay_on_suzanne_recovers_a_material():
    """The main path's shape at thumbnail size: K9's plain version records,
    the frozen-geometry replay steps."""
    *_, tscene, tcam, tcfg, _ = setup("scene_suzanne")
    target, _ = record_hits(tscene, tcam, tcfg, TIME, device="cpu")
    albedo = tscene.mat_albedo.clone()
    albedo[0] = albedo.new_tensor([0.8, 0.1, 0.1])
    bad = tscene._replace(mat_albedo=albedo)
    params, losses = fit_replay(bad, tcam, tcfg, target, time=TIME, steps=12,
                                rerecord_every=6, learning_rate=5e-2,
                                device="cpu")
    assert np.isfinite(losses).all() and losses[-1] < 0.2 * losses[0]
    before = (albedo[0] - tscene.mat_albedo[0]).abs().max()
    after = (params["scene"].mat_albedo[0] - tscene.mat_albedo[0]).abs().max()
    assert float(after) < 0.5 * float(before)


def test_fit_replay_suzanne_albedo_loss_curve_equals_jax():
    """Ten steps with one re-record from a wrong material 0, Suzanne's
    albedo alone: the port on the replay kernel's path (its plain version
    here) against the JAX package's jitted fit, which records with its
    oracle (its hits at the start are the port recorder's, compared
    first).  The JAX side's losses and albedo are kept in
    tests/jax_refs."""
    jscene, jcam, jcfg, tscene, tcam, tcfg, hits = setup("scene_suzanne")
    target, _ = record_hits(tscene, tcam, tcfg, TIME, device="cpu")
    wrong = np.asarray(jscene.mat_albedo).copy()
    wrong[0] = (0.8, 0.1, 0.1)
    kw = dict(time=TIME, steps=10, rerecord_every=5, learning_rate=5e-2)

    def jax_fit():
        _, jhits = jreplay.record_hits_oracle(jscene, jcam, jcfg,
                                              jnp.uint32(TIME))
        assert np.array_equal(np.asarray(jhits), hits)
        jparams, jlosses = jfit_replay(
            jscene, jcam, jcfg, jnp.asarray(target.numpy()),
            init_params={"scene": JTriangleParams(
                mat_albedo=jnp.asarray(wrong))},
            recorder="oracle", gather_mode="take", **kw)
        return dict(losses=np.asarray(jlosses, np.float64),
                    albedo=np.asarray(jparams["scene"].mat_albedo))

    ref = REFS("fit_replay_suzanne_albedo", jax_fit)
    start = convert.triangle_params_from_numpy(dict(mat_albedo=wrong), "cpu")
    before = profiling.counters()["replay_kernel_steps"]
    params, losses = fit_replay(tscene, tcam, tcfg, target,
                                init_params={"scene": start}, device="cpu",
                                **kw)
    assert profiling.counters()["replay_kernel_steps"] - before == 10
    assert len(losses) == 10 and losses[-1] < 0.5 * losses[0]
    np.testing.assert_allclose(losses, ref["losses"], rtol=LOSS_RTOL, atol=0)
    np.testing.assert_allclose(params["scene"].mat_albedo.numpy(),
                               ref["albedo"], rtol=0, atol=1e-3)


def test_fit_replay_loss_weight_of_ones_is_no_weight():
    *_, tscene, tcam, tcfg, _ = setup("test_scene_metal")
    target, _ = record_hits(tscene, tcam, tcfg, TIME, device="cpu")
    albedo = tscene.albedo.clone()
    albedo[1] = albedo.new_tensor([0.9, 0.1, 0.1])
    bad = tscene._replace(albedo=albedo)
    kw = dict(time=TIME, steps=4, rerecord_every=2, learning_rate=5e-2,
              device="cpu")
    _, ref = fit_replay(bad, tcam, tcfg, target, **kw)
    _, ones = fit_replay(bad, tcam, tcfg, target,
                         loss_weight=np.ones((H, W), np.float32), **kw)
    np.testing.assert_allclose(ones, ref, rtol=1e-6, atol=0)
    half = np.zeros((H, W), np.float32)
    half[:, :W // 2] = 1.0
    _, masked = fit_replay(bad, tcam, tcfg, target, loss_weight=half, **kw)
    assert np.isfinite(masked).all() and masked != ref


def test_fit_replay_carries_camera_params():
    *_, tscene, tcam, tcfg, _ = setup("test_scene_metal", sky=True)
    target, _ = record_hits(tscene, tcam, tcfg, TIME, device="cpu")
    fields = dict(eye=(0.04, -0.02, 3.5), target=(0.0, 0.0, 0.0),
                  focal_length=3.5, focal_blur=0.04, fov=np.pi * 0.2)
    cp0 = convert.camera_params_from_numpy(fields, "cpu")
    params, losses = fit_replay(
        tscene, tcam, tcfg, target, time=TIME, steps=4, rerecord_every=2,
        learning_rate=1e-3, scene_fields=dict(albedo=False),
        init_params={"camera": cp0}, device="cpu")
    assert np.isfinite(losses).all()
    for a, b in zip(params["camera"], cp0):
        assert float((a - b.detach()).abs().max()) > 0.0
    assert all(v is None for v in params["scene"])


def test_vertex_fields_need_unfrozen_geometry():
    *_, tscene, tcam, tcfg, hits = setup("scene_cube", bounces=2)
    target, _ = record_hits(tscene, tcam, tcfg, TIME, device="cpu")
    start = TriangleParams.from_scene(tscene, vertices=True)
    with pytest.raises(ValueError, match="frozen_geometry"):
        fit_replay(tscene, tcam, tcfg, target, steps=1,
                   init_params={"scene": start}, device="cpu")
    with pytest.raises(ValueError, match="frozen_geometry"):
        fit_replay(tscene, tcam, tcfg, target, steps=1,
                   scene_fields=dict(vertices=True), device="cpu")
    loss = replay_loss_fn(tscene, tcam, tcfg, target,
                          torch.from_numpy(hits.copy()), TIME)
    with pytest.raises(ValueError, match="frozen_geometry"):
        loss(start)
    with pytest.raises(ValueError, match="not supported"):
        _tri_scene_params(tscene, dict(center=True))
    assert _tri_scene_params(tscene, dict(mat_param=True,
                                          center=False)).mat_param is not None


def test_auto_routes_a_large_mesh_to_the_wave_recorder(monkeypatch):
    """Above 8192 triangles ``"auto"`` records through the sorted stream
    (K10a/K10b on a card, their plain versions here) and returns scene-order
    ids; an unknown backend and a scene on another device than asked are
    refused."""
    from rt_torch.kernels import tris_kernel as ttk

    *_, tscene, tcam, tcfg, _ = setup("scene_cube", bounces=2)
    # 8208 triangles: the cube's 36 228 times over (one bounce keeps the
    # plain version's Python loop over 257 chunks short)
    big = tscene._replace(**{k: getattr(tscene, k).repeat(
        228, *([1] * (getattr(tscene, k).dim() - 1)))
        for k in ("a", "b", "c", "normal", "mat_id")})
    calls = []
    wave = ttk.render_color_tris_wave_record
    monkeypatch.setattr(ttk, "render_color_tris_wave_record",
                        lambda *a, **k: calls.append(1) or wave(*a, **k))
    color, hits = record_hits(big, tcam, dataclasses.replace(tcfg, bounces=1),
                              TIME, device="cpu")
    assert calls == [1] and big.m == 8208
    assert hits.shape == (1, H, W) and int(hits.max()) < big.m
    assert bool((hits >= 0).any()) and torch.isfinite(color).all()
    with pytest.raises(ValueError, match="tris_backend"):
        record_hits(tscene, tcam, tcfg, TIME, device="cpu",
                    tris_backend="oracle")
    with pytest.raises(ValueError, match="asked to render on"):
        record_hits(tscene, tcam, tcfg, TIME)             # default: the card


# ---------------------------------------------------------------------------
# losses and converters
# ---------------------------------------------------------------------------

def test_losses_equal_jax():
    from rt.grad import loss as jloss

    rs = np.random.RandomState(3)
    a = rs.uniform(-0.1, 1.2, (H, W, 3)).astype(np.float32)
    b = rs.uniform(0.0, 1.0, (H, W, 3)).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_allclose(float(image_mse(ta, tb)),
                               float(jloss.image_mse(a, b)), rtol=1e-6)
    np.testing.assert_allclose(float(golden_mae_percent(ta, tb)),
                               float(jloss.golden_mae_percent(a, b)),
                               rtol=1e-6)


def test_parameter_converters_make_leaves_of_the_set_fields():
    p = convert.sphere_params_from_numpy(
        dict(albedo=np.zeros((4, 3)), mat_param=None), "cpu")
    assert p.albedo.requires_grad and p.albedo.is_leaf
    assert p.albedo.dtype == torch.float32
    assert p.mat_param is None and p.center is None
    with pytest.raises(ValueError, match="no field"):
        convert.triangle_params_from_numpy(dict(albedo=np.zeros(3)), "cpu")
    with pytest.raises(TypeError):
        convert.camera_params_from_numpy(dict(eye=np.zeros(3)), "cpu")
