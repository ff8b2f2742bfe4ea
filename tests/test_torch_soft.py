"""The port's sphere soft-visibility surrogate (``rt_torch.grad.soft``)
against the JAX package's (``rt.grad.soft``), on the same scene, camera and
target converted from NumPy; 48x32 images, one torch thread a test.

The JAX side of every comparison is the output of the JAX function on the
test's own seeded inputs, kept bit for bit in ``tests/jax_refs/`` (see
``test_torch_parity_util.JaxRefs``): eager JAX compiles every primitive on
its first call (the forward's ~9 s here, its gradient's as much again),
more than the CPU suite can spend.  ``RT_TORCH_JAX_REFS=check pytest
tests/test_torch_soft.py`` runs the JAX functions again and requires their
outputs bit-equal to the stored ones; ``=write`` makes them anew.

The forward is held against the JAX function run EAGERLY
(``jax.disable_jit``).  It is not bit-equal: XLA's CPU ``exp`` (in the
softmax), ``logistic`` (sigmoid) and ``log`` round some inputs an ULP away
from ATen's, and XLA's depth ``einsum`` is a fused multiply-add chain
where the port rounds each product, so it is held to 1e-6 absolute
(measured maximum 6.6e-7, on ``test_scene_dielectric``; ``pytest -s``
prints it).

Gradients and the recovery loops are held against the JAX functions as a
user runs them, jitted.  Gradients (``jax.grad`` against
``torch.autograd``) agree within 1e-4 of the leaf's largest entry; the
loss curves and returned parameters within 1e-4 relative (``optax.adam``
against ``torch.optim.Adam``).

The recoveries themselves (tests/test_grad.py's camera, fov and geometry
recovery) are too slow for the CPU suite; they run on a card in
tests/test_torch_gpu.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rt.grad import CameraParams as JCameraParams
from rt.grad import SphereParams as JSphereParams
from rt.grad import look_at_jnp
from rt.grad import soft as jsoft
from rt.scene import scenes as jscenes
from rt_torch import convert
from rt_torch.config import RenderConfig
from rt_torch.grad import soft
import test_torch_parity_util as U
from _torch_threads import one_torch_thread  # noqa: F401

W, H = 48, 32
TIME = 1000
FORWARD_ATOL = 1e-6
GRAD_RTOL = 1e-4
CURVE_RTOL = 1e-4
CAMERA = dict(eye=(0.15, 0.1, 3.4), target=(0.0, 0.0, 0.0),
              focal_length=3.5, focal_blur=0.04, fov=np.pi * 0.2)
REFS = U.JaxRefs(__file__)


def setup(name="test_scene_metal", bounces=2):
    jsd = getattr(jscenes, name)(W, H)
    jcfg = dataclasses.replace(jsd.config, bounces=bounces)
    tcfg = RenderConfig.for_spheres(W, H, bounces=bounces,
                                    n_active_spheres=jcfg.n_active_spheres)
    return (jsd.scene, jsd.camera, jcfg, U.port_spheres(jsd.scene),
            U.port_camera(jsd.camera), tcfg)


def random_target(seed=3):
    return np.random.RandomState(seed).uniform(
        0.0, 1.0, (H, W, 3)).astype(np.float32)


def eager(f, *args):
    with jax.disable_jit():
        return f(*args)


def max_rel(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / np.abs(want).max()


@pytest.mark.parametrize("name", ["test_scene_metal",
                                  "test_scene_dielectric"])
def test_soft_render_equals_jax(name):
    jscene, jcam, jcfg, tscene, tcam, tcfg = setup(name)
    want = REFS(f"soft_render/{name}", lambda: eager(
        jsoft.soft_render, jscene, jcam, jcfg, jnp.uint32(TIME)))
    with torch.no_grad():
        got = soft.soft_render(tscene, tcam, tcfg, TIME).numpy()
    assert got.shape == (H, W, 3) and np.isfinite(got).all()
    err = np.abs(got - want).max()
    print(f"soft_render {name}: max abs difference {err:.3g}")  # with -s
    assert err <= FORWARD_ATOL


def test_soft_camera_gradients_equal_jax_grad():
    """Every camera field, the x components the hard renderer zeroes
    included."""
    jscene, _, jcfg, tscene, _, tcfg = setup()
    target = random_target()

    def jax_grads():
        jloss = jsoft.make_soft_loss(jscene, jcfg, jnp.asarray(target))
        value, grads = jax.jit(jax.value_and_grad(jloss))(
            JCameraParams.create(**CAMERA))
        return dict(grads._asdict(), loss=value)

    want = REFS("camera_grads", jax_grads)
    tcp = convert.camera_params_from_numpy(CAMERA, "cpu")
    loss = soft.make_soft_loss(tscene, tcfg, target)(tcp)
    grads = torch.autograd.grad(loss, list(tcp))
    want_loss = float(want["loss"])
    assert abs(float(loss.detach()) - want_loss) <= 1e-5 * want_loss
    for name, g in zip(tcp._fields, grads):
        assert max_rel(g, want[name]) <= GRAD_RTOL, name
    assert float(grads[0][0]) != 0.0


def test_soft_geometry_gradients_equal_jax_grad():
    jscene, jcam, jcfg, tscene, tcam, tcfg = setup()
    target = random_target(4)
    center = np.asarray(jscene.center) + np.float32(0.05)
    radius = np.asarray(jscene.radius) * np.float32(1.02)

    def jax_grads():
        jloss = jsoft.make_soft_geom_loss(jscene, jcam, jcfg,
                                          jnp.asarray(target))
        return jax.jit(jax.grad(jloss))(JSphereParams(
            center=jnp.asarray(center), radius=jnp.asarray(radius)))._asdict()

    want = REFS("geometry_grads", jax_grads)
    tp = convert.sphere_params_from_numpy(dict(center=center, radius=radius),
                                          "cpu")
    loss = soft.make_soft_geom_loss(tscene, tcam, tcfg, target)(tp)
    g_center, g_radius = torch.autograd.grad(loss, [tp.center, tp.radius])
    assert max_rel(g_center, want["center"]) <= GRAD_RTOL
    assert max_rel(g_radius, want["radius"]) <= GRAD_RTOL


def test_recover_camera_curve_equals_jax():
    """Six steps over two taus, eye and fov free: the same losses and the
    same recovered pose; the frozen fields do not move."""
    jscene, _, jcfg, tscene, _, tcfg = setup()
    true = dict(CAMERA, eye=(0.0, 0.0, 3.5))
    target = REFS("recover_camera_target", lambda: eager(
        jsoft.soft_render, jscene, look_at_jnp(JCameraParams.create(**true)),
        jcfg, jnp.uint32(TIME), 0.02))
    kw = dict(steps=6, learning_rate=2e-2, taus=(0.2, 0.05),
              optimize_fields=("eye", "fov"))

    def jax_recover():
        jrec, jlosses = jsoft.recover_camera(
            jscene, jcfg, jnp.asarray(target),
            JCameraParams.create(**CAMERA), **kw)
        return dict(jrec._asdict(), losses=np.asarray(jlosses))

    want = REFS("recover_camera", jax_recover)
    start = convert.camera_params_from_numpy(CAMERA, "cpu")
    rec, losses = soft.recover_camera(tscene, tcfg, target, start, **kw)
    assert len(losses) == 6
    np.testing.assert_allclose(losses, want["losses"], rtol=CURVE_RTOL,
                               atol=0)
    for name in rec._fields:
        np.testing.assert_allclose(getattr(rec, name).numpy(), want[name],
                                   rtol=CURVE_RTOL, atol=0, err_msg=name)
    assert torch.equal(rec.target, start.target.detach())
    # the caller's start state is not updated in place
    assert np.array_equal(start.eye.detach().numpy(),
                          np.float32(CAMERA["eye"]))
    assert not rec.eye.requires_grad


def test_recover_geometry_curve_equals_jax():
    """Six steps over two taus on one sphere: only its row moves."""
    jscene, jcam, jcfg, tscene, tcam, tcfg = setup()
    idx = 1
    target = REFS("recover_geometry_target", lambda: eager(
        jsoft.soft_render, jscene, jcam, jcfg, jnp.uint32(TIME), 0.02))
    center = np.asarray(jscene.center).copy()
    center[idx] += np.array([0.35, -0.25, 0.2], np.float32)
    radius = np.asarray(jscene.radius)
    kw = dict(sphere_index=idx, steps=6, learning_rate=3e-2,
              taus=(0.2, 0.05))

    def jax_recover():
        jrec, jlosses = jsoft.recover_geometry(
            jscene, jcam, jcfg, jnp.asarray(target), JSphereParams(
                center=jnp.asarray(center), radius=jnp.asarray(radius)),
            **kw)
        return dict(jrec._asdict(), losses=np.asarray(jlosses))

    want = REFS("recover_geometry", jax_recover)
    start = convert.sphere_params_from_numpy(dict(center=center,
                                                  radius=radius), "cpu")
    rec, losses = soft.recover_geometry(tscene, tcam, tcfg, target, start,
                                        **kw)
    np.testing.assert_allclose(losses, want["losses"], rtol=CURVE_RTOL,
                               atol=0)
    np.testing.assert_allclose(rec.center.numpy(), want["center"],
                               rtol=CURVE_RTOL, atol=0)
    np.testing.assert_allclose(rec.radius.numpy(), want["radius"],
                               rtol=CURVE_RTOL, atol=0)
    others = np.arange(len(center)) != idx
    assert np.array_equal(rec.center.numpy()[others], center[others])
    assert not np.array_equal(rec.center.numpy()[idx], center[idx])
