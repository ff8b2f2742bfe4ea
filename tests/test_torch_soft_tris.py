"""The port's triangle soft-visibility surrogate (``rt_torch.grad.soft_tris``)
against the JAX package's (``rt.grad.soft_tris``), on the same scenes and
targets converted from NumPy; the cube at 48x32 (also with a dielectric
material on half its triangles) and 32x24, one torch thread a test.

The JAX side of every comparison but ``downsample``'s and
``OrbitParams``'s is the output of the JAX function on the test's own
seeded inputs, kept bit for bit in ``tests/jax_refs/`` (see
``test_torch_parity_util.JaxRefs``): eager JAX compiles every primitive on
its first call (~40 ms each, some 250 of them a surrogate and as many
again for its gradient), more than the CPU suite can spend.
``RT_TORCH_JAX_REFS=check pytest tests/test_torch_soft_tris.py`` runs the
JAX functions again and requires their outputs bit-equal to the stored
ones; ``=write`` makes them anew.

Forwards against the JAX function run EAGERLY (``jax.disable_jit``): not
bit-equal, as XLA's CPU ``exp``, ``logistic`` (sigmoid) and ``tan`` round
some inputs an ULP away from ATen's; held to 1e-6 absolute (measured
maximum 1.8e-7; ``pytest -s`` prints it).  ``subject_roi`` (a 0/1 mask)
and ``downsample`` (the block sums in XLA's order) are exact.

Gradients (camera and albedo) and the recovery loops are held against the
JAX functions as a user runs them, jitted (XLA fuses and contracts
multiply-adds; the forward then moves by up to 2.6e-6): gradients within
1e-4 of the leaf's largest entry, the loss curves and returned parameters
within 1e-4 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rt.config import MAT_DIELECTRIC
from rt.grad import CameraParams as JCameraParams
from rt.grad import soft_tris as jst
from rt.scene import scenes as jscenes
from rt_torch import convert
from rt_torch.config import RenderConfig
from rt_torch.grad import soft_tris as st
import test_torch_parity_util as U
from _torch_threads import one_torch_thread  # noqa: F401

TIME = 1000
FORWARD_ATOL = 1e-6
LOSS_RTOL = 1e-6
GRAD_RTOL = 1e-4
CURVE_RTOL = 1e-4
LOOK = (0.0, 0.1, -3.0)          # scene_cube's camera target
REFS = U.JaxRefs(__file__)


def setup(name="scene_cube", w=48, h=32):
    jsd = getattr(jscenes, name)(w, h)
    return (jsd.scene, jsd.camera, jsd.config, U.port_scene(jsd.scene),
            U.port_camera(jsd.camera), RenderConfig.for_triangles(w, h))


def with_dielectric(jscene):
    """The cube with every other triangle given a second, dielectric
    material: the surrogate must not see those (n_raw zeroed), in both
    packages alike.  The triangle count, and so every (chunk, H, W) shape,
    stays the cube's."""
    m = jscene.a.shape[0]
    return jscene._replace(
        mat_id=jnp.asarray(np.arange(m) % 2, jnp.int32),
        mat_albedo=jnp.concatenate([jscene.mat_albedo,
                                    jnp.asarray([[0.9, 0.9, 0.9]])]),
        mat_param=jnp.concatenate([jscene.mat_param, jnp.asarray([1.5])]),
        mat_kind=jnp.concatenate([jscene.mat_kind,
                                  jnp.asarray([MAT_DIELECTRIC],
                                              jscene.mat_kind.dtype)]))


def eager(f, *args, **kw):
    with jax.disable_jit():
        return f(*args, **kw)


def max_rel(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / np.abs(want).max()


def cube_orbit():
    """scene_cube's own pose in orbit coordinates about its look target."""
    jsd = jscenes.scene_cube(8, 8)
    return (np.asarray(jsd.camera.eye[:3]), float(jsd.camera.fov),
            float(jsd.camera.focal_length))


def camera_fields(theta=0.03, dfov=0.02):
    eye, fov, fl = cube_orbit()
    op = jst.OrbitParams.from_eye(eye, LOOK, fov + dfov)
    op = op._replace(theta=op.theta + theta)
    cp = op.to_camera_params(LOOK, fl, 0.0)
    return {k: np.asarray(v) for k, v in cp._asdict().items()}


@pytest.mark.parametrize("chunk,full_res", [(5, None), (5, (96, 64)),
                                            (128, None), (128, (96, 64))])
def test_soft_render_tris_equals_jax_on_the_cube(chunk, full_res):
    jscene, jcam, jcfg, tscene, tcam, tcfg = setup()
    want = REFS(f"cube/{chunk}/{full_res}", lambda: eager(
        jst.soft_render_tris, jscene, jcam, jcfg, jnp.uint32(TIME),
        chunk=chunk, full_res=full_res))
    with torch.no_grad():
        got = st.soft_render_tris(tscene, tcam, tcfg, TIME, chunk=chunk,
                                  full_res=full_res).numpy()
    assert got.shape == (32, 48, 3) and np.isfinite(got).all()
    err = np.abs(got - want).max()
    print(f"cube chunk {chunk} full_res {full_res}: max abs difference "
          f"{err:.3g}")                                     # with -s
    assert err <= FORWARD_ATOL


@pytest.mark.parametrize("full_res", [None, (96, 64)])
def test_soft_render_tris_equals_jax_with_a_dielectric(full_res):
    jscene, jcam, jcfg, _, tcam, tcfg = setup()
    jscene = with_dielectric(jscene)
    tscene = U.port_scene(jscene)
    want = REFS(f"dielectric/{full_res}", lambda: dict(zip(
        ("image", "coverage"), eager(
            jst.soft_render_tris, jscene, jcam, jcfg, jnp.uint32(TIME),
            return_aux=True, full_res=full_res))))
    with torch.no_grad():
        got, cov = st.soft_render_tris(tscene, tcam, tcfg, TIME,
                                       return_aux=True, full_res=full_res)
    err = np.abs(got.numpy() - want["image"]).max()
    print(f"dielectric full_res {full_res}: max abs difference {err:.3g}")
    assert err <= FORWARD_ATOL
    assert np.abs(cov.numpy() - want["coverage"]).max() <= FORWARD_ATOL
    with torch.no_grad():
        _, opaque = st.soft_render_tris(U.port_scene(setup()[0]), tcam,
                                        tcfg, TIME, return_aux=True,
                                        full_res=full_res)
    assert float(cov.sum()) < float(opaque.sum())


def test_subject_roi_equals_jax():
    """The subject (material 0, half the cube) dilated by 5: exact."""
    jscene, jcam, jcfg, _, tcam, tcfg = setup()
    jscene = with_dielectric(jscene)
    tscene = U.port_scene(jscene)
    kw = dict(subject_mat_ids=[0], dilate=5)
    want = REFS("subject_roi", lambda: eager(jst.subject_roi, jscene, jcam,
                                              jcfg, **kw))
    got = st.subject_roi(tscene, tcam, tcfg, **kw).numpy()
    assert np.array_equal(got, want)
    assert 0 < got.sum() < got.size


@pytest.mark.parametrize("factor,shape", [
    (4, (1080, 1920, 3)), (2, (540, 960, 3)), (2, (270, 480, 1)),
    (2, (32, 48, 3)), (2, (32, 48, 1)), (4, (27, 50, 3))])
def test_downsample_is_bit_equal(factor, shape):
    """Config 5's poolings (the target by 4, the images and weights by 2)
    and the test images'."""
    img = np.random.RandomState(factor).uniform(
        0.0, 1.0, shape).astype(np.float32)
    want = np.asarray(eager(jst.downsample, img, factor))
    got = st.downsample(torch.from_numpy(img), factor).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def test_downsample_where_xla_pairs_the_sums():
    """On some shapes (found: 24x32 with 1, 2, 4 or 8 channels, by 2)
    XLA's CPU reduction adds each block's two rows apart and then the two
    sums, not the four samples in turn: within 2 ULP there."""
    img = np.random.RandomState(2).uniform(
        0.0, 1.0, (24, 32, 1)).astype(np.float32)
    want = np.asarray(eager(jst.downsample, img, 2))
    got = st.downsample(torch.from_numpy(img), 2).numpy()
    ulp = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32))
    assert ulp.max() <= 2


@pytest.mark.parametrize("loss_mode", ["mse", "grad", "mse+grad"])
def test_soft_tris_loss_values_equal_jax(loss_mode):
    """Each mode with and without a weight, at grad_pool 1 and 2."""
    jscene, _, jcfg, tscene, _, tcfg = setup()
    rng = np.random.RandomState(11)
    target = rng.uniform(0.0, 1.0, (32, 48, 3)).astype(np.float32)
    weight = (rng.uniform(size=(32, 48)) > 0.3).astype(np.float32)
    fields = camera_fields()
    cases = {f"{wgt is None}/{pool}": dict(
        tau=0.02, chunk=128, loss_mode=loss_mode, grad_pool=pool, weight=wgt)
        for wgt in (None, weight) for pool in (1, 2)}

    def jax_losses():
        jcp = JCameraParams(**{k: jnp.asarray(v) for k, v in fields.items()})
        return {case: eager(jst.make_soft_tris_loss(
            jscene, jcfg, jnp.asarray(target), **kw), jcp)
            for case, kw in cases.items()}

    want = REFS(f"loss/{loss_mode}", jax_losses)
    tcp = convert.camera_params_from_numpy(fields, "cpu")
    for case, kw in cases.items():
        with torch.no_grad():
            got = float(st.make_soft_tris_loss(tscene, tcfg, target,
                                               **kw)(tcp))
        assert abs(got - float(want[case])) <= LOSS_RTOL * float(want[case]),\
            case


def test_soft_tris_gradients_equal_jax_grad():
    """Camera and albedo gradients of the config-5 loss (image gradients,
    pooled by 2, rays through the full-resolution positions) against a
    seeded random target."""
    jscene, _, jcfg, tscene, _, tcfg = setup()
    target = np.random.RandomState(12).uniform(
        0.0, 1.0, (32, 48, 3)).astype(np.float32)
    kw = dict(tau=0.02, chunk=32, loss_mode="grad", grad_pool=2,
              full_res=(64, 96))
    fields = camera_fields()
    albedo = np.asarray(jscene.mat_albedo) + np.float32(0.1)

    def jax_grads():
        jloss = jst.make_soft_tris_loss(jscene, jcfg, jnp.asarray(target),
                                        **kw)
        g_cam, g_alb = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
            JCameraParams(**{k: jnp.asarray(v) for k, v in fields.items()}),
            jnp.asarray(albedo))
        return dict(g_cam._asdict(), albedo=g_alb)

    want = REFS("grads", jax_grads)
    tcp = convert.camera_params_from_numpy(fields, "cpu")
    alb = torch.from_numpy(albedo).requires_grad_()
    loss = st.make_soft_tris_loss(tscene, tcfg, target, **kw)(tcp, alb)
    grads = torch.autograd.grad(loss, list(tcp) + [alb], allow_unused=True)
    for name, g in zip(tcp._fields, grads):
        ref = want[name]
        if g is None:         # focal_blur: the surrogate has no defocus
            assert not ref.any(), name
        elif np.abs(ref).max() > 1e-6:
            assert max_rel(g, ref) <= GRAD_RTOL, name
    assert max_rel(grads[-1], want["albedo"]) <= GRAD_RTOL
    assert float(grads[0].abs().max()) > 1e-4 and abs(float(grads[4])) > 1e-4


def test_orbit_params_roundtrip_and_camera():
    """from_eye(to_camera_params(op).eye) == op, and the camera parameters
    are the JAX package's."""
    op = st.OrbitParams.create(9.26, 1.57, 1.33, 0.9, device="cpu")
    cp = op.to_camera_params((0.0, 0.0, -4.5), 5.6, 0.0)
    back = st.OrbitParams.from_eye(cp.eye.numpy(), (0.0, 0.0, -4.5), 0.9,
                                   device="cpu")
    np.testing.assert_allclose(
        [float(back.radius), float(back.theta), float(back.phi)],
        [9.26, 1.57, 1.33], atol=1e-5)
    jcp = jst.OrbitParams.create(9.26, 1.57, 1.33, 0.9).to_camera_params(
        (0.0, 0.0, -4.5), 5.6, 0.0)
    for name in cp._fields:
        np.testing.assert_allclose(getattr(cp, name).numpy(),
                                   np.asarray(getattr(jcp, name)),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
        assert getattr(cp, name).dtype == torch.float32


def test_chunking_invariant():
    """The streamed chunk scan is the unchunked sum."""
    _, _, _, tscene, tcam, tcfg = setup()
    with torch.no_grad():
        full = st.soft_render_tris(tscene, tcam, tcfg, chunk=128)
        chunked = st.soft_render_tris(tscene, tcam, tcfg, chunk=5)
    np.testing.assert_allclose(full.numpy(), chunked.numpy(), atol=2e-6,
                               rtol=0)


def cube_target(w=32, h=24):
    """The surrogate's own render at the cube's true pose (tau 0.008)."""
    jscene, jcam, jcfg, tscene, tcam, tcfg = setup(w=w, h=h)
    with torch.no_grad():
        target = st.soft_render_tris(tscene, tcam, tcfg, tau=0.008).numpy()
    return jscene, jcfg, tscene, tcfg, target


def test_recover_orbit_tris_curve_equals_jax():
    """Eight steps over two taus in orbit coordinates, radius frozen: the
    same losses and the same returned (best) iterate."""
    jscene, jcfg, tscene, tcfg, target = cube_target()
    eye, fov, fl = cube_orbit()
    true = jst.OrbitParams.from_eye(eye, LOOK, fov)
    init = dict(radius=float(true.radius),
                theta=float(true.theta) + np.deg2rad(2.5),
                phi=float(true.phi) - np.deg2rad(1.5),
                fov=float(true.fov) + 0.03)
    kw = dict(focal_length=fl, focal_blur=0.0, steps=8, learning_rate=8e-3,
              taus=(0.02, 0.008), loss_mode="grad", grad_pool=2, chunk=32)

    def jax_recover():
        jop, jlosses = jst.recover_orbit_tris(
            jscene, jcfg, jnp.asarray(target),
            jst.OrbitParams.create(**init), LOOK, **kw)
        return dict(jop._asdict(), losses=np.asarray(jlosses))

    want = REFS("recover_orbit", jax_recover)
    op, losses = st.recover_orbit_tris(
        tscene, tcfg, target, st.OrbitParams.create(**init, device="cpu"),
        LOOK, **kw)
    assert len(losses) == 8 and losses[-1] < losses[0]
    np.testing.assert_allclose(losses, want["losses"], rtol=CURVE_RTOL,
                               atol=0)
    for name in op._fields:
        np.testing.assert_allclose(float(getattr(op, name)),
                                   float(want[name]),
                                   rtol=CURVE_RTOL, atol=0, err_msg=name)
    assert float(op.radius) == np.float32(init["radius"])


def test_recover_orbit_tris_returns_the_pre_update_best_iterate():
    """The returned iterate is the one whose loss was the final stage's
    least: evaluated again it gives that loss exactly, and it is not the
    last update."""
    _, _, tscene, tcfg, target = cube_target()
    eye, fov, fl = cube_orbit()
    true = st.OrbitParams.from_eye(eye, LOOK, fov, device="cpu")
    init = true._replace(theta=true.theta + 0.04, fov=true.fov + 0.03)
    kw = dict(focal_length=fl, focal_blur=0.0, steps=8, learning_rate=8e-3,
              taus=(0.02, 0.008), chunk=32)
    best, losses = st.recover_orbit_tris(tscene, tcfg, target, init, LOOK,
                                         **kw)
    last, losses2 = st.recover_orbit_tris(tscene, tcfg, target, init, LOOK,
                                          return_best=False, **kw)
    assert losses == losses2
    final = losses[4:]
    loss = st.make_soft_tris_loss(tscene, tcfg, target, tau=0.008, chunk=32)
    with torch.no_grad():
        again = float(loss(best.to_camera_params(LOOK, fl, 0.0)))
    assert again == min(final)
    assert any(not torch.equal(a, b) for a, b in zip(best, last))


def test_recover_camera_tris_with_albedo_curve_equals_jax():
    """Six steps over two taus, eye and fov free, the albedos jointly."""
    jscene, jcfg, tscene, tcfg, target = cube_target()
    fields = camera_fields(theta=0.02, dfov=0.01)
    albedo = np.asarray(jscene.mat_albedo) + np.float32(0.15)
    kw = dict(steps=6, learning_rate=2e-2, taus=(0.02, 0.008), chunk=32,
              optimize_albedo=True)

    def jax_recover():
        jcp, jalb, jlosses = jst.recover_camera_tris(
            jscene._replace(mat_albedo=jnp.asarray(albedo)), jcfg,
            jnp.asarray(target),
            JCameraParams(**{k: jnp.asarray(v) for k, v in fields.items()}),
            **kw)
        return dict(jcp._asdict(), albedo=jalb, losses=np.asarray(jlosses))

    want = REFS("recover_camera_albedo", jax_recover)
    start = convert.camera_params_from_numpy(fields, "cpu")
    cp, alb, losses = st.recover_camera_tris(
        tscene._replace(mat_albedo=torch.from_numpy(albedo)), tcfg, target,
        start, **kw)
    np.testing.assert_allclose(losses, want["losses"], rtol=CURVE_RTOL,
                               atol=0)
    np.testing.assert_allclose(alb.numpy(), want["albedo"],
                               rtol=CURVE_RTOL, atol=0)
    for name in cp._fields:
        np.testing.assert_allclose(getattr(cp, name).numpy(), want[name],
                                   rtol=CURVE_RTOL, atol=0, err_msg=name)
    assert torch.equal(cp.target, start.target.detach())
    assert not np.array_equal(alb.numpy(), albedo)
