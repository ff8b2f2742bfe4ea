"""The replay kernel's wrapper (``rt_torch.kernels.replay_kernel``) on the
CPU, where it runs its plain version (autograd through ``grad.replay.
replay_color`` and ``grad.loss.replay_mse``), against autograd through
``replay_color`` and ``fit_replay``'s loss expressions written out here;
and ``fit_replay``'s choice between the kernel's path and autograd's.

On a Suzanne thumbnail at the scene's 5 bounces, where the recorded paths
hit all three material kinds: the replayed colour and the loss are
bit-equal, the albedo gradient within 1e-5 relative.  The kernel itself is
held to ``replay_color`` and to autograd on the card
(``tests/test_torch_gpu.py``), and the wrapper's path to the JAX package's
gradient and loss curve (``tests/test_torch_train.py``).
"""

import dataclasses

import numpy as np
import pytest
import torch

from rt_torch.config import MAT_DIELECTRIC, MAT_LAMBERTIAN, MAT_METAL
from rt_torch.grad import (CameraParams, TriangleParams, fit_replay,
                           image_mse, record_hits, replay_color)
from rt_torch.grad import train
from rt_torch.kernels import dispatch
from rt_torch.kernels import replay_kernel as rk
from rt_torch.scene import scenes
from rt_torch.utils import profiling
from _torch_threads import one_torch_thread  # noqa: F401

W, H, TIME = 64, 32, 1000
GRAD_RTOL = 1e-5


def _setup(**cfg):
    sd = scenes.scene_suzanne(W, H, device="cpu")
    config = dataclasses.replace(sd.config, **cfg)
    _, hits = record_hits(sd.scene, sd.camera, config, TIME, device="cpu")
    return sd.scene, sd.camera, config, hits.contiguous()


_CACHE = {}


def setup(**cfg):
    key = tuple(sorted(cfg.items()))
    if key not in _CACHE:
        _CACHE[key] = _setup(**cfg)
    return _CACHE[key]


def random_target(rows=H, seed=7):
    return torch.from_numpy(np.random.RandomState(seed).uniform(
        0.0, 1.0, (rows, W, 3)).astype(np.float32))


def autograd_loss(scene, camera, config, hits, albedo, target, weight,
                  norm, row0):
    """(colour, loss, albedo gradient) through ``replay_color`` with
    ``fit_replay``'s loss expressions."""
    leaf = albedo.clone().requires_grad_()
    img = replay_color(scene._replace(mat_albedo=leaf), camera, config, TIME,
                       hits, row0=row0)
    if weight is None and norm is None:
        loss = image_mse(img, target)
    else:
        d = img - target
        loss = (torch.sum(d * d) / norm if weight is None
                else torch.sum(d * d * weight[..., None]) / norm)
    loss.backward()
    return img.detach(), loss.detach(), leaf.grad


CASES = {
    "mean": dict(),
    "loss_weight": dict(weighted=True),
    "row_band": dict(row0=8, rows=16),
    "row_band_weighted": dict(row0=16, rows=8, weighted=True),
    "final_sky_normalized_reflect": dict(
        cfg=dict(sky_from_final_dir=True, normalize_reflect_in=True)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_version_equals_autograd_replay(case):
    """Colour and loss bit-equal, gradient within GRAD_RTOL of every
    entry; the band's loss divides by the frame's count, or by the whole
    weight's sum, as ``fit_replay(mesh=)`` does."""
    c = CASES[case]
    scene, camera, config, hits = setup(**c.get("cfg", {}))
    row0, rows = c.get("row0", 0), c.get("rows", H)
    band = slice(row0, row0 + rows)
    hits = hits[:, band].contiguous()
    kinds = {int(scene.mat_kind[scene.mat_id[i]])
             for i in hits[hits >= 0].long().unique()}
    assert kinds == {MAT_LAMBERTIAN, MAT_METAL, MAT_DIELECTRIC}
    target = random_target(rows)
    weight = norm = None
    if c.get("weighted"):
        full = torch.from_numpy(np.random.RandomState(3).uniform(
            0.0, 2.0, (H, W)).astype(np.float32))
        norm = torch.sum(full) * 3.0 + 1e-9
        weight = full[band].contiguous()
    elif rows != H:
        norm = torch.tensor(float(H * W * 3))
    albedo = scene.mat_albedo.clone()
    img, loss, grad = autograd_loss(scene, camera, config, hits, albedo,
                                    target, weight, norm, row0)
    k_loss, k_grad, k_color = rk.replay_loss_grad(
        scene, camera, config, TIME, hits, target, weight, norm, row0=row0,
        want_color=True)
    assert torch.equal(k_color, img)
    assert k_loss.dtype == torch.float32 and torch.equal(k_loss, loss)
    assert bool((grad != 0).all())
    np.testing.assert_allclose(k_grad.numpy(), grad.numpy(), rtol=GRAD_RTOL,
                               atol=0)


def test_a_zero_albedo_has_a_finite_gradient():
    """A zero albedo keeps the gradient finite and equal to autograd's (the
    kernel multiplies the other bounces' factors and divides by none; its
    card test holds the same case)."""
    scene, camera, config, hits = setup()
    albedo = scene.mat_albedo.clone()
    albedo[0] = 0.0
    albedo[4, 1] = 0.0
    target = random_target()
    _, loss, grad = autograd_loss(scene, camera, config, hits, albedo,
                                  target, None, None, 0)
    k_loss, k_grad = rk.replay_loss_grad(
        scene._replace(mat_albedo=albedo), camera, config, TIME, hits, target)
    assert torch.equal(k_loss, loss) and torch.isfinite(k_grad).all()
    assert float(k_grad[0].abs().min()) > 0.0
    np.testing.assert_allclose(k_grad.numpy(), grad.numpy(), rtol=GRAD_RTOL,
                               atol=0)


def test_the_function_hands_the_gradient_to_what_made_the_albedo():
    """``replay_loss`` as an autograd node: its backward is the saved
    gradient times the cotangent, chained through the ops before it."""
    scene, camera, config, hits = setup()
    target = random_target()
    base = scene.mat_albedo.clone().requires_grad_()
    loss = rk.replay_loss(scene._replace(mat_albedo=base * 0.5), camera,
                          config, TIME, hits, target)
    (3.0 * loss).backward()
    _, want = rk.replay_loss_grad(
        scene._replace(mat_albedo=base.detach() * 0.5), camera, config, TIME,
        hits, target)
    torch.testing.assert_close(base.grad, 1.5 * want, rtol=0, atol=0)


def _steps(run):
    """(kernel steps, autograd steps) that ``run()`` took."""
    before = dict(profiling.counters())
    run()
    after = profiling.counters()
    return (after["replay_kernel_steps"] - before["replay_kernel_steps"],
            after["replay_autograd_steps"] - before["replay_autograd_steps"])


def _wrong(scene):
    albedo = scene.mat_albedo.clone()
    albedo[0] = albedo.new_tensor([0.8, 0.1, 0.1])
    return scene._replace(mat_albedo=albedo)


def test_fit_replay_takes_the_kernel_for_albedo_alone(monkeypatch):
    """Albedo alone on triangles: every step on the kernel's path, and the
    losses and the recovered albedo those of the autograd path (forced by
    denying the choice) within GRAD_RTOL."""
    scene, camera, config, _ = setup(bounces=3)
    target, _ = record_hits(scene, camera, config, TIME, device="cpu")
    kw = dict(time=TIME, steps=4, rerecord_every=2, learning_rate=5e-2,
              device="cpu")
    out = {}
    assert _steps(lambda: out.setdefault("k", fit_replay(
        _wrong(scene), camera, config, target, **kw))) == (4, 0)
    monkeypatch.setattr(train, "_albedo_is_the_only_leaf", lambda s: False)
    assert _steps(lambda: out.setdefault("a", fit_replay(
        _wrong(scene), camera, config, target, **kw))) == (0, 4)
    (pk, lk), (pa, la) = out["k"], out["a"]
    assert lk[0] == la[0] and lk[-1] < lk[0]
    np.testing.assert_allclose(lk, la, rtol=GRAD_RTOL, atol=0)
    np.testing.assert_allclose(pk["scene"].mat_albedo.numpy(),
                               pa["scene"].mat_albedo.numpy(), rtol=0,
                               atol=1e-5)


def test_fit_replay_with_a_loss_weight_takes_the_kernel(monkeypatch):
    """config 5's polish: albedo with a per-pixel weight, on the kernel's
    path, the losses within GRAD_RTOL of the autograd path's."""
    scene, camera, config, _ = setup(bounces=3)
    target, _ = record_hits(scene, camera, config, TIME, device="cpu")
    weight = np.ones((H, W), np.float32)
    weight[:, :W // 3] = 0.0
    kw = dict(time=TIME, steps=2, rerecord_every=2, learning_rate=5e-2,
              loss_weight=weight, device="cpu")
    out = {}
    assert _steps(lambda: out.setdefault("k", fit_replay(
        _wrong(scene), camera, config, target, **kw))) == (2, 0)
    monkeypatch.setattr(train, "_albedo_is_the_only_leaf", lambda s: False)
    assert _steps(lambda: out.setdefault("a", fit_replay(
        _wrong(scene), camera, config, target, **kw))) == (0, 2)
    np.testing.assert_allclose(out["k"][1], out["a"][1], rtol=GRAD_RTOL,
                               atol=0)


OTHER_LEAVES = ["camera", "mat_param", "vertices", "spheres",
                "unfrozen_geometry"]


@pytest.mark.parametrize("leaves", OTHER_LEAVES)
def test_fit_replay_keeps_autograd_for_other_leaves(leaves):
    """A camera entry, a material parameter, vertices, a sphere scene, or
    geometry in the graph: every step through autograd."""
    if leaves == "spheres":
        sd = scenes.scene_sphere_simple(W, H, device="cpu")
        scene, camera = sd.scene, sd.camera
        config = dataclasses.replace(sd.config, bounces=2)
    else:
        scene, camera, config, _ = setup(bounces=2)
    target, _ = record_hits(scene, camera, config, TIME, device="cpu")
    kw = dict(time=TIME, steps=2, rerecord_every=2, learning_rate=1e-3,
              device="cpu")
    if leaves == "camera":
        kw["init_params"] = {"camera": CameraParams.create(
            (0.0, 2.2, 4.5), (0.0, 0.0, -4.5), 5.6, 0.0, np.pi * 0.3,
            device="cpu")}
    elif leaves == "mat_param":
        kw["scene_fields"] = dict(albedo=True, mat_param=True)
    elif leaves == "vertices":
        kw["init_params"] = {"scene": TriangleParams.from_scene(
            scene, vertices=True)}
        kw["frozen_geometry"] = False
    elif leaves == "unfrozen_geometry":
        kw["frozen_geometry"] = False
    n_kernel, n_autograd = _steps(lambda: fit_replay(
        scene, camera, config, target, **kw))
    assert (n_kernel, n_autograd) == (0, 2)


@pytest.mark.parametrize("fields,want", [
    (dict(mat_albedo=True), True),
    (dict(mat_albedo=True, mat_param=True), False),
    (dict(mat_albedo=True, a=True), False),
    (dict(mat_albedo=True, normal=True), False),
    (dict(mat_param=True), False),
    (dict(), False),
])
def test_the_choice_reads_which_scene_tensors_need_a_gradient(fields, want):
    scene = setup()[0]
    scene = scene._replace(**{k: getattr(scene, k).clone().requires_grad_()
                              for k in fields})
    assert train._albedo_is_the_only_leaf(scene) is want


def test_the_kernel_counts_in_the_launch_counts():
    assert dispatch.launch_counts()["replay_loss"] == rk.LAUNCHES[
        "replay_loss"]


def test_fit_replay_takes_the_kernel_for_any_number_of_materials():
    """Suzanne's faces spread over 40 materials (the kernel's columns hold
    16 a block; its grid's second axis takes the rest): still the kernel's
    path, whatever the table's length."""
    scene, camera, config, _ = setup(bounces=2)
    n = 40
    gen = torch.Generator().manual_seed(5)
    pick = lambda t: t[torch.randint(0, t.shape[0], (n,), generator=gen)]
    many = scene._replace(
        mat_id=torch.randint(0, n, scene.mat_id.shape, generator=gen,
                             dtype=scene.mat_id.dtype),
        mat_albedo=pick(scene.mat_albedo), mat_param=pick(scene.mat_param),
        mat_kind=pick(scene.mat_kind))
    target, _ = record_hits(scene, camera, config, TIME, device="cpu")
    kw = dict(time=TIME, steps=2, rerecord_every=2, learning_rate=5e-2,
              device="cpu")
    assert _steps(lambda: fit_replay(many, camera, config, target,
                                     **kw)) == (2, 0)


def test_the_tables_hold_the_scene_and_the_camera_row():
    scene, camera, _, _ = setup()
    t = rk.pack_replay_tables(scene, camera)
    assert t.tri.shape == (scene.a.shape[0], 13) and t.tri.is_contiguous()
    torch.testing.assert_close(t.tri[:, 3:6], scene.b - scene.a, rtol=0,
                               atol=0)
    assert torch.equal(t.tri[:, 12], scene.mat_id.to(torch.float32))
    assert np.array_equal(t.cam, dispatch.pack_camera(camera).reshape(-1))
