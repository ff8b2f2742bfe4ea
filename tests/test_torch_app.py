"""The port's app shell against the JAX package's: checkpoint and resume
(``render.checkpoint``), the CLI's ``--batch``, ``--stats``,
``--checkpoint`` and ``--resume``, the profiling utilities, the orbit
camera, the terminal viewer and the native bridge (``scene.native_bridge``
against the Python paths).  Everything on the CPU at thumbnail sizes; the
PPMs and images are compared byte for byte."""

import dataclasses
import math
import os
import pty
import select
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from rt_torch import cli
from rt_torch.config import RenderConfig
from rt_torch.render.checkpoint import (load_pytree, load_render_state,
                                        save_pytree, save_render_state,
                                        tree_leaves)
from rt_torch.render.ppm import render_ppm
from rt_torch.render.renderer import ProgressiveRenderer
from rt_torch.scene import bvh as bvh_mod
from rt_torch.scene import native_bridge as nb
from rt_torch.scene import scenes
from rt_torch.scene.objloader import ASSET_DIR, load_asset, parse_obj
from rt_torch.utils import RenderStats, Timer, device_sync, profile_trace
from rt_torch.viewer import TerminalViewer, image_to_ansi
from _torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def small_scene(w=64, h=32, bounces=3):
    sd = scenes.test_scene_metal(w, h, device="cpu")
    return dataclasses.replace(
        sd, config=dataclasses.replace(sd.config, bounces=bounces))


# ---------------------------------------------------------------------------
# checkpoint
# ---------------------------------------------------------------------------

def test_resume_equals_uninterrupted(tmp_path):
    """6 frames in one renderer == 3, a checkpoint, and 3 in a new one."""
    sd = small_scene()
    r1 = ProgressiveRenderer(sd, device="cpu")
    for i in range(6):
        r1.set_time(1000 + 10 * i)
        r1.draw()
    r2 = ProgressiveRenderer(sd, device="cpu")
    for i in range(3):
        r2.set_time(1000 + 10 * i)
        r2.draw()
    ckpt = str(tmp_path / "render.ckpt")
    save_render_state(ckpt, r2.state, r2.time)
    r3 = ProgressiveRenderer(sd, device="cpu")
    r3.state, t = load_render_state(ckpt, device="cpu")
    assert t == 1020
    for i in range(3, 6):
        r3.set_time(1000 + 10 * i)
        r3.draw()
    assert np.array_equal(r1.image.view(np.int32), r3.image.view(np.int32))
    assert r3.frame_count == 6 and not os.path.exists(ckpt + ".tmp")


def test_pytree_roundtrip_with_adam_state(tmp_path):
    """Nested dicts, a NamedTuple, a tuple, None and an Adam state dict
    after two steps; every leaf comes back equal, of its kind and dtype,
    and the restored optimizer takes the same next step."""
    from rt_torch.grad.params import CameraParams

    albedo = torch.full((5, 3), 0.3, requires_grad=True)
    fov = torch.tensor(0.6, requires_grad=True)
    opt = torch.optim.Adam([albedo, fov], lr=1e-2)
    for _ in range(2):
        opt.zero_grad()
        (albedo.square().sum() + fov * 2.0).backward()
        opt.step()
    cam = CameraParams.create((0.0, 1.0, 2.0), (0.0, 0.0, 0.0), 3.5, 0.0,
                              0.9, device="cpu")
    tree = {"params": {"albedo": albedo.detach(), "fov": fov.detach()},
            "camera": cam, "pair": (np.arange(3), 7), "none": None,
            "opt": opt.state_dict()}
    path = str(tmp_path / "train.ckpt")
    save_pytree(path, tree)
    like = {"params": {"albedo": torch.zeros(5, 3), "fov": torch.zeros(())},
            "camera": cam._replace(eye=torch.zeros(3)),
            "pair": (np.zeros(3, np.int64), 0), "none": None,
            "opt": opt.state_dict()}
    back = load_pytree(path, like)
    for a, b in zip(tree_leaves(tree), tree_leaves(back)):
        assert type(a) is type(b)
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b)
        else:
            assert np.array_equal(a, b)
    assert back["none"] is None and isinstance(back["camera"], CameraParams)
    opt2 = torch.optim.Adam([albedo.detach().clone().requires_grad_(),
                             fov.detach().clone().requires_grad_()], lr=1e-2)
    opt2.load_state_dict(back["opt"])
    for o, ps in ((opt, [albedo, fov]), (opt2, opt2.param_groups[0]["params"])):
        o.zero_grad()
        (ps[0].square().sum() + ps[1] * 2.0).backward()
        o.step()
    assert torch.equal(albedo, opt2.param_groups[0]["params"][0])


def test_checkpoints_load_across_packages(tmp_path):
    """A checkpoint written by the JAX package's save_render_state loads in
    the port, and the port's in the JAX package's (the same .npz keys)."""
    import jax.numpy as jnp

    from rt.render import checkpoint as jck
    from rt.render.renderer import RenderState as JRenderState

    img = np.random.RandomState(0).uniform(size=(8, 6, 3)).astype(np.float32)
    path = str(tmp_path / "from_jax.npz")
    jck.save_render_state(path, JRenderState(image=jnp.asarray(img),
                                             frame_count=jnp.uint32(5)), 1040)
    state, t = load_render_state(path, device="cpu")
    assert t == 1040 and state.frame_count == 5
    assert np.array_equal(state.image.numpy(), img)

    path = str(tmp_path / "from_port.npz")
    save_render_state(path, state._replace(frame_count=9), 2050)
    jstate, t = jck.load_render_state(path)
    assert t == 2050 and int(jstate.frame_count) == 9
    assert np.array_equal(np.asarray(jstate.image), img)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def test_cli_checkpoint_resume_bitwise(tmp_path):
    """Interrupted (2 frames, checkpoint, resume to 4) == uninterrupted 4,
    byte for byte."""
    ck, out_a, out_b = (str(tmp_path / n) for n in ("s.npz", "a.ppm",
                                                    "b.ppm"))
    common = ["--scene", "1", "--size", "32x32", "--device", "cpu",
              "--batch", "2", "--checkpoint", ck]
    assert cli.main(common + ["--frames", "2", "-o", out_a]) == 0
    assert os.path.exists(ck)
    assert cli.main(common + ["--frames", "4", "--resume", "-o", out_a]) == 0
    assert cli.main(["--scene", "1", "--size", "32x32", "--device", "cpu",
                     "--frames", "4", "-o", out_b]) == 0
    with open(out_a, "rb") as a, open(out_b, "rb") as b:
        assert a.read() == b.read()


def test_cli_stats_prints_a_line_a_batch(tmp_path, capsys):
    out = str(tmp_path / "o.ppm")
    assert cli.main(["--scene", "3", "--size", "16x16", "--device", "cpu",
                     "--frames", "5", "--batch", "2", "--stats",
                     "-o", out]) == 0
    lines = [ln for ln in capsys.readouterr().err.splitlines()
             if ln.strip().startswith("frame ")]
    assert [ln.split(":")[0].strip() for ln in lines] == [
        "frame 2/5", "frame 4/5", "frame 5/5"]
    assert "ray segments/s" in lines[-1]


# ---------------------------------------------------------------------------
# profiling
# ---------------------------------------------------------------------------

def test_render_stats_accounting():
    s = RenderStats(width=100, height=50, bounces=4, samples_per_frame=2)
    s.update(10, 2.0)
    s.update(10, 2.0)
    assert s.frames == 20 and s.seconds == 4.0
    assert s.fps == 5.0
    assert s.camera_rays_per_s == 100 * 50 * 2 * 20 / 4.0
    assert s.ray_segments_per_s == s.camera_rays_per_s * 4
    assert "20 frames" in s.summary()
    assert RenderStats(4, 4, 1).fps == 0.0


def test_timer_syncs_device_work():
    x = torch.arange(1024.0)
    with Timer(x) as t:
        y = x * 2 + 1
        device_sync(y)
    assert t.seconds > 0.0


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    logdir = str(tmp_path / "trace")
    with profile_trace(logdir) as prof:
        torch.ones(64).add_(1.0)
    path = os.path.join(logdir, "trace.json")
    assert os.path.getsize(path) > 0
    assert any("add" in e.key for e in prof.key_averages())


# ---------------------------------------------------------------------------
# orbit camera and viewer
# ---------------------------------------------------------------------------

def test_orbit_camera_equals_jax():
    """The same moves give the same camera as the JAX package's."""
    from rt.interactive import OrbitCamera as JOrbitCamera
    from rt_torch.interactive import OrbitCamera

    cams = (OrbitCamera(2.0), JOrbitCamera(2.0))
    for c in cams:
        c.handle_mouse_input(True)
        c.handle_mouse_motion(10.0, 5.0)
        c.handle_mouse_motion(40.0, -30.0)
        c.handle_scroll(2.0)
        c.resize(320, 200)
    got, want = (c.to_camera() for c in cams)
    for name in got._fields:
        assert np.array_equal(np.asarray(getattr(got, name)),
                              np.asarray(getattr(want, name))), name
    assert cams[0].aspect_ratio == 1.6 and cams[0].has_moved
    assert RenderConfig(width=320, height=200).aspect_ratio == 1.6


def test_image_to_ansi_shape_and_colors():
    img = np.zeros((4, 3, 3), np.float32)
    img[0, :, 0] = 1.0
    out = image_to_ansi(img)
    lines = out.split("\n")
    assert len(lines) == 2
    assert "\x1b[38;2;255;0;0m" in lines[0]
    assert out.count("▀") == 6


def test_keys_update_camera_within_ranges():
    v = TerminalViewer(small_scene(32, 16, 2), device="cpu")
    v.camera.reset_movement_flag()
    assert v.handle_key("LEFT")
    assert v.camera.has_moved
    for _ in range(100):
        v.handle_key("-")
    assert v.camera.radius <= 50.0
    for _ in range(100):
        v.handle_key("+")
    assert v.camera.radius >= 1.0
    for _ in range(50):
        v.handle_key("]")
    assert math.degrees(v.camera.fov) <= 120.0 + 1e-6
    assert not v.handle_key("q")


def test_reset_on_move_invariant():
    v = TerminalViewer(small_scene(32, 16, 2), device="cpu")
    v.tick()
    assert v.renderer.frame_count > 0
    v.handle_key("RIGHT")
    v.tick()
    assert v.renderer.frame_count == v.frames_per_tick
    assert "θ" in v.status_line()


def test_viewer_in_a_terminal_quits_on_q():
    """``python -m rt_torch.viewer --device cpu`` on a pseudo-terminal
    draws, reads ``q`` and exits 0; its own deadline kills it otherwise."""
    master, slave = pty.openpty()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "rt_torch.viewer", "3", "--size", "16x8",
         "--device", "cpu"], cwd=ROOT, env=env, stdin=slave, stdout=slave,
        stderr=subprocess.PIPE, close_fds=True)
    os.close(slave)
    seen = bytearray()

    def drain():                          # the pty's buffer must not fill
        while True:
            try:
                r, _, _ = select.select([master], [], [], 0.1)
                if r:
                    chunk = os.read(master, 65536)
                    if not chunk:
                        return
                    seen.extend(chunk)
                elif proc.poll() is not None:
                    return
            except OSError:
                return

    reader = threading.Thread(target=drain, daemon=True)
    reader.start()
    deadline = time.time() + 60
    while b"frame" not in seen and time.time() < deadline \
            and proc.poll() is None:
        time.sleep(0.05)
    os.write(master, b"q")
    try:
        rc = proc.wait(timeout=max(1.0, deadline - time.time()))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = None
    reader.join(timeout=5)
    os.close(master)
    err = proc.stderr.read().decode(errors="replace")
    proc.stderr.close()
    assert rc == 0, err
    assert b"\xe2\x96\x80" in seen and b"frame" in seen       # "▀"


# ---------------------------------------------------------------------------
# native bridge
# ---------------------------------------------------------------------------

needs_cxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="no g++ to build native/rt_native.cpp")


@needs_cxx
@pytest.mark.parametrize("name", sorted(
    n for n in os.listdir(ASSET_DIR) if n.endswith(".obj")))
def test_obj_parse_parity(name):
    """Every bundled asset (load_asset takes the C++ parser for them)."""
    with open(os.path.join(ASSET_DIR, name)) as f:
        text = f.read()
    v1, f1 = parse_obj(text)
    v2, f2 = nb.parse_obj(text)
    assert np.array_equal(v1.view(np.int32), v2.view(np.int32))
    assert np.array_equal(f1, f2)
    mesh = load_asset(name)
    assert np.array_equal(mesh.vertices, v1) and np.array_equal(
        mesh.indices, f1)


def test_obj_loader_keeps_the_empty_mesh_on_a_malformed_line():
    """A vertex line with two coordinates: the loader gives the empty mesh
    of the reference, where the C++ parser alone would read a zero."""
    text = "v 1 2\nf 1 2 3\n"
    from rt_torch.scene.objloader import load_obj
    assert load_obj(text).num_triangles == 0
    if nb.available():
        assert len(nb.parse_obj(text)[1]) == 3


@needs_cxx
def test_obj_negative_indices():
    text = "v 0 0 0\nv 1 0 0\nv 0 1 0\nf -3 -2 -1\n"
    v1, f1 = parse_obj(text)
    v2, f2 = nb.parse_obj(text)
    assert np.array_equal(f1, f2) and f2.tolist() == [0, 1, 2]


@needs_cxx
def test_obj_quad_fan_triangulation():
    text = "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nf 1/1/1 2/2/2 3/3/3 4/4/4\n"
    v1, f1 = parse_obj(text)
    v2, f2 = nb.parse_obj(text)
    assert np.array_equal(f1, f2) and len(f2) == 6


@needs_cxx
@pytest.mark.parametrize("name", ["cube.obj", "suzanne.obj"])
def test_bvh_build_parity(name):
    mesh = load_asset(name, bvh_mod.material_lambertian((1, 1, 1)))
    t1 = bvh_mod.Tree().add_mesh(mesh).build(use_native=True)
    t2 = bvh_mod.Tree().add_mesh(mesh).build(use_native=False)
    assert t1.sizes == t2.sizes
    for f in ("a", "b", "c", "custom", "mat_id", "bmin", "bmax"):
        assert np.array_equal(getattr(t1, f), getattr(t2, f)), f


@needs_cxx
def test_ppm_parity():
    rng = np.random.default_rng(0)
    img = rng.random((32, 24, 3)).astype(np.float32) * 1.4 - 0.1
    img[0, 0, 0] = np.nan
    img[0, 1, 1] = np.inf
    assert render_ppm(img, use_native=True) == render_ppm(img,
                                                          use_native=False)


@needs_cxx
def test_native_library_is_the_ports_own_build():
    """Built from native/rt_native.cpp into rt_torch/kernels/_build/ under
    the source's hash; never the library the JAX package's bridge builds."""
    assert nb.available()
    path = nb.library_path()
    assert path.startswith(os.path.join(ROOT, "rt_torch", "kernels",
                                        "_build"))
    assert os.path.exists(path)
    assert "librtnative.so" != os.path.basename(path)
