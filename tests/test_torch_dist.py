"""Row-band sharding of the port (``rt_torch.dist``) over a gloo group of
four CPU processes, mirroring the JAX package's tests/test_dist.py,
test_dist_wave.py, test_multihost.py and the ``--sharded`` cases of
test_cli.py: the sharded result equals the unsharded one bit for bit.

One module-scoped fixture starts the group (``tests/_torch_dist_worker.py``,
one torch thread a rank); each rank drives every case at 64x32 (8 rows a
band: one tile row), computes its share of the unsharded references, and
writes what it got to an ``.npz``; the tests below assert on those.

Against the JAX package: ``rt.dist``'s sharded wave frames (8 virtual
devices, interpret mode), ``sample_sharded_render`` and ``fit_replay(mesh=)``
on the same scenes, stored in ``tests/jax_refs/test_torch_dist.npz``
(``RT_TORCH_JAX_REFS=check`` reruns them).  The JAX side is jitted, so the
wave frames are held within the jitted path's limits (ROADMAP queue 3:
at most 0.5 % of pixels past 1e-6, images within 0.05 % mean u8).
"""

import dataclasses
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from rt_torch.dist import sharding
from rt_torch.render import ppm as tppm
import test_torch_parity_util as U
from _torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_dist_worker.py")
WORLD, W, H, TIME = 4, 64, 32, 1000
BAND = H // WORLD
FLIP_ABOVE, FLIP_LIMIT, U8_BOUND_PCT = 1e-6, 0.005, 0.05
LOSS_RTOL = 1e-4            # tests/test_torch_train.py's, against JAX
refs = U.JaxRefs(__file__)


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """(per-rank result dicts, the output directory) of one run of the
    four workers."""
    outdir = str(tmp_path_factory.mktemp("torch_dist"))
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK",
                        "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    port = str(sharding.free_port())
    logs = [open(os.path.join(outdir, f"log{r}.txt"), "w+")
            for r in range(WORLD)]
    procs = [subprocess.Popen([sys.executable, WORKER, port, str(r),
                               str(WORLD), outdir], env=env, stdout=log,
                              stderr=subprocess.STDOUT)
             for r, log in enumerate(logs)]
    deadline = time.monotonic() + 300
    try:
        # a rank that fails leaves the others waiting in a collective:
        # stop them all at the first failure
        while any(p.poll() is None for p in procs):
            if (any(p.poll() not in (None, 0) for p in procs)
                    or time.monotonic() > deadline):
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    text = []
    for r, log in enumerate(logs):
        log.seek(0)
        text.append(log.read())
        log.close()
    for r, p in enumerate(procs):
        assert p.returncode == 0 and f"rank {r} done" in text[r], \
            f"rank {r} exited {p.returncode}:\n{text[r][-3000:]}"
    ranks = []
    for r in range(WORLD):
        with np.load(os.path.join(outdir, f"rank{r}.npz")) as f:
            ranks.append(dict(f))
    return ranks, outdir


def ref(ranks, key):
    """The reference ``key``, computed by whichever rank's share it was."""
    found = [r[key] for r in ranks if key in r]
    assert len(found) == 1, key
    return found[0]


# ---------------------------------------------------------------------------
# In-process: the band arguments, the mesh, the backend's choice
# ---------------------------------------------------------------------------

def test_primary_rays_and_replay_of_a_band_are_rows_of_the_frame():
    from rt_torch.core.camera import generate_primary_rays
    from rt_torch.grad.replay import record_hits, replay_color
    from rt_torch.scene import scenes

    sd = scenes.test_scene_metal(W, H, device="cpu")
    cfg = dataclasses.replace(sd.config, bounces=3)
    full = generate_primary_rays(sd.camera, W, H, TIME, True, device="cpu")
    band = generate_primary_rays(sd.camera, W, H, TIME, True, device="cpu",
                                 row0=12, rows=5)
    for f, b in zip(full, band):
        assert torch.equal(f[12:17], b)
    _, hits = record_hits(sd.scene, sd.camera, cfg, TIME, device="cpu")
    with torch.no_grad():
        whole = replay_color(sd.scene, sd.camera, cfg, TIME, hits)
        part = replay_color(sd.scene, sd.camera, cfg, TIME,
                            hits[:, 8:16].contiguous(), row0=8)
    assert torch.equal(whole[8:16], part)


def test_mesh_band_and_the_backend_from_the_facts(monkeypatch):
    mesh = sharding.Mesh(None, 2, 4, torch.device("cpu"), "gloo")
    assert mesh.band(32) == (16, 8)
    with pytest.raises(ValueError, match="not divisible"):
        mesh.band(30)
    assert sharding.choose_backend(torch.device("cpu"), 4)[0] == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    cuda = torch.device("cuda", 0)
    assert sharding.choose_backend(cuda, 1)[0] == "nccl"
    assert sharding.choose_backend(cuda, 2) == ("gloo",
                                                "2 local ranks share 1 card")


def test_no_card_is_no_silent_cpu_rank(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sharding.rank_device("cuda", 0)
    assert sharding.rank_device("cpu") == torch.device("cpu")


# ---------------------------------------------------------------------------
# The oracle (tests/test_dist.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["metal", "cube"])
def test_sharded_render_bitwise_equal(group, name):
    ranks, _ = group
    np.testing.assert_array_equal(ranks[0][f"oracle_{name}/sharded"],
                                  ref(ranks, f"oracle_{name}/ref"))
    assert int(ranks[0][f"oracle_{name}/frame_count"]) == 1


def test_progressive_sharded_frames(group):
    """Three frames with each rank's band kept on the rank between them."""
    ranks, _ = group
    np.testing.assert_array_equal(ranks[0]["progressive/sharded"],
                                  ref(ranks, "progressive/ref"))
    for r in ranks:
        assert r["progressive/band"].shape == (BAND, W, 3)
        assert int(r["progressive/frame_count"]) == 3


@pytest.mark.parametrize("rank", range(WORLD))
def test_each_rank_band_is_its_rows_of_the_unsharded_render(group, rank):
    """The multi-process form (tests/test_multihost.py): a rank's band is
    bitwise its rows of the unsharded render."""
    ranks, _ = group
    want = ref(ranks, "progressive/ref")[rank * BAND:(rank + 1) * BAND]
    np.testing.assert_array_equal(ranks[rank]["progressive/band"], want)


def test_sample_sharded_render_matches_sequential(group):
    """One time uniform a rank, all_reduce and divide == the mean of the
    four sequential frames; every rank holds the same mean."""
    ranks, _ = group
    seq = np.mean([r["sample/seq"] for r in ranks], axis=0)
    for r in ranks:
        np.testing.assert_array_equal(r["sample/mean"],
                                      ranks[0]["sample/mean"])
    np.testing.assert_allclose(ranks[0]["sample/mean"], seq, atol=2e-6,
                               rtol=0)


@pytest.mark.parametrize("recorder", ["oracle", "kernels"])
def test_fit_replay_sharded_matches_unsharded(group, recorder):
    """Bands of hits and target, one gradient all_reduce a step: the
    losses match the unsharded loop up to the sums' order, and the
    parameters stay replicated bit for bit."""
    ranks, _ = group
    losses = ranks[0][f"fit_{recorder}/losses"]
    assert len(losses) == 4 and np.isfinite(losses).all()
    np.testing.assert_allclose(losses, ref(ranks, f"fit_{recorder}/ref"),
                               rtol=2e-5, atol=1e-8)
    for r in ranks:
        np.testing.assert_array_equal(r[f"fit_{recorder}/losses"], losses)
        np.testing.assert_array_equal(r[f"fit_{recorder}/albedo"],
                                      ranks[0][f"fit_{recorder}/albedo"])


def test_fit_replay_sharded_on_the_replay_kernel_matches_unsharded(group):
    """Suzanne's albedo alone: every rank steps on the replay kernel's path
    (its plain version here) with its band over the frame's count, and the
    losses match the unsharded loop's up to the sums' order."""
    ranks, _ = group
    losses = ranks[0]["fit_tris/losses"]
    assert len(losses) == 4 and np.isfinite(losses).all()
    np.testing.assert_allclose(losses, ref(ranks, "fit_tris/ref"),
                               rtol=2e-5, atol=1e-8)
    for r in ranks:
        assert int(r["fit_tris/kernel_steps"]) == 4
        np.testing.assert_array_equal(r["fit_tris/losses"], losses)
        np.testing.assert_array_equal(r["fit_tris/albedo"],
                                      ranks[0]["fit_tris/albedo"])


# ---------------------------------------------------------------------------
# The wave path (tests/test_dist_wave.py)
# ---------------------------------------------------------------------------

WAVE = ["cube_b3", "quad_b2", "cube_b2_spp2", "suzanne_b2"]


def wave_frames(ranks, name):
    """(F, H, W, 3): the ranks' bands in rank order."""
    return np.concatenate([r[f"wave_{name}/band"] for r in ranks], axis=1)


@pytest.mark.parametrize("name", WAVE)
def test_sharded_wave_bitwise_equal(group, name):
    ranks, _ = group
    got = wave_frames(ranks, name)
    want = ref(ranks, f"wave_{name}/ref")
    assert got.shape[1:] == (H, W, 3)
    np.testing.assert_array_equal(got, want)


def test_sharded_wave_step_matches_a_group_of_one(group):
    """Three progressive steps with each band kept on its rank == the same
    step on a group of one, bitwise; and the hand EMA of the unsharded
    frames within 3e-7 (the same f32 host weights: here 0)."""
    ranks, _ = group
    got = ranks[0]["wave_step/sharded"]
    np.testing.assert_array_equal(got, ref(ranks, "wave_step/world1"))
    assert all(int(r["wave_step/frame_count"]) == 3 for r in ranks)
    image = np.zeros((H, W, 3), np.float32)
    for i, color in enumerate(ref(ranks, "wave_step/colors")):
        w = np.float32(1.0) / (np.float32(i) + np.float32(1.0))
        image = image * (np.float32(1.0) - w) + color * w
    np.testing.assert_allclose(image, got, atol=3e-7, rtol=0)


def test_bad_height_raises(group):
    ranks, _ = group
    assert all(int(r["bad_height/raised"]) == 1 for r in ranks)


# ---------------------------------------------------------------------------
# The CLI's --sharded (tests/test_cli.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["oracle", "wave"])
def test_sharded_cli_matches_unsharded(group, name):
    """Scene 1 through --oracle, scene 3 on the wave path: rank 0's PPM is
    the unsharded run's byte for byte."""
    ranks, outdir = group
    assert int(ref(ranks, f"cli_{name}/plain_rc")) == 0
    with open(os.path.join(outdir, f"cli_{name}_sharded.ppm")) as f, \
            open(os.path.join(outdir, f"cli_{name}_plain.ppm")) as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("i,name", enumerate(["bad_height", "sphere_kernels",
                                               "mono"], start=2))
def test_sharded_cli_exits_2_and_writes_nothing(group, i, name):
    """A height the ranks do not divide, the sphere kernels, --mono: exit
    2 on every rank before any rendering, no file."""
    ranks, outdir = group
    assert all(int(r["cli/rcs"][i]) == 2 for r in ranks)
    assert all(int(r["cli/rcs"][j]) == 0 for r in ranks for j in (0, 1))
    assert not os.path.exists(os.path.join(outdir, f"cli_{name}.ppm"))


def test_cli_leaves_a_group_it_did_not_form(group):
    ranks, _ = group
    assert all(int(r["cli/group_alive"]) == 1 for r in ranks)


def test_measure_multihost_and_scaling_agree_across_ranks(group):
    ranks, _ = group
    rays = [float(r["multihost/rays_per_s"]) for r in ranks]
    assert rays[0] > 0 and rays == [rays[0]] * WORLD
    for r in ranks:
        assert r["scaling/counts"].tolist() == [1, 2, 4]
        np.testing.assert_array_equal(r["scaling/rays_per_s"],
                                      ranks[0]["scaling/rays_per_s"])
    assert (ranks[0]["scaling/rays_per_s"] > 0).all()


# ---------------------------------------------------------------------------
# Against the JAX package's rt.dist
# ---------------------------------------------------------------------------

def _jax_mesh(n):
    import jax

    from rt.dist import make_mesh
    return make_mesh(jax.devices()[:n])


def _jax_scene(name, bounces, backend):
    from rt.scene import scenes as jscenes

    builder = {"cube": jscenes.scene_cube, "suzanne": jscenes.scene_suzanne,
               "metal": jscenes.test_scene_metal}[name]
    sd = builder(W, H)
    return dataclasses.replace(sd, config=dataclasses.replace(
        sd.config, bounces=bounces, backend=backend))


@pytest.mark.parametrize("name,times", [("cube_b3", [1000, 1010]),
                                        ("suzanne_b2", [1000])])
def test_sharded_wave_equals_jax_sharded_wave(group, name, times):
    ranks, _ = group

    def compute():
        import jax.numpy as jnp

        from rt.dist import sharded_wave_render_frames
        scene, bounces = name.split("_b")
        sd = _jax_scene(scene, int(bounces), "pallas")
        return sharded_wave_render_frames(
            sd.scene, sd.camera, sd.config, jnp.asarray(times, jnp.uint32),
            _jax_mesh(8), interpret=True)

    want = refs(f"wave_{name}", compute)
    got = wave_frames(ranks, name)
    assert want.shape == got.shape
    for w, g in zip(want, got):
        assert np.isfinite(g).all()
        flips = (np.abs(w - g).max(axis=-1) > FLIP_ABOVE).mean()
        assert flips <= FLIP_LIMIT, f"{flips:.3%} of pixels flipped"
        ok, pct = tppm.compare_ppm(tppm.render_ppm(g), tppm.render_ppm(w),
                                   U8_BOUND_PCT)
        assert ok, f"{pct:.4f}% > {U8_BOUND_PCT}%"


def test_sample_sharded_render_equals_jax(group):
    ranks, _ = group

    def compute():
        import jax.numpy as jnp

        from rt.dist.sharding import sample_sharded_render
        sd = _jax_scene("metal", 3, "jax")
        times = jnp.arange(TIME, TIME + 10 * WORLD, 10, dtype=jnp.uint32)
        return sample_sharded_render(_jax_mesh(WORLD))(
            sd.scene, sd.camera, times, sd.config)

    np.testing.assert_allclose(ranks[0]["sample/mean"],
                               refs("sample", compute), atol=2e-6, rtol=0)


def test_fit_replay_sharded_losses_equal_jax(group):
    """``rt.grad.train.fit_replay(mesh=)`` over 4 devices from the same
    target and wrong albedo: the losses within test_torch_train.py's
    LOSS_RTOL of the port's (the JAX replay is jitted)."""
    ranks, _ = group
    target = ranks[0]["fit/target"]

    def compute():
        import jax.numpy as jnp

        from rt.grad.train import fit_replay as jfit_replay
        sd = _jax_scene("metal", 3, "jax")
        bad = sd.scene._replace(albedo=sd.scene.albedo.at[1].set(
            jnp.array([0.9, 0.1, 0.1], jnp.float32)))
        _, losses = jfit_replay(bad, sd.camera, sd.config,
                                jnp.asarray(target), steps=4,
                                rerecord_every=2, learning_rate=5e-2,
                                recorder="oracle", mesh=_jax_mesh(WORLD))
        return np.asarray(losses)

    np.testing.assert_allclose(ranks[0]["fit_oracle/losses"],
                               refs("fit_losses", compute), rtol=LOSS_RTOL,
                               atol=0)
