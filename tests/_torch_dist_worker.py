"""Worker of tests/test_torch_dist.py: one rank of a gloo group of CPU
processes that drives every sharded path of ``rt_torch.dist`` at 64x32 and
writes what it got to ``OUTDIR/rank{RANK}.npz`` (rank 0 also the gathered
images, and the CLI's PPMs to OUTDIR).  The unsharded references are
computed here too, each by one rank (``mine``), so the group shares them.

Run:  python tests/_torch_dist_worker.py PORT RANK WORLD OUTDIR
"""

import dataclasses
import os
import sys

import numpy as np
import torch

port, rank, world, outdir = (sys.argv[1], int(sys.argv[2]),
                             int(sys.argv[3]), sys.argv[4])
torch.set_num_threads(1)

import torch.distributed as dist  # noqa: E402

from rt_torch import cli  # noqa: E402
from rt_torch import dist as rdist  # noqa: E402
from rt_torch.grad.train import fit_replay  # noqa: E402
from rt_torch.kernels import dispatch  # noqa: E402
from rt_torch.render import oracle  # noqa: E402
from rt_torch.render.renderer import (init_state, render_color,  # noqa: E402
                                      render_frame)
from rt_torch.scene import scenes  # noqa: E402

W, H = 64, 32                 # H / 4 ranks = 8 rows: one tile row a band
TIME = 1000

created = rdist.multihost_init(f"127.0.0.1:{port}", world, rank,
                               device="cpu")
assert created and dist.get_world_size() == world
mesh = rdist.make_mesh(device="cpu")
assert mesh.backend == "gloo" and mesh.band(H) == (rank * H // world,
                                                   H // world)
out = {}
_task = [0]


def mine() -> bool:
    """True for this rank's share of the reference computations (round
    robin over the tasks in the order every rank meets them)."""
    _task[0] += 1
    return (_task[0] - 1) % world == rank


def small(builder, bounces, spp=1, backend="kernels"):
    sd = builder(W, H, device="cpu")
    return dataclasses.replace(sd, config=dataclasses.replace(
        sd.config, bounces=bounces, samples_per_frame=spp, backend=backend))


# --- the oracle: one frame, then three progressive frames ------------------
step = rdist.sharded_render_frame(mesh)
for name, builder, bounces in (("metal", scenes.test_scene_metal, 3),
                               ("cube", scenes.scene_cube, 2)):
    sd = small(builder, bounces, backend="oracle")
    state = rdist.shard_state(init_state(sd.config, "cpu"), mesh)
    state = step(rdist.shard_scene(sd.scene, mesh), sd.camera, state, TIME,
                 sd.config)
    image = rdist.gather_image(state, mesh)
    if rank == 0:
        out[f"oracle_{name}/sharded"] = image
        out[f"oracle_{name}/frame_count"] = np.int64(state.frame_count)
    if mine():
        out[f"oracle_{name}/ref"] = render_frame(
            sd.scene, sd.camera, init_state(sd.config, "cpu"), TIME,
            sd.config, "cpu").image.numpy()

sd = small(scenes.test_scene_metal, 3, backend="oracle")
state = rdist.shard_state(init_state(sd.config, "cpu"), mesh)
for i in range(3):
    state = step(sd.scene, sd.camera, state, TIME + 10 * i, sd.config)
out["progressive/band"] = state.image.numpy()
out["progressive/frame_count"] = np.int64(state.frame_count)
image = rdist.gather_image(state, mesh)
if rank == 0:
    out["progressive/sharded"] = image
if mine():
    ref = init_state(sd.config, "cpu")
    for i in range(3):
        ref = render_frame(sd.scene, sd.camera, ref, TIME + 10 * i,
                           sd.config, "cpu")
    out["progressive/ref"] = ref.image.numpy()

# --- sample parallelism: one time uniform a rank --------------------------
times = np.arange(TIME, TIME + 10 * world, 10, dtype=np.uint32)
out["sample/mean"] = rdist.sample_sharded_render(mesh)(
    sd.scene, sd.camera, times, sd.config).numpy()
# the sequential frame of this rank's time (the test averages them)
out["sample/seq"] = render_color(sd.scene, sd.camera, sd.config,
                                 int(times[rank]), "cpu").numpy()

# --- fit_replay(mesh=): BASELINE config 5's multi-device form -------------
target = oracle.render_color(sd.scene, sd.camera, sd.config, TIME, "cpu")
if rank == 0:
    out["fit/target"] = target.numpy()
albedo = sd.scene.albedo.clone()
albedo[1] = albedo.new_tensor([0.9, 0.1, 0.1])
bad = sd.scene._replace(albedo=albedo)
for recorder in ("oracle", "kernels"):
    kw = dict(steps=4, rerecord_every=2, learning_rate=5e-2,
              recorder=recorder, device="cpu")
    params, losses = fit_replay(bad, sd.camera, sd.config, target,
                                mesh=mesh, **kw)
    out[f"fit_{recorder}/losses"] = np.asarray(losses)
    out[f"fit_{recorder}/albedo"] = params["scene"].albedo.numpy()
    if mine():
        _, ref = fit_replay(bad, sd.camera, sd.config, target, **kw)
        out[f"fit_{recorder}/ref"] = np.asarray(ref)

# --- fit_replay(mesh=) on the replay kernel's path: a triangle scene's
# albedo alone, each rank's band through the plain version -----------------
from rt_torch.grad import record_hits  # noqa: E402
from rt_torch.utils import profiling  # noqa: E402

sd = small(scenes.scene_suzanne, 3)
target, _ = record_hits(sd.scene, sd.camera, sd.config, TIME, device="cpu")
albedo = sd.scene.mat_albedo.clone()
albedo[0] = albedo.new_tensor([0.8, 0.1, 0.1])
bad = sd.scene._replace(mat_albedo=albedo)
kw = dict(steps=4, rerecord_every=2, learning_rate=5e-2, device="cpu")
before = profiling.counters()["replay_kernel_steps"]
params, losses = fit_replay(bad, sd.camera, sd.config, target, mesh=mesh,
                            **kw)
out["fit_tris/kernel_steps"] = np.int64(
    profiling.counters()["replay_kernel_steps"] - before)
out["fit_tris/losses"] = np.asarray(losses)
out["fit_tris/albedo"] = params["scene"].mat_albedo.numpy()
if mine():
    _, ref = fit_replay(bad, sd.camera, sd.config, target, **kw)
    out["fit_tris/ref"] = np.asarray(ref)

# --- the wave path: each rank's band on a stream of its own ---------------
WAVE = {"cube_b3": (scenes.scene_cube, 3, 1, [1000, 1010]),
        "quad_b2": (scenes.scene_quad, 2, 1, [1000, 1010]),
        "cube_b2_spp2": (scenes.scene_cube, 2, 2, [1000, 1010]),
        "suzanne_b2": (scenes.scene_suzanne, 2, 1, [1000])}
for name, (builder, bounces, spp, ts) in WAVE.items():
    sd = small(builder, bounces, spp)
    packed = dispatch.pack_scene(sd.scene)
    out[f"wave_{name}/band"] = rdist.sharded_wave_render_frames(
        packed, sd.camera, sd.config, ts, mesh).numpy()
    if mine():
        out[f"wave_{name}/ref"] = dispatch.render_color_frames(
            packed, sd.camera, sd.config, ts, "cpu").numpy()

# three progressive steps, against the same step on a group of one
sd = small(scenes.scene_cube, 2)
packed = dispatch.pack_scene(sd.scene)
wstep = rdist.sharded_wave_step(mesh)
state = rdist.shard_state(init_state(sd.config, "cpu"), mesh)
for i in range(3):
    state = wstep(packed, sd.camera, state, TIME + 10 * i, sd.config)
out["wave_step/frame_count"] = np.int64(state.frame_count)
image = rdist.gather_image(state, mesh)
if rank == 0:
    out["wave_step/sharded"] = image
# new_group is collective: every rank makes every group of one
singles = [dist.new_group([r]) for r in range(world)]
if mine():
    mesh1 = rdist.make_mesh(singles[rank], device="cpu")
    assert mesh1.world_size == 1 and mesh1.band(H) == (0, H)
    step1 = rdist.sharded_wave_step(mesh1)
    ref = init_state(sd.config, "cpu")
    for i in range(3):
        ref = step1(packed, sd.camera, ref, TIME + 10 * i, sd.config)
    out["wave_step/world1"] = ref.image.numpy()
    out["wave_step/colors"] = dispatch.render_color_frames(
        packed, sd.camera, sd.config, [TIME, TIME + 10, TIME + 20],
        "cpu").numpy()
try:
    rdist.sharded_wave_render_frames(
        packed, sd.camera, dataclasses.replace(sd.config, height=30),
        [TIME], mesh)
    out["bad_height/raised"] = np.int64(0)
except ValueError as e:
    out["bad_height/raised"] = np.int64("not divisible" in str(e))

# --- the CLI, from the ranks of a group it did not form --------------------
base = ["--frames", "2", "--bounces", "3", "--device", "cpu"]
rcs = []
for name, args in (("oracle", ["1", "--oracle", "--size", "64x32"]),
                   ("wave", ["3", "--size", "64x32"])):
    rcs.append(cli.main(args + base + [
        "--sharded", "-o", os.path.join(outdir, f"cli_{name}_sharded.ppm")]))
    if mine():
        out[f"cli_{name}/plain_rc"] = np.int64(cli.main(args + base + [
            "-o", os.path.join(outdir, f"cli_{name}_plain.ppm")]))
for name, args in (("bad_height", ["3", "--size", "64x30"]),
                   ("sphere_kernels", ["1", "--size", "64x32"]),
                   ("mono", ["3", "--mono", "--size", "64x32"])):
    rcs.append(cli.main(args + base + [
        "--sharded", "-o", os.path.join(outdir, f"cli_{name}.ppm")]))
out["cli/rcs"] = np.asarray(rcs)
dist.barrier()                        # the CLI left the group up
out["cli/group_alive"] = np.int64(dist.is_initialized())

# --- the multi-process measurements ----------------------------------------
sd = small(scenes.scene_quad, 2)
out["multihost/rays_per_s"] = np.float64(rdist.measure_multihost(
    sd, frames=1, warmup=1, device="cpu"))
res = rdist.measure_scaling(sd, frames=1, warmup=1, device="cpu")
out["scaling/counts"] = np.asarray(res.device_counts)
out["scaling/rays_per_s"] = np.asarray(res.rays_per_s)

dist.barrier()
dist.destroy_process_group()
np.savez(os.path.join(outdir, f"rank{rank}.npz"), **out)
print(f"rank {rank} done", flush=True)
