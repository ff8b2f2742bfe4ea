"""Scaling of the row-sharded render over ranks — counterpart of
``rt/dist/scaling.py``: rays/s on groups of 1..N ranks, and the global
rays/s of the whole group between barriers.

Every rank of the default group calls these functions (they are
collective).  A triangle scene on the kernels renders through the sharded
wave step (``dist.wave``), a scene on the oracle through
``sharded_render_frame``; the sphere kernels take no band.  Ranks that
share one card (gloo) measure the mechanism, not the scaling: the result
names the topology it ran on.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from rt_torch.core.triangle import TriangleScene
from rt_torch.dist.sharding import (Mesh, all_reduce, collective,
                                    make_mesh, shard_scene, shard_state,
                                    sharded_render_frame)
from rt_torch.dist.wave import sharded_wave_step
from rt_torch.kernels import dispatch
from rt_torch.render.renderer import init_state


@dataclass
class ScalingResult:
    device_counts: list = field(default_factory=list)
    rays_per_s: list = field(default_factory=list)
    topology: str = ""

    @property
    def efficiency(self) -> list:
        """Throughput per rank relative to the first count's."""
        if not self.rays_per_s:
            return []
        base = self.rays_per_s[0] / self.device_counts[0]
        return [r / n / base for n, r in zip(self.device_counts,
                                            self.rays_per_s)]

    def summary(self) -> str:
        rows = [f"  {n} ranks: {r:.3e} rays/s ({e:.1%} eff)"
                for n, r, e in zip(self.device_counts, self.rays_per_s,
                                   self.efficiency)]
        return f"scaling on {self.topology}:\n" + "\n".join(rows)


def _stepper(scene_def, mesh: Mesh):
    """(scene on the mesh's device, step) of the sharded path for
    ``scene_def``'s config."""
    cfg = scene_def.config
    scene = shard_scene(scene_def.scene, mesh)
    if cfg.backend == "oracle":
        return scene, sharded_render_frame(mesh)
    if not isinstance(scene, TriangleScene):
        raise ValueError("the sphere kernels take no row band: shard a "
                         "sphere scene through the oracle")
    return dispatch.pack_scene(scene), sharded_wave_step(mesh)


def _frames_seconds(scene_def, mesh: Mesh, frames: int, warmup: int
                    ) -> float:
    """Seconds of ``frames`` sharded frames after ``warmup`` ones, between
    barriers of the mesh's group: the slowest rank's, on every rank."""
    cfg = scene_def.config
    scene, step = _stepper(scene_def, mesh)
    state = shard_state(init_state(cfg, mesh.device), mesh)
    t = 1000

    def run(n, state, t):
        for _ in range(n):
            state = step(scene, scene_def.camera, state, t, cfg)
            t += 10
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        return state, t

    state, t = run(warmup, state, t)
    dist.barrier(group=mesh.group)
    t0 = time.perf_counter()
    state, t = run(frames, state, t)
    dt = torch.tensor([time.perf_counter() - t0], dtype=torch.float64,
                      device=mesh.device)
    all_reduce(mesh, dt, dist.ReduceOp.MAX)
    return float(dt)


def _topology(mesh: Mesh) -> str:
    """The group's size and backend, and the cards this host shows."""
    if mesh.device.type != "cuda":
        return f"{mesh.world_size} processes over {mesh.backend}, CPU"
    return (f"{mesh.world_size} processes over {mesh.backend}, "
            f"{torch.cuda.device_count()} visible card(s) "
            f"({torch.cuda.get_device_name(mesh.device)})")


def measure_scaling(scene_def, device_counts=None, frames: int = 8,
                    warmup: int = 2, device="cuda") -> ScalingResult:
    """Rays/s of ``frames`` progressive frames on groups of the first n
    ranks for each n of ``device_counts`` (default 1, 2, 4, ... up to the
    group's size); the image height must divide by each n.  Called by every
    rank; each returns the same result."""
    world = dist.get_world_size()
    rank = dist.get_rank()
    if device_counts is None:
        device_counts = [n for n in (1, 2, 4, 8, 16, 32) if n <= world]
    cfg = scene_def.config
    world_mesh = make_mesh(device=device)
    res = ScalingResult(topology=_topology(world_mesh))
    for n in device_counts:
        # new_group is collective over the default group: every rank
        # makes every subgroup, members or not
        group = None if n == world else dist.new_group(list(range(n)))
        dt = torch.zeros(1, dtype=torch.float64, device=world_mesh.device)
        if rank < n:
            dt[0] = _frames_seconds(scene_def, make_mesh(group, device),
                                    frames, warmup)
        # rank 0 is in every subgroup: its window is the members' slowest
        collective(world_mesh, lambda t: dist.broadcast(t, 0), dt)
        rays = cfg.width * cfg.height * cfg.samples_per_frame * frames
        res.device_counts.append(n)
        res.rays_per_s.append(rays / float(dt))
    return res


def measure_multihost(scene_def, frames: int = 4, warmup: int = 1,
                      device="cuda") -> float:
    """Global rays/s over the whole group, timed between barriers (the
    slowest rank's window), the same number on every rank."""
    cfg = scene_def.config
    dt = _frames_seconds(scene_def, make_mesh(device=device), frames,
                         warmup)
    return cfg.width * cfg.height * cfg.samples_per_frame * frames / dt
