"""Row-band sharding over ``torch.distributed`` — counterpart of
``rt/dist/sharding.py``.

The image is split by pixel rows across the ranks of a process group, one
band a rank; the scene and the camera are replicated.  Ray generation is
position-based: the per-pixel seed and the uv come from the global (x, y)
and the global height (``core.camera.generate_primary_rays``,
``tris_kernel.primary_rays``), so a band's rays are the same rows of the
full frame bit for bit, and rendering needs **no per-frame collective**:
each rank traces its rows and accumulates into its band.  Ranks talk in two
places only: the image's assembly on the host (``gather_image``) and the
sum of the parameter gradients in ``grad.train.fit_replay(mesh=)``.

PyTorch runs one process a rank and has no SPMD partitioner, so a band is an
explicit slice and a collective an explicit call.  ``multihost_init`` forms
the group (NCCL when every rank has a card of its own, gloo when ranks
share one: NCCL refuses two ranks on one device); ``make_mesh`` describes
this rank's place in it.
"""

from __future__ import annotations

import dataclasses
import os
import socket
import sys
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from rt_torch.config import RenderConfig
from rt_torch.render import oracle
from rt_torch.render.renderer import RenderState, accumulate, render_color


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of a 1-D group of ranks that split the image rows:
    the group (None for the default group), this rank, the group's size,
    this rank's device and the group's backend.  Its band of an image of a
    given height is ``band(height)``."""

    group: Optional[dist.ProcessGroup]
    rank: int
    world_size: int
    device: torch.device
    backend: str

    def band(self, height: int) -> tuple[int, int]:
        """(row0, rows) of this rank's band of an image ``height`` rows
        tall; a height the group does not divide raises."""
        if height % self.world_size:
            raise ValueError(f"height {height} not divisible by "
                             f"{self.world_size} shards")
        rows = height // self.world_size
        return self.rank * rows, rows


def free_port() -> int:
    """A free TCP port on 127.0.0.1 (for a group's coordinator)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_device(device="cuda", local_rank: Optional[int] = None
                ) -> torch.device:
    """The device of this process: ``device`` itself where it names an
    index or the CPU, else ``cuda:LOCAL_RANK % device_count``."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("no CUDA device is visible; pass device='cpu' "
                           "to run the ranks on the CPU")
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK",
                                        os.environ.get("RANK", 0)))
    return torch.device("cuda", local_rank % count)


def choose_backend(device: torch.device, local_world_size: int
                   ) -> tuple[str, str]:
    """(backend, reason): gloo for CPU ranks; for CUDA ranks NCCL when
    every rank of this host has a card of its own, gloo when ranks share
    one (NCCL refuses two ranks on one device)."""
    if device.type != "cuda":
        return "gloo", "CPU ranks"
    cards = torch.cuda.device_count()
    if local_world_size <= cards:
        return "nccl", f"{local_world_size} local ranks on {cards} cards"
    return "gloo", (f"{local_world_size} local ranks share {cards} card"
                    + ("s" if cards > 1 else ""))


def multihost_init(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   device="cuda") -> bool:
    """Join the process group (``init_process_group`` over ``tcp://``).

    Without arguments it reads torchrun's ``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR`` and ``MASTER_PORT``; when none is set, this one process
    forms a group of one (a free localhost port).  ``LOCAL_WORLD_SIZE``
    (default: the whole group, on this host) and the device's card count
    choose the backend (``choose_backend``), and the choice is printed on
    stderr.  A CUDA rank takes ``cuda:LOCAL_RANK % device_count``.

    Returns True when it formed the group (the caller then owns its
    ``destroy_process_group``), False when this process is already in one.
    """
    if dist.is_initialized():
        return False
    env = os.environ
    if num_processes is None:
        num_processes = int(env.get("WORLD_SIZE", 1))
    if process_id is None:
        process_id = int(env.get("RANK", 0))
    if coordinator_address is None:
        if "MASTER_ADDR" in env:
            coordinator_address = (f"{env['MASTER_ADDR']}:"
                                   f"{env.get('MASTER_PORT', '29500')}")
        elif num_processes == 1:
            coordinator_address = f"127.0.0.1:{free_port()}"
        else:
            raise ValueError(f"a group of {num_processes} processes needs a "
                             "coordinator address (or MASTER_ADDR)")
    local = int(env.get("LOCAL_RANK", process_id))
    dev = rank_device(device, local)
    backend, why = choose_backend(
        dev, int(env.get("LOCAL_WORLD_SIZE", num_processes)))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    print(f"rank {process_id} of {num_processes}: {backend} ({why}), "
          f"{dev}", file=sys.stderr)
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return True


def make_mesh(group: Optional[dist.ProcessGroup] = None,
              device="cuda") -> Mesh:
    """This rank's Mesh in ``group`` (the default group when None) of an
    initialised process group, on ``rank_device(device)``."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call multihost_init first")
    return Mesh(group=group, rank=dist.get_rank(group),
                world_size=dist.get_world_size(group),
                device=rank_device(device), backend=dist.get_backend(group))


def collective(mesh: Mesh, fn, tensor: torch.Tensor) -> torch.Tensor:
    """``fn(t)`` (a collective on ``t`` in place) on ``tensor``: staged
    through the host under gloo, whose collectives on CUDA tensors are
    partial, and through a contiguous copy where ``tensor`` is a strided
    view; returns ``tensor``."""
    staged = tensor.cpu() if mesh.backend == "gloo" else tensor
    staged = staged.contiguous()
    fn(staged)
    if staged is not tensor:
        tensor.copy_(staged)
    return tensor


def all_reduce(mesh: Mesh, tensor: torch.Tensor,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce of ``tensor`` over the mesh's group."""
    return collective(
        mesh, lambda t: dist.all_reduce(t, op=op, group=mesh.group), tensor)


def shard_state(state: RenderState, mesh: Mesh) -> RenderState:
    """This rank's band of a full-frame state, on its device; frame_count
    is a host int, the same on every rank."""
    row0, rows = mesh.band(state.image.shape[0])
    return RenderState(
        image=state.image[row0:row0 + rows].to(mesh.device, copy=True),
        frame_count=state.frame_count)


def _to(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_to(v, device) for v in tree))
    return tree


def shard_scene(scene, mesh: Mesh):
    """The scene (a SphereArray, a TriangleScene or its PackedScene; the
    camera's NumPy fields pass through) replicated on this rank's device."""
    return _to(scene, mesh.device)


def sharded_render_frame(mesh: Mesh):
    """step(scene, camera, state, time, config) -> RenderState: this rank's
    band traced through the oracle (``config.backend == "oracle"``) and
    EMA-accumulated into its band with ``render_frame``'s f32 host
    weights, so the gathered image is the unsharded one bit for bit."""

    def step(scene, camera, state: RenderState, time,
             config: RenderConfig) -> RenderState:
        if config.backend != "oracle":
            raise ValueError("sharded_render_frame traces the oracle's "
                             f"bands; backend is {config.backend!r} (the "
                             "kernels' bands: dist.wave)")
        row0, rows = mesh.band(config.height)
        color = oracle.render_color(scene, camera, config, time,
                                    mesh.device, row0=row0, rows=rows)
        return accumulate(state, color, config)

    return step


def gather_image(state: RenderState, mesh: Mesh) -> np.ndarray:
    """The full (H, W, 3) image on the host of every rank, the bands in
    rank order: a readback, as ``jax.device_get`` is in the JAX package.
    Under gloo the bands travel as host tensors; under NCCL they are
    gathered on the card and read back."""
    band = state.image.detach().contiguous()
    if mesh.world_size == 1:
        return band.cpu().numpy()
    if mesh.backend != "nccl":
        band = band.cpu()
    parts = [torch.empty_like(band) for _ in range(mesh.world_size)]
    dist.all_gather(parts, band, group=mesh.group)
    return torch.cat(parts).cpu().numpy()


def sample_sharded_render(mesh: Mesh):
    """Sample-parallel form: step(scene, camera, times, config) -> (H, W,
    3) mean color on every rank.  Each rank traces the FULL frame at its
    own time uniform ``times[rank]`` (through ``config.backend``), then one
    ``all_reduce(SUM)`` and a division by the group's size average them —
    the progressive loop's uniform average run in parallel."""

    def step(scene, camera, times, config: RenderConfig) -> torch.Tensor:
        t = int(np.asarray(times).reshape(-1)[mesh.rank])
        color = render_color(scene, camera, config, t, mesh.device)
        all_reduce(mesh, color)
        # a tensor divisor: CUDA division by a Python scalar multiplies by
        # its reciprocal, which is not the IEEE quotient
        return color / torch.tensor(float(mesh.world_size),
                                    dtype=torch.float32, device=color.device)

    return step
