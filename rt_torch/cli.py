"""Headless CLI of the port — counterpart of ``rt/cli.py``.

Usage:
    python -m rt_torch.cli [ID] [--scene ID | --scene-name NAME] --frames N
                           --size WxH -o out.ppm
                           [--spp S] [--bounces B] [--seed N] [--device cpu]
                           [--mono] [--oracle] [--time-step MS]
                           [--start-time T] [--batch N] [--stats]
                           [--checkpoint PATH] [--resume] [--sharded]

Renders a scene (1 sphere_simple, 2 sphere_globe, 3 quad, 4 cube, 5 suzanne,
6 lucy, 7 dragon, 8 sphere_cover; another id gives scene 1) progressively
and writes a PPM.  The id is positional, as in the reference app;
``--scene`` overrides it, and an absent or unparsable id picks a random
scene in 1..7.  ``--scene-name`` names any scene of ``rt_torch.scene.scenes``
instead (``rtiow_three_spheres``: the BENCH_CONFIGS config2 scene).  The
default device is ``cuda``: the hand-written kernels are
compiled at first use.  ``--device cpu`` runs their plain PyTorch versions
(slow; meant for small sizes).  ``--oracle`` renders through the oracle
backend instead of the kernels: plain tensor code, every sphere or the BVH
walk per bounce, on the same device.

Frames are drawn in batches of ``--batch`` (one ``draw_frames`` call each);
``--stats`` prints a throughput line a batch, and ``--checkpoint PATH``
saves the render state after every batch.  ``--resume`` continues from that
file where it exists: the resumed render is bit for bit the uninterrupted
one.

``--sharded`` splits the image rows among the ranks of a process group
(``rt_torch.dist``): run it under ``python -m torch.distributed.run
--nproc-per-node N -m rt_torch.cli ... --sharded``, or alone as a group of
one.  A triangle scene on the kernels renders through the sharded wave path
(``sharded_wave_frames``), ``--oracle`` through the sharded oracle; the
sphere kernels and ``--mono`` take no row band and exit 2, as does a height
the ranks do not divide, before any rendering.  Rank 0 writes the PPM and
the checkpoint and prints ``--stats``; ``--resume`` loads on every rank.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import random
import sys
import time as time_mod

import torch

from rt_torch.render.checkpoint import load_render_state, save_render_state
from rt_torch.render.ppm import write_ppm
from rt_torch.render.renderer import ProgressiveRenderer
from rt_torch.scene import scenes
from rt_torch.utils import RenderStats, device_sync


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("scene", nargs="?", default=None,
                   help="scene id 1-8 (random in 1-7 if omitted or not a "
                        "number, like the reference)")
    p.add_argument("--scene", dest="scene_opt", type=int, default=None,
                   help="scene id; overrides the positional one")
    p.add_argument("--scene-name", default=None,
                   help="a scene by its name in rt_torch.scene.scenes "
                        "(rtiow_one_sphere, rtiow_three_spheres, "
                        "test_scene_complex, ...); overrides the id")
    p.add_argument("--frames", type=int, default=100)
    p.add_argument("--size", default="512x512")
    p.add_argument("-o", "--output", default="out.ppm")
    p.add_argument("--device", default="cuda")
    p.add_argument("--time-step", type=int, default=10,
                   help="ms added to the RNG time uniform per frame")
    p.add_argument("--start-time", type=int, default=1000)
    p.add_argument("--spp", type=int, default=None,
                   help="samples per pixel per frame (default 1): the same "
                        "primary ray traced again with the RNG state carried "
                        "across samples")
    p.add_argument("--bounces", type=int, default=None,
                   help="bounces a path (default: the scene's own)")
    p.add_argument("--mono", action="store_true",
                   help="triangle scenes: one whole-frame kernel launch per "
                        "frame instead of the wavefront stream")
    p.add_argument("--oracle", action="store_true",
                   help="render through the oracle backend (plain tensor "
                        "code, no kernel) instead of the kernels")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the randomised globe scene (scene 2)")
    p.add_argument("--batch", type=int, default=25,
                   help="frames a draw_frames call")
    p.add_argument("--stats", action="store_true",
                   help="print throughput stats a frame batch")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint file, saved after every batch")
    p.add_argument("--resume", action="store_true",
                   help="resume from --checkpoint where it exists")
    p.add_argument("--sharded", action="store_true",
                   help="split the image rows among the ranks of a process "
                        "group (torchrun's variables, or a group of one)")
    return p.parse_args(argv)


def resolve_scene_id(args) -> int:
    """``--scene`` if given, else the positional id; a random id in 1..7
    when that is absent or not a number (the reference's
    ``App::parse_args``, ``src/app.rs:36-41``)."""
    if args.scene_opt is not None:
        return args.scene_opt
    fallback = random.randint(1, 7)
    if args.scene is None:
        return fallback
    try:
        return int(args.scene)
    except ValueError:
        return fallback


def main(argv=None) -> int:
    args = parse_args(argv)
    scene_id = resolve_scene_id(args)
    w, h = (int(v) for v in args.size.lower().split("x"))
    if args.scene_name is not None:
        make = getattr(scenes, args.scene_name, None) or getattr(
            scenes, f"scene_{args.scene_name}", None)
        if make is None:
            raise SystemExit(f"no scene named {args.scene_name!r}")
        sd = make(w, h, device=args.device)
    elif scene_id == 2:
        sd = scenes.scene_sphere_globe(w, h, device=args.device,
                                       seed=args.seed)
    else:
        sd = scenes.build_scene(scene_id, w, h, device=args.device)
    if args.spp is not None:
        sd = dataclasses.replace(sd, config=dataclasses.replace(
            sd.config, samples_per_frame=args.spp))
    if args.bounces is not None:
        sd = dataclasses.replace(sd, config=dataclasses.replace(
            sd.config, bounces=args.bounces))
    if args.mono:
        sd = dataclasses.replace(sd, config=dataclasses.replace(
            sd.config, tris_path="mono"))
    if args.oracle:
        sd = dataclasses.replace(sd, config=dataclasses.replace(
            sd.config, backend="oracle"))
    spp = sd.config.samples_per_frame
    print(f"scene {args.scene_name or scene_id} ({sd.name}), {w}x{h}, "
          f"{args.frames} frames, "
          f"bounces={sd.config.bounces}, spp={spp}, device={args.device}, "
          f"backend={sd.config.backend}",
          file=sys.stderr)
    if args.sharded:
        return _main_sharded(args, sd, w, h)
    r = ProgressiveRenderer(sd, device=args.device)
    r.set_time(args.start_time)
    done = 0
    if args.resume and args.checkpoint and os.path.exists(args.checkpoint):
        r.state, t = load_render_state(args.checkpoint, device=args.device)
        r.set_time(t)
        done = r.frame_count
        print(f"resumed at frame {done} (time {t})", file=sys.stderr)

    stats = RenderStats(width=w, height=h, bounces=sd.config.bounces,
                        samples_per_frame=spp)
    while done < args.frames:
        n = min(args.batch, args.frames - done)
        t0 = time_mod.perf_counter()
        r.draw_frames(n, args.time_step)
        device_sync(r.state.image)
        stats.update(n, time_mod.perf_counter() - t0)
        done += n
        if args.checkpoint:
            save_render_state(args.checkpoint, r.state, r.time)
        if args.stats:
            print(f"  frame {done}/{args.frames}: {stats.summary()}",
                  file=sys.stderr)
    write_ppm(args.output, r.image)
    print(f"wrote {args.output} ({stats.summary()}, first call included)",
          file=sys.stderr)
    return 0


def _sharded_refusal(sd, mesh, h) -> str | None:
    """Why ``--sharded`` cannot render this, or None."""
    if h % mesh.world_size:
        return f"height {h} not divisible by {mesh.world_size} processes"
    if sd.config.backend == "kernels":
        if sd.kind != "triangles":
            return ("the sphere kernels take no row band: shard a sphere "
                    "scene through --oracle")
        if sd.config.tris_path == "mono":
            return ("--mono takes no row band: shard a triangle scene on "
                    "the wave path")
    return None


def _main_sharded(args, sd, w: int, h: int) -> int:
    """The render of ``main`` with the rows split among the group's ranks
    (``rt_torch.dist``); tears down only a group it formed itself."""
    import torch.distributed as dist

    from rt_torch import dist as rdist
    from rt_torch.kernels import dispatch
    from rt_torch.render.renderer import RenderState, init_state

    created = rdist.multihost_init(device=args.device)
    try:
        mesh = rdist.make_mesh(device=args.device)
        why = _sharded_refusal(sd, mesh, h)
        if why is not None:
            print(f"--sharded: {why}", file=sys.stderr)
            return 2
        print(f"sharded over {mesh.world_size} processes ({mesh.backend})",
              file=sys.stderr)
        lead = mesh.rank == 0
        scene = rdist.shard_scene(sd.scene, mesh)
        if sd.config.backend == "oracle":
            step = rdist.sharded_render_frame(mesh)

            def frames(state, t0, n):
                for i in range(n):
                    state = step(scene, sd.camera, state,
                                 (t0 + i * args.time_step) & 0xFFFFFFFF,
                                 sd.config)
                return state
        else:
            scene = dispatch.pack_scene(scene, sd.config)
            run = rdist.sharded_wave_frames(mesh)

            def frames(state, t0, n):
                return run(scene, sd.camera, state, t0, args.time_step,
                           sd.config, n)

        state = init_state(sd.config, "cpu")
        t = args.start_time & 0xFFFFFFFF
        if (args.resume and args.checkpoint
                and os.path.exists(args.checkpoint)):
            state, t = load_render_state(args.checkpoint, device="cpu")
            if lead:
                print(f"resumed at frame {state.frame_count} (time {t})",
                      file=sys.stderr)
        state = rdist.shard_state(state, mesh)
        done = state.frame_count
        stats = RenderStats(width=w, height=h, bounces=sd.config.bounces,
                            samples_per_frame=sd.config.samples_per_frame)
        while done < args.frames:
            n = min(args.batch, args.frames - done)
            t0 = time_mod.perf_counter()
            state = frames(state, t, n)
            device_sync(state.image)
            stats.update(n, time_mod.perf_counter() - t0)
            t = (t + n * args.time_step) & 0xFFFFFFFF
            done += n
            if args.checkpoint:
                image = rdist.gather_image(state, mesh)
                if lead:
                    save_render_state(args.checkpoint, RenderState(
                        torch.from_numpy(image), state.frame_count), t)
            if args.stats and lead:
                print(f"  frame {done}/{args.frames}: {stats.summary()}",
                      file=sys.stderr)
        image = rdist.gather_image(state, mesh)
        if lead:
            write_ppm(args.output, image)
            print(f"wrote {args.output} ({stats.summary()}, first call "
                  "included)", file=sys.stderr)
        return 0
    finally:
        if created:
            dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
