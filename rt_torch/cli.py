"""Headless CLI of the port — counterpart of ``rt/cli.py``.

Usage:
    python -m rt_torch.cli --scene 5 --frames N --size WxH -o out.ppm
                           [--spp S] [--seed N] [--device cpu] [--mono]
                           [--oracle] [--time-step MS] [--start-time T]

Renders a scene (1 sphere_simple, 2 sphere_globe, 3 quad, 4 cube, 5 suzanne,
6 lucy, 7 dragon, 8 sphere_cover; another id gives scene 1) progressively
and writes a PPM.  The default device is ``cuda``: the hand-written kernels are
compiled at first use.  ``--device cpu`` runs their plain PyTorch versions
(slow; meant for small sizes).  ``--oracle`` renders through the oracle
backend instead of the kernels: plain tensor code, every sphere or the BVH
walk per bounce, on the same device.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time as time_mod

from rt_torch.render.ppm import write_ppm
from rt_torch.render.renderer import ProgressiveRenderer
from rt_torch.scene import scenes


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--scene", type=int, default=5, help="scene id 1-8")
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
    p.add_argument("--mono", action="store_true",
                   help="triangle scenes: one whole-frame kernel launch per "
                        "frame instead of the wavefront stream")
    p.add_argument("--oracle", action="store_true",
                   help="render through the oracle backend (plain tensor "
                        "code, no kernel) instead of the kernels")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the randomised globe scene (scene 2)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    w, h = (int(v) for v in args.size.lower().split("x"))
    if args.scene == 2:
        sd = scenes.scene_sphere_globe(w, h, device=args.device,
                                       seed=args.seed)
    else:
        sd = scenes.build_scene(args.scene, w, h, device=args.device)
    if args.spp is not None:
        sd = dataclasses.replace(sd, config=dataclasses.replace(
            sd.config, samples_per_frame=args.spp))
    if args.mono:
        sd = dataclasses.replace(sd, config=dataclasses.replace(
            sd.config, tris_path="mono"))
    if args.oracle:
        sd = dataclasses.replace(sd, config=dataclasses.replace(
            sd.config, backend="oracle"))
    spp = sd.config.samples_per_frame
    print(f"scene {args.scene} ({sd.name}), {w}x{h}, {args.frames} frames, "
          f"bounces={sd.config.bounces}, spp={spp}, device={args.device}, "
          f"backend={sd.config.backend}",
          file=sys.stderr)
    r = ProgressiveRenderer(sd, device=args.device)
    r.set_time(args.start_time)
    t0 = time_mod.perf_counter()
    r.draw_frames(args.frames, args.time_step)
    image = r.image                       # device -> host: waits for the card
    dt = time_mod.perf_counter() - t0
    write_ppm(args.output, image)
    segs = w * h * sd.config.bounces * spp * args.frames
    print(f"wrote {args.output} ({args.frames / dt:.2f} frames/s, "
          f"{segs / dt:.3e} ray segments/s, first call included)",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
