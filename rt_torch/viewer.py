"""Interactive terminal viewer — counterpart of ``rt/viewer.py``: the
stand-in for the reference's window and debug panel.

- orbit camera: arrow keys orbit, +/- zoom, [ ] fov, within the reference
  panel's ranges (radius 1-50, fov 30-120 degrees);
- progressive accumulation with reset on move: any camera change zeroes
  the accumulator and the frame count;
- the window is the terminal: 24-bit ANSI half-block cells (two pixel rows
  a character), redrawn as frames accumulate;
- a status line with the panel's values and the frame count.

Usage:  python -m rt_torch.viewer [scene_id] [--size 160x90]
                                  [--backend kernels|oracle] [--device cpu]
Keys:   arrows orbit · +/- zoom · [ ] fov · r reset view · q quit
Without a terminal on stdin and stdout it draws three ticks and prints the
status line.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import select
import sys
import time


def _supports_tty() -> bool:
    return sys.stdout.isatty() and sys.stdin.isatty()


def image_to_ansi(img, gamma: bool = False) -> str:
    """(H, W, 3) f32 linear -> ANSI half-block string (H/2 text rows).
    Linear * 255 as the PPM path (no gamma), clamped; gamma=True applies
    the swapchain's 1/2.2 for nicer terminals."""
    import numpy as np
    v = np.asarray(img, np.float32)
    if gamma:
        v = np.clip(v, 0.0, 1.0) ** (1.0 / 2.2)
    u8 = np.clip(v * 255.0, 0.0, 255.0).astype(np.uint8)
    h = u8.shape[0] - (u8.shape[0] % 2)
    rows = []
    for y in range(0, h, 2):
        top, bot = u8[y], u8[y + 1]
        cells = [f"\x1b[38;2;{t[0]};{t[1]};{t[2]}m"
                 f"\x1b[48;2;{b[0]};{b[1]};{b[2]}m▀"
                 for t, b in zip(top, bot)]
        rows.append("".join(cells) + "\x1b[0m")
    return "\n".join(rows)


class TerminalViewer:
    """Drives OrbitCamera and ProgressiveRenderer from terminal input."""

    def __init__(self, scene_def, backend: str = "kernels", device="cuda"):
        from rt_torch.interactive import OrbitCamera
        from rt_torch.render.renderer import ProgressiveRenderer
        scene_def = dataclasses.replace(
            scene_def, config=dataclasses.replace(scene_def.config,
                                                  backend=backend))
        self.sd = scene_def
        self.renderer = ProgressiveRenderer(scene_def, device=device)
        self.camera = OrbitCamera(scene_def.config.aspect_ratio)
        self.renderer.update_camera(self.camera.to_camera())
        self.frames_per_tick = 2
        self.t0 = time.time()

    def handle_key(self, key: str) -> bool:
        """Returns False to quit."""
        c = self.camera
        step = 0.12
        if key in ("q", "\x03"):
            return False
        elif key == "UP":
            c.phi -= step
        elif key == "DOWN":
            c.phi += step
        elif key == "LEFT":
            c.theta -= step
        elif key == "RIGHT":
            c.theta += step
        elif key in ("+", "="):
            c.radius = max(1.0, c.radius * 0.9)
        elif key == "-":
            c.radius = min(50.0, c.radius * 1.1)
        elif key == "[":
            c.fov = max(math.radians(30), c.fov - math.radians(5))
        elif key == "]":
            c.fov = min(math.radians(120), c.fov + math.radians(5))
        elif key == "r":
            c.radius, c.theta, c.phi = 5.0, 0.0, math.pi / 4
            c.fov = math.radians(45.0)
        else:
            return True
        c.update_position()
        return True

    def tick(self):
        """One frame batch; applies the reset-on-move invariant."""
        if self.camera.has_moved:
            self.renderer.update_camera(self.camera.to_camera())
            self.renderer.reset_frame_count()
            self.camera.reset_movement_flag()
        self.renderer.set_time(int((time.time() - self.t0) * 1000.0) or 1)
        for _ in range(self.frames_per_tick):
            self.renderer.draw()

    def status_line(self) -> str:
        c = self.camera
        return (f" r={c.radius:.1f} θ={math.degrees(c.theta):6.1f}° "
                f"φ={math.degrees(c.phi):5.1f}° fov={math.degrees(c.fov):5.1f}° "
                f"| frame {self.renderer.frame_count} | arrows orbit, +/- zoom,"
                f" [ ] fov, r reset, q quit")

    def render_text(self) -> str:
        return image_to_ansi(self.renderer.image, gamma=True)


def _read_key(timeout_s: float):
    """A single key without blocking past ``timeout_s`` (arrow escape
    sequences decoded)."""
    r, _, _ = select.select([sys.stdin], [], [], timeout_s)
    if not r:
        return None
    ch = sys.stdin.read(1)
    if ch == "\x1b":
        r, _, _ = select.select([sys.stdin], [], [], 0.01)
        if r and sys.stdin.read(1) == "[":
            code = sys.stdin.read(1)
            return {"A": "UP", "B": "DOWN", "C": "RIGHT", "D": "LEFT"}.get(
                code, None)
        return None
    return ch


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("scene", nargs="?", default="1")
    p.add_argument("--size", default="160x90")
    p.add_argument("--backend", choices=["kernels", "oracle"],
                   default="kernels")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    from rt_torch.scene import scenes
    try:
        sid = int(args.scene)
    except ValueError:
        sid = 1
    w, h = (int(v) for v in args.size.lower().split("x"))
    sd = scenes.build_scene(sid, w, h, device=args.device)
    viewer = TerminalViewer(sd, backend=args.backend, device=args.device)

    if not _supports_tty():
        for _ in range(3):
            viewer.tick()
        print(viewer.status_line())
        return 0

    import termios
    import tty
    fd = sys.stdin.fileno()
    saved = termios.tcgetattr(fd)
    try:
        tty.setcbreak(fd)
        sys.stdout.write("\x1b[2J")  # clear
        running = True
        while running:
            viewer.tick()
            sys.stdout.write("\x1b[H" + viewer.render_text() + "\n"
                             + viewer.status_line() + "\x1b[K")
            sys.stdout.flush()
            key = _read_key(0.01)
            if key is not None:
                running = viewer.handle_key(key)
    finally:
        termios.tcsetattr(fd, termios.TCSADRAIN, saved)
        sys.stdout.write("\x1b[0m\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
