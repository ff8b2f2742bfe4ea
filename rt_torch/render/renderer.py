"""Progressive renderer — counterpart of ``rt/render/renderer.py``.

``render_frame(scene, camera, state, time, config) -> state`` traces every
pixel (``config.samples_per_frame`` samples, looped inside the kernels'
paths, or through the oracle with ``config.backend == "oracle"``) and folds
the frame into the accumulator with the reference's EMA:
w = 1 / (min(frame_count, SAMPLE_FRAME) + 1);  new = mix(old, color, w).
Any camera or scene change must zero both the accumulator and the frame
count (``ProgressiveRenderer.reset_frame_count``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from rt_torch.config import RenderConfig
from rt_torch.kernels import dispatch
from rt_torch.render import oracle
from rt_torch.utils.profiling import count, span, wait


class RenderState(NamedTuple):
    image: torch.Tensor   # (H, W, 3) f32 linear accumulator
    frame_count: int      # host-side; wraps at 2**32 like the u32 uniform


def init_state(config: RenderConfig, device="cuda") -> RenderState:
    return RenderState(
        image=torch.zeros((config.height, config.width, 3),
                          dtype=torch.float32, device=device),
        frame_count=0)


def render_color(scene, camera, config: RenderConfig, time,
                 device="cuda") -> torch.Tensor:
    """(H, W, 3) color of one frame through ``config.backend``.  scene: the
    scene itself for the oracle, the scene or what ``dispatch.pack_scene``
    made of it for the kernels."""
    if config.backend == "oracle":
        return oracle.render_color(scene, camera, config, time, device)
    if config.backend == "kernels":
        return dispatch.render_color(scene, camera, config, time, device)
    raise ValueError(f"backend {config.backend!r}: kernels or oracle")


def accumulate(state: RenderState, color: torch.Tensor,
               config: RenderConfig) -> RenderState:
    """Fold one frame's color (the accumulator's shape: the frame or a row
    band of it) into the state with the reference's EMA."""
    fc = min(state.frame_count, config.sample_frame)
    # weights in float32 on the host, as the f32 scalars the mix multiplies by
    w = np.float32(1.0) / (np.float32(fc) + np.float32(1.0))
    with span("render.accumulate"):
        image = state.image * float(np.float32(1.0) - w) + color * float(w)
    return RenderState(image=image,
                       frame_count=(state.frame_count + 1) & 0xFFFFFFFF)


def render_frame(scene, camera, state: RenderState, time,
                 config: RenderConfig, device="cuda") -> RenderState:
    """draw(): trace every pixel and EMA-accumulate.  scene: the scene
    itself for the oracle, the scene or what ``dispatch.pack_scene`` made of
    it for the kernels."""
    with span("render.frame"):
        return accumulate(state, render_color(scene, camera, config, time,
                                              device), config)


def render_frames(scene, camera, state: RenderState, time0, time_step,
                  config: RenderConfig, n_frames: int,
                  device="cuda") -> RenderState:
    """n progressive frames with time = time0 + i*time_step (u32 wrap)."""
    for i in range(n_frames):
        t = (int(time0) + i * int(time_step)) & 0xFFFFFFFF
        state = render_frame(scene, camera, state, t, config, device)
    return state


class ProgressiveRenderer:
    """Stateful wrapper with the reference Renderer's host-side API (draw /
    set_time / reset_frame_count / resize / update_camera)."""

    def __init__(self, scene_def, device="cuda"):
        self.scene_def = scene_def
        self.device = torch.device(device)
        self.camera = scene_def.camera
        self.config = scene_def.config
        self.time = 0
        self.state = init_state(self.config, self.device)
        # kernel tables depend on the scene only: packed once, not per frame
        # (the oracle reads the scene itself)
        self._packed = (scene_def.scene if self.config.backend == "oracle"
                        else dispatch.pack_scene(scene_def.scene,
                                                 self.config))

    def set_time(self, time: int):
        self.time = int(time) & 0xFFFFFFFF

    def update_camera(self, camera):
        """Does NOT reset the accumulator; the caller resets on movement."""
        self.camera = camera

    def reset_frame_count(self):
        self.state = init_state(self.config, self.device)

    def resize(self, width: int, height: int):
        self.config = dataclasses.replace(self.config, width=width,
                                          height=height)
        self.state = init_state(self.config, self.device)

    def draw(self):
        self.state = render_frame(self._packed, self.camera, self.state,
                                  self.time, self.config, self.device)

    def draw_frames(self, n_frames: int, time_step: int = 10):
        """n progressive frames starting at the current time uniform;
        advances time past the last frame."""
        self.state = render_frames(self._packed, self.camera, self.state,
                                   self.time, time_step, self.config,
                                   n_frames, self.device)
        self.time = (self.time + n_frames * time_step) & 0xFFFFFFFF

    @property
    def image(self) -> np.ndarray:
        """The accumulator read back to the host: a wait for the work that
        feeds it (``render.wait``), then the copy alone
        (``render.readback``).  From a card the copy lands in page-locked
        host memory, which copies at a steady rate where a pageable copy's
        swings: a fresh buffer of torch's caching host allocator each call,
        so an array a caller keeps never changes."""
        img = self.state.image
        with span("render.wait"):
            wait(img)
        with span("render.readback"):
            if img.is_cuda:
                out = torch.empty(img.shape, dtype=img.dtype,
                                  pin_memory=True)
                out.copy_(img)
            else:
                out = img.cpu()
            out = out.numpy()
        count("readback_bytes", out.nbytes)
        return out

    @property
    def frame_count(self) -> int:
        return self.state.frame_count
