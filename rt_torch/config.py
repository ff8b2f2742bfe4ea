"""Render configuration — counterpart of ``rt/config.py``.

Constants mirror the reference shaders (see ``rt/config.py`` for the WGSL
citations).  ``RenderConfig`` is a frozen dataclass; nothing is traced or
compiled per config in the port, so the fields are plain run-time values.
"""

from __future__ import annotations

import dataclasses

SKY = (0.54, 0.86, 0.92)
BLUE = (0.54, 0.7, 0.98)
SAMPLE_FRAME = 1000       # EMA saturation frame
SAMPLE_PER_FRAME = 1
BOUNCE_MAX_SPHERE = 10
BOUNCE_MAX_TRIS = 5
EPSILON_SPHERE = 1e-6
EPSILON_TRIS = 1e-4
FLT_MAX = 3.40282e38      # the shader's own constant, NOT float32 max
BVH_MAX_STEPS = 600       # the stackless BVH walk's step cap
MAX_SPHERES = 100         # the reference's sphere buffer is always this long

MAT_LAMBERTIAN = 1
MAT_METAL = 2
MAT_DIELECTRIC = 3


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Render parameters.

    backend — ``"kernels"`` (default) or ``"oracle"``.  With the kernels,
        the device of the tensors decides: on a CUDA device the
        hand-written Hopper kernels run; on the CPU their plain PyTorch
        versions do, and the two compute the same image bit for bit at the
        same ``tile``.  The oracle (``render.oracle``, the counterpart of
        the JAX package's default ``backend="jax"``) is plain tensor code
        on whichever device the scene lies: every sphere, or the stackless
        BVH walk over the triangles, per bounce.
    tris_path — ``"wave"`` (default: the sorted wavefront stream) or
        ``"mono"`` (one whole-frame launch per frame, the counterpart of the
        JAX package's ``backend="pallas_mono"``), for triangle scenes.
    tile — (th, tw) rays per tile: the unit of the tile-union chunk cull
        and of the per-tile chunk visit order.  One CUDA block traces one
        tile, so th*tw must be a multiple of 32 and at most 1024 there.
        ``None`` takes the default of ``kernels.dispatch.wave_params``.
    normalize_defocus_dir / normalize_reflect_in — the sphere/triangle
        shader forks (see ``rt/config.py``).
    n_active_spheres — live spheres in the padded buffer (0 = scan all);
        the sphere kernels scan only this prefix.
    sky_from_final_dir — extension, default off: the sky term reads the
        final bounced direction instead of the primary ray's.
    """

    width: int = 512
    height: int = 512
    bounces: int = BOUNCE_MAX_SPHERE
    samples_per_frame: int = SAMPLE_PER_FRAME
    sample_frame: int = SAMPLE_FRAME
    normalize_defocus_dir: bool = False
    normalize_reflect_in: bool = True
    n_active_spheres: int = 0
    mat_kinds: tuple = (MAT_LAMBERTIAN, MAT_METAL, MAT_DIELECTRIC)
    sky_from_final_dir: bool = False
    tile: tuple | None = None
    tris_path: str = "wave"
    backend: str = "kernels"

    @staticmethod
    def for_spheres(width: int = 512, height: int = 512,
                    **kw) -> "RenderConfig":
        """Config matching shader_sphere.wgsl semantics."""
        kw.setdefault("bounces", BOUNCE_MAX_SPHERE)
        kw.setdefault("normalize_defocus_dir", False)
        kw.setdefault("normalize_reflect_in", True)
        return RenderConfig(width=width, height=height, **kw)

    @staticmethod
    def for_triangles(width: int = 512, height: int = 512,
                      **kw) -> "RenderConfig":
        """Config matching shader_tris.wgsl semantics."""
        kw.setdefault("bounces", BOUNCE_MAX_TRIS)
        kw.setdefault("normalize_defocus_dir", True)
        kw.setdefault("normalize_reflect_in", False)
        return RenderConfig(width=width, height=height, **kw)

    @property
    def aspect_ratio(self) -> float:
        return self.width / self.height
