"""The roofline yardstick: the least time the card could take for the work
of a traced window, from operations and bytes the benchmark counts itself
on the same rays (``reference.tracer`` with ``counts``).

The per-operation constants are frozen copies of the program's
measurement module as it stood when the benchmark was defined; the chunk
table the counts use is the benchmark's own (``reference.scene
.morton_chunks``).  A chunk is counted for a ray when the ray enters its
box before the ray's closest hit: any chunk-culled scan must scan it,
whatever its order or its tiles, so a change to the program's culling
does not move the yardstick.
"""

from __future__ import annotations

# published peaks of one H100 SXM (NVIDIA data sheet), stated whatever the
# card's power limit, which the result line carries beside them
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
CHUNK = 32
# f32 operations: Moeller-Trumbore a (ray, triangle) pair; a ray-box slab
# test; a ray-sphere pair; a resolved and scattered sphere hit (its
# Lambertian arm, the least of the three); one primary ray
FLOPS_PER_PAIR = 46
FLOPS_PER_BOX = 24
FLOPS_PER_SPHERE_PAIR = 23
FLOPS_PER_SPHERE_HIT = 45
FLOPS_PER_RAYGEN = 102
# 4-byte planes a kernel moves: the payload a wave bounce reads (origin,
# direction, attenuation, state, live flag) and writes (the same and the
# winning chunk); the payload, primary dy, state, live flag and chunk the
# first wave kernel writes; the origin, direction, primary dy and state the
# raygen writes; the color a whole-frame kernel writes, and per bounce the
# recorder's index plane
PLANES_BOUNCE_READ = 11
PLANES_BOUNCE_WRITE = 12
PLANES_FIRST = 13
PLANES_RAYGEN = 8
PLANES_COLOR = 3


def operations(c: dict) -> float:
    """f32 operations of counted work."""
    return (c.get("chunk_scans", 0) * CHUNK * FLOPS_PER_PAIR
            + c.get("box_tests", 0) * FLOPS_PER_BOX
            + c.get("sphere_pairs", 0) * FLOPS_PER_SPHERE_PAIR
            + c.get("sphere_hits", 0) * FLOPS_PER_SPHERE_HIT
            + c.get("primary_rays", 0) * FLOPS_PER_RAYGEN)


def least_ms(flops: float, nbytes: float) -> float:
    """The larger of operations over the f32 peak and bytes over the
    memory peak, in milliseconds."""
    return max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S) * 1e3


def wave_bytes(c: dict, pixels: int) -> float:
    """Bytes of a wave frame: the first kernel's planes for every pixel,
    a bounce's read and write for each later live ray."""
    later = c["live_rays"] - pixels
    return 4.0 * (PLANES_FIRST * pixels
                  + (PLANES_BOUNCE_READ + PLANES_BOUNCE_WRITE) * later)


def sample_bytes(c: dict) -> float:
    """Bytes of a wave sample from raygen's rays: every live ray's bounce
    read and write."""
    return 4.0 * (PLANES_BOUNCE_READ + PLANES_BOUNCE_WRITE) * c["live_rays"]


def frame_bytes(pixels: int, bounces: int = 0) -> float:
    """Bytes a whole-frame kernel writes: the color, and a recorder's
    index plane a bounce."""
    return 4.0 * pixels * (PLANES_COLOR + bounces)
