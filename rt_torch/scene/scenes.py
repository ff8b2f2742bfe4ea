"""Scene constructors — counterpart of ``rt/scene/scenes.py``: the eight
app scenes (``SCENE_BY_ID``), the two RTIOW baseline scenes and the seven
deterministic golden-test scenes (``GOLDEN_SCENES``).

Each returns a ``SceneDef``: the packed scene on ``device``, the authored
camera and the per-variant RenderConfig.  The globe and cover scenes draw
from ``np.random.default_rng(seed)`` in the same call order as the JAX
package, so equal seeds give equal scenes.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np

from typing import Any

from rt_torch.config import (MAT_DIELECTRIC, MAT_LAMBERTIAN, MAT_METAL,
                             MAX_SPHERES, RenderConfig)
from rt_torch.core.camera import Camera, look_at
from rt_torch.core.sphere import pack_spheres
from rt_torch.scene import bvh as bvh_mod
from rt_torch.scene.objloader import load_asset

PI = np.float32(np.pi)


@dataclass
class SceneDef:
    name: str
    kind: str                  # "spheres" | "triangles"
    scene: Any                 # SphereArray | TriangleScene
    camera: Camera
    config: RenderConfig

    def with_resolution(self, width, height):
        return dataclasses.replace(self, config=dataclasses.replace(
            self.config, width=width, height=height))


def sph_lambertian(center, radius, albedo):
    return (center, radius, albedo, 0.0, MAT_LAMBERTIAN)


def sph_metal(center, radius, albedo, fuzz):
    return (center, radius, albedo, fuzz, MAT_METAL)


def sph_dielectric(center, radius, ir):
    return (center, radius, (1.0, 1.0, 1.0), ir, MAT_DIELECTRIC)


def _sphere_scene(name, objects, camera, width, height,
                  device) -> SceneDef:
    """Pads to the reference's MAX_SPHERES buffer; a scene past that cap
    (the cover scene) pads to the next multiple of 8."""
    pad_to = MAX_SPHERES if len(objects) <= MAX_SPHERES \
        else -(-len(objects) // 8) * 8
    kinds = tuple(sorted({int(o[4]) for o in objects})) or (MAT_LAMBERTIAN,)
    return SceneDef(name, "spheres", pack_spheres(objects, pad_to, device),
                    camera,
                    RenderConfig.for_spheres(
                        width, height, n_active_spheres=len(objects),
                        mat_kinds=kinds))


# --------------------------------------------------------------------------
# App scenes
# --------------------------------------------------------------------------

def scene_sphere_simple(width=512, height=512, device="cuda") -> SceneDef:
    """Scene 1, the default."""
    yellow = (0.98, 0.89, 0.69)
    red = (0.953, 0.545, 0.659)
    base = (0.12, 0.12, 0.18)
    blue = (0.54, 0.7, 0.98)
    black = (0.06, 0.06, 0.1)
    cam = look_at((0.0, 0.2, 1.5), (0.0, 0.1, -3.0), 2.2, 0.05, PI * 0.3)
    objs = [
        sph_lambertian((0.0, -100.5, -1.0), 100.0, base),
        sph_dielectric((-1.0, 0.0, -0.6), 0.5, 1.5),
        sph_lambertian((0.0, 0.0, -1.0), 0.5, black),
        sph_metal((1.0, 0.0, -1.0), 0.5, yellow, 0.1),
        sph_lambertian((-0.7, -0.3, -0.1), 0.2, red),
        sph_metal((-0.3, -0.4, -0.4), 0.1, blue, 0.9),
        sph_dielectric((0.2, -0.38, -0.16), 0.12, 0.1),
    ]
    return _sphere_scene("sphere_simple", objs, cam, width, height, device)


def scene_sphere_globe(width=512, height=512, device="cuda",
                       seed: int = 0) -> SceneDef:
    """Scene 2: random small spheres on a unit globe, seeded."""
    rng = np.random.default_rng(seed)
    black = (0.06, 0.06, 0.1)
    base_radius = 1.0
    base_center = np.zeros(3, np.float32)
    cam = look_at(base_center + np.array([0, 0, 3.5], np.float32),
                  base_center, 3.5, 0.04, PI * 0.2)
    objs = [sph_lambertian(tuple(base_center), base_radius, black)]
    for x in range(-2, 2):
        for y in range(-2, 2):
            for z in range(0, 4):
                if rng.random() < 0.6:  # rng.gen_bool(0.6) -> skip
                    continue
                d = np.array([x, y, z], np.float32)
                mat = rng.integers(1, 4)
                size = rng.uniform(0.05, 0.15) * base_radius
                nd = d / np.sqrt(np.sum(d * d)) if np.any(d) else d
                pos = tuple(nd * (base_radius + size) + base_center)
                if mat == MAT_METAL:
                    objs.append(sph_metal(pos, size, tuple(rng.random(3)),
                                          rng.random()))
                elif mat == MAT_DIELECTRIC:
                    objs.append(sph_dielectric(pos, size,
                                               rng.uniform(0.1, 0.4)))
                else:
                    objs.append(sph_lambertian(pos, size,
                                               tuple(rng.random(3))))
    return _sphere_scene("sphere_globe", objs, cam, width, height, device)


def scene_sphere_cover(width=1280, height=720, device="cuda",
                       seed: int = 7) -> SceneDef:
    """Scene 8 (extension): the RTIOW "final scene" cover, ~490 random small
    spheres on a ground sphere and 3 hero spheres.  It exceeds the
    reference's 100-sphere cap on purpose; past 128 live spheres the
    dispatch takes the chunk-culled kernel.  Seeded like the globe scene."""
    rng = np.random.default_rng(seed)
    objs = [sph_lambertian((0.0, -1000.0, 0.0), 1000.0, (0.5, 0.5, 0.5))]
    for a in range(-11, 11):
        for b in range(-11, 11):
            choose = rng.random()
            center = np.array([a + 0.9 * rng.random(), 0.2,
                               b + 0.9 * rng.random()], np.float32)
            if np.linalg.norm(center - np.array([4.0, 0.2, 0.0])) <= 0.9:
                continue
            pos = tuple(center)
            if choose < 0.8:
                albedo = rng.random(3) * rng.random(3)
                objs.append(sph_lambertian(pos, 0.2, tuple(albedo)))
            elif choose < 0.95:
                objs.append(sph_metal(pos, 0.2,
                                      tuple(rng.uniform(0.5, 1.0, 3)),
                                      rng.uniform(0.0, 0.5)))
            else:
                objs.append(sph_dielectric(pos, 0.2, 1.5))
    objs += [
        sph_dielectric((0.0, 1.0, 0.0), 1.0, 1.5),
        sph_lambertian((-4.0, 1.0, 0.0), 1.0, (0.4, 0.2, 0.1)),
        sph_metal((4.0, 1.0, 0.0), 1.0, (0.7, 0.6, 0.5), 0.0),
    ]
    cam = look_at((13.0, 2.0, 3.0), (0.0, 0.0, 0.0), 10.0, 0.1, PI / 9.0)
    return _sphere_scene("sphere_cover", objs, cam, width, height, device)


def scene_rtiow_one_sphere(width=400, height=225, device="cuda") -> SceneDef:
    """BASELINE config 1: one gray Lambertian sphere on a ground sphere."""
    cam = look_at((0.0, 0.0, 0.5), (0.0, 0.0, -1.0), 1.5, 0.0, PI * 0.3)
    objs = [
        sph_lambertian((0.0, -100.5, -1.0), 100.0, (0.5, 0.5, 0.5)),
        sph_lambertian((0.0, 0.0, -1.0), 0.5, (0.5, 0.5, 0.5)),
    ]
    return _sphere_scene("rtiow_one_sphere", objs, cam, width, height, device)


def scene_rtiow_three_spheres(width=800, height=450,
                              device="cuda") -> SceneDef:
    """BASELINE config 2: diffuse centre, dielectric left, metal right, on a
    ground sphere."""
    cam = look_at((0.0, 0.0, 0.8), (0.0, 0.0, -1.0), 1.8, 0.0, PI * 0.3)
    objs = [
        sph_lambertian((0.0, -100.5, -1.0), 100.0, (0.8, 0.8, 0.0)),
        sph_lambertian((0.0, 0.0, -1.0), 0.5, (0.1, 0.2, 0.5)),
        sph_dielectric((-1.0, 0.0, -1.0), 0.5, 1.5),
        sph_metal((1.0, 0.0, -1.0), 0.5, (0.8, 0.6, 0.2), 0.0),
    ]
    return _sphere_scene("rtiow_three_spheres", objs, cam, width, height,
                         device)


def _tris_scene(name, meshes, camera, width, height, device) -> SceneDef:
    tree = bvh_mod.build_tree(meshes)
    kinds = tuple(sorted({int(m[2]) for m in tree.materials})) \
        or (MAT_LAMBERTIAN,)
    return SceneDef(name, "triangles",
                    bvh_mod.to_triangle_scene(tree, device), camera,
                    RenderConfig.for_triangles(width, height,
                                               mat_kinds=kinds))


def scene_quad(width=512, height=512, device="cuda") -> SceneDef:
    """Scene 3."""
    cam = look_at((0.0, 0.2, 3.5), (0.0, 0.1, -3.0), 2.2, 0.0, PI * 0.3)
    m = load_asset("quad.obj", bvh_mod.material_lambertian((0.5, 0.5, 0.6)))
    return _tris_scene("quad", [m], cam, width, height, device)


def scene_cube(width=512, height=512, device="cuda") -> SceneDef:
    """Scene 4."""
    cam = look_at((0.0, 2.2, 6.5), (0.0, 0.1, -3.0), 2.2, 0.0, PI * 0.3)
    m = load_asset("cube2.obj", bvh_mod.material_lambertian((0.5, 0.5, 0.6)))
    return _tris_scene("cube", [m], cam, width, height, device)


def scene_suzanne(width=512, height=512, device="cuda") -> SceneDef:
    """Scene 5 (flagship): Suzanne, an ico sphere and three cubes — five
    materials of all three kinds."""
    cam = look_at((0.0, 2.2, 4.5), (0.0, 0.0, -4.5), 5.6, 0.0, PI * 0.3)
    meshes = [
        load_asset("suzanne.obj",
                   bvh_mod.material_lambertian((0.3, 0.4, 0.6))),
        load_asset("ico_sphere.obj", bvh_mod.material_dielectric(0.2)),
        load_asset("cube_s.obj",
                   bvh_mod.material_metal((0.5, 0.5, 0.6), 0.2)),
        load_asset("cube_m.obj", bvh_mod.material_dielectric(0.1)),
        load_asset("cube_l.obj",
                   bvh_mod.material_lambertian((0.5, 0.5, 0.6))),
    ]
    return _tris_scene("suzanne", meshes, cam, width, height, device)


def scene_lucy(width=512, height=512, device="cuda") -> SceneDef:
    """Scene 6: a ~20K-triangle statue on a floor."""
    cam = look_at((0.0, 5.0, 6.0), (0.0, 0.0, -8.0), 5.6, 0.0, PI * 0.3)
    meshes = [
        load_asset("lucy_lp_20.obj",
                   bvh_mod.material_lambertian((0.4, 0.3, 0.6))),
        load_asset("floor.obj", bvh_mod.material_lambertian((0.5, 0.5, 0.6))),
    ]
    return _tris_scene("lucy", meshes, cam, width, height, device)


def scene_dragon(width=512, height=512, device="cuda") -> SceneDef:
    """Scene 7: a ~50K-triangle dragon on a floor."""
    cam = look_at((0.0, 2.0, 8.0), (0.0, 0.0, -8.0), 5.6, 0.0, PI * 0.3)
    meshes = [
        load_asset("xyzrgb_dragon_lp_20.obj",
                   bvh_mod.material_lambertian((0.7, 0.7, 0.2))),
        load_asset("floor.obj", bvh_mod.material_lambertian((0.5, 0.5, 0.6))),
    ]
    return _tris_scene("dragon", meshes, cam, width, height, device)


SCENE_BY_ID = {
    1: scene_sphere_simple,
    2: scene_sphere_globe,
    3: scene_quad,
    4: scene_cube,
    5: scene_suzanne,
    6: scene_lucy,
    7: scene_dragon,
    8: scene_sphere_cover,   # extension past the reference's 1-7 range
}


def build_scene(scene_id: int, width=512, height=512,
                device="cuda") -> SceneDef:
    """Scene by id; an unknown id gives ``sphere_simple``, as in the
    reference app."""
    return SCENE_BY_ID.get(scene_id, scene_sphere_simple)(width, height,
                                                          device)


# --------------------------------------------------------------------------
# Deterministic golden-test scenes.  Their default camera is the globe
# scene's: look_at((0, 0, 3.5), origin, 3.5, 0.04, pi/5).
# --------------------------------------------------------------------------

def _default_test_camera() -> Camera:
    return look_at((0.0, 0.0, 3.5), (0.0, 0.0, 0.0), 3.5, 0.04, PI * 0.2)


def test_scene_lambertian(width=512, height=512, device="cuda") -> SceneDef:
    objs = [
        sph_lambertian((-2.0, 0.0, -5.0), 1.0, (0.8, 0.2, 0.2)),
        sph_lambertian((0.0, 0.0, -5.0), 1.0, (0.2, 0.8, 0.2)),
        sph_lambertian((2.0, 0.0, -5.0), 1.0, (0.2, 0.2, 0.8)),
        sph_lambertian((0.0, -101.0, -5.0), 100.0, (0.5, 0.5, 0.5)),
    ]
    return _sphere_scene("lambertian_materials", objs, _default_test_camera(),
                         width, height, device)


def test_scene_metal(width=512, height=512, device="cuda") -> SceneDef:
    objs = [
        sph_metal((-2.0, 0.0, -5.0), 1.0, (0.8, 0.8, 0.8), 0.0),
        sph_metal((0.0, 0.0, -5.0), 1.0, (0.8, 0.6, 0.2), 0.2),
        sph_metal((2.0, 0.0, -5.0), 1.0, (0.6, 0.2, 0.8), 0.5),
        sph_lambertian((0.0, -101.0, -5.0), 100.0, (0.5, 0.5, 0.5)),
    ]
    return _sphere_scene("metal_materials", objs, _default_test_camera(),
                         width, height, device)


def test_scene_dielectric(width=512, height=512, device="cuda") -> SceneDef:
    objs = [
        sph_dielectric((0.0, 0.0, -5.0), 1.5, 1.5),
        sph_dielectric((-2.0, 0.0, -4.0), 0.5, 1.33),
        sph_dielectric((2.0, 0.0, -4.0), 0.5, 2.4),
        sph_lambertian((0.0, 0.0, -8.0), 1.0, (1.0, 0.0, 0.0)),
        sph_lambertian((0.0, -101.5, -5.0), 100.0, (0.5, 0.5, 0.5)),
    ]
    return _sphere_scene("dielectric_materials", objs, _default_test_camera(),
                         width, height, device)


def test_scene_camera_position(width=512, height=512,
                               device="cuda") -> SceneDef:
    """Custom camera."""
    objs = []
    for i in range(-2, 3):
        objs.append(sph_lambertian(
            (i * 1.5, 0.0, -5.0 - abs(i)), 0.5,
            (0.5 + i * 0.1, 0.5, 0.5 - i * 0.1)))
    objs.append(sph_lambertian((0.0, -100.5, -5.0), 100.0, (0.5, 0.5, 0.5)))
    cam = look_at((3.0, 1.5, -2.0), (0.0, 0.0, -5.0), 5.0, 0.1, 0.8)
    return _sphere_scene("camera_position", objs, cam, width, height, device)


def test_scene_depth_of_field(width=512, height=512,
                              device="cuda") -> SceneDef:
    """Strong defocus blur."""
    objs = []
    for i in range(-3, 4):
        z = -3.0 - abs(i) * 2.0
        objs.append(sph_lambertian(
            (float(i), 0.0, z), 0.4,
            (1.0 - (i + 3) / 6.0, 0.5, (i + 3) / 6.0)))
    objs.append(sph_lambertian((0.0, -100.4, -5.0), 100.0, (0.5, 0.5, 0.5)))
    cam = look_at((0.0, 1.0, 0.0), (0.0, 0.0, -5.0), 5.0, 0.3, 0.8)
    return _sphere_scene("depth_of_field", objs, cam, width, height, device)


def test_scene_complex(width=512, height=512, device="cuda") -> SceneDef:
    """5x5 mixed-material grid."""
    objs = []
    for i in range(-2, 3):
        for j in range(-2, 3):
            if i == 0 and j == 0:
                objs.append(sph_dielectric((0.0, 0.0, -5.0), 0.8, 1.5))
            else:
                x = i * 1.2
                z = -5.0 + j * 1.2
                mt = abs(i + j) % 3
                if mt == 0:
                    objs.append(sph_lambertian((x, 0.0, z), 0.3,
                                               (0.7, 0.3, 0.3)))
                elif mt == 1:
                    objs.append(sph_metal((x, 0.0, z), 0.3, (0.7, 0.7, 0.7),
                                          0.1))
                else:
                    objs.append(sph_dielectric((x, 0.0, z), 0.3, 1.33))
    objs.append(sph_lambertian((0.0, -100.3, -5.0), 100.0, (0.5, 0.5, 0.5)))
    return _sphere_scene("complex_scene", objs, _default_test_camera(),
                         width, height, device)


def test_scene_shadow(width=512, height=512, device="cuda") -> SceneDef:
    objs = [
        sph_lambertian((0.0, 2.0, -5.0), 2.0, (0.7, 0.3, 0.3)),
        sph_lambertian((0.0, -0.5, -5.0), 0.5, (0.3, 0.7, 0.3)),
        sph_lambertian((0.0, -101.0, -5.0), 100.0, (0.8, 0.8, 0.8)),
    ]
    return _sphere_scene("shadow_rendering", objs, _default_test_camera(),
                         width, height, device)


def test_scene_perf(width=512, height=512, device="cuda") -> SceneDef:
    """20-sphere ring perf scene."""
    objs = []
    for i in range(20):
        ang = i * np.pi * 2.0 / 20.0
        objs.append(sph_lambertian(
            (np.cos(ang) * 3.0, 0.0, -5.0 + np.sin(ang) * 3.0), 0.4,
            (i / 20.0, 0.5, 1.0 - i / 20.0)))
    objs.append(sph_lambertian((0.0, -100.4, -5.0), 100.0, (0.5, 0.5, 0.5)))
    return _sphere_scene("perf", objs, _default_test_camera(), width,
                         height, device)


GOLDEN_SCENES = {
    "lambertian_materials": test_scene_lambertian,
    "metal_materials": test_scene_metal,
    "dielectric_materials": test_scene_dielectric,
    "camera_position": test_scene_camera_position,
    "depth_of_field": test_scene_depth_of_field,
    "complex_scene": test_scene_complex,
    "shadow_rendering": test_scene_shadow,
}
