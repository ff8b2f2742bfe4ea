"""Scene constructors — counterpart of ``rt/scene/scenes.py`` for the
triangle scenes ported so far: quad (3), cube (4), suzanne (5).

Each returns a ``SceneDef``: the packed scene on ``device``, the authored
camera and the per-variant RenderConfig.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np

from rt_torch.config import MAT_LAMBERTIAN, RenderConfig
from rt_torch.core.camera import Camera, look_at
from rt_torch.core.triangle import TriangleScene
from rt_torch.scene import bvh as bvh_mod
from rt_torch.scene.objloader import load_asset

PI = np.float32(np.pi)


@dataclass
class SceneDef:
    name: str
    kind: str                  # "triangles"
    scene: TriangleScene
    camera: Camera
    config: RenderConfig

    def with_resolution(self, width, height):
        return dataclasses.replace(self, config=dataclasses.replace(
            self.config, width=width, height=height))


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


SCENE_BY_ID = {3: scene_quad, 4: scene_cube, 5: scene_suzanne}

# scene ids of the JAX package that are not ported yet
_NOT_PORTED = {
    1: "sphere_simple (ROADMAP M6, sphere path)",
    2: "sphere_globe (ROADMAP M6, sphere path)",
    6: "lucy (ROADMAP M5, large-scene wave branch)",
    7: "dragon (ROADMAP M5, large-scene wave branch)",
    8: "sphere_cover (ROADMAP M6, sphere path)",
}


def build_scene(scene_id: int, width=512, height=512,
                device="cuda") -> SceneDef:
    if scene_id in SCENE_BY_ID:
        return SCENE_BY_ID[scene_id](width, height, device)
    raise NotImplementedError(
        f"scene {scene_id} is not ported yet: "
        + _NOT_PORTED.get(scene_id, "unknown scene id"))
