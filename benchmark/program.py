"""The system under test, built from a configuration and a traffic mix:
the port's scene, camera and render configuration, its progressive
renderer, and its material fit.  This is the only module of the benchmark
that imports the program."""

from __future__ import annotations

import os

from benchmark.reference import scene as ref_scene


def camera(config: dict):
    """The configuration's camera as the program's Camera: the benchmark
    makes it and hands the same floats to the reference."""
    from rt_torch.core.camera import Camera

    c = ref_scene.look_at(config["camera"])
    return Camera(eye=c["eye"], direction=c["direction"], up=c["up"],
                  right=c["right"], focal_length=c["focal_length"],
                  focal_blur=c["focal_blur"], fov=c["fov"])


def _material(spec: dict):
    from rt_torch.scene import bvh

    if spec["kind"] == "lambertian":
        return bvh.material_lambertian(spec["albedo"])
    if spec["kind"] == "metal":
        return bvh.material_metal(spec["albedo"], spec["fuzz"])
    return bvh.material_dielectric(spec["ir"])


def scene_def(config: dict, traffic: dict, root: str, device):
    """The program's SceneDef: the configuration's geometry through the
    port's OBJ loader and BVH build (triangles) or sphere packing, at the
    traffic's image size and samples a frame, the configuration's
    bounces."""
    from rt_torch.config import MAX_SPHERES, RenderConfig
    from rt_torch.core.sphere import pack_spheres
    from rt_torch.scene import bvh, objloader
    from rt_torch.scene.scenes import SceneDef

    w, h = traffic["width"], traffic["height"]
    common = dict(bounces=config["bounces"],
                  samples_per_frame=traffic.get("spp", 1))
    if config["kind"] == "triangles":
        meshes = [objloader.load_obj(os.path.join(root, m["obj"]),
                                     _material(m["material"]),
                                     use_native=True)
                  for m in config["meshes"]]
        tree = bvh.build_tree(meshes)
        kinds = tuple(sorted({int(m[2]) for m in tree.materials}))
        scene = bvh.to_triangle_scene(tree, device)
        rc = RenderConfig.for_triangles(w, h, mat_kinds=kinds, **common)
    else:
        objs = []
        for s in config["spheres"]:
            albedo, param, kind = ref_scene.material(s["material"])
            objs.append((tuple(s["center"]), s["radius"], tuple(albedo),
                         float(param), kind))
        pad = (MAX_SPHERES if len(objs) <= MAX_SPHERES
               else -(-len(objs) // 8) * 8)
        scene = pack_spheres(objs, pad, device)
        kinds = tuple(sorted({o[4] for o in objs}))
        rc = RenderConfig.for_spheres(w, h, n_active_spheres=len(objs),
                                      mat_kinds=kinds, **common)
    return SceneDef(config["name"], config["kind"], scene, camera(config), rc)


def renderer(sd, device):
    from rt_torch.render.renderer import ProgressiveRenderer

    return ProgressiveRenderer(sd, device=device)


class Fit:
    """A material fit: the target rendered at the true albedo
    (``prepare``), then ``fit_replay`` from the traffic's wrong albedo
    rows, whole fits back to back."""

    def __init__(self, sd, traffic: dict, device):
        self.sd, self.traffic, self.device = sd, traffic, device
        albedo = sd.scene.mat_albedo.clone()
        for row, rgb in traffic["wrong_albedo"].items():
            albedo[int(row)] = albedo.new_tensor(rgb)
        self.scene = sd.scene._replace(mat_albedo=albedo)

    def prepare(self, time: int):
        """The target of the fits at time uniform ``time``."""
        from rt_torch.kernels import dispatch

        self.time = time
        self.target = dispatch.render_color(self.sd.scene, self.sd.camera,
                                            self.sd.config, time,
                                            self.device)

    def run(self, steps: int | None = None):
        """One whole fit: (recovered albedo, losses)."""
        from rt_torch.grad.train import fit_replay

        t = self.traffic
        params, losses = fit_replay(
            self.scene, self.sd.camera, self.sd.config, self.target,
            time=self.time, steps=steps or t["steps"],
            rerecord_every=t["rerecord_every"],
            learning_rate=t["learning_rate"], device=self.device)
        return params["scene"].mat_albedo, losses


def launch_counts() -> dict:
    from rt_torch.kernels import dispatch

    return dict(dispatch.launch_counts())

