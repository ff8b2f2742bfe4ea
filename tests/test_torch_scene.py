"""rt_torch host scene side against the JAX package: OBJ loader, BVH
triangle order and normals, cameras, the packed camera row and the kernels'
tables, for quad, cube and suzanne.  Tolerance: none — all bitwise.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rt.core import camera as jcamera
from rt.kernels import dispatch as jdispatch
from rt.kernels import tris_kernel as jtk
from rt.scene import objloader as jobj
from rt.scene import scenes as jscenes
from rt_torch import convert
from rt_torch.core import camera as tcamera
from rt_torch.kernels import dispatch as tdispatch
from rt_torch.kernels import tris_kernel as ttk
from rt_torch.scene import objloader as tobj
from rt_torch.scene import scenes as tscenes
from test_torch_parity_util import scene_fields
from _torch_threads import one_torch_thread  # noqa: F401

SCENES = ["quad", "cube", "suzanne"]


def both(name, w=64, h=32):
    return (getattr(jscenes, f"scene_{name}")(w, h),
            getattr(tscenes, f"scene_{name}")(w, h, device="cpu"))


@pytest.mark.parametrize("asset", ["quad.obj", "cube2.obj", "suzanne.obj",
                                   "ico_sphere.obj", "cube_s.obj"])
def test_obj_loader_equals_jax_python_parser(asset):
    want = jobj.load_obj(os.path.join(jobj.ASSET_DIR, asset),
                         use_native=False)
    got = tobj.load_asset(asset)
    assert got.vertices.dtype == np.float32 and got.indices.dtype == np.uint32
    np.testing.assert_array_equal(got.vertices, want.vertices)
    np.testing.assert_array_equal(got.indices, want.indices)
    assert got.num_triangles == want.num_triangles > 0


def test_obj_loader_empty_on_garbage():
    m = tobj.load_obj("v 1 2\nf 1 2 3\n")
    assert m.num_triangles == 0 and m.vertices.shape == (0, 3)


@pytest.mark.parametrize("name", SCENES)
def test_scene_fields_equal_jax(name):
    """BFS-median triangle order, flat normals, node boxes, materials."""
    jsd, tsd = both(name)
    for field, want in scene_fields(jsd.scene).items():
        got = getattr(tsd.scene, field).numpy()
        assert got.shape == want.shape, field
        np.testing.assert_array_equal(got.astype(want.dtype), want,
                                      err_msg=field)
    assert tsd.config.mat_kinds == jsd.config.mat_kinds
    assert tsd.config.bounces == jsd.config.bounces
    assert tsd.config.normalize_defocus_dir and \
        not tsd.config.normalize_reflect_in


@pytest.mark.parametrize("name", SCENES)
def test_camera_and_packed_row_equal_jax(name):
    jsd, tsd = both(name)
    for field in jsd.camera._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(jsd.camera, field)),
            np.asarray(getattr(tsd.camera, field)), err_msg=field)
    want = np.asarray(jdispatch.pack_camera(jsd.camera))
    got = tdispatch.pack_camera(tsd.camera)
    assert got.shape == (1, 20) and got.dtype == np.float32
    np.testing.assert_array_equal(got[0, :19], want[0, :19])
    # slot 19: tan(fov/2), held to XLA's value at this scene's fov
    k = np.asarray(jnp.tan(jsd.camera.fov * 0.5))
    assert got[0, 19].view(np.uint32) == k.view(np.uint32)


def test_orbit_uniform_equals_jax():
    want = jcamera.orbit_uniform((1.0, 2.0, 3.0), (0.0, 0.5, -1.0), 0.8)
    got = tcamera.orbit_uniform((1.0, 2.0, 3.0), (0.0, 0.5, -1.0), 0.8)
    for field in want._fields:
        np.testing.assert_array_equal(np.asarray(getattr(want, field)),
                                      np.asarray(getattr(got, field)))


@pytest.mark.parametrize("name", SCENES)
def test_pack_tri_table_equals_jax(name):
    jsd, tsd = both(name)
    tab, mats, chunks, _, m_pad, n_chunks = jtk.pack_tri_table(jsd.scene)
    packed = ttk.pack_tri_table(tsd.scene)
    assert packed.tab.shape == (m_pad, 13) and packed.n_chunks == n_chunks
    np.testing.assert_array_equal(packed.tab.numpy(), np.asarray(tab))
    np.testing.assert_array_equal(packed.mats.numpy(), np.asarray(mats))
    np.testing.assert_array_equal(packed.chunks.numpy(), np.asarray(chunks))
    # Morton order itself (stable) and the camera-eye chunk order
    cen = (jsd.scene.a + jsd.scene.b + jsd.scene.c) / 3.0
    np.testing.assert_array_equal(
        ttk._morton_order(torch.from_numpy(np.array(cen))).numpy(),
        np.asarray(jtk._morton_order(cen)))
    eye = jdispatch.pack_camera(jsd.camera)[0, 0:3]
    centroid = (chunks[:, 0:3] + chunks[:, 3:6]) * 0.5
    want = jnp.argsort(jnp.sum((centroid - eye) ** 2, axis=1))
    got = ttk.chunk_order(packed.centroid,
                          torch.from_numpy(np.array(eye)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_convert_carries_scene_camera_and_state():
    jsd, tsd = both("suzanne")
    scene = convert.scene_from_numpy(scene_fields(jsd.scene), device="cpu")
    for a, b in zip(scene, tsd.scene):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    cam = convert.camera_from_numpy(
        {k: np.asarray(getattr(jsd.camera, k)) for k in jsd.camera._fields})
    np.testing.assert_array_equal(tdispatch.pack_camera(cam),
                                  tdispatch.pack_camera(tsd.camera))
    img = np.random.default_rng(0).random((4, 6, 3), dtype=np.float32)
    st = convert.render_state_from_numpy(img, np.uint32(7), device="cpu")
    assert st.frame_count == 7 and st.image.dtype == torch.float32
    np.testing.assert_array_equal(st.image.numpy(), img)
    with pytest.raises(ValueError):
        convert.scene_from_numpy({"a": np.zeros((1, 3))}, device="cpu")
    with pytest.raises(ValueError):
        convert.render_state_from_numpy(np.zeros((4, 6)), 0, device="cpu")


@pytest.mark.parametrize("scene_id,name,kind", [
    (1, "sphere_simple", "spheres"), (2, "sphere_globe", "spheres"),
    (3, "quad", "triangles"), (4, "cube", "triangles"),
    (5, "suzanne", "triangles"), (6, "lucy", "triangles"),
    (7, "dragon", "triangles"), (8, "sphere_cover", "spheres"),
    (0, "sphere_simple", "spheres"), (99, "sphere_simple", "spheres")])
def test_build_scene_ids(scene_id, name, kind):
    """All eight ids; an unknown id gives the default scene, as in the JAX
    package."""
    sd = tscenes.build_scene(scene_id, 64, 32, device="cpu")
    assert sd.name == name and sd.kind == kind and sd.config.width == 64
    assert sd.name == jscenes.build_scene(scene_id, 64, 32).name
    assert sd.with_resolution(16, 8).config.height == 8
    assert sorted(tscenes.SCENE_BY_ID) == sorted(jscenes.SCENE_BY_ID)


@pytest.mark.parametrize("name", ["lucy", "dragon"])
def test_large_scene_fields_equal_jax(name):
    jsd, tsd = both(name)
    assert tsd.scene.m > 8192
    for field, want in scene_fields(jsd.scene).items():
        got = getattr(tsd.scene, field).numpy()
        np.testing.assert_array_equal(got.astype(want.dtype), want,
                                      err_msg=field)
    assert tsd.config.mat_kinds == jsd.config.mat_kinds == (1,)
