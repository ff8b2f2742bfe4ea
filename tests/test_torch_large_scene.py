"""The wave path's large-scene branch (above ``SMALL_SCENE_MAX_TRIS``
triangles) through the plain versions on the CPU: ``split_big`` tables
with group boxes, the ``morton`` key and a sort before every 1-bounce
launch, held bit for bit against the benchmark's plain reference
(``benchmark/reference``, a brute-force closest hit over the OBJ files'
own triangles); the plain versions' scan counters against
``trace_bounce``'s ``scan_counts``; and the benchmark's ``dragon``
configuration against scene 7."""

import json
import os

import numpy as np
import pytest
import torch

from benchmark import program
from benchmark.reference import scene as ref_scene
from benchmark.reference import tracer
from rt_torch.kernels import dispatch
from rt_torch.kernels import tris_kernel as ttk
from rt_torch.scene import scenes
from rt_torch.utils import profiling
from _torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE, BOUNCES = 16, 3
TIMES = [123456789, 4000000007]
N_BIG = 16


def _obj(tris: np.ndarray) -> str:
    """OBJ text of (F, 3, 3) f32 triangles, each with vertices of its own:
    every float printed so that it parses back to the same f32."""
    lines = [f"v {x!r} {y!r} {z!r}" for x, y, z in
             tris.reshape(-1, 3).astype(np.float32).tolist()]
    lines += [f"f {3 * k + 1} {3 * k + 2} {3 * k + 3}"
              for k in range(len(tris))]
    return "\n".join(lines) + "\n"


def _soup(rng):
    """Three meshes of small triangles scattered in front of the camera
    (lambertian, metal, dielectric; 3,200 each) and N_BIG oversized ones
    (lambertian) under and behind them, no two sharing a vertex, so that
    exact-t ties between triangles have measure zero."""
    small = []
    for _ in range(3):
        c = rng.uniform((-3.0, -1.0, -7.0), (3.0, 1.5, -3.0), (3200, 1, 3))
        small.append(c + rng.normal(0.0, 0.08, (3200, 3, 3)))
    c = np.concatenate([rng.uniform((-6.0, -2.0, -12.0), (6.0, -1.6, -2.0),
                                    (N_BIG // 2, 1, 3)),
                        rng.uniform((-6.0, -1.0, -12.0), (6.0, 3.0, -11.0),
                                    (N_BIG // 2, 1, 3))])
    big = c + rng.normal(0.0, 3.0, (N_BIG, 3, 3))
    return small + [big]


@pytest.fixture(scope="module")
def soup(tmp_path_factory):
    """The soup's configuration, the port's SceneDef of it, the wave path's
    frames with the spans on, the scan_counts entries and live rays of
    every trace_bounce of them, and the counters' change."""
    d = tmp_path_factory.mktemp("soup")
    mats = [{"kind": "lambertian", "albedo": [0.7, 0.6, 0.3]},
            {"kind": "metal", "albedo": [0.8, 0.8, 0.9], "fuzz": 0.3},
            {"kind": "dielectric", "ir": 1.5},
            {"kind": "lambertian", "albedo": [0.5, 0.5, 0.6]}]
    meshes = []
    for k, (tris, mat) in enumerate(zip(_soup(np.random.default_rng(7)),
                                        mats)):
        path = d / f"mesh{k}.obj"
        path.write_text(_obj(tris))
        meshes.append({"obj": str(path), "material": mat})
    config = {"name": "soup", "kind": "triangles", "meshes": meshes,
              "camera": {"eye": [0.0, 0.5, 2.0], "target": [0.0, 0.0, -5.0],
                         "focal_length": 5.0, "focal_blur": 0.0,
                         "fov_pi": 0.3},
              "bounces": BOUNCES}
    traffic = {"width": SIZE, "height": SIZE, "spp": 1}
    sd = program.scene_def(config, traffic, ROOT, "cpu")

    plain, entries, rays = ttk.trace_bounce, [], []

    def seen(packed, order, carry, flags, scan_counts=None, **kw):
        mine = []
        out = plain(packed, order, carry, flags, scan_counts=mine, **kw)
        entries.extend(mine)
        rays.append(int((carry[4] > 0).sum()))
        if scan_counts is not None:
            scan_counts.extend(mine)
        return out

    before = profiling.counters()
    # the scan takes a chunk's 32 triangles at once, as on a card: the same
    # bits in a fraction of the CPU loop's time
    whole = ttk._whole_chunks
    ttk.trace_bounce, ttk._whole_chunks = seen, lambda rays: True
    profiling.enable()
    try:
        colors = dispatch.render_color_frames(sd.scene, sd.camera, sd.config,
                                              TIMES, "cpu")
    finally:
        profiling.disable()
        profiling.take()
        ttk.trace_bounce, ttk._whole_chunks = plain, whole
    after = profiling.counters()
    change = {k: after[k] - before[k] for k in after}
    return config, sd, colors, entries, rays, change


def test_soup_takes_the_large_branch(soup):
    _, sd, _, _, _, _ = soup
    scene = sd.scene
    assert scene.m > dispatch.SMALL_SCENE_MAX_TRIS
    kw = dispatch.wave_params(scene, sd.config)
    assert (kw["key_mode"], kw["sort_every"]) == ("morton", 1)
    packed = dispatch.pack_scene(scene)
    assert packed.groups is not None
    # split_big: the oversized triangles, and only they, in the last rows
    e1, e2 = scene.b - scene.a, scene.c - scene.a
    area2 = (torch.linalg.cross(e1, e2) ** 2).sum(dim=1)
    big = area2 > 256.0 * area2.median()
    assert int(big.sum()) == N_BIG
    assert bool(big[packed.order[-N_BIG:]].all())


def test_soup_frames_equal_the_plain_reference(soup):
    config, _, colors, _, _, _ = soup
    scene = tracer.Triangles(ref_scene.triangles(config, ROOT), "cpu",
                             torch.float32)
    cam = ref_scene.camera_row(ref_scene.look_at(config["camera"]))
    ys, xs = torch.meshgrid(torch.arange(SIZE), torch.arange(SIZE),
                            indexing="ij")
    want = tracer.render(scene, cam, xs.reshape(-1), ys.reshape(-1), TIMES,
                         height=SIZE, width=SIZE, spp=1, bounces=BOUNCES)
    got = colors.reshape(len(TIMES), SIZE * SIZE, 3)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_plain_scan_counters_equal_scan_counts(soup):
    _, _, _, entries, rays, change = soup
    assert len(entries) == len(rays) == BOUNCES
    assert change["wave_rays"] == sum(rays) > 0
    assert change["wave_chunk_scans"] == sum(e[0] for e in entries) > 0
    assert change["wave_box_tests"] == sum(e[1] for e in entries) > 0


def test_scan_counters_stay_with_spans_off():
    sd = scenes.scene_suzanne(16, 8, device="cpu")
    before = profiling.counters()
    dispatch.render_color_frames(sd.scene, sd.camera, sd.config, [TIMES[0]],
                                 "cpu")
    after = profiling.counters()
    assert all(after[k] == before[k] for k in profiling.DEVICE_COUNTS)


def test_dragon_configuration_builds_scene_7():
    """The benchmark's ``dragon`` configuration gives scene 7's triangle
    table (the kernels' tables are packed from it alone), materials,
    camera and render configuration."""
    with open(os.path.join(ROOT, "benchmark", "configs", "dragon.json")) as f:
        config = json.load(f)
    traffic = {"width": 512, "height": 512, "spp": 1}
    got = program.scene_def(config, traffic, ROOT, "cpu")
    want = scenes.scene_dragon(512, 512, device="cpu")
    assert got.scene.m == config["triangles"] == want.scene.m
    assert got.scene.mat_albedo.shape[0] == config["materials"]
    for x, y in zip(got.scene, want.scene):
        assert torch.equal(x, y)
    assert got.config == want.config
    assert got.config.bounces == config["bounces"]
    for field in ("eye", "direction", "up", "right", "focal_length",
                  "focal_blur", "fov"):
        assert np.array_equal(np.asarray(getattr(got.camera, field)),
                              np.asarray(getattr(want.camera, field))), field
