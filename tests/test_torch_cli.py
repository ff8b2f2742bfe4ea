"""The port's CLI takes the reference's scene id: a positional id,
``--scene`` over it, and a random id in 1..7 when it is absent or not a
number (``tests/test_cli.py::test_scene_id_fallback_semantics`` on
``rt.cli``; the reference's ``App::parse_args``, ``src/app.rs:36-41``)."""

import dataclasses
import random

import pytest

from rt import cli as jcli
from rt_torch import cli
from rt_torch.render.ppm import write_ppm
from rt_torch.render.renderer import ProgressiveRenderer
from rt_torch.scene import scenes
from _torch_threads import one_torch_thread  # noqa: F401


def test_scene_id_fallback_semantics():
    ns = cli.parse_args(["5"])
    assert cli.resolve_scene_id(ns) == 5

    random.seed(123)
    expect = random.randint(1, 7)
    random.seed(123)
    got = cli.resolve_scene_id(cli.parse_args(["not-a-number"]))
    assert got == expect and 1 <= got <= 7

    random.seed(123)
    assert cli.resolve_scene_id(cli.parse_args([])) == expect

    ns = cli.parse_args(["3", "--scene", "4"])
    assert cli.resolve_scene_id(ns) == 4
    assert cli.resolve_scene_id(cli.parse_args(["--scene", "8"])) == 8


def test_scene_id_resolves_as_the_jax_cli_does():
    """The same argument lists, the same random state: the same id."""
    for argv in (["5"], ["x"], [], ["3", "--scene", "4"], ["--scene", "2"],
                 ["8"]):
        random.seed(7)
        want = jcli.resolve_scene_id(jcli.parse_args(argv))
        random.seed(7)
        assert cli.resolve_scene_id(cli.parse_args(argv)) == want, argv


def test_positional_scene_renders(tmp_path):
    out = tmp_path / "q.ppm"
    assert cli.main(["3", "--frames", "1", "--size", "16x16", "--device",
                     "cpu", "-o", str(out)]) == 0
    assert out.read_text().startswith("P3\n16 16 255\n")


def test_bounces_override(tmp_path):
    """``--bounces`` renders what the scene at that many bounces renders."""
    out, want = tmp_path / "c.ppm", tmp_path / "w.ppm"
    assert cli.main(["4", "--bounces", "2", "--frames", "1", "--size",
                     "16x16", "--device", "cpu", "-o", str(out)]) == 0
    sd = scenes.build_scene(4, 16, 16, device="cpu")
    assert sd.config.bounces != 2
    sd = dataclasses.replace(sd, config=dataclasses.replace(sd.config,
                                                            bounces=2))
    r = ProgressiveRenderer(sd, device="cpu")
    r.set_time(1000)
    r.draw_frames(1, 10)
    write_ppm(str(want), r.image)
    assert out.read_bytes() == want.read_bytes()


def test_scene_name_renders_the_named_scene(tmp_path):
    """``--scene-name`` renders a scene of ``rt_torch.scene.scenes`` that
    has no id (the BENCH_CONFIGS config2 scene), with or without its
    ``scene_`` prefix, as the renderer renders it; an unknown name stops
    the CLI."""
    outs = [tmp_path / "a.ppm", tmp_path / "b.ppm"]
    for name, out in zip(("rtiow_three_spheres", "scene_rtiow_three_spheres"),
                         outs):
        assert cli.main(["--scene-name", name, "--spp", "2", "--bounces",
                         "3", "--frames", "1", "--size", "16x8", "--device",
                         "cpu", "-o", str(out)]) == 0
    sd = scenes.scene_rtiow_three_spheres(16, 8, device="cpu")
    sd = dataclasses.replace(sd, config=dataclasses.replace(
        sd.config, bounces=3, samples_per_frame=2))
    r = ProgressiveRenderer(sd, device="cpu")
    r.set_time(1000)
    r.draw_frames(1, 10)
    want = tmp_path / "w.ppm"
    write_ppm(str(want), r.image)
    assert outs[0].read_bytes() == outs[1].read_bytes() == want.read_bytes()
    with pytest.raises(SystemExit, match="no scene named"):
        cli.main(["--scene-name", "nothing", "--device", "cpu"])
