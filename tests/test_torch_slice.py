"""The ported path as a whole: ``rt_torch`` on the CPU against the JAX package's
wavefront path in interpret mode, on suzanne and quad, 64x32, 3 bounces,
at the JAX package's tile (th=32, tw=128, so both pad to 32x128 and the
padding pixels are real rays in both).

Tolerance.  The JAX side is a jitted graph: XLA's CPU compiler contracts
multiply-adds in the kernel bodies and the sky/EMA expressions, the port
rounds every operation (tests/test_torch_kernels.py holds the two bitwise
when the JAX kernels run eagerly).  So pixels agree to a few ULP, and a ray
on a branch edge (a grazing hit, a Schlick draw) can take the other branch
and change its pixel visibly.  A pixel whose channels differ by more than
1e-6 counts as flipped; at most 0.5 % of pixels may flip, and the images
must stay within the goldens' 0.05 % mean-absolute-u8 bound of each other.
"""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from rt.kernels import dispatch as jdispatch
from rt.render import ppm as jppm
from rt.render.renderer import ProgressiveRenderer as JaxRenderer
from rt.scene import scenes as jscenes
from rt_torch.kernels import dispatch as tdispatch
from rt_torch.render import ppm as tppm
from rt_torch.render.renderer import ProgressiveRenderer as TorchRenderer
from rt_torch.scene import scenes as tscenes
import test_torch_parity_util as U
from _torch_threads import one_torch_thread  # noqa: F401

W, H, BOUNCES = 64, 32, 3
JAX_TILE = (32, 128)          # dispatch.wave_params of rt/ at 64x32
FLIP_ABOVE, FLIP_LIMIT, U8_BOUND_PCT = 1e-6, 0.005, 0.05
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def scene_pair(name):
    jsd = getattr(jscenes, f"scene_{name}")(W, H)
    jsd = dataclasses.replace(jsd, config=dataclasses.replace(
        jsd.config, bounces=BOUNCES, backend="pallas", interpret=True))
    tsd = getattr(tscenes, f"scene_{name}")(W, H, device="cpu")
    # same scene arrays on both sides, carried across as NumPy
    tsd = dataclasses.replace(
        tsd, scene=U.port_scene(jsd.scene), camera=U.port_camera(jsd.camera),
        config=dataclasses.replace(tsd.config, bounces=BOUNCES,
                                   tile=JAX_TILE))
    return jsd, tsd


def assert_images_agree(want, got):
    assert want.shape == got.shape == (H, W, 3)
    assert np.isfinite(got).all()
    flips = (np.abs(want - got).max(axis=-1) > FLIP_ABOVE).mean()
    assert flips <= FLIP_LIMIT, f"{flips:.3%} of pixels flipped"
    ok, pct = tppm.compare_ppm(tppm.render_ppm(got), tppm.render_ppm(want),
                               U8_BOUND_PCT)
    assert ok, f"{pct:.4f}% > {U8_BOUND_PCT}%"


@pytest.mark.parametrize("name", ["suzanne", "quad"])
def test_render_color_equals_jax_wavefront(name):
    jsd, tsd = scene_pair(name)
    want = np.asarray(jdispatch.render_color(
        jsd.scene, jsd.camera, jsd.config, jnp.uint32(1000), interpret=True))
    got = tdispatch.render_color(tsd.scene, tsd.camera, tsd.config, 1000,
                                 device="cpu").numpy()
    assert_images_agree(want, got)


def test_progressive_renderers_agree_over_three_frames():
    jsd, tsd = scene_pair("suzanne")
    jr, tr = JaxRenderer(jsd), TorchRenderer(tsd, device="cpu")
    for r in (jr, tr):
        r.set_time(1000)
        r.draw_frames(3)
    assert tr.frame_count == jr.frame_count == 3
    assert tr.time == jr.time == 1030
    assert_images_agree(np.asarray(jr.image), tr.image)
    # draw() one more frame at the advanced time; reset zeroes both
    jr.draw()
    tr.draw()
    assert_images_agree(np.asarray(jr.image), tr.image)
    tr.reset_frame_count()
    assert tr.frame_count == 0 and float(tr.image.max()) == 0.0
    tr.resize(16, 8)
    assert tr.image.shape == (8, 16, 3)


def test_ema_weights_are_the_f32_values_jax_uses():
    """mix(old, color, 1/(min(fc, SAMPLE_FRAME)+1)) with f32 weights: frame
    counts past the saturation frame keep the last weight."""
    import torch
    from rt_torch.render import renderer as tr
    cfg = dataclasses.replace(tscenes.scene_quad(8, 8, device="cpu").config,
                              sample_frame=2, tile=(8, 32))
    sd = tscenes.scene_quad(8, 8, device="cpu")
    state = tr.RenderState(torch.ones((8, 8, 3)), 5)
    out = tr.render_frame(sd.scene, sd.camera, state, 1000, cfg, "cpu")
    color = tdispatch.render_color(sd.scene, sd.camera, cfg, 1000, "cpu")
    w = np.float32(1.0) / np.float32(3.0)
    want = state.image * float(np.float32(1.0) - w) + color * float(w)
    assert out.frame_count == 6
    assert torch.equal(out.image, want)


def test_default_tile_gives_the_same_image_up_to_regrouping():
    """The card's default tile regroups rays; the closest hit does not
    depend on the grouping except at exact-t ties and box-surface rounding,
    so the image stays within the golden bound of the JAX-tile image."""
    _, tsd = scene_pair("suzanne")
    a = tdispatch.render_color(tsd.scene, tsd.camera, tsd.config, 1000,
                               device="cpu").numpy()
    cfg = dataclasses.replace(tsd.config, tile=None)
    b = tdispatch.render_color(tsd.scene, tsd.camera, cfg, 1000,
                               device="cpu").numpy()
    assert_images_agree(a, b)


def test_ppm_writer_and_comparator_equal_jax():
    g = np.random.default_rng(0)
    img = g.uniform(-0.2, 1.3, (9, 7, 3)).astype(np.float32)
    img[0, 0] = [np.nan, np.inf, -np.inf]
    text = tppm.render_ppm(img)
    assert text == jppm.render_ppm(img, use_native=False)
    np.testing.assert_array_equal(tppm.image_to_u8(img),
                                  jppm.image_to_u8(img))
    other = tppm.render_ppm(np.clip(img + 0.01, 0, 1))
    assert tppm.compare_ppm(text, other) == jppm.compare_ppm(text, other)
    with pytest.raises(ValueError):
        tppm.compare_ppm(text, tppm.render_ppm(img[:4]))


def test_cli_writes_a_ppm_on_the_cpu(tmp_path):
    from rt_torch import cli
    out = tmp_path / "quad.ppm"
    assert cli.main(["--scene", "3", "--frames", "2", "--size", "32x16",
                     "--device", "cpu", "-o", str(out)]) == 0
    dims, px = tppm.parse_ppm(out.read_text())
    assert dims == "32 16 255" and len(px) == 32 * 16 * 3 and px.max() > 0


def test_unported_branches_raise():
    sd = tscenes.scene_quad(16, 8, device="cpu")
    with pytest.raises(TypeError):
        tdispatch.render_color(object(), sd.camera, sd.config, 1000, "cpu")


@pytest.mark.parametrize("argv", [
    ["--scene", "1"], ["--scene", "2", "--seed", "3"],
    ["--scene", "8", "--frames", "1"], ["--scene", "1", "--spp", "3"],
    ["--scene", "4", "--spp", "3", "--frames", "1"]])
def test_cli_sphere_scenes_and_spp_on_the_cpu(tmp_path, argv):
    from rt_torch import cli
    out = tmp_path / "out.ppm"
    base = ["--frames", "2", "--size", "32x16", "--device", "cpu", "-o",
            str(out)]
    assert cli.main(base + argv) == 0
    dims, px = tppm.parse_ppm(out.read_text())
    assert dims == "32 16 255" and len(px) == 32 * 16 * 3 and px.max() > 0
    assert len(np.unique(px)) > 8


def test_progressive_sphere_renderer_packs_once_and_agrees_with_jax():
    """scene 1 through ProgressiveRenderer on both sides, 3 frames at spp 2
    (the kernels' sample loop on the port's side, the JAX package's on the
    other).  sphere_simple holds dielectrics, whose t ~ 0 re-hits flip
    with the last bit (see tests/test_torch_sphere.py), so the limits are
    taken here: twice what the JAX package's own oracle renderer
    differs from its kernel backend over the same three frames (the port
    reads 1.5 times it in u8)."""
    jsd = jscenes.scene_sphere_simple(W, H)
    ocfg = dataclasses.replace(jsd.config, bounces=BOUNCES,
                               samples_per_frame=2)
    jsd = dataclasses.replace(jsd, config=dataclasses.replace(
        ocfg, backend="pallas", interpret=True))
    tsd = tscenes.scene_sphere_simple(W, H, device="cpu")
    tsd = dataclasses.replace(tsd, config=dataclasses.replace(
        tsd.config, bounces=BOUNCES, samples_per_frame=2))
    jr, tr = JaxRenderer(jsd), TorchRenderer(tsd, device="cpu")
    oracle = JaxRenderer(dataclasses.replace(jsd, config=ocfg))
    assert tr._packed.n == 7 and tr._packed.chunks is None
    for r in (jr, tr, oracle):
        r.set_time(1000)
        r.draw_frames(3)
    assert tr.frame_count == jr.frame_count == 3 and tr.time == 1030

    def distance(a, b):
        flips = (np.abs(a - b).max(axis=-1) > FLIP_ABOVE).mean()
        return flips, tppm.compare_ppm(tppm.render_ppm(a), tppm.render_ppm(b),
                                       100.0)[1]

    want, got = np.asarray(jr.image), tr.image
    yard_flips, yard_pct = distance(want, np.asarray(oracle.image))
    assert yard_flips > FLIP_LIMIT
    flips, pct = distance(want, got)
    assert flips <= 2 * yard_flips, (flips, yard_flips)
    assert pct <= 2 * yard_pct, (pct, yard_pct)


_SCAN = """
import sys, pkgutil, importlib
import torch
torch.cuda.is_available = lambda: True      # let chip_smoke import through
import rt_torch
for m in pkgutil.walk_packages(rt_torch.__path__, "rt_torch."):
    importlib.import_module(m.name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "rt" or m.startswith("rt."))
print("BAD", bad)
print("SEEN", sorted(m for m in sys.modules if m.startswith("rt_torch.")))
"""


def test_port_and_chip_smoke_import_neither_jax_nor_rt():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _SCAN], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "BAD []" in proc.stdout, proc.stdout
    seen = proc.stdout.split("SEEN", 1)[1]
    for module in ("grad.loss", "grad.params", "grad.replay", "grad.train",
                   "grad.diff_render", "grad.fd", "core.materials",
                   "core.trace", "core.camera", "core.sphere",
                   "core.triangle", "core.hits", "render.oracle", "measure",
                   "convert"):
        assert f"'rt_torch.{module}'" in seen, module


def test_no_jax_or_rt_import_statement_in_the_port():
    import re
    pat = re.compile(r"^\s*(import jax|from jax|import rt$|from rt[. ]"
                     r"|import rt\.)", re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "rt_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 15
    for path in files:
        with open(path) as f:
            assert not pat.search(f.read()), path
