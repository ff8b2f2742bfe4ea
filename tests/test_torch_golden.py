"""The port on the CPU against the triangle goldens of
``tests/golden_tris`` (generated by the JAX oracle): 128x128, 8 progressive
frames from time 1000, under the same 0.05 % bound as
``tests/test_golden_tris.py``.  The kernels' plain versions render here;
``chip_smoke.py`` holds the CUDA kernels to the same goldens on a card.
"""

import os

import pytest

from rt_torch.render.ppm import compare_ppm, render_ppm
from rt_torch.render.renderer import ProgressiveRenderer
from rt_torch.scene import scenes

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden_tris")


@pytest.mark.parametrize("name", ["quad", "cube", "suzanne"])
def test_port_matches_triangle_golden(name):
    sd = getattr(scenes, f"scene_{name}")(128, 128, device="cpu")
    r = ProgressiveRenderer(sd, device="cpu")
    r.set_time(1000)
    r.draw_frames(8)
    with open(os.path.join(GOLDEN_DIR, f"{name}.ppm")) as f:
        golden = f.read()
    ok, pct = compare_ppm(render_ppm(r.image), golden, 0.05)
    assert ok, f"{name}: {pct:.4f}% > 0.05%"
