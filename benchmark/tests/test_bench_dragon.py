"""The dragon cell (``dragon-512-view``): a thumbnail on the CPU through
the program's plain versions agrees with the reference, and the control
(the reference in bfloat16 in the program's place) fails; on the card
(``gpu``) the cell at its own size, traced and untraced.

The thumbnail's plain scan takes a chunk's 32 triangles at once, as it
does on a card: the same bits, and a 50,000-triangle frame in seconds."""

import pytest
import torch

from benchmark import check, harness, loops

CELL = "dragon-512-view"
THUMBNAIL = dict(width=16, height=8, warmup_requests=1, trace_requests=1,
                 check_pixels=64)
SEEDS = (2147483647, 3000000019, 4294967311)
PER_LAYER = ("kernel_roofline.dragon", "glue_ms_per_image.dragon",
             "idle_share.dragon")


@pytest.fixture
def whole_chunks(monkeypatch):
    from rt_torch.kernels import tris_kernel

    monkeypatch.setattr(tris_kernel, "_whole_chunks", lambda rays: True)


def test_dragon_thumbnail_agrees_with_the_reference(root, whole_chunks):
    res = harness.run_cell(root, CELL, SEEDS[0], 0.01, False, "cpu",
                           traffic_overrides=THUMBNAIL)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"images_per_s", "setup_s"}


def test_dragon_control_fails(root, whole_chunks):
    limits = check.load_limits(root, CELL)
    c = harness.Cell(root, CELL, "cpu", THUMBNAIL)
    c.prepare(SEEDS[1])
    rec = c.window(loops.stop_after(requests=2))
    assert check.judge(c.numbers(rec), limits)[0]
    ok, checks = check.judge(c.numbers(rec, dt=torch.bfloat16), limits)
    assert not ok, checks


@pytest.mark.gpu
def test_dragon_cell_on_the_card(root, cuda):
    """A short window at 512x512 is correct, untraced and traced (which
    reads the cell's three per-layer metrics); the control is not."""
    res = harness.run_cell(root, CELL, SEEDS[0], 2.0, False, cuda)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"images_per_s", "setup_s"}
    res = harness.run_cell(root, CELL, SEEDS[2], 1.0, True, cuda)
    assert res["correct"], res["checks"]
    assert set(PER_LAYER) <= set(res["metrics"])
    c = harness.Cell(root, CELL, cuda)
    c.prepare(SEEDS[1])
    rec = c.window(loops.stop_after(seconds=1.0))
    ok, checks = check.judge(c.numbers(rec, dt=torch.bfloat16),
                             check.load_limits(root, CELL))
    assert not ok, checks
