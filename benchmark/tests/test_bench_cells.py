"""Every cell end to end at thumbnail size on the CPU, through the
program's plain versions: the reference agrees; the control (the
reference in bfloat16 in the program's place) and each fault the cell can
have, planted in the program underneath a whole run, make ``correct``
false.  The same on the card at the cells' own sizes (``gpu``)."""

import pytest
import torch

from benchmark import check, harness, loops

THUMBNAILS = {
    "rtiow3-800x450-converge": dict(width=24, height=16, spp=4,
                                    frames_per_request=3, warmup_requests=1,
                                    trace_requests=2, check_pixels=96),
    "suzanne-720p-spp128": dict(width=16, height=12, spp=3,
                                warmup_requests=1, trace_requests=1,
                                check_pixels=96),
    "suzanne-1080p-fit": dict(width=24, height=16, steps=4, rerecord_every=2,
                              warmup_steps=1, trace_requests=1),
}
SEEDS = (2147483647, 3000000019, 4294967311)


def run(root, cell, seed, trace=False):
    return harness.run_cell(root, cell, seed, 0.01, trace, "cpu",
                            traffic_overrides=THUMBNAILS[cell])


@pytest.mark.parametrize("cell", list(THUMBNAILS))
def test_cell_agrees_with_the_reference(root, cell):
    res = run(root, cell, SEEDS[0])
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) >= {"setup_s"}
    assert list(res)[-1] == "checks"


def test_traced_run_reads_its_metrics(root):
    res = run(root, "rtiow3-800x450-converge", SEEDS[1], trace=True)
    assert res["correct"]
    assert "mfu.converge" in res["metrics"]
    assert {"busy_s", "window_s"} <= set(res["device"])


@pytest.mark.parametrize("cell", list(THUMBNAILS))
def test_control_fails(root, cell):
    limits = check.load_limits(root, cell)
    c = harness.Cell(root, cell, "cpu", THUMBNAILS[cell])
    for seed in SEEDS:
        c.prepare(seed)
        rec = c.window(loops.stop_after(requests=1))
        ok, checks = check.judge(c.numbers(rec, dt=torch.bfloat16), limits)
        assert not ok, checks


def test_progressive_window_folds_every_frame(root):
    """A progressive mix (no reset: the frames of all requests fold into
    one image, read back every ``frames_per_request``) agrees with the
    reference, which folds every frame again; the control does not."""
    view = dict(width=24, height=16, spp=1, frames_per_request=2,
                reset_each_request=False, warmup_requests=1,
                check_pixels=96)
    c = harness.Cell(root, "suzanne-720p-spp128", "cpu", view)
    c.prepare(SEEDS[1])
    rec = c.window(loops.stop_after(requests=3))
    assert rec["frames"] == 6 and list(rec["images"]) == [2]
    limits = check.load_limits(root, "suzanne-720p-spp128")
    assert check.judge(c.numbers(rec), limits)[0]
    assert not check.judge(c.numbers(rec, dt=torch.bfloat16), limits)[0]


# faults planted in the program underneath a whole run ------------------

def _state_unchanged(monkeypatch, cell):
    if "fit" in cell:
        monkeypatch.setattr(torch.optim.Adam, "step",
                            lambda self, closure=None: None)
    else:
        from rt_torch.render import renderer
        monkeypatch.setattr(renderer, "accumulate",
                            lambda state, color, config: state)


def _half_batch(monkeypatch, cell):
    if "fit" in cell:
        from rt_torch.grad import train

        def half_mse(img, target):
            d = (img - target)[: img.shape[0] // 2]
            return torch.mean(d * d)
        monkeypatch.setattr(train, "image_mse", half_mse)
    else:
        from rt_torch.kernels import dispatch
        real = dispatch.render_color

        def half_rows(*a, **k):
            color = real(*a, **k)
            h = color.shape[0] // 2
            return torch.cat([color[:h], color[:color.shape[0] - h]])
        monkeypatch.setattr(dispatch, "render_color", half_rows)


def _answer_altered(monkeypatch, cell):
    if "fit" in cell:
        from rt_torch.grad import train
        real = train.replay_color
        monkeypatch.setattr(train, "replay_color",
                            lambda *a, **k: real(*a, **k) * 1.01)
    else:
        from rt_torch.kernels import dispatch
        real = dispatch.render_color
        monkeypatch.setattr(dispatch, "render_color",
                            lambda *a, **k: real(*a, **k) * 1.01)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _answer_altered])
@pytest.mark.parametrize("cell", list(THUMBNAILS))
def test_fault_makes_the_run_incorrect(root, monkeypatch, cell, fault):
    fault(monkeypatch, cell)
    res = run(root, cell, SEEDS[2])
    assert not res["correct"], res["checks"]


# faults of a fit that show only after its first steps ------------------

def _second_record_altered(monkeypatch):
    from rt_torch.grad import train
    real, start = train.record_hits, []

    def record(scene, *a, **k):
        # every fit records first at the same starting albedo
        start.append(start[0] if start else scene.mat_albedo.clone())
        color, hits = real(scene, *a, **k)
        if torch.equal(scene.mat_albedo, start[0]):
            return color, hits
        return color, torch.roll(hits, 1, -1)
    monkeypatch.setattr(train, "record_hits", record)


def _late_steps_skipped(monkeypatch):
    real, steps = torch.optim.Adam.step, {}

    def step(self, closure=None):
        steps[id(self)] = steps.get(id(self), 0) + 1
        return real(self, closure) if steps[id(self)] <= 3 else None
    monkeypatch.setattr(torch.optim.Adam, "step", step)


@pytest.mark.parametrize("fault", [_second_record_altered,
                                   _late_steps_skipped])
def test_late_fit_fault_makes_the_run_incorrect(root, monkeypatch, fault):
    """The thumbnail fit re-records after step 2 and runs 4 steps: a fault
    in its second record, or in a step after the third, fails it."""
    fault(monkeypatch)
    res = run(root, "suzanne-1080p-fit", SEEDS[2])
    assert not res["correct"], res["checks"]
    assert res["checks"]["grad_gap"]["value"] <= 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("cell", list(THUMBNAILS))
def test_cell_on_the_card(root, cuda, cell):
    """A short window at the cell's own size is correct; the control at
    that size is not."""
    res = harness.run_cell(root, cell, SEEDS[0], 1.0, False, cuda)
    assert res["correct"], res["checks"]
    c = harness.Cell(root, cell, cuda)
    c.prepare(SEEDS[1])
    rec = c.window(loops.stop_after(seconds=1.0))
    ok, checks = check.judge(c.numbers(rec, dt=torch.bfloat16),
                             check.load_limits(root, cell))
    assert not ok, checks
