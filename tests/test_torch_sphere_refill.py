"""The flat sphere kernel's schedule model (``rt_torch.kernels.
sphere_schedule``), which ``measure occupancy`` prints for the flat sphere
paths: its per-pixel segment counts against the plain version's own live
masks and index planes, and its warp turns of the tile schedule against a
count by hand and an independent loop over the warps of a padded frame.
(A persistent grid whose lanes took new pixels was timed and was slower;
its model went with it.)  Counts are integers: tolerance none.  Thumbnail
frames, one torch thread a test."""

import dataclasses

import pytest
import torch

from rt_torch.kernels import dispatch as tdispatch
from rt_torch.kernels import sphere_kernel as tsk
from rt_torch.kernels import sphere_schedule as ss
from rt_torch.scene import scenes as tscenes
from _torch_threads import one_torch_thread  # noqa: F401

TIME = 1000


def frame(make_scene, spp, bounces, width=48, height=13):
    """(tables, camera row, keyword arguments) of a padded thumbnail frame
    (13 rows padded to 16 at the default 8x16 tile)."""
    sd = getattr(tscenes, make_scene)(width, height, device="cpu")
    cfg = dataclasses.replace(sd.config, samples_per_frame=spp,
                              bounces=bounces, tile=tdispatch.DEFAULT_TILE)
    p = tdispatch.pack_scene(sd.scene, cfg)
    kw = dict(n_spheres=p.n, bounces=bounces, spp=spp,
              normalize_defocus_dir=cfg.normalize_defocus_dir,
              flags=tdispatch.trace_flags(cfg),
              **tdispatch.frame_geometry(cfg))
    return p, tdispatch.pack_camera(sd.camera), kw


def plain_kw(kw, drop=()):
    return {k: v for k, v in kw.items()
            if k not in ("th", "tw", *drop)}


@pytest.mark.parametrize("make_scene", ["scene_rtiow_three_spheres",
                                        "scene_sphere_simple",
                                        "scene_rtiow_one_sphere",
                                        "test_scene_dielectric"])
def test_sample_scans_equal_the_plain_versions_live_masks(make_scene,
                                                          monkeypatch):
    """Per pixel, the segments summed over samples are the plain render's
    live rays summed over its bounces; at one sample they are one more than
    the recorder's hits, at most ``bounces``; the first of three samples is
    the one-sample frame (the RNG state is carried from sample to
    sample)."""
    p, cam_row, kw = frame(make_scene, 3, 4)
    scans = ss.sample_scans(p.tab, p.kinds, cam_row, TIME, **kw)
    assert scans.shape == (3, kw["height_pad"], kw["width_pad"])

    live = torch.zeros_like(scans[0])
    plain_bounce = tsk.sphere_bounce

    def counted(tab, kinds, carry, flags, **kw_):
        live.add_((carry[4] > 0).to(live.dtype))
        return plain_bounce(tab, kinds, carry, flags, **kw_)

    monkeypatch.setattr(tsk, "sphere_bounce", counted)
    tsk.render_color_spheres_plain(p.tab, p.kinds, cam_row, TIME,
                                   **plain_kw(kw))
    monkeypatch.undo()
    assert torch.equal(scans.sum(dim=0), live)

    one = ss.sample_scans(p.tab, p.kinds, cam_row, TIME, **dict(kw, spp=1))
    _, idx = tsk.render_color_spheres_record_plain(
        p.tab, p.kinds, cam_row, TIME, **plain_kw(kw, drop=("spp",)))
    hits = (idx >= 0).sum(dim=0).to(torch.int32)
    assert torch.equal(one[0], torch.clamp(hits + 1, max=kw["bounces"]))
    assert torch.equal(one[0], scans[0])
    assert int(scans.min()) == 1 and int(scans.max()) == kw["bounces"]


@pytest.mark.parametrize("make_scene,spp,bounces", [
    ("scene_rtiow_three_spheres", 3, 10), ("scene_rtiow_one_sphere", 4, 4),
    ("scene_sphere_simple", 1, 10)])
def test_tile_schedule_turns_each_warp_as_its_longest_path(make_scene, spp,
                                                           bounces):
    """On a padded thumbnail frame, the tile schedule's warp turns are, for
    every sample, tile and warp of 32 consecutive threads of the row-major
    tile, its lanes' most segments, counted here by a loop over the warps;
    its lane efficiency lies in (0, 1] and no schedule of whole pixels
    could take fewer turns than the segments over 32."""
    p, cam_row, kw = frame(make_scene, spp, bounces)
    scans = ss.sample_scans(p.tab, p.kinds, cam_row, TIME, **kw)
    th, tw = kw["th"], kw["tw"]
    got = ss.tile_schedule(scans, th, tw)
    work = scans.numpy()
    turns = 0
    for s in range(spp):
        for r0 in range(0, kw["height_pad"], th):
            for c0 in range(0, kw["width_pad"], tw):
                tile = work[s, r0:r0 + th, c0:c0 + tw].reshape(-1)
                turns += sum(int(tile[w:w + 32].max())
                             for w in range(0, th * tw, 32))
    assert got["warp_turns"] == turns
    assert got["segments"] == int(work.sum())
    assert -(-got["segments"] // 32) <= turns
    assert 0 < got["lane_efficiency"] <= 1


def test_tile_schedule_by_hand():
    """Hand-made counts: the tile schedule turns, sample by sample, as
    often as each warp's longest path; a tile that is not whole warps, or
    a frame that is not whole tiles, is refused."""
    scans = torch.ones((2, 8, 16), dtype=torch.int32)
    scans[0, 0, 0] = 5          # warp 0: rows 0-1 of the 8x16 tile
    scans[1, 0, 1] = 4
    scans[1, 7, 15] = 3         # warp 3: rows 6-7
    tile = ss.tile_schedule(scans, 8, 16)
    # warp 0: max 5 then 4; warps 1, 2: 1 + 1; warp 3: 1 then 3
    assert tile["warp_turns"] == 9 + 2 + 2 + 4
    assert tile["segments"] == 256 + 4 + 3 + 2
    assert tile["lane_efficiency"] == 265 / (32 * 17)
    with pytest.raises(ValueError, match="whole warps"):
        ss.tile_schedule(scans, 4, 4)
    with pytest.raises(ValueError, match="whole warps"):
        ss.tile_schedule(scans[:, :6], 8, 16)
