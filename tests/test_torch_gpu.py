"""The CUDA kernels against their plain PyTorch versions, on a card.

Marked ``gpu``; skipped where ``torch.cuda.is_available()`` is false.  This
file imports only ``torch`` and ``rt_torch``, so on a machine with a card it
runs without the JAX package's test harness:

    python -m pytest tests/test_torch_gpu.py --noconftest -q
"""

import dataclasses

import pytest
import torch

from rt_torch.kernels import dispatch as tdispatch
from rt_torch.kernels import sphere_kernel as tsk
from rt_torch.kernels import tris_kernel as ttk
from rt_torch.scene import scenes as tscenes

TIME = 1000


@pytest.mark.gpu
def test_cuda_kernels_equal_plain_versions_bitwise():
    """On a card: K2 and K3 launched through their wrappers against the
    plain versions on the same CUDA tensors.  Tolerance: none, here and in
    every test of this file."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sd = tscenes.scene_suzanne(128, 128, device="cuda")
    kw = tdispatch.wave_params(sd.scene, sd.config)
    th, tw, flags = kw["th"], kw["tw"], kw["flags"]
    packed = tdispatch.pack_scene(sd.scene)
    cam_row = tdispatch.pack_camera(sd.camera)
    order = ttk.chunk_order(packed.centroid,
                            torch.from_numpy(cam_row[0, 0:3].copy()).cuda())
    times = torch.tensor([TIME], dtype=torch.int32, device="cuda")
    args = dict(height=128, width=128, height_pad=128, width_pad=128, th=th,
                tw=tw, normalize_defocus_dir=True)
    before = dict(ttk.LAUNCHES)
    k = ttk.wave_first(packed, order, cam_row, times, 0, flags, **args)
    p = ttk.wave_first_plain(packed, order, cam_row, times, 0, flags, **args)
    assert ttk.LAUNCHES["wave_first"] == before["wave_first"] + 1
    for a, b in zip(k, p):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    n_tiles = 128 * 128 // (th * tw)
    mo = k[0][0:3].reshape(3, n_tiles, th * tw).mean(dim=2)
    tile_order = ttk.chunk_order(packed.centroid, mo.T).reshape(-1)
    ins = [(k[0][0:9].clone(), k[1].clone(), k[2].clone()) for _ in range(2)]
    kw_ = ttk.wave_bounce(packed, tile_order, *ins[0], flags, n_bounces=2,
                          th=th, tw=tw)
    pw_ = ttk.wave_bounce_plain(packed, tile_order, *ins[1], flags,
                                n_bounces=2, th=th, tw=tw)
    assert ttk.LAUNCHES["wave_bounce"] == before["wave_bounce"] + 1
    for a, b in zip((*ins[0], kw_), (*ins[1], pw_)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def _bit_equal(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.gpu
def test_cuda_raygen_kernel_equals_plain_version_bitwise():
    """K4 on two frames of Suzanne's camera, a band offset included, and
    on three frames whose padded width (69) ends inside a block's strip."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sd = tscenes.scene_suzanne(128, 128, device="cuda")
    cam_row = tdispatch.pack_camera(sd.camera)
    times = torch.tensor([TIME, TIME + 10], dtype=torch.int32, device="cuda")
    args = dict(height=128, width=128, height_pad=64, width_pad=128,
                normalize_defocus_dir=True)
    before = ttk.LAUNCHES["wave_raygen"]
    k = ttk.wave_raygen(cam_row, times, 64, th=8, tw=16, **args)
    p = ttk.wave_raygen_plain(cam_row, times, 64, **args)
    assert ttk.LAUNCHES["wave_raygen"] == before + 1
    for a, b in zip(k, p):
        assert _bit_equal(a, b)
    # a padded width of 69 pixels, not a multiple of a block's strip of
    # columns, and three frames of 64 rows
    times = torch.tensor([TIME, TIME + 10, TIME + 20], dtype=torch.int32,
                         device="cuda")
    args = dict(height=33, width=69, height_pad=64, width_pad=69,
                normalize_defocus_dir=False)
    assert 69 % ttk.RAYGEN_THREADS
    k = ttk.wave_raygen(cam_row, times, 5, th=32, tw=1, **args)
    p = ttk.wave_raygen_plain(cam_row, times, 5, **args)
    assert ttk.LAUNCHES["wave_raygen"] == before + 2
    for a, b in zip(k, p):
        assert _bit_equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("make_scene,spp,bounces,sky_from_final_dir", [
    ("scene_sphere_simple", 1, None, False),
    ("scene_sphere_simple", 3, None, False),
    ("test_scene_complex", 2, None, True),
    ("scene_sphere_globe", 1, None, False)] + [
    ("scene_rtiow_three_spheres", spp, bounces, False)
    for spp in (1, 3, 8) for bounces in (1, 4, 10)] + [
    ("scene_rtiow_three_spheres", 3, 0, False)])
def test_cuda_sphere_kernel_equals_plain_version_bitwise(make_scene, spp,
                                                         bounces,
                                                         sky_from_final_dir):
    """K5: the whole frame, all three materials, the sample loop from the
    primary ray's closest hit found once; on rtiow_three paths end at the
    sky and at budgets of 1, 4 and 10 bounces, and at 0 every sample is the
    sky.  At one sample K8 too: color and index planes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sd = getattr(tscenes, make_scene)(128, 96, device="cuda")
    p = tdispatch.pack_scene(sd.scene, sd.config)
    assert p.chunks is None
    args = dict(n_spheres=p.n, height=96, width=128, height_pad=96,
                width_pad=128,
                bounces=sd.config.bounces if bounces is None else bounces,
                normalize_defocus_dir=False,
                flags=tdispatch.trace_flags(sd.config),
                sky_from_final_dir=sky_from_final_dir)
    cam_row = tdispatch.pack_camera(sd.camera)
    before = tsk.LAUNCHES["spheres"]
    k = tsk.render_color_spheres(p.tab, p.kinds, cam_row, TIME, th=8, tw=16,
                                 spp=spp, **args)
    assert tsk.LAUNCHES["spheres"] == before + 1
    assert _bit_equal(k, tsk.render_color_spheres_plain(
        p.tab, p.kinds, cam_row, TIME, spp=spp, **args))
    if spp == 1:
        color, idx = tsk.render_color_spheres_record(
            p.tab, p.kinds, cam_row, TIME, th=8, tw=16, **args)
        p_color, p_idx = tsk.render_color_spheres_record_plain(
            p.tab, p.kinds, cam_row, TIME, **args)
        assert _bit_equal(color, p_color) and _bit_equal(color, k)
        assert torch.equal(idx, p_idx)
    with pytest.raises(ValueError, match="n_spheres"):
        tsk.render_color_spheres(p.tab, p.kinds, cam_row, TIME, th=8, tw=16,
                                 spp=spp, **dict(args, n_spheres=0))


@pytest.mark.gpu
@pytest.mark.parametrize("tile,spp", [((8, 16), 1), ((8, 32), 2)])
def test_cuda_chunked_sphere_kernel_equals_plain_and_flat_bitwise(tile, spp):
    """K6 on the cover scene against its plain version at the same tile,
    and against the flat plain scan over the same Morton-ordered table."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sd = tscenes.scene_sphere_cover(256, 128, device="cuda")
    cfg = dataclasses.replace(sd.config, bounces=6)
    p = tdispatch.pack_scene(sd.scene, cfg)
    assert p.chunks is not None
    args = dict(height=128, width=256, height_pad=128, width_pad=256,
                bounces=cfg.bounces, normalize_defocus_dir=False,
                flags=tdispatch.trace_flags(cfg), spp=spp)
    cam_row = tdispatch.pack_camera(sd.camera)
    before = tsk.LAUNCHES["spheres_chunked"]
    k = tsk.render_color_spheres_chunked(p, cam_row, TIME, th=tile[0],
                                         tw=tile[1], **args)
    assert tsk.LAUNCHES["spheres_chunked"] == before + 1
    assert _bit_equal(k, tsk.render_color_spheres_chunked_plain(
        p, cam_row, TIME, th=tile[0], tw=tile[1], **args))
    assert _bit_equal(k, tsk.render_color_spheres_plain(
        p.tab, p.kinds, cam_row, TIME, n_spheres=p.n, **args))


@pytest.mark.gpu
def test_cuda_bounce_kernel_from_raygen_equals_plain_version_bitwise():
    """K3 as a path of more than one sample per pixel launches it first:
    2 fused bounces on K4's output, every ray alive, in pixel order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sd = tscenes.scene_suzanne(128, 128, device="cuda")
    kw = tdispatch.wave_params(sd.scene, sd.config)
    th, tw, flags = kw["th"], kw["tw"], kw["flags"]
    packed = tdispatch.pack_scene(sd.scene)
    times = torch.tensor([TIME], dtype=torch.int32, device="cuda")
    od, _, state = ttk.wave_raygen(
        tdispatch.pack_camera(sd.camera), times, 0, height=128, width=128,
        height_pad=128, width_pad=128, th=th, tw=tw,
        normalize_defocus_dir=True)
    pay = torch.cat([od, torch.ones_like(od[0:3])])
    mo = pay[0:3].reshape(3, -1, th * tw).mean(dim=2)
    tile_order = ttk.chunk_order(packed.centroid, mo.T).reshape(-1)
    ins = [(pay.clone(), state.clone(), torch.ones_like(state))
           for _ in range(2)]
    k = ttk.wave_bounce(packed, tile_order, *ins[0], flags, n_bounces=2,
                        th=th, tw=tw)
    p = ttk.wave_bounce_plain(packed, tile_order, *ins[1], flags,
                              n_bounces=2, th=th, tw=tw)
    for a, b in zip((*ins[0], k), (*ins[1], p)):
        assert _bit_equal(a, b)


@pytest.mark.gpu
def test_cuda_kernels_equal_plain_versions_on_the_large_branch_bitwise():
    """K2, then one 1-bounce K3 on the morton-sorted stream, on lucy's
    ``split_big`` tables (about 20K triangles): the large-scene branch.
    The plain versions loop over every chunk and triangle in Python, so
    this takes some tens of seconds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    size = 64
    sd = tscenes.scene_lucy(size, size, device="cuda")
    kw = tdispatch.wave_params(sd.scene, sd.config)
    assert kw["key_mode"] == "morton" and kw["sort_every"] == 1
    th, tw, flags = kw["th"], kw["tw"], kw["flags"]
    packed = tdispatch.pack_scene(sd.scene)
    cam_row = tdispatch.pack_camera(sd.camera)
    order = ttk.chunk_order(packed.centroid,
                            torch.from_numpy(cam_row[0, 0:3].copy()).cuda())
    times = torch.tensor([TIME], dtype=torch.int32, device="cuda")
    args = dict(height=size, width=size, height_pad=size, width_pad=size,
                th=th, tw=tw, normalize_defocus_dir=True)
    k = ttk.wave_first(packed, order, cam_row, times, 0, flags, **args)
    p = ttk.wave_first_plain(packed, order, cam_row, times, 0, flags, **args)
    for a, b in zip(k, p):
        assert _bit_equal(a, b)
    payf, state, active, wch = k
    key, perm = torch.sort(
        ttk.stream_key(payf, active, wch, "morton",
                       ttk.scene_bounds(packed.chunks)), stable=True)
    pay = payf[0:9][:, perm].contiguous()
    mo = pay[0:3].reshape(3, -1, th * tw).mean(dim=2)
    tile_order = ttk.chunk_order(packed.centroid, mo.T).reshape(-1)
    ins = [(pay.clone(), state[perm].contiguous(),
            (key != ttk.DEAD_KEY).to(torch.int32)) for _ in range(2)]
    kw_ = ttk.wave_bounce(packed, tile_order, *ins[0], flags, n_bounces=1,
                          th=th, tw=tw)
    pw_ = ttk.wave_bounce_plain(packed, tile_order, *ins[1], flags,
                                n_bounces=1, th=th, tw=tw)
    for a, b in zip((*ins[0], kw_), (*ins[1], pw_)):
        assert _bit_equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("name,size,bounces,spp,tile,sky,row0", [
    ("suzanne", 128, 4, 1, (8, 16), False, 0),
    ("suzanne", 128, 3, 3, (8, 32), True, 0),
    ("cube", 64, 5, 2, (4, 8), False, 32),
])
def test_cuda_mono_kernel_equals_plain_version_bitwise(name, size, bounces,
                                                       spp, tile, sky, row0):
    """K7: the whole frame in one launch, the sample loop and a band
    offset included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sd = getattr(tscenes, f"scene_{name}")(size, size, device="cuda")
    packed = tdispatch.pack_scene(sd.scene)
    cam_row = tdispatch.pack_camera(sd.camera)
    args = dict(height=size, width=size, height_pad=size - row0,
                width_pad=size, bounces=bounces, normalize_defocus_dir=True,
                flags=tdispatch.trace_flags(sd.config), th=tile[0],
                tw=tile[1], sky_from_final_dir=sky, spp=spp, row0=row0)
    before = ttk.LAUNCHES["tris_mono"]
    k = ttk.render_color_tris(packed, cam_row, TIME, **args)
    assert ttk.LAUNCHES["tris_mono"] == before + 1
    assert _bit_equal(k, ttk.render_color_tris_plain(packed, cam_row, TIME,
                                                     **args))


@pytest.mark.gpu
@pytest.mark.parametrize("name,bounces,tile", [("suzanne", 4, (8, 16)),
                                               ("quad", 6, (8, 32))])
def test_cuda_tris_recorder_equals_plain_and_mono_bitwise(name, bounces,
                                                          tile):
    """K9: color and every index plane against the plain version; its color
    against K7's.  quad at 6 bounces: whole tiles die before the last
    bounce, whose planes must read -1."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sd = getattr(tscenes, f"scene_{name}")(128, 128, device="cuda")
    packed = tdispatch.pack_scene(sd.scene)
    cam_row = tdispatch.pack_camera(sd.camera)
    args = dict(height=128, width=128, height_pad=128, width_pad=128,
                bounces=bounces, normalize_defocus_dir=True,
                flags=tdispatch.trace_flags(sd.config), th=tile[0],
                tw=tile[1])
    before = ttk.LAUNCHES["tris_record"]
    color, idx, order = ttk.render_color_tris_record(packed, cam_row, TIME,
                                                     **args)
    assert ttk.LAUNCHES["tris_record"] == before + 1
    p_color, p_idx, _ = ttk.render_color_tris_record_plain(
        packed, cam_row, TIME, **args)
    assert _bit_equal(color, p_color)
    assert torch.equal(idx, p_idx)
    assert idx.dtype == torch.int32 and int(idx.min()) == -1
    assert int(idx.max()) < packed.tab.shape[0]
    assert order.shape == (sd.scene.m,)
    assert _bit_equal(color, ttk.render_color_tris(packed, cam_row, TIME,
                                                   **args))


@pytest.mark.gpu
@pytest.mark.parametrize("make_scene,width,height", [
    ("scene_sphere_simple", 128, 96), ("test_scene_complex", 128, 96),
    ("scene_sphere_cover", 64, 48)])
def test_cuda_sphere_recorder_equals_plain_and_render_bitwise(make_scene,
                                                              width, height):
    """K8: color and every index plane against the plain version; its color
    against K5's plain version.  cover: 486 rows, past what K5 renders
    flat."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sd = getattr(tscenes, make_scene)(width, height, device="cuda")
    tab, kinds, n = tdispatch.pack_spheres_table(sd.scene)
    if 0 < sd.config.n_active_spheres < n:
        n = sd.config.n_active_spheres
    cam_row = tdispatch.pack_camera(sd.camera)
    args = dict(n_spheres=n, height=height, width=width, height_pad=height,
                width_pad=width, bounces=sd.config.bounces,
                normalize_defocus_dir=False,
                flags=tdispatch.trace_flags(sd.config))
    before = tsk.LAUNCHES["spheres_record"]
    color, idx = tsk.render_color_spheres_record(tab, kinds, cam_row, TIME,
                                                 th=8, tw=16, **args)
    assert tsk.LAUNCHES["spheres_record"] == before + 1
    p_color, p_idx = tsk.render_color_spheres_record_plain(
        tab, kinds, cam_row, TIME, **args)
    assert _bit_equal(color, p_color)
    assert torch.equal(idx, p_idx)
    assert int(idx.min()) == -1 and 0 <= int(idx.max()) < n
    assert _bit_equal(color, tsk.render_color_spheres_plain(
        tab, kinds, cam_row, TIME, **args))
    with pytest.raises(ValueError, match="n_spheres"):
        big = torch.zeros((2000, 8), device="cuda")
        tsk.render_color_spheres_record(
            big, torch.zeros(2000, dtype=torch.int32, device="cuda"),
            cam_row, TIME, th=8, tw=16, **dict(args, n_spheres=2000))


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["suzanne", "sphere_simple"])
def test_cuda_fit_replay_takes_five_steps(name):
    """Five Adam steps on the card with one re-record: the recorder kernel
    launches twice, the losses are finite and fall, and the replay of the
    recorded hits gives the recorder's color."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from rt_torch.grad import fit_replay, record_hits, replay_color

    sd = getattr(tscenes, f"scene_{name}")(128, 96, device="cuda")
    cfg = dataclasses.replace(sd.config, bounces=4)
    target, hits = record_hits(sd.scene, sd.camera, cfg, TIME)
    with torch.no_grad():
        img = replay_color(sd.scene, sd.camera, cfg, TIME, hits)
    assert float((img - target).abs().max()) <= 1e-5
    if name == "suzanne":
        albedo = sd.scene.mat_albedo.clone()
        albedo[0] = albedo.new_tensor([0.8, 0.1, 0.1])
        bad, table = sd.scene._replace(mat_albedo=albedo), ttk.LAUNCHES
        kernel = "tris_record"
    else:
        albedo = sd.scene.albedo.clone()
        albedo[0] = albedo.new_tensor([0.1, 0.9, 0.1])
        bad, table = sd.scene._replace(albedo=albedo), tsk.LAUNCHES
        kernel = "spheres_record"
    before = table[kernel]
    _, losses = fit_replay(bad, sd.camera, cfg, target, time=TIME, steps=5,
                           rerecord_every=3, learning_rate=5e-2)
    assert table[kernel] == before + 2
    assert all(l == l and l < float("inf") for l in losses)
    assert losses[-1] < losses[0]


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["suzanne", "lucy"])
def test_cuda_wave_recorder_equals_plain_and_render_bitwise(name):
    """K10a and K10b (two fused bounces, the second over all-dead tiles
    too) against their plain versions, index planes included; the
    recorder's color against the render path's with a sort before every
    bounce; the launch counts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sd = getattr(tscenes, f"scene_{name}")(64, 64, device="cuda")
    flags = tdispatch.trace_flags(sd.config)
    packed = ttk.pack_tri_table(sd.scene)
    cam_row = tdispatch.pack_camera(sd.camera)
    order = ttk.eye_chunk_order(packed, cam_row)
    times = torch.tensor([TIME], dtype=torch.int32, device="cuda")
    args = dict(height=64, width=64, height_pad=64, width_pad=64, th=8,
                tw=16, normalize_defocus_dir=True, track_idx=True)
    before = dict(ttk.LAUNCHES)
    k = ttk.wave_first(packed, order, cam_row, times, 0, flags, **args)
    p = ttk.wave_first_plain(packed, order, cam_row, times, 0, flags, **args)
    assert ttk.LAUNCHES["wave_record"] == before["wave_record"] + 1
    assert ttk.LAUNCHES["wave_first"] == before["wave_first"]
    for a, b in zip(k, p):
        assert _bit_equal(a, b)
    tile_order = ttk.tile_chunk_order(packed, k[0][0:9], 128)
    ins = [(k[0][0:9].clone(), k[1].clone(), k[2].clone()) for _ in range(2)]
    kw_ = ttk.wave_bounce(packed, tile_order, *ins[0], flags, n_bounces=2,
                          th=8, tw=16, track_idx=True)
    pw_ = ttk.wave_bounce_plain(packed, tile_order, *ins[1], flags,
                                n_bounces=2, th=8, tw=16, track_idx=True)
    assert ttk.LAUNCHES["wave_record_bounce"] == \
        before["wave_record_bounce"] + 1
    for a, b in zip((*ins[0], *kw_), (*ins[1], *pw_)):
        assert _bit_equal(a, b)
    geo = {k_: v for k_, v in args.items() if k_ != "track_idx"}
    color, idx, _ = ttk.render_color_tris_wave_record(
        packed, cam_row, TIME, bounces=4, flags=flags, **geo)
    render = ttk.render_color_tris_wave(
        packed, cam_row, times, bounces=4, flags=flags, sort_every=1,
        skip_last_sort=False, key_mode="morton", **geo)[0]
    assert _bit_equal(color, render) and idx.shape == (4, 64, 64)


@pytest.mark.gpu
def test_cuda_oracle_and_diff_render_run_on_the_card():
    """The oracle renders and records on the card without a kernel; the
    differentiable renderer's forward is the oracle's there too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from rt_torch.grad import record_hits_oracle, render_color_diff
    from rt_torch.render import oracle

    sd = tscenes.test_scene_metal(64, 32, device="cuda")
    cfg = dataclasses.replace(sd.config, bounces=3)
    before = tdispatch.launch_counts()
    img = oracle.render_color(sd.scene, sd.camera, cfg, TIME)
    color, hits = record_hits_oracle(sd.scene, sd.camera, cfg, TIME)
    diff = render_color_diff(sd.scene, sd.camera, cfg, TIME)
    assert tdispatch.launch_counts() == before
    assert img.is_cuda and torch.equal(img, color)
    assert torch.equal(img, diff.detach()) and (hits >= 0).any()


@pytest.mark.gpu
def test_cuda_probe_kernels_against_their_plain_versions():
    """P1 and P2 A bit-equal to their plain versions (P1 at every shape of
    the probe, 512 iterations, and at a width past 1024 and widths and
    iteration counts that are not multiples of 4; P2 A at 1, 2, 7 and 64
    chunks with a degenerate row, at 1000 rays, not a multiple of a
    block's, and at 301 and 600 chunks, each slice in pieces); P2 B
    (tensor cores) within ``r5_mxu.woop_agreement``'s limits at 1, 4, 7,
    64 and 600 chunks (in pieces) and at 1000 rays.  Chunk counts below
    the cluster's size leave blocks an empty slice; 7 does not divide.
    Each call is one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from rt_torch.probes import lane_gather, launch_counts, r5_mxu

    before = launch_counts()
    # the tool's shapes; a width past 1024 columns (four copies of the
    # row); widths not a multiple of 4 (the row once), iterations that end
    # inside a 128-bit load or before the loads in flight, and indices
    # past the width and below 0
    cases = [(th, tw, 512) for th, tw in lane_gather.SHAPES]
    cases += [(4, 1500, 512), (3, 1001, 37), (2, 7, 3), (5, 96, 0)]
    for th, tw, iters in cases:
        _, tab, idx = lane_gather.inputs(th, tw)
        tab, idx = torch.from_numpy(tab).cuda(), torch.from_numpy(idx).cuda()
        if iters == 37:
            idx = idx * 3 - 5 * tw
        assert _bit_equal(lane_gather.lane_gather(tab, idx, iters),
                          lane_gather.lane_gather_plain(tab, idx, iters)), \
            (th, tw, iters)
    assert launch_counts()["lane_gather"] == before["lane_gather"] \
        + len(cases)

    def one_launch(name, fn):
        n = launch_counts()[name]
        out = fn()
        assert launch_counts()[name] == n + 1, name
        return out

    arrays = r5_mxu.inputs(64)
    arrays["tri"][5, 3:6] = 0.0
    a = r5_mxu.to_device(arrays, "cuda")
    o1000 = a["o"].reshape(3, -1)[:, :1000].contiguous()
    d1000 = a["d"].reshape(3, -1)[:, :1000].contiguous()
    # past 300 (A) and 584 (B) chunks a block's slice no longer fits in
    # its shared memory and is staged and scanned in pieces
    wide = r5_mxu.to_device(r5_mxu.inputs(600), "cuda")
    for n_chunks, o, d in ((1, a["o"], a["d"]), (2, a["o"], a["d"]),
                           (7, a["o"], a["d"]), (64, a["o"], a["d"]),
                           (7, o1000, d1000), (301, wide["o"], wide["d"]),
                           (600, wide["o"], wide["d"])):
        src = wide if n_chunks > 64 else a
        tri = src["tri"][:n_chunks * r5_mxu.CHUNK].contiguous()
        t = one_launch("mt_scan", lambda: r5_mxu.mt_scan(tri, o, d))
        assert t.shape == o.shape[1:], (n_chunks, t.shape)
        assert _bit_equal(t, r5_mxu.mt_scan_plain(tri, o, d)), n_chunks
        shape = r5_mxu.launch_shape("mt_scan", o[0].numel(), n_chunks)
        assert (shape["piece"], shape["pieces"]) == r5_mxu.piece_plan(
            "mt_scan", n_chunks), (n_chunks, shape)
        assert (shape["pieces"] > 1) == (n_chunks > 300), (n_chunks, shape)
    for n_chunks, rays in ((1, r5_mxu.R), (4, r5_mxu.R), (7, r5_mxu.R),
                           (64, r5_mxu.R), (7, 1000), (600, r5_mxu.R)):
        src = wide if n_chunks > 64 else a
        w = src["w"][:n_chunks]
        x = src["x"][:rays].contiguous()
        t = one_launch("woop_mma", lambda: r5_mxu.woop(w, x))
        t_ref, win = r5_mxu.woop_plain(w, x, winner=True)
        agree = r5_mxu.woop_agreement(t, t_ref, w, x, win)
        assert agree["ok"], (n_chunks, rays, agree)
        # at 600 chunks every ray hits one of 19200 triangles
        assert agree["hit_share"] > 0.02, (n_chunks, agree)
        assert n_chunks > 64 or agree["hit_share"] < 1.0, (n_chunks, agree)
        shape = r5_mxu.launch_shape("woop_mma", rays, n_chunks)
        assert (shape["piece"], shape["pieces"]) == r5_mxu.piece_plan(
            "woop_mma", n_chunks), (n_chunks, shape)
        assert (shape["pieces"] > 1) == (n_chunks > 584), (n_chunks, shape)


@pytest.mark.gpu
def test_cuda_probe_reciprocal_equals_ieee_division_on_every_float():
    """Both P2 kernels take 1 / x through a fast path written out, the slow
    path's branch shared by several x: on every 32-bit pattern it gives the
    bits of 1.0f / x compiled with IEEE division."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from rt_torch.probes import r5_mxu

    assert r5_mxu.reciprocal_mismatches("cuda") == 0


@pytest.mark.gpu
@pytest.mark.parametrize("tile", [(4, 8), (8, 16), (16, 16)])
@pytest.mark.parametrize("name,size,n_chunks,n_bounces", [
    ("suzanne", 128, 35, 2), ("lucy", 64, 623, 1)])
def test_cuda_trace_kernels_equal_plain_at_other_tiles_bitwise(
        name, size, n_chunks, n_bounces, tile):
    """K2, then K3 on the sorted stream after bounce 0, at a tile of 32
    rays (4x8), the default 8x16 (both: K3 at two lanes a ray) and 16x16
    (one lane a ray, the instances for tiles above 128 rays), on Suzanne
    (35 chunks: a full box batch and a tail of 3) and lucy (623 chunks: 20
    batches, the last of 15): every plane bit-equal, the winning-chunk
    plane included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from rt_torch import measure

    def make_scene(w, h, device):
        sd = tscenes.build_scene({"suzanne": 5, "lucy": 6}[name], w, h,
                                 device=device)
        return dataclasses.replace(sd, config=dataclasses.replace(
            sd.config, tile=tile))

    st = measure.wave_state(make_scene, size, "cuda")
    assert (st.th, st.tw) == tile and st.packed.n_chunks == n_chunks
    p = ttk.wave_first_plain(st.packed, st.order, st.cam_row, st.times, 0,
                             st.flags, **st.first_kw)
    for a, b in zip(st.first, p):
        assert _bit_equal(a, b)
    ins = [(st.pay0.clone(), st.state0.clone(), st.active0.clone())
           for _ in range(2)]
    kw = dict(n_bounces=n_bounces, th=st.th, tw=st.tw)
    k = ttk.wave_bounce(st.packed, st.tile_order, *ins[0], st.flags, **kw)
    p = ttk.wave_bounce_plain(st.packed, st.tile_order, *ins[1], st.flags,
                              **kw)
    for a, b in zip((*ins[0], k), (*ins[1], p)):
        assert _bit_equal(a, b)


def _frame_args(sd, width, height, bounces, tile, **more):
    return dict(height=height, width=width, height_pad=height,
                width_pad=width, bounces=bounces, th=tile[0], tw=tile[1],
                normalize_defocus_dir=sd.config.normalize_defocus_dir,
                flags=tdispatch.trace_flags(sd.config), **more)


@pytest.mark.gpu
@pytest.mark.parametrize("spp", [1, 2])
@pytest.mark.parametrize("tile", [(4, 8), (8, 16), (16, 16)])
def test_cuda_packed_sphere_kernel_equals_plain_bitwise(tile, spp):
    """K6 (live rays packed, votes batched, rows staged) on cover at
    256x128, 8 bounces, where most live warps of a thread a ray are under a
    quarter full after bounce 1 (``measure occupancy``); tiles of 32, 128
    (the bounded instance) and 256 rays (the one bounded by 1024)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sd = tscenes.scene_sphere_cover(256, 128, device="cuda")
    p = tdispatch.pack_scene(sd.scene, sd.config)
    args = _frame_args(sd, 256, 128, 8, tile, spp=spp)
    cam_row = tdispatch.pack_camera(sd.camera)
    before = tsk.LAUNCHES["spheres_chunked"]
    k = tsk.render_color_spheres_chunked(p, cam_row, TIME, **args)
    assert tsk.LAUNCHES["spheres_chunked"] == before + 1
    assert _bit_equal(k, tsk.render_color_spheres_chunked_plain(
        p, cam_row, TIME, **args))


@pytest.mark.gpu
@pytest.mark.parametrize("spp", [1, 2])
@pytest.mark.parametrize("tile", [(4, 8), (8, 16), (16, 16)])
def test_cuda_flat_sphere_kernels_equal_plain_at_every_tile_bitwise(tile,
                                                                    spp):
    """K5 (and at one sample K8, color and index planes) through the
    early-exit pair test, on the complex scene (all three materials)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sd = tscenes.test_scene_complex(128, 96, device="cuda")
    p = tdispatch.pack_scene(sd.scene, sd.config)
    cam_row = tdispatch.pack_camera(sd.camera)
    args = _frame_args(sd, 128, 96, sd.config.bounces, tile, n_spheres=p.n)
    k = tsk.render_color_spheres(p.tab, p.kinds, cam_row, TIME, spp=spp,
                                 **args)
    args.pop("th"), args.pop("tw")
    assert _bit_equal(k, tsk.render_color_spheres_plain(
        p.tab, p.kinds, cam_row, TIME, spp=spp, **args))
    if spp == 1:
        color, idx = tsk.render_color_spheres_record(
            p.tab, p.kinds, cam_row, TIME, th=tile[0], tw=tile[1], **args)
        p_color, p_idx = tsk.render_color_spheres_record_plain(
            p.tab, p.kinds, cam_row, TIME, **args)
        assert _bit_equal(color, p_color) and torch.equal(idx, p_idx)


@pytest.mark.gpu
@pytest.mark.parametrize("spp", [1, 2])
@pytest.mark.parametrize("tile", [(4, 8), (8, 16), (16, 16)])
def test_cuda_packed_mono_kernels_equal_plain_bitwise(tile, spp):
    """K7 (and at one sample K9, color and index planes) with live rays
    packed, on cube at 128x128, 8 bounces: from bounce 2 on its live warps
    hold 8, 5, 4, 3, 2 and 2 lanes of 32 on average (``measure occupancy``
    on the plain version), so most scans run at more than one lane a ray."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sd = tscenes.scene_cube(128, 128, device="cuda")
    packed = tdispatch.pack_scene(sd.scene)
    cam_row = tdispatch.pack_camera(sd.camera)
    args = _frame_args(sd, 128, 128, 8, tile)
    before = ttk.LAUNCHES["tris_mono"]
    k = ttk.render_color_tris(packed, cam_row, TIME, spp=spp, **args)
    assert ttk.LAUNCHES["tris_mono"] == before + 1
    assert _bit_equal(k, ttk.render_color_tris_plain(packed, cam_row, TIME,
                                                     spp=spp, **args))
    if spp == 1:
        color, idx, _ = ttk.render_color_tris_record(packed, cam_row, TIME,
                                                     **args)
        p_color, p_idx, _ = ttk.render_color_tris_record_plain(
            packed, cam_row, TIME, **args)
        assert _bit_equal(color, p_color) and torch.equal(idx, p_idx)
        assert _bit_equal(color, k)


@pytest.mark.gpu
def test_cuda_tris_recorder_with_padding_pixels_equals_plain_bitwise():
    """K9 on Suzanne at 120x72, padded as the dispatch pads it to the
    default tile (128x72: the last tile column is half padding pixels,
    traced like any other)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sd = tscenes.scene_suzanne(120, 72, device="cuda")
    geometry = tdispatch.frame_geometry(sd.config)
    assert (geometry["width_pad"], geometry["height_pad"]) == (128, 72)
    packed = tdispatch.pack_scene(sd.scene)
    cam_row = tdispatch.pack_camera(sd.camera)
    args = dict(bounces=5, normalize_defocus_dir=True,
                flags=tdispatch.trace_flags(sd.config), **geometry)
    color, idx, _ = ttk.render_color_tris_record(packed, cam_row, TIME,
                                                 **args)
    p_color, p_idx, _ = ttk.render_color_tris_record_plain(packed, cam_row,
                                                           TIME, **args)
    assert _bit_equal(color, p_color) and torch.equal(idx, p_idx)
    assert int((idx[:, :, 120:] >= 0).sum()) > 0      # padding pixels hit


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["spheres_chunked", "tris_mono"])
def test_cuda_packed_kernels_equal_plain_across_samples_bitwise(kernel):
    """K6 (cover 256x128) and K7 (cube 128x128) at 8 bounces and 4 samples,
    launched 8 times.  A tile whose rays all escape leaves its bounce loop
    and starts the next sample, whose live-ray count rewrites the block's
    shared words: a barrier on that exit keeps a fast warp from rewriting a
    word a slow warp still reads.  Every launch equals the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if kernel == "spheres_chunked":
        sd = tscenes.scene_sphere_cover(256, 128, device="cuda")
        p = tdispatch.pack_scene(sd.scene, sd.config)
        run, plain = (tsk.render_color_spheres_chunked,
                      tsk.render_color_spheres_chunked_plain)
        launches = tsk.LAUNCHES
        args = _frame_args(sd, 256, 128, 8, (8, 16), spp=4)
    else:
        sd = tscenes.scene_cube(128, 128, device="cuda")
        p = tdispatch.pack_scene(sd.scene)
        run, plain = ttk.render_color_tris, ttk.render_color_tris_plain
        launches = ttk.LAUNCHES
        args = _frame_args(sd, 128, 128, 8, (8, 16), spp=4)
    cam_row = tdispatch.pack_camera(sd.camera)
    want = plain(p, cam_row, TIME, **args)
    before = launches[kernel]
    for _ in range(8):
        assert _bit_equal(run(p, cam_row, TIME, **args), want)
    assert launches[kernel] == before + 8


def _record_stream(name, size):
    """The recorder's morton-sorted stream after K10a on ``name`` at size x
    size (``measure.record_state``), its live rays and the tiles that hold
    them."""
    from rt_torch import measure

    st = measure.record_state(getattr(tscenes, f"scene_{name}"), size,
                              "cuda")
    live = int(st.active0.sum())
    return st, live, -(-live // (st.th * st.tw))


@pytest.mark.gpu
@pytest.mark.parametrize("name,size", [("lucy", 512), ("lucy", 64),
                                       ("dragon", 64)])
def test_cuda_recorder_every_launch_equals_plain_bitwise(name, size):
    """A whole record (K10a, then K10b before each of bounces 1-4 on the
    live tiles of the sorted stream, at the lanes the launch picks: on an
    H100 lucy 512x512's 1245, 187, 124 and 71 live tiles take 2, 4, 8 and
    8, the 64x64 records' few tiles 8): each launch against its plain
    version on copies of its inputs, and the record's planes against the
    plain recorder's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sd = getattr(tscenes, f"scene_{name}")(size, size, device="cuda")
    packed = ttk.pack_tri_table(sd.scene)
    cam_row = tdispatch.pack_camera(sd.camera)
    args = dict(height=size, width=size, height_pad=size, width_pad=size,
                bounces=5, th=8, tw=16, normalize_defocus_dir=True,
                flags=tdispatch.trace_flags(sd.config))
    first, bounce = ttk.wave_first, ttk.wave_bounce
    seen = []

    def checked_first(*a, **kw):
        k = first(*a, **kw)
        for x, y in zip(k, ttk.wave_first_plain(*a, **kw)):
            assert _bit_equal(x, y)
        seen.append(0)
        return k

    def checked_bounce(packed_, order, pay, state, active, flags, **kw):
        ins = pay.clone(), state.clone(), active.clone()
        p = ttk.wave_bounce_plain(packed_, order, *ins, flags, **kw)
        k = bounce(packed_, order, pay, state, active, flags, **kw)
        for x, y in zip((pay, state, active, *k), (*ins, *p)):
            assert _bit_equal(x, y)
        seen.append(kw["live_tiles"])
        return k

    try:
        ttk.wave_first, ttk.wave_bounce = checked_first, checked_bounce
        color, idx, _ = ttk.render_color_tris_wave_record(packed, cam_row,
                                                          TIME, **args)
    finally:
        ttk.wave_first, ttk.wave_bounce = first, bounce
    assert len(seen) == 5 and all(0 < t < size * size // 128
                                  for t in seen[1:])
    ttk.wave_first, ttk.wave_bounce = ttk.wave_first_plain, \
        ttk.wave_bounce_plain
    try:
        p_color, p_idx, _ = ttk.render_color_tris_wave_record(
            packed, cam_row, TIME, **args)
    finally:
        ttk.wave_first, ttk.wave_bounce = first, bounce
    assert _bit_equal(color, p_color) and torch.equal(idx, p_idx)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["lucy", "dragon"])
def test_cuda_group_boxes_change_no_bit(name):
    """K10a, and K2 over the render path's table (``split_big``), with
    their group boxes and without them (chunk boxes only): every plane the
    same bits.  Then K10b on a stream whose live rays fill only its first 3
    tiles (the others died), launched on those 3 and on the whole stream:
    the same planes, -1 past the 3 tiles."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    st, _, _ = _record_stream(name, 64)
    assert st.packed.groups is not None
    k = ttk.wave_first(st.packed._replace(groups=None), st.order, st.cam_row,
                       st.times, 0, st.flags, **st.first_kw)
    for a, b in zip(st.first, k):
        assert _bit_equal(a, b)
    render = tdispatch.pack_scene(st.sd.scene)
    assert render.groups is not None
    kw = {k_: v for k_, v in st.first_kw.items() if k_ != "track_idx"}
    order = ttk.eye_chunk_order(render, st.cam_row)
    k = [ttk.wave_first(packed, order, st.cam_row, st.times, 0, st.flags,
                        **kw) for packed in (render,
                                             render._replace(groups=None))]
    for a, b in zip(*k):
        assert _bit_equal(a, b)
    active = st.active0.clone()
    active[3 * 128 - 5:] = 0
    outs = []
    for live_tiles, order in ((3, st.tile_order[:3 * st.packed.n_chunks]),
                              (None, st.tile_order)):
        ins = st.pay0.clone(), st.state0.clone(), active.clone()
        out = ttk.wave_bounce(st.packed, order, *ins, st.flags, n_bounces=1,
                              th=st.th, tw=st.tw, track_idx=True,
                              live_tiles=live_tiles)
        outs.append((*ins, *out))
    for a, b in zip(*outs):
        assert _bit_equal(a, b)
    assert (outs[0][4][0, :3 * 128 - 5] >= 0).any()
    assert (outs[0][4][:, 3 * 128:] == -1).all()


@pytest.mark.gpu
def test_cuda_counting_kernels_count_the_plain_scans_on_dragon(monkeypatch):
    """A 128x128 frame of the dragon through the wave path (K2, then a
    morton sort and a 1-bounce K3 a bounce), with the spans on: the
    colors equal the uncounted kernels' bit for bit, and the counters'
    change (the counting instances' accumulator) equals what the plain
    versions count on the same frame (their ``scan_counts``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from rt_torch.utils import profiling

    sd = tscenes.scene_dragon(128, 128, device="cuda")
    packed = tdispatch.pack_scene(sd.scene)
    assert packed.groups is not None

    def frame(spans: bool):
        before = profiling.counters()
        if spans:
            profiling.enable()
        try:
            colors = tdispatch.render_color_frames(packed, sd.camera,
                                                   sd.config, [TIME])
            torch.cuda.synchronize()
        finally:
            profiling.disable()
            profiling.take()
        after = profiling.counters()
        return colors, {k: after[k] - before[k]
                        for k in profiling.DEVICE_COUNTS}

    off, none = frame(False)
    on, counted = frame(True)
    assert _bit_equal(off, on)
    assert not any(none.values()) and all(counted.values())
    monkeypatch.setattr(ttk, "wave_first", ttk.wave_first_plain)
    monkeypatch.setattr(ttk, "wave_bounce", ttk.wave_bounce_plain)
    plain, plain_counts = frame(True)
    assert _bit_equal(off, plain)
    assert counted == plain_counts


@pytest.mark.gpu
def test_cuda_readback_is_pinned_and_a_kept_image_stays():
    """``ProgressiveRenderer.image`` from a card: the accumulator's bits,
    in page-locked memory, and an array a caller keeps does not change
    when the renderer draws and reads back again."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np

    from rt_torch.render.renderer import ProgressiveRenderer

    r = ProgressiveRenderer(tscenes.scene_suzanne(64, 48, device="cuda"),
                            device="cuda")
    r.draw()
    kept = r.image
    assert np.array_equal(kept, r.state.image.cpu().numpy())
    assert torch.from_numpy(kept).is_pinned()
    copy = kept.copy()
    for _ in range(3):
        r.draw()
        later = r.image
    assert np.array_equal(kept, copy)
    assert np.array_equal(later, r.state.image.cpu().numpy())
    assert not np.array_equal(later, kept)


def _flat_frame(make_scene, width, height, n=None):
    """(tab, kinds, n, camera row, keyword arguments) of one frame of a
    sphere scene for the flat kernels, padded to the default tile; n: the
    live rows (the scene's own by default)."""
    sd = getattr(tscenes, make_scene)(width, height, device="cuda")
    tab, kinds, n_all = tdispatch.pack_spheres_table(sd.scene)
    live = sd.config.n_active_spheres
    n = n or (live if 0 < live < n_all else n_all)
    args = _frame_args(sd, width, height, sd.config.bounces, (8, 16),
                       n_spheres=n)
    args.update(height_pad=-(-height // 8) * 8, width_pad=-(-width // 16) * 16)
    return tab, kinds, n, tdispatch.pack_camera(sd.camera), args


@pytest.mark.gpu
@pytest.mark.parametrize("make_scene,n,spp", [
    ("scene_sphere_simple", 1, 3), ("scene_rtiow_one_sphere", 2, 16),
    ("scene_rtiow_three_spheres", 4, 3), ("scene_sphere_simple", 7, 1),
    ("scene_sphere_simple", 7, 16), ("test_scene_complex", 26, 3),
    ("scene_sphere_globe", 36, 1), ("scene_sphere_cover", 484, 1)])
def test_cuda_flat_kernels_equal_plain_with_padding_bitwise(make_scene, n,
                                                           spp):
    """K5 (up to FLAT_MAX_SPHERES rows) and at one sample K8, color and
    index planes: a 100x70 frame padded to 112x72, every padded pixel
    traced and written; 1 to 484 rows, 1 to 16 samples."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tab, kinds, n_, cam_row, args = _flat_frame(make_scene, 100, 70, n)
    assert n_ == n and (args["height_pad"], args["width_pad"]) == (72, 112)
    if n <= tsk.FLAT_MAX_SPHERES:
        before = tsk.LAUNCHES["spheres"]
        k = tsk.render_color_spheres(tab, kinds, cam_row, TIME, spp=spp,
                                     **args)
        assert tsk.LAUNCHES["spheres"] == before + 1
        args_ = {k_: v for k_, v in args.items() if k_ not in ("th", "tw")}
        p = tsk.render_color_spheres_plain(tab, kinds, cam_row, TIME,
                                           spp=spp, **args_)
        assert _bit_equal(k, p) and float(p[:, 70:].abs().max()) > 0
    if spp == 1:
        before = tsk.LAUNCHES["spheres_record"]
        color, idx = tsk.render_color_spheres_record(tab, kinds, cam_row,
                                                     TIME, **args)
        assert tsk.LAUNCHES["spheres_record"] == before + 1
        args.pop("th"), args.pop("tw")
        p_color, p_idx = tsk.render_color_spheres_record_plain(
            tab, kinds, cam_row, TIME, **args)
        assert _bit_equal(color, p_color) and torch.equal(idx, p_idx)
        assert int(idx.min()) == -1 and int(idx.max()) >= 0


@pytest.mark.gpu
@pytest.mark.parametrize("record", [False, True])
def test_cuda_flat_kernels_replayed_from_a_graph_equal_plain(record):
    """One launch captured in a CUDA graph and the graph replayed twice,
    its outputs zeroed before each: each replay gives the plain version's
    image (K5) or image and index planes (K8), not a stale or empty
    frame."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tab, kinds, n, cam_row, args = _flat_frame("scene_rtiow_three_spheres",
                                               100, 70)
    spp = 1 if record else 4
    if record:
        run = lambda: tsk.render_color_spheres_record(  # noqa: E731
            tab, kinds, cam_row, TIME, **args)
    else:
        run = lambda: tsk.render_color_spheres(  # noqa: E731
            tab, kinds, cam_row, TIME, spp=spp, **args)
    run()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = run()
    outs = out if record else (out,)
    args.pop("th"), args.pop("tw")
    if record:
        want = tsk.render_color_spheres_record_plain(tab, kinds, cam_row,
                                                     TIME, **args)
    else:
        want = (tsk.render_color_spheres_plain(tab, kinds, cam_row, TIME,
                                               spp=spp, **args),)
    for _ in range(2):
        for o in outs:
            o.fill_(0)
        graph.replay()
        torch.cuda.synchronize()
        for o, w in zip(outs, want):
            assert _bit_equal(o, w)


@pytest.mark.gpu
def test_cuda_flat_kernel_renders_a_4096_square_frame_bitwise():
    """K5 through the render dispatch on a 4096x4096 frame (2^24 pixels,
    past the range in which a float holds every pixel index exactly) at 4
    bounces: one launch, bit-equal to the plain version, every pixel
    finite."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sd = tscenes.scene_sphere_simple(4096, 4096, device="cuda")
    cfg = dataclasses.replace(sd.config, bounces=4)
    packed = tdispatch.pack_scene(sd.scene, cfg)
    before = tsk.LAUNCHES["spheres"]
    k = tdispatch.render_color_spheres(packed, sd.camera, cfg, TIME)
    assert tsk.LAUNCHES["spheres"] == before + 1
    p = tsk.render_color_spheres_plain(
        packed.tab, packed.kinds, tdispatch.pack_camera(sd.camera), TIME,
        n_spheres=packed.n, height=4096, width=4096, height_pad=4096,
        width_pad=4096, bounces=4,
        normalize_defocus_dir=cfg.normalize_defocus_dir,
        flags=tdispatch.trace_flags(cfg),
        sky_from_final_dir=cfg.sky_from_final_dir)
    assert k.shape == (4096, 4096, 3)
    assert _bit_equal(k, p.permute(1, 2, 0)) and bool(torch.isfinite(k).all())


# ---------------------------------------------------------------------------
# The soft surrogates' recoveries (rt_torch.grad.soft, soft_tris): the JAX
# package's own recovery tests (tests/test_grad.py, tests/test_soft_tris.py)
# run on the card, with their step counts and guards.  Too slow for the CPU
# suite; tests/test_torch_soft*.py hold the same functions against the JAX
# package at a few steps there.
# ---------------------------------------------------------------------------

def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _small(builder, w, h, bounces, spp=1):
    sd = builder(w, h, device="cuda")
    return dataclasses.replace(sd, config=dataclasses.replace(
        sd.config, bounces=bounces, samples_per_frame=spp))


def _cube_cp():
    from rt_torch.grad.params import CameraParams

    sd = tscenes.scene_cube(8, 8, device="cuda")
    return CameraParams.create(sd.camera.eye[:3], (0.0, 0.0, 0.0),
                               float(sd.camera.focal_length),
                               float(sd.camera.focal_blur),
                               float(sd.camera.fov), device="cuda")


@pytest.mark.gpu
def test_cuda_cube_free_eye_recovery_is_gauge_limited():
    """tests/test_soft_tris.py:99 on the card: free 3-dof eye recovery on
    the cube against the exact render converges in loss (5x) and moves the
    eye closer, not to it."""
    _needs_card()
    import numpy as np

    from rt_torch.grad.params import host_camera, look_at
    from rt_torch.grad.soft_tris import recover_camera_tris

    sd = _small(tscenes.scene_cube, 96, 72, 2, spp=4)
    true_cp = _cube_cp()
    target = tdispatch.render_color(sd.scene, host_camera(look_at(true_cp)),
                                    sd.config, TIME)
    v = true_cp.eye.cpu().numpy()
    a = np.deg2rad(1.8)
    c, s = np.cos(a), np.sin(a)
    v2 = np.array([c * v[0] + s * v[2], v[1], -s * v[0] + c * v[2]],
                  np.float32)
    init = true_cp._replace(eye=torch.from_numpy(v2).cuda())
    rec, _, losses = recover_camera_tris(
        sd.scene, sd.config, target, init, steps=160, learning_rate=8e-3,
        taus=(0.06, 0.02, 0.008), optimize_fields=("eye",))
    err0 = float((init.eye - true_cp.eye).abs().max())
    err1 = float((rec.eye - true_cp.eye).abs().max())
    assert losses[-1] < losses[0] / 5, f"loss {losses[0]} -> {losses[-1]}"
    assert err1 < err0, f"eye error {err0} -> {err1}"


@pytest.mark.gpu
def test_cuda_cube_orbit_recovery_from_exact_target():
    """tests/test_soft_tris.py:245 on the card: theta and phi 10x, fov 2x."""
    _needs_card()
    import numpy as np

    from rt_torch.grad.soft_tris import OrbitParams, recover_orbit_tris

    sd = _small(tscenes.scene_cube, 96, 72, 2, spp=4)
    look_target = (0.0, 0.1, -3.0)
    fl = float(sd.camera.focal_length)
    true_op = OrbitParams.from_eye(sd.camera.eye[:3], look_target,
                                   float(sd.camera.fov), device="cuda")
    target = tdispatch.render_color(sd.scene, sd.camera, sd.config, TIME)
    init = OrbitParams.create(float(true_op.radius),
                              float(true_op.theta) + np.deg2rad(2.5),
                              float(true_op.phi) - np.deg2rad(1.5),
                              float(true_op.fov) + 0.03, device="cuda")
    rec, losses = recover_orbit_tris(
        sd.scene, sd.config, target, init, look_target, focal_length=fl,
        focal_blur=float(sd.camera.focal_blur), steps=200,
        learning_rate=8e-3, taus=(0.06, 0.02, 0.008, 0.003))
    errs = lambda op: [abs(float(getattr(op, k)) - float(getattr(true_op, k)))
                       for k in ("theta", "phi", "fov")]
    e0, e1 = errs(init), errs(rec)
    assert e1[0] < e0[0] / 10, f"theta {e0[0]} -> {e1[0]}"
    assert e1[1] < e0[1] / 10, f"phi {e0[1]} -> {e1[1]}"
    assert e1[2] < e0[2] / 2, f"fov {e0[2]} -> {e1[2]}"
    assert losses[-1] < losses[0]


def _metal(bounces):
    return _small(tscenes.test_scene_metal, 64, 32, bounces)


@pytest.mark.gpu
@pytest.mark.parametrize("fields,init_eye,init_fov,lr,limit", [
    (("eye",), (0.35, -0.25, 3.5), 0.2, 2e-2, 0.08),
    (("fov",), (0.0, 0.0, 3.5), 0.26, 1e-2, 0.02)])
def test_cuda_soft_camera_recovery(fields, init_eye, init_fov, lr, limit):
    """tests/test_grad.py:194 (an eye offset) and :212 (a fov offset) on the
    card: annealed soft-visibility descent, 240 steps."""
    _needs_card()
    import numpy as np

    from rt_torch.grad.params import CameraParams, look_at
    from rt_torch.grad.soft import recover_camera, soft_render

    sd = _metal(3)
    make = lambda eye, fov: CameraParams.create(
        eye, (0.0, 0.0, 0.0), 3.5, 0.04, np.pi * fov, device="cuda")
    true_cp = make((0.0, 0.0, 3.5), 0.2)
    with torch.no_grad():
        target = soft_render(sd.scene, look_at(true_cp), sd.config, TIME,
                             tau=0.02)
    rec, _ = recover_camera(sd.scene, sd.config, target,
                            make(init_eye, init_fov), steps=240,
                            learning_rate=lr, optimize_fields=fields)
    if fields == ("eye",):
        err = float((rec.eye - true_cp.eye).abs().max())
    else:
        err = abs(float(rec.fov) - float(true_cp.fov))
    assert err < limit, f"{fields} error {err}"


@pytest.mark.gpu
def test_cuda_sphere_geometry_recovery():
    """tests/test_grad.py:371 on the card: one sphere's center recovered on
    the soft surrogate, then validated with the differentiable exact
    renderer (the recovered scene's image far closer to the truth)."""
    _needs_card()
    from rt_torch.grad import (SphereParams, apply_params, image_mse,
                               render_color_diff)
    from rt_torch.grad.soft import recover_geometry, soft_render

    sd = _metal(2)
    idx = 1
    with torch.no_grad():
        target = soft_render(sd.scene, sd.camera, sd.config, TIME, tau=0.02)
    wrong = sd.scene.center.clone()
    wrong[idx] += wrong.new_tensor([0.35, -0.25, 0.2])
    init = SphereParams(center=wrong, radius=sd.scene.radius)
    rec, _ = recover_geometry(sd.scene, sd.camera, sd.config, target, init,
                              sphere_index=idx, steps=180,
                              learning_rate=3e-2)
    err = float((rec.center[idx] - sd.scene.center[idx]).abs().max())
    assert err < 0.06, f"center error {err}"
    with torch.no_grad():
        exact = render_color_diff(sd.scene, sd.camera, sd.config, TIME)
        mse = lambda p: float(image_mse(render_color_diff(
            apply_params(sd.scene, p), sd.camera, sd.config, TIME), exact))
        assert mse(rec) < 0.05 * mse(init)


def _replay_case(width, height, row0=0, rows=None):
    """(scene, camera, config, the band's hits, a random target of the
    band) of Suzanne at its 5 bounces, recorded by K9 on the card."""
    import numpy as np

    from rt_torch.grad import record_hits

    sd = tscenes.scene_suzanne(width, height, device="cuda")
    _, hits = record_hits(sd.scene, sd.camera, sd.config, TIME)
    rows = height - row0 if rows is None else rows
    hits = hits[:, row0:row0 + rows].contiguous()
    target = torch.from_numpy(np.random.RandomState(7).uniform(
        0.0, 1.0, (rows, width, 3)).astype(np.float32)).cuda()
    return sd.scene, sd.camera, sd.config, hits, target


REPLAY_SHAPES = {"suzanne_256": (256, 256, 0, None),
                 "band_1080p": (1920, 1080, 512, 64)}


@pytest.mark.gpu
@pytest.mark.parametrize("shape", list(REPLAY_SHAPES))
def test_cuda_replay_kernel_colour_equals_replay_color_bitwise(shape):
    """The replay kernel's colour plane against ``replay_color``'s on the
    same hits, bit for bit: at Suzanne 256x256 and at a band of a 1080p
    frame."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from rt_torch.grad import replay_color
    from rt_torch.kernels import replay_kernel as rk

    width, height, row0, rows = REPLAY_SHAPES[shape]
    scene, camera, config, hits, target = _replay_case(width, height, row0,
                                                       rows)
    with torch.no_grad():
        img = replay_color(scene, camera, config, TIME, hits, row0=row0)
    before = rk.LAUNCHES["replay_loss"]
    _, _, color = rk.replay_loss_grad(scene, camera, config, TIME, hits,
                                      target, row0=row0, want_color=True)
    torch.cuda.synchronize()
    assert rk.LAUNCHES["replay_loss"] == before + 1
    assert _bit_equal(color, img)


def _many_materials(scene, n, seed=5):
    """The scene's faces spread over ``n`` materials drawn from its own."""
    gen = torch.Generator().manual_seed(seed)
    pick = lambda t: t[torch.randint(0, t.shape[0], (n,),
                                     generator=gen).to(t.device)]
    mat_id = torch.randint(0, n, scene.mat_id.shape, generator=gen)
    return scene._replace(mat_id=mat_id.to(scene.mat_id),
                          mat_albedo=pick(scene.mat_albedo),
                          mat_param=pick(scene.mat_param),
                          mat_kind=pick(scene.mat_kind))


REPLAY_GRAD_CASES = ["band", "weighted", "zero_albedo", "40_materials"]


@pytest.mark.gpu
@pytest.mark.parametrize("case", REPLAY_GRAD_CASES)
def test_cuda_replay_kernel_loss_and_gradient_equal_autograd(case):
    """Loss and albedo gradient within 1e-5 relative of autograd through
    ``replay_color`` and the loss on the card (a band of 64 rows of a
    256x256 frame over the frame's count, or with a per-pixel weight over
    the whole weight's sum; a zero albedo; Suzanne's faces over 40
    materials, three chunks of the kernel's columns); two launches give
    the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np

    from rt_torch.grad import record_hits
    from rt_torch.kernels import replay_kernel as rk

    scene, camera, config, hits, target = _replay_case(256, 256, 96, 64)
    band = slice(96, 160)
    if case == "weighted":
        full = torch.from_numpy(np.random.RandomState(3).uniform(
            0.0, 2.0, (256, 256)).astype(np.float32)).cuda()
        norm, weight = torch.sum(full) * 3.0 + 1e-9, full[band].contiguous()
    else:
        norm = torch.tensor(256.0 * 256 * 3, device="cuda")
        weight = None
    if case == "zero_albedo":
        albedo = scene.mat_albedo.clone()
        albedo[0] = 0.0
        albedo[4, 1] = 0.0
        scene = scene._replace(mat_albedo=albedo)
    elif case == "40_materials":
        scene = _many_materials(scene, 40)
        _, hits = record_hits(scene, camera, config, TIME)
        hits = hits[:, band].contiguous()
    args = (scene, camera, config, TIME, hits, target, weight, norm)
    loss, grad = rk.replay_loss_grad_plain(*args, row0=96)
    k_loss, k_grad = rk.replay_loss_grad(*args, row0=96)
    again = rk.replay_loss_grad(*args, row0=96)
    torch.testing.assert_close(k_loss, loss, rtol=1e-5, atol=0)
    torch.testing.assert_close(k_grad, grad, rtol=1e-5, atol=0)
    assert torch.isfinite(k_grad).all()
    if case == "zero_albedo":
        assert float(k_grad[0].abs().min()) > 0.0
    assert _bit_equal(again[0], k_loss) and _bit_equal(again[1], k_grad)


@pytest.mark.gpu
def test_cuda_fit_replay_on_the_kernel_equals_the_autograd_path(monkeypatch):
    """A 12-step fit with one re-record at Suzanne 256x256, 5 bounces: the
    replay kernel launches once a step and its losses are within 1e-5 of
    the autograd path's (forced by denying the choice)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from rt_torch.grad import record_hits, train
    from rt_torch.kernels import replay_kernel as rk
    from rt_torch.utils import profiling

    sd = tscenes.scene_suzanne(256, 256, device="cuda")
    target, _ = record_hits(sd.scene, sd.camera, sd.config, TIME)
    albedo = sd.scene.mat_albedo.clone()
    albedo[0] = albedo.new_tensor([0.8, 0.1, 0.1])
    bad = sd.scene._replace(mat_albedo=albedo)
    kw = dict(time=TIME, steps=12, rerecord_every=6, learning_rate=5e-2)
    before = dict(profiling.counters())
    _, losses = train.fit_replay(bad, sd.camera, sd.config, target, **kw)
    after = profiling.counters()
    assert after["replay_loss"] - before["replay_loss"] == 12
    assert after["replay_kernel_steps"] - before["replay_kernel_steps"] == 12
    assert after["replay_autograd_steps"] == before["replay_autograd_steps"]
    monkeypatch.setattr(train, "_albedo_is_the_only_leaf", lambda s: False)
    _, ref = train.fit_replay(bad, sd.camera, sd.config, target, **kw)
    assert rk.LAUNCHES["replay_loss"] == after["replay_loss"]
    assert losses[-1] < 0.5 * losses[0]
    torch.testing.assert_close(torch.tensor(losses), torch.tensor(ref),
                               rtol=1e-5, atol=0)
