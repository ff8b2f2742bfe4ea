"""The sorted-stream recorder's redesign (K10a, K10b: ``csrc/tris_trace.cuh``
``trace_bounce``, ``csrc/tris_wave.cu``, the glue
``tris_kernel.render_color_tris_wave_record``), held on the CPU.

- Group boxes.  The kernels test a ray against the box of each run of 32
  consecutive table chunks (``tris_kernel.group_boxes``) and run a chunk's
  slab test only where its group was entered (``tris_kernel.enters_groups``
  is that test as plain tensor code).  On random rays and boxes made with
  numpy from a seed (direction components of +0 and -0, origins on the
  faces of chunk and group boxes: NaN products) and on the recorder's
  streams of lucy and dragon thumbnails at every bounce, the group bits
  must cover every chunk bit (``alive & tmin <= tmax & tmax >= 0``), so the
  kernels' mask is the plain one.
- The plain scan of a chunk's 32 triangles at once (a card's) against
  the scan one triangle at a time (the CPU's, strict ``t < best``), on
  chunks with repeated triangles (exact-t ties) and through a record.
- The live-tile launch: the recorder launches K10b on the tiles that hold
  the sorted stream's live rays (``live_tiles``); its color and index
  planes equal those of the recorder that traces the whole stream, bit for
  bit, and the tiles not launched keep their payload and get -1 planes.
- The work the group boxes leave (``tris_kernel.group_box_tests``, the box
  tests of the plain version's counts and so of ``measure.bound``): each
  live ray's group tests and the chunks of the groups it enters, against
  an independent float64 count in numpy.
"""

import math

import numpy as np
import pytest
import torch

from rt_torch import measure
from rt_torch.core import vecmath as vm
from rt_torch.kernels import dispatch
from rt_torch.kernels import tris_kernel as ttk
from rt_torch.scene import scenes
from _torch_threads import one_torch_thread  # noqa: F401

GROUP = ttk.GROUP


def _slab_bits(chunks, o, inv_d):
    """The chunk bits of rays (n, 3) against boxes (m, 6): the plain
    version's slab test without its best-t term, (n, m)."""
    t0 = [(chunks[None, :, c] - o[:, None, c]) * inv_d[:, None, c]
          for c in range(3)]
    t1 = [(chunks[None, :, 3 + c] - o[:, None, c]) * inv_d[:, None, c]
          for c in range(3)]
    tmin = ttk._fmax(ttk._fmax(ttk._fmin(t0[0], t1[0]),
                               ttk._fmin(t0[1], t1[1])),
                     ttk._fmin(t0[2], t1[2]))
    tmax = ttk._fmin(ttk._fmin(ttk._fmax(t0[0], t1[0]),
                               ttk._fmax(t0[1], t1[1])),
                     ttk._fmax(t0[2], t1[2]))
    return (tmin <= tmax) & (tmax >= 0.0)


def _group_bits(groups, o, inv_d):
    """``enters_groups`` on rays (n, 3): (n, n_groups)."""
    return ttk.enters_groups(groups, tuple(o.T), tuple(inv_d.T))


def _narrow_group_bits(groups, o, inv_d):
    """The group test without the NaN widening: fminf/fmaxf alone."""
    t0 = (groups[None, :, 0:3] - o[:, None, :]) * inv_d[:, None, :]
    t1 = (groups[None, :, 3:6] - o[:, None, :]) * inv_d[:, None, :]
    lo, hi = torch.fmin(t0, t1), torch.fmax(t0, t1)
    tmin = torch.fmax(torch.fmax(lo[..., 0], lo[..., 1]), lo[..., 2])
    tmax = torch.fmin(torch.fmin(hi[..., 0], hi[..., 1]), hi[..., 2])
    return (tmin <= tmax) & (tmax >= 0.0)


def _random_case(seed, n_rays=600, n_chunks=96):
    rng = np.random.default_rng(seed)
    # chunks in runs of GROUP that cluster, as the Morton order gives
    centre = np.repeat(rng.uniform(-3, 3, (-(-n_chunks // GROUP), 3)),
                       GROUP, axis=0)[:n_chunks]
    lo = (centre + rng.uniform(-1, 0.5, (n_chunks, 3))).astype(np.float32)
    hi = (lo + rng.uniform(0, 1.0, (n_chunks, 3))).astype(np.float32)
    hi[::9] = lo[::9]                          # flat boxes
    chunks = torch.from_numpy(np.concatenate([lo, hi], axis=1))
    groups = ttk.group_boxes(chunks)
    o = rng.uniform(-5, 5, (n_rays, 3)).astype(np.float32)
    d = rng.normal(size=(n_rays, 3)).astype(np.float32)
    # axis-parallel directions: components of +0 and -0 (+-inf inverses)
    zero = rng.random((n_rays, 3)) < 0.3
    d[zero] = np.where(rng.random(int(zero.sum())) < 0.5, 0.0, -0.0)
    d[::101] = 0.0
    # origins on the planes of chunk faces and of group faces: (face - o)
    # == 0, NaN products on the zero components
    for boxes, share in ((chunks.numpy(), 0.3), (groups.numpy(), 0.3)):
        on = rng.random(n_rays) < share
        pick = rng.integers(0, boxes.shape[0], n_rays)
        for axis in range(3):
            side = rng.integers(0, 2, n_rays) * 3
            sel = on & (rng.random(n_rays) < 0.6)
            o[sel, axis] = boxes[pick[sel], axis + side[sel]]
    with np.errstate(divide="ignore"):
        inv_d = (np.float32(1.0) / d).astype(np.float32)
    return chunks, groups, torch.from_numpy(o), torch.from_numpy(inv_d)


def _assert_cover(chunks, groups, o, inv_d):
    """Every chunk bit lies in an entered group; returns the bits."""
    bits = _slab_bits(chunks, o, inv_d)
    gbits = _group_bits(groups, o, inv_d)
    of = torch.arange(chunks.shape[0]) // GROUP
    assert not bool((bits & ~gbits[:, of]).any())
    # the kernels' mask: the chunk test only where the group was entered
    assert torch.equal(bits & gbits[:, of], bits)
    return bits, gbits


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_group_bits_cover_every_chunk_bit_on_random_rays(seed):
    chunks, groups, o, inv_d = _random_case(seed)
    # each chunk box lies in its group's box, exactly
    of = torch.arange(chunks.shape[0]) // GROUP
    assert bool((groups[of, 0:3] <= chunks[:, 0:3]).all())
    assert bool((groups[of, 3:6] >= chunks[:, 3:6]).all())
    assert torch.equal(groups[:, 0:3],
                       torch.stack([chunks[g * GROUP:(g + 1) * GROUP, 0:3]
                                    .amin(dim=0)
                                    for g in range(groups.shape[0])]))
    bits, gbits = _assert_cover(chunks, groups, o, inv_d)
    # the cases are there: NaN products, infinite inverses, both signs of
    # zero, chunk bits set and clear, groups entered and missed
    t0 = (chunks[None, :, 0:3] - o[:, None, :]) * inv_d[:, None, :]
    assert bool(torch.isnan(t0).any()) and bool(torch.isinf(inv_d).any())
    assert bool((inv_d == -math.inf).any()) and bool(
        (inv_d == math.inf).any())
    assert 0 < int(bits.sum()) < bits.numel()
    assert 0 < int(gbits.sum()) < gbits.numel()


def test_the_widening_is_needed():
    """Without it, a group box whose face plane holds the origin of a ray
    parallel to it would keep the other product of that axis alone (+inf)
    and miss a chunk the ray enters.  The smallest such case: a ray with
    direction (0, 0, 1) from o = (0, 0.5, -1) and a chunk flat in x at
    x = 0 (both its x products NaN: the chunk test drops the axis) in a
    group from x = 0 to 2."""
    chunks = torch.tensor([[0.0, 0.0, 0.0, 0.0, 1.0, 1.0],
                           [1.0, 0.0, 0.0, 2.0, 1.0, 1.0]])
    groups = ttk.group_boxes(chunks)
    o = torch.tensor([[0.0, 0.5, -1.0]])
    inv_d = 1.0 / torch.tensor([[0.0, 0.0, 1.0]])
    bits = _slab_bits(chunks, o, inv_d)
    assert bits.tolist() == [[True, False]]
    assert _narrow_group_bits(groups, o, inv_d).tolist() == [[False]]
    _assert_cover(chunks, groups, o, inv_d)


def _stream_rays(name, size, bounces, counted=False):
    """(packed, [(o (n, 3), inv_d (n, 3)) of the live rays before each
    bounce], [the plain version's counts of each bounce, with ``counted``])
    of the recorder's plain run on ``name`` at size x size (its scan a
    chunk at once, as on a card: the same rays, sooner; the tensors of a
    16x16 frame stay under torch's parallel grain)."""
    sd = getattr(scenes, f"scene_{name}")(size, size, device="cpu")
    packed = ttk.pack_tri_table(sd.scene)
    rays, counts = [], []
    plain = ttk.trace_bounce

    def seen(packed_, order, carry, flags, **kw):
        _, o, d, _, active = carry
        alive = (active > 0).reshape(-1)
        o3 = torch.stack([c.reshape(-1)[alive] for c in o], dim=1)
        d3 = torch.stack([c.reshape(-1)[alive] for c in d], dim=1)
        rays.append((o3, 1.0 / d3))
        if counted:
            kw["scan_counts"] = counts
        return plain(packed_, order, carry, flags, **kw)

    ttk.trace_bounce = seen
    whole = ttk._whole_chunks
    ttk._whole_chunks = lambda rays: True
    try:
        ttk.render_color_tris_wave_record(
            packed, dispatch.pack_camera(sd.camera), 1000, height=size,
            width=size, height_pad=size, width_pad=size, bounces=bounces,
            normalize_defocus_dir=True, flags=dispatch.trace_flags(
                sd.config), th=8, tw=16)
    finally:
        ttk.trace_bounce, ttk._whole_chunks = plain, whole
    return packed, rays, counts


@pytest.mark.parametrize("name,n_groups", [("lucy", 20), ("dragon", 49)])
def test_group_bits_cover_every_chunk_bit_on_the_recorders_streams(
        name, n_groups):
    packed, rays, _ = _stream_rays(name, 16, 3)
    assert packed.groups.shape == (n_groups, 6)
    assert len(rays) == 3
    entered = []
    for o, inv_d in rays:
        bits, gbits = _assert_cover(packed.chunks, packed.groups, o, inv_d)
        assert int(bits.sum()) > 0
        entered.append(float(gbits.float().sum(dim=1).mean()))
    # the groups cull: a ray enters a minority of them
    assert all(0 < e < n_groups / 2 for e in entered), entered


def test_whole_chunk_scan_equals_the_loop_with_ties(monkeypatch):
    """On a card the plain trace_bounce scans a chunk's 32 triangles at once
    and takes the first of least t; on the CPU it loops over them with
    strict t < best.  The two agree bit for bit, exact-t ties included
    (each triangle of the table is repeated in its chunk)."""
    rng = np.random.default_rng(5)
    m = 64
    a = rng.uniform(-1, 1, (m, 3)).astype(np.float32)
    b = a + rng.uniform(-2, 2, (m, 3)).astype(np.float32)
    c = a + rng.uniform(-2, 2, (m, 3)).astype(np.float32)
    # rows 2k and 2k+1 are one triangle: every hit on it is a tie
    a, b, c = (np.repeat(x[: m // 2], 2, axis=0) for x in (a, b, c))
    a[:, 2] -= 4.0
    b[:, 2] -= 4.0
    c[:, 2] -= 4.0
    scene = scenes.build_scene(5, 8, 8, device="cpu").scene
    scene = scene._replace(
        a=torch.from_numpy(a), b=torch.from_numpy(b), c=torch.from_numpy(c),
        normal=torch.zeros(m, 3), mat_id=torch.zeros(m, dtype=torch.int32))
    packed = ttk.pack_tri_table(scene)
    n_tiles, tile = 4, 64
    o = torch.from_numpy(rng.uniform(-0.5, 0.5, (3, n_tiles, tile))
                         .astype(np.float32))
    o[2] = 0.0
    d = torch.from_numpy(rng.normal(size=(3, n_tiles, tile))
                         .astype(np.float32))
    d[0:2] *= 0.1
    d[2] = -torch.abs(d[2]) - 1.0
    one = torch.ones(n_tiles, tile)
    carry = (torch.zeros(n_tiles, tile, dtype=torch.int64), tuple(o),
             tuple(d), (one, one, one),
             torch.ones(n_tiles, tile, dtype=torch.int32))
    order = torch.arange(packed.n_chunks).expand(n_tiles, -1)
    flags = ttk.TraceFlags(False, False, False)
    loop = ttk.trace_bounce(packed, order, carry, flags, track_idx=True)
    monkeypatch.setattr(ttk, "_whole_chunks", lambda rays: True)
    whole = ttk.trace_bounce(packed, order, carry, flags, track_idx=True)
    hit = loop[4] > 0
    assert int(hit.sum()) > 50
    assert bool((loop[6][hit] % 2 == 0).all())      # the first of a tie
    for x, y in zip(loop, whole):
        for xa, ya in zip(*((x, y) if isinstance(x, tuple) else ((x,), (y,)))):
            assert torch.equal(xa.view(torch.int32) if xa.is_floating_point()
                               else xa, ya.view(torch.int32)
                               if ya.is_floating_point() else ya)


def test_whole_chunk_scan_gives_the_loops_record(monkeypatch):
    """The whole-chunk scan through a whole record of Suzanne 32x16: color
    and index planes bit-equal to the loop's."""
    sd = scenes.scene_suzanne(32, 16, device="cpu")
    packed = ttk.pack_tri_table(sd.scene)
    kw = dict(height=16, width=32, height_pad=16, width_pad=32, bounces=3,
              normalize_defocus_dir=True,
              flags=dispatch.trace_flags(sd.config), th=8, tw=16)
    cam_row = dispatch.pack_camera(sd.camera)
    loop = ttk.render_color_tris_wave_record(packed, cam_row, 1000, **kw)
    monkeypatch.setattr(ttk, "_whole_chunks", lambda rays: True)
    whole = ttk.render_color_tris_wave_record(packed, cam_row, 1000, **kw)
    assert torch.equal(loop[0].view(torch.int32), whole[0].view(torch.int32))
    assert torch.equal(loop[1], whole[1]) and int((loop[1] >= 0).sum()) > 0


def _full_stream_record(packed, cam_row, size, bounces, flags):
    """The recorder as it was before the live-tile launch: every bounce
    traces the whole sorted stream."""
    wave_bounce = ttk.wave_bounce

    def whole(*a, live_tiles, **kw):
        pay = a[2]
        order = ttk.tile_chunk_order(packed, pay, 128)
        return wave_bounce(a[0], order, *a[2:], **kw)

    ttk.wave_bounce = whole
    try:
        return ttk.render_color_tris_wave_record(
            packed, cam_row, 1000, height=size, width=size, height_pad=size,
            width_pad=size, bounces=bounces, normalize_defocus_dir=True,
            flags=flags, th=8, tw=16)
    finally:
        ttk.wave_bounce = wave_bounce


def test_live_tile_launch_gives_the_whole_streams_planes():
    sd = scenes.scene_suzanne(32, 32, device="cpu")
    packed = ttk.pack_tri_table(sd.scene)
    cam_row = dispatch.pack_camera(sd.camera)
    flags = dispatch.trace_flags(sd.config)
    launched = []
    wave_bounce = ttk.wave_bounce

    def seen(packed_, order, pay, state, active, flags_, **kw):
        live = int(active.sum())
        tiles = kw["live_tiles"]
        # the launch covers the live rays, which the sort put first
        assert tiles == -(-live // 128) and bool(active[:live].all())
        assert order.shape == (tiles * packed_.n_chunks,)
        before = pay[:, tiles * 128:].clone(), state[tiles * 128:].clone()
        out = wave_bounce(packed_, order, pay, state, active, flags_, **kw)
        assert torch.equal(pay[:, tiles * 128:], before[0])
        assert torch.equal(state[tiles * 128:], before[1])
        assert bool((out[1][:, tiles * 128:] == -1).all())
        launched.append(tiles)
        return out

    ttk.wave_bounce = seen
    try:
        color, idx, _ = ttk.render_color_tris_wave_record(
            packed, cam_row, 1000, height=32, width=32, height_pad=32,
            width_pad=32, bounces=4, normalize_defocus_dir=True, flags=flags,
            th=8, tw=16)
    finally:
        ttk.wave_bounce = wave_bounce
    want_color, want_idx, _ = _full_stream_record(packed, cam_row, 32, 4,
                                                  flags)
    assert torch.equal(color.view(torch.int32), want_color.view(torch.int32))
    assert torch.equal(idx, want_idx)
    # the tiles launched fall as rays die: fewer than the stream's 8
    assert len(launched) == 3 and launched[-1] < 8 and launched == sorted(
        launched, reverse=True)


def test_live_tiles_argument_of_the_plain_bounce():
    """live_tiles 0 launches nothing and gives -1 planes; a live ray past
    the launched tiles or a count past the stream raises."""
    sd = scenes.scene_cube(32, 8, device="cpu")
    packed = ttk.pack_tri_table(sd.scene)
    flags = dispatch.trace_flags(sd.config)
    n = 256
    pay = torch.zeros(9, n)
    pay[3:6] = 1.0
    state = torch.zeros(n, dtype=torch.int32)
    dead = torch.zeros(n, dtype=torch.int32)
    order = torch.zeros(0, dtype=torch.int32)
    wch, idx = ttk.wave_bounce(packed, order, pay, state, dead, flags,
                               n_bounces=2, th=8, tw=16, track_idx=True,
                               live_tiles=0)
    assert bool((wch == -1).all()) and idx.shape == (2, n)
    assert bool((idx == -1).all())
    live = dead.clone()
    live[200] = 1
    with pytest.raises(ValueError, match="past the first 1 tiles"):
        ttk.wave_bounce(packed, order, pay, state, live, flags, n_bounces=1,
                        th=8, tw=16, track_idx=True, live_tiles=1)
    with pytest.raises(ValueError, match="live_tiles 3"):
        ttk.wave_bounce(packed, order, pay, state, dead, flags, n_bounces=1,
                        th=8, tw=16, live_tiles=3)


def _numpy_group_box_tests(groups, n_chunks, o, inv_d):
    """(group tests, groups entered, chunk tests) of rays (n, 3) in float64:
    the first MAX_GROUPS group boxes, a NaN axis widened to everything,
    then the chunks of each entered group and every chunk past them."""
    g = groups.numpy().astype(np.float64)[:ttk.MAX_GROUPS]
    o = o.numpy().astype(np.float64)[:, None, :]
    inv_d = inv_d.numpy().astype(np.float64)[:, None, :]
    with np.errstate(invalid="ignore"):
        t0 = (g[None, :, 0:3] - o) * inv_d
        t1 = (g[None, :, 3:6] - o) * inv_d
        nan = np.isnan(t0 + t1)
    tmin = np.where(nan, -np.inf, np.fmin(t0, t1)).max(axis=2)
    tmax = np.where(nan, np.inf, np.fmax(t0, t1)).min(axis=2)
    entered = (tmin <= tmax) & (tmax >= 0.0)
    sizes = np.array([min(GROUP, n_chunks - GROUP * k)
                      for k in range(g.shape[0])])
    n = o.shape[0]
    return (n * g.shape[0], int(entered.sum()),
            int((entered * sizes).sum()) + n * (n_chunks - int(sizes.sum())))


@pytest.mark.parametrize("n_chunks", [116, 2100])
def test_group_box_tests_count_the_live_rays_entered_groups(n_chunks):
    """116 chunks: 4 groups, the last of 20; 2100: 66 groups, of which a
    ray tests the first MAX_GROUPS and then every chunk of the last two.
    Dead rays test nothing."""
    chunks, groups, o, inv_d = _random_case(n_chunks, n_chunks=n_chunks)
    packed = ttk.PackedScene(torch.zeros(0, ttk.TRI_COLS), torch.zeros(0, 5),
                             chunks, chunks[:, 0:3], torch.zeros(0),
                             groups)
    d = 1.0 / inv_d
    alive = torch.from_numpy(
        np.random.default_rng(n_chunks).random(o.shape[0]) < 0.7)
    got = ttk.group_box_tests(packed, tuple(o.T), tuple(d.T), alive)
    want = _numpy_group_box_tests(groups, n_chunks, o[alive], 1.0 / d[alive])
    assert got == want
    assert 0 < got[1] < got[0]


def test_the_plain_counts_and_the_bound_take_the_group_boxes():
    """On the recorder's lucy stream the box tests of every bounce's counts
    are the group tests and the entered groups' chunk tests of its live
    rays (far fewer than every chunk a ray of a live tile, the last entry),
    and ``measure.bound`` charges those; a table without group boxes
    (Suzanne's) counts every chunk."""
    packed, rays, counts = _stream_rays("lucy", 16, 2, counted=True)
    assert len(counts) == 2
    for (o, inv_d), c in zip(rays, counts):
        scans, boxes, visits, *_, every_box = c
        tests = _numpy_group_box_tests(packed.groups, packed.n_chunks, o,
                                       inv_d)
        assert boxes == tests[0] + tests[2]
        assert every_box == visits * 128 and boxes < every_box / 2
    _, by, flops = measure.bound(counts, 0)
    assert by == "operations"
    assert flops == sum(c[0] * ttk.CHUNK * measure.FLOPS_PER_PAIR
                        + c[1] * measure.FLOPS_PER_BOX for c in counts)

    sd = scenes.scene_suzanne(16, 16, device="cpu")
    plain = ttk.pack_tri_table(sd.scene)
    assert plain.groups is None
    got = []
    ttk.wave_first_plain(
        plain, ttk.eye_chunk_order(plain, dispatch.pack_camera(sd.camera)),
        dispatch.pack_camera(sd.camera), torch.tensor([1000]), 0,
        dispatch.trace_flags(sd.config), height=16, width=16, height_pad=16,
        width_pad=16, th=8, tw=16, normalize_defocus_dir=True,
        scan_counts=got)
    assert got[0][1] == got[0][6] == 2 * 128 * plain.n_chunks
