"""Live-ray packing, lanes a ray and the sphere early exits of the
whole-frame kernels, held on the CPU against the plain versions.

K6 (``csrc/spheres.cu:spheres_chunked_kernel``), K7 and K9
(``csrc/tris_mono.cu:tris_mono_kernel``) run one bounce's scan through
``csrc/tris_trace.cuh:packed_scan``: each tile numbers its live rays in
thread order and scans live ray k in thread group k (``lanes`` threads a
ray: lane g scans primitives g, g + lanes, ... of a chunk from the best t
before it, shuffles keep the least (t, index)), with the chunk votes
batched 32 visit entries at a time; the scan returns (best t, winning row)
and the home thread resolves the hit from the table row.  The sphere pair
test leaves a pair at ``!(disc >= 0)`` and at ``!(num > 0)`` without the
root or the divide.

Four tests, each on inputs made from a seed with numpy or on the port's
scenes, bit for bit against the plain versions or the tensor code they
replace:
(i) the early exits against ``sphere_kernel._scan_rows`` on pairs with a
discriminant of exactly 0, a NaN discriminant, a zero direction, padding
rows, origins on a sphere and the cover scene's ground sphere;
(ii) a model of K6's packed, batched loop in place of
``sphere_bounce_chunked`` on cover 64x32, 4 bounces, at 1, 2 and 4 lanes;
(iii) a model of the packed whole-frame loop in place of ``trace_bounce``
on Suzanne 64x32, 3 bounces, at 1, 2 and 4 lanes, color and K9's index
planes (the kernels' default builds give a ray 1 to 4 lanes);
(iv) the wrappers' chunk order from the eye as scalars against
``chunk_order`` from the eye as a tensor.

A kernel picks each tile's lanes from its live count; every tile of a
model run below takes the same lanes, and tiles are independent, so equality
at each lane count covers any mixture of them.  K6 scans a lane's share of
a chunk in two phases (every discriminant's sign, then the pairs that pass,
in ascending order); the first phase filters on a test that does not
depend on the best t, so the models' one ascending pass covers it.
"""

import functools

import numpy as np
import pytest
import torch

from rt_torch.core import vecmath as vm
from rt_torch.kernels import dispatch
from rt_torch.kernels import sphere_kernel as tsk
from rt_torch.kernels import tris_kernel as ttk
from rt_torch.scene import scenes
from _torch_threads import one_torch_thread  # noqa: F401

BATCH = 32                      # visit entries a batch (tris_trace.cuh)
CHUNK = ttk.CHUNK
_FLT_MAX = ttk._FLT_MAX


def _bits_equal(a, b):
    if a.dtype.is_floating_point:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


# ---------------------------------------------------------------------------
# (i) the sphere pair test's early exits
# ---------------------------------------------------------------------------

def sphere_pair(row, o, d, two_a, four_a):
    """(t, ok) of rays against sphere rows as ``hit_sphere`` computes them:
    ok is False where the kernel leaves the pair at ``!(disc >= 0)`` or
    ``!(num > 0)``, and where the quotient fails ``t > 0``; t is the
    quotient where the kernel reaches it (without the ``t < bt`` term)."""
    oc = (o[0] - row[0], o[1] - row[1], o[2] - row[2])
    b = 2.0 * vm.dot3(oc, d)
    cc = vm.dot3(oc, oc) - row[3] * row[3]
    disc = b * b - four_a * cc
    reached = disc >= 0.0
    num = -b - vm.sqrt(torch.where(reached, disc, torch.zeros_like(disc)))
    reached = reached & (num > 0.0)
    t = num / two_a
    return t, reached & (t > 0.0)


def _pairs():
    """(table (N, 8), o (3, R), d (3, R)) with every edge case listed in the
    module docstring, and seeded random rays and spheres."""
    rng = np.random.default_rng(7)
    rows = [
        [0, 0, 5, 1],             # tangent rays: disc exactly 0
        [0, 0, 5, 2],             # origins (0, 0, 3) and (0, 0, 7) on it
        [0, -1000, 0, 1000],      # cover's ground sphere
        [0, 0, 0, tsk.PAD_RADIUS],  # a padding row
        [3, 1, -4, 0.5],
    ]
    rows += [list(rng.uniform(-4, 4, 3)) + [rng.uniform(0.1, 2)]
             for _ in range(11)]
    tab = np.zeros((len(rows), 8), np.float32)
    tab[:, :4] = np.asarray(rows, np.float32)
    tab[3, :3] = 0.0

    o = [[1, 0, 0], [1, 0, 10], [0, 0, 3], [0, 0, 3], [0, 0, 3],
         [0, 0, 7], [0, 5, 0], [0, 0.5, 0], [0, -0.5, 0], [2, 2, 2],
         [np.inf, 0, 0], [0, 0, 0], [0, 0, 0]]
    d = [[0, 0, 1], [0, 0, -1], [0, 0, 1], [0, 0, -1], [1, 0, 0],
         [0, 0, -1], [0, -1, 0], [0.3, -1, 0.1], [0, 1, 0], [0, 0, 0],
         [0, 0, 1], [np.nan, 0, 0], [0, 0, 1]]
    o = np.asarray(o, np.float32)
    d = np.asarray(d, np.float32)
    n = 512
    ro = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    rd[::9] = 0.0                                   # zero directions
    # origins exactly on random spheres: centre + radius along an axis
    pick = rng.integers(5, len(rows), n // 4)
    ro[: n // 4] = tab[pick, :3]
    ro[np.arange(n // 4), 1] += tab[pick, 3]
    o = np.concatenate([o, ro])
    d = np.concatenate([d, rd])
    return (torch.from_numpy(tab), torch.from_numpy(o.T.copy()),
            torch.from_numpy(d.T.copy()))


def test_sphere_early_exits_equal_the_plain_scan_bitwise():
    tab, o, d = _pairs()
    o, d = tuple(o), tuple(d)
    two_a, four_a = tsk._hoisted(d)
    n = tab.shape[0]
    bt0 = torch.zeros_like(o[0]) + _FLT_MAX
    idx0 = torch.full(o[0].shape, -1, dtype=torch.int64)
    p_bt, p_idx = tsk._scan_rows(tab, 0, n, o, d, two_a, four_a, bt0, idx0)

    bt, bidx = bt0, idx0
    discs = []
    for si in range(n):
        row = tab[si]
        t, ok = sphere_pair(row, o, d, two_a, four_a)
        ok = ok & (t < bt)
        bt = torch.where(ok, t, bt)
        bidx = torch.where(ok, si, bidx)
        oc = (o[0] - row[0], o[1] - row[1], o[2] - row[2])
        b = 2.0 * vm.dot3(oc, d)
        discs.append(b * b - four_a * (vm.dot3(oc, oc) - row[3] * row[3]))
    assert _bits_equal(bt, p_bt) and _bits_equal(bidx, p_idx)

    disc = torch.stack(discs)
    # the edge cases are there: disc exactly 0 (with and without a hit),
    # NaN, +inf (padding rows), zero directions, origins on a sphere
    assert int((disc == 0).sum()) >= 4 and bool(torch.isnan(disc).any())
    assert bool(torch.isinf(disc[3]).any())
    assert bool((two_a == 0).any())
    assert int((p_idx == 0).sum()) >= 1            # a tangent hit
    assert int((p_idx == 2).sum()) >= 1            # the ground sphere
    assert 0 < int((p_idx >= 0).sum()) < p_idx.numel()
    assert not bool((p_idx == 3).any())            # padding never hits


# ---------------------------------------------------------------------------
# the packed, batched scan (tris_trace.cuh: packed_scan over cull_scan)
# ---------------------------------------------------------------------------

def _slab(box, o3, id3):
    """The kernels' slab test: fminf/fmaxf (``torch.fmin``/``fmax``)."""
    t0 = [(box[..., c] - o3[..., c]) * id3[..., c] for c in range(3)]
    t1 = [(box[..., 3 + c] - o3[..., c]) * id3[..., c] for c in range(3)]
    tmin = torch.fmax(torch.fmax(torch.fmin(t0[0], t1[0]),
                                 torch.fmin(t0[1], t1[1])),
                      torch.fmin(t0[2], t1[2]))
    tmax = torch.fmin(torch.fmin(torch.fmax(t0[0], t1[0]),
                                 torch.fmax(t0[1], t1[1])),
                      torch.fmax(t0[2], t1[2]))
    return tmin, tmax


def _tri_pair(tab, rows, o, d):
    """(t, ok) of Moeller-Trumbore without its ``t < bt`` term."""
    c = [tab[rows, m][:, None] for m in range(ttk.TRI_COLS)]
    e1, e2 = (c[3], c[4], c[5]), (c[6], c[7], c[8])
    h = vm.cross3(d, e2)
    det = vm.dot3(e1, h)
    inv_det = 1.0 / det
    s = (o[0] - c[0], o[1] - c[1], o[2] - c[2])
    u = inv_det * vm.dot3(s, h)
    q = vm.cross3(s, e1)
    v = inv_det * vm.dot3(d, q)
    t = inv_det * vm.dot3(e2, q)
    ok = (torch.abs(det) >= ttk._EPS) & (u >= 0.0) & (u <= 1.0) \
        & (v >= 0.0) & (u + v <= 1.0) & (t >= ttk._EPS)
    return t, ok


def _sph_pair(tab, rows, o, d):
    two_a, four_a = tsk._hoisted(d)
    row = [tab[rows, m][:, None] for m in range(4)]
    return sphere_pair(row, o, d, two_a, four_a)


def packed_scan(pair, chunks, order, o, d, alive, *, lanes, stats=None):
    """One bounce's closest hit as ``packed_scan`` runs it, on (n_tiles, T)
    tensors: the live rays of each tile packed into its first slots in
    thread order, batches of BATCH visit entries (a mask without the best-t
    term, the tile's OR, then per set bit in ascending order the exact
    vote and the scan of the chunk's rows in ``lanes`` shares merged by
    least (t, index)); the (best t, winning row) go back to the home slots.
    pair(rows (n_tiles,), o, d) -> (t, ok) tests one row of each tile's
    chunk.  Returns (bt, win) in home order; win is -1 where nothing hit.
    stats: optional list; gets the live count of every tile appended."""
    n_tiles, tile = alive.shape
    # the ballot and prefix: live ray `rank` goes to slot `rank`
    perm = torch.argsort((~alive).to(torch.int8), dim=1, stable=True)
    n_live = alive.sum(dim=1, keepdim=True)
    if stats is not None:
        stats.append(n_live[:, 0])
    scanning = torch.arange(tile)[None, :] < n_live
    o = tuple(torch.gather(c, 1, perm) for c in o)
    d = tuple(torch.gather(c, 1, perm) for c in d)
    o3 = torch.stack(o, dim=-1)[:, :, None, :]
    id3 = torch.stack(tuple(1.0 / c for c in d), dim=-1)[:, :, None, :]
    bt = torch.zeros_like(o[0]) + _FLT_MAX
    win = torch.full(bt.shape, -1, dtype=torch.int64)

    for base in range(0, order.shape[1], BATCH):
        ci_b = order[:, base:base + BATCH]
        tmin, tmax = _slab(chunks[ci_b][:, None, :, :], o3, id3)
        mask = scanning[:, :, None] & (tmin <= tmax) & (tmax >= 0.0)
        cand = mask.any(dim=1)
        for j in range(ci_b.shape[1]):
            if not bool(cand[:, j].any()):
                continue
            ci = ci_b[:, j]
            live = mask[:, :, j] & (tmin[:, :, j] < bt)
            scan = live.any(dim=1, keepdim=True) & scanning
            prev = bt
            shares = []
            for g in range(lanes):
                bt_g = prev
                k_g = torch.full_like(win, CHUNK)
                for k in range(g, CHUNK, lanes):
                    t, ok = pair(ci * CHUNK + k, o, d)
                    ok = ok & scan & (t < bt_g)
                    bt_g = torch.where(ok, t, bt_g)
                    k_g = torch.where(ok, k, k_g)
                shares.append((bt_g, k_g))
            step = 1                      # the shuffles, pairwise
            while step < lanes:
                merged = []
                for g, (bt_g, k_g) in enumerate(shares):
                    bt_o, k_o = shares[g ^ step]
                    take = (bt_o < bt_g) | ((bt_o == bt_g) & (k_o < k_g))
                    merged.append((torch.where(take, bt_o, bt_g),
                                   torch.where(take, k_o, k_g)))
                shares, step = merged, 2 * step
            bt, kbest = shares[0]
            win = torch.where(bt < prev, ci[:, None] * CHUNK + kbest, win)

    # back to the home threads
    home_bt = torch.empty_like(bt).scatter_(1, perm, bt)
    home_win = torch.empty_like(win).scatter_(1, perm, win)
    return home_bt, home_win


# ---------------------------------------------------------------------------
# (ii) K6 on cover
# ---------------------------------------------------------------------------

def packed_sphere_bounce(packed, order, carry, flags, *, lanes, stats,
                         chunk=CHUNK, scan_counts=None):
    """``sphere_bounce_chunked`` as K6 runs it: packed_scan, then the home
    thread's resolve from the winning row of the table."""
    assert chunk == CHUNK
    _, o, d, _, active = carry
    tile_order = order.to(torch.int64)[None, :].expand(active.shape[0], -1)
    bt, win = packed_scan(functools.partial(_sph_pair, packed.tab),
                          packed.chunks, tile_order, o, d, active > 0,
                          lanes=lanes, stats=stats)
    return tsk._resolve_and_scatter(packed.tab, packed.kinds, carry, bt, win,
                                    flags)


@pytest.fixture(scope="module")
def cover():
    sd = scenes.scene_sphere_cover(64, 32, device="cpu")
    cfg = sd.config
    packed = dispatch.pack_scene(sd.scene, cfg)
    assert packed.chunks is not None and packed.n_chunks == 16
    kw = dict(height=32, width=64, height_pad=32, width_pad=64, bounces=4,
              normalize_defocus_dir=cfg.normalize_defocus_dir,
              flags=dispatch.trace_flags(cfg), th=8, tw=16)
    cam_row = dispatch.pack_camera(sd.camera)
    plain = tsk.render_color_spheres_chunked_plain(packed, cam_row, 1000,
                                                   **kw)
    return packed, cam_row, kw, plain


@pytest.mark.parametrize("lanes", [1, 2, 4])
def test_packed_sphere_model_equals_the_plain_chunked_bounce_bitwise(
        cover, monkeypatch, lanes):
    packed, cam_row, kw, plain = cover
    stats = []
    monkeypatch.setattr(tsk, "sphere_bounce_chunked", functools.partial(
        packed_sphere_bounce, lanes=lanes, stats=stats))
    model = tsk.render_color_spheres_chunked_plain(packed, cam_row, 1000,
                                                   **kw)
    assert _bits_equal(model, plain)
    # the packing moved rays: after bounce 0 some tiles are partly dead
    live = torch.stack(stats[1:])
    assert len(stats) == 4 and bool(((live > 0) & (live < 128)).any())


# ---------------------------------------------------------------------------
# (iii) K7 and K9 on Suzanne
# ---------------------------------------------------------------------------

def packed_tri_bounce(packed, order, carry, flags, *, lanes, stats,
                      chunk=CHUNK, scan_counts=None, track_idx=False):
    """``trace_bounce`` as K7 and K9 run it: packed_scan, then the home
    thread's resolve from the winning row of the table (its normal and
    material id), the material chain and the scatter."""
    assert chunk == CHUNK
    state, o, d, atten, active = carry
    alive = active > 0
    bt, win = packed_scan(functools.partial(_tri_pair, packed.tab),
                          packed.chunks, order.to(torch.int64), o, d, alive,
                          lanes=lanes, stats=stats)
    hit = alive & (bt != _FLT_MAX)
    row = packed.tab[torch.clamp(win, min=0)]
    zero = torch.zeros_like(bt)
    bn = tuple(torch.where(hit, row[..., c], zero) for c in (9, 10, 11))
    bmid = torch.where(hit, row[..., 12], zero)
    bal, bpar, bkind = (zero, zero, zero), zero, zero
    for j in range(packed.mats.shape[0]):
        match = bmid == float(j)
        m = packed.mats[j]
        bal = vm.where3(match, (m[0], m[1], m[2]), bal)
        bpar = torch.where(match, m[3], bpar)
        bkind = torch.where(match, m[4], bkind)
    point = vm.add3(o, vm.scale3(d, bt))
    front_face = vm.dot3(bn, d) > 0.0
    ns, nd = ttk.tc.scatter(state, d, point, bn, front_face, bal, bpar,
                            bkind.to(torch.int32),
                            normalize_reflect_in=flags.normalize_reflect_in,
                            has_metal=flags.has_metal,
                            has_dielectric=flags.has_dielectric)
    minus = torch.full_like(active, -1)
    out = (torch.where(hit, ns, state), vm.where3(hit, point, o),
           vm.where3(hit, nd, d),
           vm.where3(hit, vm.scale3(vm.mul3(atten, bal), 0.7), atten),
           hit.to(torch.int32),
           torch.where(hit, (win // CHUNK).to(minus.dtype), minus))
    if track_idx:
        out += (torch.where(hit, win.to(minus.dtype), minus),)
    return out


@pytest.fixture(scope="module")
def suzanne():
    sd = scenes.scene_suzanne(64, 32, device="cpu")
    packed = dispatch.pack_scene(sd.scene)
    assert packed.n_chunks == 35               # a full batch and 3
    kw = dict(height=32, width=64, height_pad=32, width_pad=64, bounces=3,
              normalize_defocus_dir=True, th=8, tw=16,
              flags=dispatch.trace_flags(sd.config))
    cam_row = dispatch.pack_camera(sd.camera)
    plain = ttk.render_color_tris_record_plain(packed, cam_row, 1000, **kw)
    return packed, cam_row, kw, plain


@pytest.mark.parametrize("lanes", [1, 2, 4])
def test_packed_mono_model_equals_the_plain_frame_bitwise(suzanne,
                                                          monkeypatch, lanes):
    """The color and K9's index planes (through the recorder's plain
    version; K7's color is the same frame's)."""
    packed, cam_row, kw, (p_color, p_idx, _) = suzanne
    stats = []
    monkeypatch.setattr(ttk, "trace_bounce", functools.partial(
        packed_tri_bounce, lanes=lanes, stats=stats))
    color, idx, _ = ttk.render_color_tris_record_plain(packed, cam_row, 1000,
                                                       **kw)
    assert _bits_equal(color, p_color) and _bits_equal(idx, p_idx)
    assert int((p_idx >= 0).sum()) > 0 and int((p_idx == -1).sum()) > 0
    live = torch.stack(stats[1:])
    assert len(stats) == 3 and bool(((live > 0) & (live < 128)).any())


@pytest.mark.parametrize("make_scene", [scenes.scene_suzanne,
                                        scenes.scene_sphere_cover,
                                        scenes.scene_lucy])
def test_eye_order_from_scalars_equals_the_tensor_eye_order(make_scene):
    """The whole-frame wrappers order the chunks from the eye as three f32
    scalars (no copy to the card): the same order as ``chunk_order`` from
    the eye as a tensor."""
    sd = make_scene(32, 32, device="cpu")
    packed = dispatch.pack_scene(sd.scene, sd.config)
    cam_row = dispatch.pack_camera(sd.camera)
    centroid = (packed.centroid if hasattr(packed, "centroid") else
                (packed.chunks[:, 0:3] + packed.chunks[:, 3:6]) * 0.5)
    eye = torch.from_numpy(cam_row[0, 0:3].copy())
    want = ttk.chunk_order(centroid, eye)
    got = ttk.eye_order(centroid, cam_row)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert not torch.equal(want, torch.arange(want.numel(),
                                              dtype=torch.int32))
