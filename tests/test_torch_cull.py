"""The split tile vote of the triangle kernels' ``trace_bounce``
(``rt_torch/kernels/csrc/tris_trace.cuh``), held on the CPU.

The kernels test a batch of 32 visit entries at a time: each ray keeps a
mask of ``alive & tmin <= tmax & tmax >= 0`` (no best-t term), the tile ORs
the masks, and only the set bits take the exact vote
``any(bit & tmin < bt)`` with the ray's current best t.  Two tests: the
identity that makes this exact, on rays and boxes made with numpy from a
seed (zero direction components, origins on box faces, dead rays); and a
model of the kernel's batched loop, written here, in place of the plain
version's loop over one visit entry at a time on Suzanne 64x32, 3
bounces (K2, then K3 fusing 2), at one and two lanes a ray: every output
bitwise equal, the winning-chunk and index planes included.
"""

import functools

import numpy as np
import pytest
import torch

from rt_torch.kernels import dispatch
from rt_torch.kernels import tris_kernel as ttk
from rt_torch.scene import scenes
from _torch_threads import one_torch_thread  # noqa: F401

BATCH = 32      # visit entries a batch (tris_trace.cuh BATCH)
TILE = 32       # rays a tile


def _slab(box, o, inv_d, fmin=ttk._fmin, fmax=ttk._fmax):
    """(tmin, tmax) of rays (..., 3) against boxes broadcast to them, with
    the plain version's expressions (or other min/max)."""
    t0 = [(box[..., c] - o[..., c]) * inv_d[..., c] for c in range(3)]
    t1 = [(box[..., 3 + c] - o[..., c]) * inv_d[..., c] for c in range(3)]
    tmin = fmax(fmax(fmin(t0[0], t1[0]), fmin(t0[1], t1[1])),
                fmin(t0[2], t1[2]))
    tmax = fmin(fmin(fmax(t0[0], t1[0]), fmax(t0[1], t1[1])),
                fmax(t0[2], t1[2]))
    return tmin, tmax


def _rays_and_boxes(seed=0, n_tiles=64, n_boxes=96):
    rng = np.random.default_rng(seed)
    n = n_tiles * TILE
    lo = rng.uniform(-2, 1, (n_boxes, 3)).astype(np.float32)
    hi = lo + rng.uniform(0, 1.5, (n_boxes, 3)).astype(np.float32)
    hi[::7] = lo[::7]                        # flat boxes
    boxes = np.concatenate([lo, hi], axis=1)
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    # direction components exactly 0: an inf reciprocal, and NaN slabs
    # where an origin lies on the face (0 * inf)
    d[rng.random((n, 3)) < 0.2] = 0.0
    d[::97] = 0.0
    # origins on a face of a box: a slab of (face - o) == 0
    on = rng.random(n) < 0.25
    pick = rng.integers(0, n_boxes, n)
    axis = rng.integers(0, 3, n)
    side = rng.integers(0, 2, n) * 3
    o[on, axis[on]] = boxes[pick[on], axis[on] + side[on]]
    alive = rng.random(n) < 0.8
    alive[: 5 * TILE] = False                # whole dead tiles
    return (torch.from_numpy(boxes), torch.from_numpy(o),
            torch.from_numpy(d), torch.from_numpy(alive))


def test_split_vote_equals_the_tile_vote_for_every_best_t():
    boxes, o, d, alive = _rays_and_boxes()
    with np.errstate(divide="ignore"):
        inv_d = 1.0 / d
    n_tiles = o.shape[0] // TILE
    tmin, tmax = _slab(boxes[None, :, :], o[:, None, :], inv_d[:, None, :])
    # NaN slabs (an origin on a face, a zero direction component) and
    # infinite entries are among the cases
    slabs = (boxes[None, :, 0:3] - o[:, None, :]) * inv_d[:, None, :]
    assert bool(torch.isnan(slabs).any()) and bool(torch.isinf(tmin).any())
    # the mask, once, without bt
    mask = alive[:, None] & (tmin <= tmax) & (tmax >= 0.0)
    tile_or = mask.reshape(n_tiles, TILE, -1).any(dim=1)
    assert 0 < int(tile_or.sum()) < tile_or.numel()
    rng = np.random.default_rng(1)
    finite = tmin[torch.isfinite(tmin)]
    bts = [torch.full_like(o[:, 0], float(np.float32(3.40282e38))),
           torch.zeros_like(o[:, 0]),
           torch.from_numpy(rng.uniform(-1, 4, o.shape[0]).astype(
               np.float32)),
           # best t exactly on a box's entry: strict < decides
           finite[torch.from_numpy(rng.integers(0, finite.numel(),
                                                o.shape[0]))]]
    for bt in bts:
        full = alive[:, None] & (tmin <= tmax) & (tmax >= 0.0) \
            & (tmin < bt[:, None])
        split = mask & (tmin < bt[:, None])
        vote = full.reshape(n_tiles, TILE, -1).any(dim=1)
        assert torch.equal(vote, split.reshape(n_tiles, TILE, -1).any(dim=1))
        # a tile whose OR-mask bit is clear never votes live
        assert not bool((vote & ~tile_or).any())
    # dead rays never set a bit, and whole dead tiles have no candidate
    assert not bool(mask[~alive].any())
    assert not bool(tile_or[:5].any())


def _flip_zero(f):
    """``f`` with the sign of a zero result flipped."""
    return lambda a, b: (lambda m: torch.where(m == 0, -m, m))(f(a, b))


@pytest.mark.parametrize("fmin,fmax", [
    (torch.fmin, torch.fmax),
    (_flip_zero(torch.fmin), _flip_zero(torch.fmax)),
    (_flip_zero(ttk._fmin), _flip_zero(ttk._fmax))],
    ids=["fmin", "fmin_zero_flipped", "selects_zero_flipped"])
def test_ieee_min_max_give_the_same_mask_and_vote(fmin, fmax):
    """The kernels' box test (fminf/fmaxf: the non-NaN operand, like
    the plain version's selects, but -0 and +0 in either order): tmin and
    tmax may differ from the plain version's only in the sign of a zero,
    so every comparison the mask and the vote make is the same."""
    boxes, o, d, alive = _rays_and_boxes(seed=2)
    with np.errstate(divide="ignore"):
        inv_d = 1.0 / d
    ref = _slab(boxes[None, :, :], o[:, None, :], inv_d[:, None, :])
    alt = _slab(boxes[None, :, :], o[:, None, :], inv_d[:, None, :],
                fmin, fmax)
    assert bool(((ref[0] == 0) | (ref[1] == 0)).any())
    for r, a in zip(ref, alt):
        assert torch.equal(torch.isnan(r), torch.isnan(a))
        # torch.equal compares values: -0 == +0
        assert torch.equal(r.nan_to_num(7.0), a.nan_to_num(7.0))
    bt = torch.from_numpy(np.random.default_rng(3).uniform(
        -1, 4, o.shape[0]).astype(np.float32))[:, None]
    for t in (bt, torch.zeros_like(bt)):
        assert torch.equal(
            (ref[0] <= ref[1]) & (ref[1] >= 0.0) & (ref[0] < t),
            (alt[0] <= alt[1]) & (alt[1] >= 0.0) & (alt[0] < t))


def batched_trace_bounce(packed, order, carry, flags, *, chunk=ttk.CHUNK,
                         scan_counts=None, track_idx=False, lanes=2):
    """``trace_bounce`` as the kernel runs it, on (n_tiles, T) tensors:
    batches of BATCH visit entries, a mask a ray without the best-t term,
    the tile's OR, then per set bit in ascending order the exact vote and
    the scan of the chunk's 32 triangles from the staged rows as ``lanes``
    lanes a ray run it (lane g scans triangles g, g + lanes, ... from the
    best t before the chunk; shuffles keep the least (t, index); the
    normal, material and row come from the winner's row afterwards); dead
    rays skip the scan."""
    assert chunk == ttk.CHUNK
    state, o, d, atten, active = carry
    alive = active > 0
    inv_d = (1.0 / d[0], 1.0 / d[1], 1.0 / d[2])
    zero = torch.zeros_like(o[0])
    bt = zero + ttk._FLT_MAX
    bn = (zero, zero, zero)
    bmid = zero
    wch = torch.full_like(active, -1)
    btid = torch.full_like(active, -1) if track_idx else None
    n_chunks = packed.n_chunks
    rows = torch.zeros(packed.tab.shape[0], 20)
    rows[:, :ttk.TRI_COLS] = packed.tab          # the staged row layout
    o3 = torch.stack(o, dim=-1)[:, :, None, :]
    id3 = torch.stack(inv_d, dim=-1)[:, :, None, :]

    for base in range(0, n_chunks, BATCH):
        ci_b = order[:, base:base + BATCH]                 # (n_tiles, nb)
        box = packed.chunks[ci_b][:, None, :, :]           # (n_tiles,1,nb,6)
        tmin, tmax = _slab(box, o3, id3)                   # (n_tiles,T,nb)
        mask = alive[:, :, None] & (tmin <= tmax) & (tmax >= 0.0)
        cand = mask.any(dim=1)                             # (n_tiles, nb)
        for j in range(ci_b.shape[1]):
            if not bool(cand[:, j].any()):
                continue
            ci = ci_b[:, j]
            live = mask[:, :, j] & (tmin[:, :, j] < bt)
            tile_live = live.any(dim=1, keepdim=True)
            scan = tile_live & alive
            prev = bt
            shares = []          # lane g: triangles g, g + lanes, ...
            for g in range(lanes):
                bt_h, k_h = prev, torch.full_like(wch, chunk)
                for k in range(g, chunk, lanes):
                    r = rows[ci * chunk + k]               # (n_tiles, 20)
                    c = [r[:, m:m + 1] for m in range(13)]
                    a, e1, e2 = (c[0], c[1], c[2]), (c[3], c[4], c[5]), \
                        (c[6], c[7], c[8])
                    h = ttk.vm.cross3(d, e2)
                    det = ttk.vm.dot3(e1, h)
                    ok = scan & (torch.abs(det) >= ttk._EPS)
                    inv_det = 1.0 / det
                    s = (o[0] - a[0], o[1] - a[1], o[2] - a[2])
                    u = inv_det * ttk.vm.dot3(s, h)
                    ok &= (u >= 0.0) & (u <= 1.0)
                    q = ttk.vm.cross3(s, e1)
                    v = inv_det * ttk.vm.dot3(d, q)
                    ok &= (v >= 0.0) & (u + v <= 1.0)
                    t = inv_det * ttk.vm.dot3(e2, q)
                    ok &= (t >= ttk._EPS) & (t < bt_h)
                    bt_h = torch.where(ok, t, bt_h)
                    k_h = torch.where(ok, k, k_h)
                shares.append((bt_h, k_h))
            step = 1                       # the shuffles: least (t, index)
            while step < lanes:
                merged = []
                for g, (bt_g, k_g) in enumerate(shares):
                    bt_o, k_o = shares[g ^ step]
                    take = (bt_o < bt_g) | ((bt_o == bt_g) & (k_o < k_g))
                    merged.append((torch.where(take, bt_o, bt_g),
                                   torch.where(take, k_o, k_g)))
                shares, step = merged, 2 * step
            bt, kbest = shares[0]
            kbest = torch.clamp(kbest, max=chunk - 1)   # unused unless won
            won = bt < prev
            row = rows[ci[:, None] * chunk + kbest]        # (n_tiles, T, 20)
            bn = ttk.vm.where3(won, (row[..., 9], row[..., 10], row[..., 11]),
                               bn)
            bmid = torch.where(won, row[..., 12], bmid)
            if track_idx:
                btid = torch.where(won, (ci[:, None] * chunk + kbest)
                                   .to(btid.dtype), btid)
            wch = torch.where(won, ci[:, None].to(wch.dtype), wch)

    hit = alive & (bt != ttk._FLT_MAX)
    bal, bpar, bkind = (zero, zero, zero), zero, zero
    for j in range(packed.mats.shape[0]):
        match = bmid == float(j)
        m = packed.mats[j]
        bal = ttk.vm.where3(match, (m[0], m[1], m[2]), bal)
        bpar = torch.where(match, m[3], bpar)
        bkind = torch.where(match, m[4], bkind)
    point = ttk.vm.add3(o, ttk.vm.scale3(d, bt))
    front_face = ttk.vm.dot3(bn, d) > 0.0
    ns, nd = ttk.tc.scatter(state, d, point, bn, front_face, bal, bpar,
                            bkind.to(torch.int32),
                            normalize_reflect_in=flags.normalize_reflect_in,
                            has_metal=flags.has_metal,
                            has_dielectric=flags.has_dielectric)
    out = (torch.where(hit, ns, state), ttk.vm.where3(hit, point, o),
           ttk.vm.where3(hit, nd, d),
           ttk.vm.where3(hit, ttk.vm.scale3(ttk.vm.mul3(atten, bal), 0.7),
                         atten),
           hit.to(torch.int32), torch.where(hit, wch, torch.full_like(wch,
                                                                     -1)))
    if track_idx:
        out += (torch.where(hit, btid, torch.full_like(btid, -1)),)
    return out


def _equal(a, b):
    if a.dtype.is_floating_point:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


@pytest.fixture(scope="module")
def suzanne():
    return scenes.scene_suzanne(64, 32, device="cpu")


def _run(sd, monkeypatch, lanes: int = 0):
    """K2's and then K3's plain versions (2 fused bounces, with the index
    planes), through the plain loop or (lanes > 0) the batched model."""
    if lanes:
        monkeypatch.setattr(ttk, "trace_bounce", functools.partial(
            batched_trace_bounce, lanes=lanes))
    kw = dispatch.wave_params(sd.scene, sd.config)
    th, tw, flags = kw["th"], kw["tw"], kw["flags"]
    packed = dispatch.pack_scene(sd.scene)
    cam_row = dispatch.pack_camera(sd.camera)
    times = torch.tensor([1000], dtype=torch.int32)
    order = ttk.eye_chunk_order(packed, cam_row)
    size = dict(height=32, width=64, height_pad=32, width_pad=64, th=th,
                tw=tw, normalize_defocus_dir=kw["normalize_defocus_dir"])
    first = ttk.wave_first_plain(packed, order, cam_row, times, 0, flags,
                                 track_idx=True, **size)
    payf, state, active, wch, _ = first
    pay = payf[0:9].clone()
    tile_order = ttk.tile_chunk_order(packed, pay, th * tw)
    state, active = state.clone(), active.clone()
    planes = ttk.wave_bounce_plain(packed, tile_order, pay, state, active,
                                   flags, n_bounces=2, th=th, tw=tw,
                                   track_idx=True)
    monkeypatch.undo()
    return (*first, pay, state, active, *planes)


@pytest.fixture(scope="module")
def plain_run(suzanne):
    with pytest.MonkeyPatch.context() as mp:
        return _run(suzanne, mp)


@pytest.mark.parametrize("lanes", [1, 2])
def test_batched_visit_model_equals_the_plain_loop_bitwise(
        suzanne, plain_run, monkeypatch, lanes):
    assert dispatch.pack_scene(suzanne.scene).n_chunks == 35   # 32 + 3
    plain = plain_run
    batched = _run(suzanne, monkeypatch, lanes)
    assert len(plain) == len(batched) == 10
    for a, b in zip(plain, batched):
        assert _equal(a, b)
    wch = plain[3]
    assert int((wch >= 0).sum()) > 0 and int((plain[4] >= 0).sum()) > 0
