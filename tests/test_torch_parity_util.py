"""Helpers for the tests that hold ``rt_torch`` against ``rt``: the JAX wave
kernels launched on their own in interpret mode (with the specs
``render_color_tris_wave`` gives them), the JAX kernel bodies run eagerly on
stand-in refs, and NumPy bridges between the two packages' scene
containers."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental import pallas as pl

from rt.kernels import sphere_kernel as jsk
from rt.kernels import tris_kernel as jtk
from rt_torch import convert


class JaxRefs:
    """Outputs of JAX functions that a test file holds the port against,
    kept bit for bit in an ``.npz`` beside the tests (``tests/jax_refs/``).

    ``refs(key, compute)`` gives the output stored under ``key``;
    ``compute`` makes it with the JAX package from the same seeded inputs
    the test gives the port, and runs only as ``RT_TORCH_JAX_REFS`` says:

    * unset (the suite): the stored output; eager JAX compiles every
      primitive on its first call, seconds a surrogate, more than the CPU
      suite can spend on them;
    * ``check``: runs ``compute`` and requires the stored output to be
      bit-equal to it, then goes on with it;
    * ``write``: runs ``compute`` and stores its output.

    ``compute`` returns an array or a flat dict of arrays (JAX or NumPy;
    entries that are None are left out).
    """

    def __init__(self, test_file):
        name = os.path.splitext(os.path.basename(test_file))[0]
        self.path = os.path.join(os.path.dirname(os.path.abspath(test_file)),
                                 "jax_refs", name + ".npz")
        self.mode = os.environ.get("RT_TORCH_JAX_REFS", "")
        assert self.mode in ("", "check", "write"), self.mode
        self.stored = None
        self.written = set()

    def __call__(self, key, compute):
        if self.stored is None:
            self.stored = {}
            if os.path.exists(self.path):
                with np.load(self.path) as f:
                    self.stored = dict(f)
        if not self.mode:
            if key in self.stored:
                return self.stored[key]
            out = {k[len(key) + 1:]: v for k, v in self.stored.items()
                   if k.startswith(key + "/")}
            assert out, (f"{key} is not in {self.path}: make it with "
                         "RT_TORCH_JAX_REFS=write")
            return out
        value = compute()
        if isinstance(value, dict):
            value = {k: v for k, v in value.items() if v is not None}
        flat = ({f"{key}/{k}": np.asarray(v) for k, v in value.items()}
                if isinstance(value, dict) else {key: np.asarray(value)})
        if self.mode == "check":
            for k, v in flat.items():
                old = self.stored.get(k)
                assert old is not None and old.dtype == v.dtype \
                    and old.shape == v.shape \
                    and old.tobytes() == v.tobytes(), k
        else:                 # no call's keys clash with another's
            assert not flat.keys() & self.written, flat.keys() & self.written
            self.written |= flat.keys()
            self.stored.update(flat)
            os.makedirs(os.path.dirname(self.path), exist_ok=True)
            np.savez_compressed(self.path, **self.stored)
        return ({k: flat[f"{key}/{k}"] for k in value}
                if isinstance(value, dict) else flat[key])


def scene_fields(jscene) -> dict:
    return {k: np.asarray(getattr(jscene, k)) for k in jscene._fields}


def port_scene(jscene):
    """The JAX scene's arrays as an rt_torch TriangleScene on the CPU."""
    return convert.scene_from_numpy(scene_fields(jscene), device="cpu")


def port_spheres(jscene):
    """The JAX SphereArray's arrays as an rt_torch SphereArray on the CPU."""
    return convert.spheres_from_numpy(scene_fields(jscene), device="cpu")


def port_camera(jcamera):
    return convert.camera_from_numpy(
        {k: np.asarray(getattr(jcamera, k)) for k in jcamera._fields})


def jax_tables(jscene):
    tab, mats, chunks, subs, m_pad, n_chunks = jtk.pack_tri_table(jscene)
    return tab, mats, chunks, subs, n_chunks


def _common(mats, n_chunks, flags, track_idx=False, track_chunk=True):
    return dict(n_chunks=n_chunks, chunk=32, n_mats=mats.shape[0],
                normalize_reflect_in=flags["normalize_reflect_in"],
                has_metal=flags["has_metal"],
                has_dielectric=flags["has_dielectric"], unroll=1,
                track_idx=track_idx, track_chunk=track_chunk, sub=0)


def jax_wave_first(jscene, cam_row, order, time, *, height, width, hp, wp,
                   th, tw, flags, normalize_defocus_dir=True):
    """_wave_first_kernel in interpret mode, one frame.  Returns NumPy
    (payf (10, n), state u32 (n,), active (n,), wch (n,))."""
    tab, mats, chunks, subs, n_chunks = jax_tables(jscene)
    kernel = functools.partial(
        jtk._wave_first_kernel, height=height, width=width, th=th, tw=tw,
        normalize_defocus_dir=normalize_defocus_dir,
        **_common(mats, n_chunks, flags))
    nh = hp // th
    plane = lambda dt: jax.ShapeDtypeStruct((hp, wp), dt)
    pspec = pl.BlockSpec((th, tw), lambda f, i, j: (f * nh + i, j))
    outs = pl.pallas_call(
        kernel,
        out_shape=(jax.ShapeDtypeStruct((10, hp, wp), jnp.float32),
                   plane(jnp.uint32), plane(jnp.int32), plane(jnp.int32)),
        grid=(1, nh, wp // tw),
        in_specs=[_whole(x) for x in (tab, mats, chunks, subs, order,
                                      cam_row, time, jnp.zeros((1, 1),
                                                               jnp.int32))],
        out_specs=(pl.BlockSpec((10, th, tw), lambda f, i, j: (0, f * nh + i,
                                                              j)),
                   pspec, pspec, pspec),
        interpret=True,
    )(tab, mats, chunks, subs, order, cam_row, time,
      jnp.zeros((1, 1), jnp.int32))
    n = hp * wp
    return (np.asarray(outs[0]).reshape(10, n),
            np.asarray(outs[1]).reshape(n), np.asarray(outs[2]).reshape(n),
            np.asarray(outs[3]).reshape(n))


def _whole(x):
    """BlockSpec handing a kernel the whole array at every grid step."""
    nd = x.ndim
    return pl.BlockSpec(x.shape, lambda *_: (0,) * nd)


def jax_wave_bounce(jscene, tile_order, pay, state, active, *, n_bounces,
                    th, tw, flags):
    """_wave_bounce_kernel in interpret mode over a (9, n) stream.  Returns
    NumPy (pay, state u32, active, wch)."""
    tab, mats, chunks, subs, n_chunks = jax_tables(jscene)
    n = pay.shape[1]
    rows = n // tw
    kernel = functools.partial(jtk._wave_bounce_kernel, th=th, tw=tw,
                               n_bounces=n_bounces,
                               **_common(mats, n_chunks, flags))
    ray_specs = (pl.BlockSpec((9, th, tw), lambda i: (0, i, 0)),
                 pl.BlockSpec((th, tw), lambda i: (i, 0)),
                 pl.BlockSpec((th, tw), lambda i: (i, 0)))
    tile_order = jnp.asarray(tile_order, jnp.int32).reshape(-1, 1)
    outs = pl.pallas_call(
        kernel,
        out_shape=(jax.ShapeDtypeStruct((9, rows, tw), jnp.float32),
                   jax.ShapeDtypeStruct((rows, tw), jnp.uint32),
                   jax.ShapeDtypeStruct((rows, tw), jnp.int32),
                   jax.ShapeDtypeStruct((rows, tw), jnp.int32)),
        grid=(rows // th,),
        in_specs=[_whole(x) for x in (tab, mats, chunks, subs, tile_order)]
        + list(ray_specs),
        out_specs=ray_specs + (ray_specs[2],),
        interpret=True,
    )(tab, mats, chunks, subs, tile_order,
      jnp.asarray(pay).reshape(9, rows, tw),
      jnp.asarray(state, jnp.uint32).reshape(rows, tw),
      jnp.asarray(active, jnp.int32).reshape(rows, tw))
    return (np.asarray(outs[0]).reshape(9, n), np.asarray(outs[1]).reshape(n),
            np.asarray(outs[2]).reshape(n), np.asarray(outs[3]).reshape(n))


# ---------------------------------------------------------------------------
# The same two kernel functions run EAGERLY, op by op, on stand-in refs.
#
# XLA's CPU compiler fuses a jitted kernel body and contracts multiply-adds,
# so the interpret-mode launches above agree with arithmetic that rounds
# every operation only to a few ULP.  Run eagerly (jax.disable_jit), each
# jnp op is its own rounded XLA op — the arithmetic the TPU kernel and the
# port's plain version define — and the comparison can be bitwise.
# ---------------------------------------------------------------------------

class FakeRef:
    """Stand-in for a Pallas ref over a NumPy array: scalar and plane reads,
    plane writes."""

    def __init__(self, array):
        self.a = np.array(array)

    def __getitem__(self, idx):
        if idx is Ellipsis:
            return jnp.asarray(self.a)
        if isinstance(idx, tuple):
            return self.a[tuple(int(i) for i in idx)]      # NumPy scalar
        return jnp.asarray(self.a[int(idx)])

    def __setitem__(self, idx, value):
        self.a[idx] = np.asarray(value)


def _tables_refs(jscene, order):
    tab, mats, chunks, subs, n_chunks = jax_tables(jscene)
    refs = [FakeRef(x) for x in (tab, mats, chunks, subs)]
    refs.append(FakeRef(np.asarray(order, np.int32).reshape(-1, 1)))
    return refs, mats, n_chunks


def eager_wave_first(jscene, cam_row, order, time, *, height,
                     width, hp, wp, th, tw, flags,
                     normalize_defocus_dir=True, track_idx=False):
    """_wave_first_kernel, tile by tile, eagerly.  Same returns as
    jax_wave_first; with track_idx (the recorder's K10a) one more, the
    index plane (n,)."""
    refs, mats, n_chunks = _tables_refs(jscene, order)
    payf = np.zeros((10, hp, wp), np.float32)
    state = np.zeros((hp, wp), np.uint32)
    active = np.zeros((hp, wp), np.int32)
    wch = np.zeros((hp, wp), np.int32)
    idx = np.zeros((hp, wp), np.int32)
    ids = [0, 0, 0]
    with pytest.MonkeyPatch.context() as mp, jax.disable_jit():
        mp.setattr(jtk.pl, "program_id", lambda axis: ids[axis])
        for i in range(hp // th):
            for j in range(wp // tw):
                ids[1], ids[2] = i, j
                plane = lambda: FakeRef(np.zeros((th, tw), np.int32))
                outs = (FakeRef(np.zeros((10, th, tw), np.float32)),
                        FakeRef(np.zeros((th, tw), np.uint32)), plane())
                # the extra planes: the index (track_idx), the chunk
                rest = (plane(), plane()) if track_idx else (plane(),)
                jtk._wave_first_kernel(
                    *refs, FakeRef(cam_row),
                    FakeRef(np.asarray(time, np.uint32).reshape(1, 1)),
                    FakeRef(np.zeros((1, 1), np.int32)), *outs, *rest,
                    height=height, width=width, th=th, tw=tw,
                    normalize_defocus_dir=normalize_defocus_dir,
                    **_common(mats, n_chunks, flags, track_idx=track_idx))
                sl = (slice(i * th, (i + 1) * th), slice(j * tw, (j + 1) * tw))
                payf[(slice(None),) + sl] = outs[0].a
                state[sl], active[sl] = outs[1].a, outs[2].a
                wch[sl] = rest[-1].a
                idx[sl] = rest[0].a
    n = hp * wp
    out = (payf.reshape(10, n), state.reshape(n), active.reshape(n),
           wch.reshape(n))
    return out + (idx.reshape(n),) if track_idx else out


def eager_wave_bounce(jscene, tile_order, pay, state, active, *,
                      n_bounces, th, tw, flags, track_idx=False):
    """_wave_bounce_kernel, tile by tile, eagerly.  Same returns as
    jax_wave_bounce; with track_idx (the recorder's K10b) the last is the
    index planes (n_bounces, n) instead of the chunk plane."""
    refs, mats, n_chunks = _tables_refs(jscene, tile_order)
    n = pay.shape[1]
    rows = n // tw
    pay = np.asarray(pay, np.float32).reshape(9, rows, tw)
    state = np.asarray(state).astype(np.uint32).reshape(rows, tw)
    active = np.asarray(active, np.int32).reshape(rows, tw)
    last = (np.zeros((n_bounces, rows, tw), np.int32) if track_idx
            else np.zeros_like(active))
    out = (np.zeros_like(pay), np.zeros_like(state), np.zeros_like(active),
           last)
    ids = [0]
    with pytest.MonkeyPatch.context() as mp, jax.disable_jit():
        mp.setattr(jtk.pl, "program_id", lambda axis: ids[axis])
        for i in range(rows // th):
            ids[0] = i
            sl = slice(i * th, (i + 1) * th)
            outs = tuple(FakeRef(np.zeros_like(o[..., sl, :])) for o in out)
            jtk._wave_bounce_kernel(
                *refs, FakeRef(pay[:, sl]), FakeRef(state[sl]),
                FakeRef(active[sl]), *outs, th=th, tw=tw,
                n_bounces=n_bounces,
                **_common(mats, n_chunks, flags, track_idx=track_idx,
                          track_chunk=not track_idx))
            for o, r in zip(out, outs):
                o[..., sl, :] = r.a
    return (out[0].reshape(9, n), out[1].reshape(n), out[2].reshape(n),
            out[3].reshape(n_bounces, n) if track_idx else out[3].reshape(n))


def eager_wave_raygen(cam_row, time, *, height, width, hp, wp, th, tw,
                      normalize_defocus_dir=True):
    """_wave_raygen_kernel, tile by tile, eagerly, one frame.  Returns NumPy
    (od (6, n), primary dy (n,), state u32 (n,))."""
    od = np.zeros((6, hp, wp), np.float32)
    pdy = np.zeros((hp, wp), np.float32)
    state = np.zeros((hp, wp), np.uint32)
    ids = [0, 0, 0]
    with pytest.MonkeyPatch.context() as mp, jax.disable_jit():
        mp.setattr(jtk.pl, "program_id", lambda axis: ids[axis])
        for i in range(hp // th):
            for j in range(wp // tw):
                ids[1], ids[2] = i, j
                outs = (FakeRef(np.zeros((6, th, tw), np.float32)),
                        FakeRef(np.zeros((th, tw), np.float32)),
                        FakeRef(np.zeros((th, tw), np.uint32)))
                jtk._wave_raygen_kernel(
                    FakeRef(cam_row),
                    FakeRef(np.asarray(time, np.uint32).reshape(1, 1)),
                    FakeRef(np.zeros((1, 1), np.int32)), *outs,
                    height=height, width=width, th=th, tw=tw,
                    normalize_defocus_dir=normalize_defocus_dir)
                sl = (slice(i * th, (i + 1) * th), slice(j * tw, (j + 1) * tw))
                od[(slice(None),) + sl] = outs[0].a
                pdy[sl], state[sl] = outs[1].a, outs[2].a
    n = hp * wp
    return od.reshape(6, n), pdy.reshape(n), state.reshape(n)


def _jax_carry(carry):
    """A port carry (state int64, o3, d3, atten3, active) of (th, tw) NumPy
    planes as the JAX kernels' carry."""
    state, o, d, atten, active = carry
    f = lambda v: tuple(jnp.asarray(c, jnp.float32) for c in v)
    return (jnp.asarray(np.asarray(state).astype(np.uint32)), f(o), f(d),
            f(atten), jnp.asarray(active, jnp.int32))


def _numpy_carry(out):
    state, o, d, atten, active = out
    f = lambda v: tuple(np.asarray(c) for c in v)
    return (np.asarray(state).astype(np.int64), f(o), f(d), f(atten),
            np.asarray(active))


def eager_sphere_bounce(tab, kinds, carry, *, n_spheres, flags, chunked=None):
    """``_sphere_bounce`` (or, with chunked=(aabbs, order), the chunked
    bounce) run eagerly on ONE tile.  tab (N, 8), kinds (N,), carry of
    (th, tw) NumPy planes.  Returns the new carry as NumPy."""
    th, tw = np.asarray(carry[0]).shape
    zero = jnp.zeros((th, tw), jnp.float32)
    refs = (FakeRef(np.asarray(tab, np.float32)),
            FakeRef(np.asarray(kinds, np.int32).reshape(-1, 1)))
    with jax.disable_jit():
        if chunked is None:
            out = jsk._sphere_bounce(*refs, zero, zero + 1.0,
                                     _jax_carry(carry), n_spheres=n_spheres,
                                     th=th, tw=tw, **flags)
        else:
            aabbs, order = chunked
            out = jsk._sphere_bounce_chunked(
                *refs, FakeRef(np.asarray(aabbs, np.float32)),
                FakeRef(np.asarray(order, np.int32).reshape(-1, 1)), zero,
                zero + 1.0, _jax_carry(carry), chunk=32,
                n_chunks=np.asarray(aabbs).shape[0], th=th, tw=tw, **flags)
        return _numpy_carry(out)


def eager_sphere_kernel(tab, kinds, cam_row, time, *, n_spheres, height,
                        width, hp, wp, th, tw, bounces, flags,
                        normalize_defocus_dir=False, spp=1,
                        sky_from_final_dir=False):
    """The flat sphere ``_kernel`` (whole frame), tile by tile, eagerly.
    Returns the (3, hp, wp) NumPy image."""
    out = np.zeros((3, hp, wp), np.float32)
    ids = [0, 0]
    refs = (FakeRef(np.asarray(tab, np.float32)),
            FakeRef(np.asarray(kinds, np.int32).reshape(-1, 1)),
            FakeRef(cam_row),
            FakeRef(np.asarray(time, np.uint32).reshape(1, 1)))
    with pytest.MonkeyPatch.context() as mp, jax.disable_jit():
        mp.setattr(jsk.pl, "program_id", lambda axis: ids[axis])
        for i in range(hp // th):
            for j in range(wp // tw):
                ids[0], ids[1] = i, j
                tile = FakeRef(np.zeros((3, th, tw), np.float32))
                jsk._kernel(*refs, tile, n_spheres=n_spheres, height=height,
                            width=width, th=th, tw=tw, bounces=bounces,
                            normalize_defocus_dir=normalize_defocus_dir,
                            sky_from_final_dir=sky_from_final_dir, spp=spp,
                            **flags)
                out[:, i * th:(i + 1) * th, j * tw:(j + 1) * tw] = tile.a
    return out


def _eager_frame(kernel, refs, outs_of, module, *, hp, wp, th, tw, **kw):
    """A whole-frame kernel body (grid (rows, cols) of (th, tw) tiles) run
    eagerly tile by tile.  outs_of(): fresh (leading, th, tw) output arrays
    of one tile.  Returns the outputs as (leading, hp, wp) NumPy arrays."""
    full = [np.zeros(o.shape[:1] + (hp, wp), o.dtype) for o in outs_of()]
    ids = [0, 0]
    with pytest.MonkeyPatch.context() as mp, jax.disable_jit():
        mp.setattr(module.pl, "program_id", lambda axis: ids[axis])
        for i in range(hp // th):
            for j in range(wp // tw):
                ids[0], ids[1] = i, j
                tiles = [FakeRef(o) for o in outs_of()]
                kernel(*refs, *tiles, th=th, tw=tw, **kw)
                for f, t in zip(full, tiles):
                    f[:, i * th:(i + 1) * th, j * tw:(j + 1) * tw] = t.a
    return full


def eager_tris_kernel(jscene, cam_row, order, time, *, record, height, width,
                      hp, wp, th, tw, bounces, flags,
                      normalize_defocus_dir=True, spp=1,
                      sky_from_final_dir=False):
    """The monolithic triangle ``_kernel`` (record=False: returns the
    (3, hp, wp) image) or ``_kernel_record`` (record=True: returns (image,
    (bounces, hp, wp) table-order index planes)), eagerly."""
    refs, mats, n_chunks = _tables_refs(jscene, order)
    refs += [FakeRef(cam_row),
             FakeRef(np.asarray(time, np.uint32).reshape(1, 1))]
    kw = dict(m=refs[0].a.shape[0], n_chunks=n_chunks, chunk=32,
              n_mats=mats.shape[0], height=height, width=width,
              bounces=bounces, normalize_defocus_dir=normalize_defocus_dir,
              sky_from_final_dir=sky_from_final_dir, **flags)
    color = lambda: np.zeros((3, th, tw), np.float32)
    if record:
        outs = lambda: [color(), np.zeros((bounces, th, tw), np.int32)]
        return _eager_frame(jtk._kernel_record, refs, outs, jtk, hp=hp,
                            wp=wp, th=th, tw=tw, **kw)
    refs.append(FakeRef(np.zeros((1, 1), np.int32)))          # row0
    return _eager_frame(jtk._kernel, refs, lambda: [color()], jtk, hp=hp,
                        wp=wp, th=th, tw=tw, spp=spp, **kw)[0]


def eager_sphere_record(tab, kinds, cam_row, time, *, n_spheres, height,
                        width, hp, wp, th, tw, bounces, flags,
                        sky_from_final_dir=False):
    """The sphere ``_kernel_record``, eagerly: (image (3, hp, wp), index
    planes (bounces, hp, wp))."""
    refs = (FakeRef(np.asarray(tab, np.float32)),
            FakeRef(np.asarray(kinds, np.int32).reshape(-1, 1)),
            FakeRef(cam_row),
            FakeRef(np.asarray(time, np.uint32).reshape(1, 1)))
    outs = lambda: [np.zeros((3, th, tw), np.float32),
                    np.zeros((bounces, th, tw), np.int32)]
    return _eager_frame(jsk._kernel_record, refs, outs, jsk, hp=hp, wp=wp,
                        th=th, tw=tw, n_spheres=n_spheres, height=height,
                        width=width, bounces=bounces,
                        normalize_defocus_dir=False,
                        sky_from_final_dir=sky_from_final_dir, **flags)
