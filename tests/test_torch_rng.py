"""rt_torch shared math against the JAX package: the PCG stream, the
u32 -> f32 conversion, Schlick and the vector helpers.

Inputs come from NumPy with a fixed seed.  The JAX functions are called
eagerly (one rounded XLA op per jnp op), which is the arithmetic the port's
plain versions repeat.  Tolerance: none — every comparison is bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rt.core import rng as jrng
from rt.kernels import plane_math as pm
from rt_torch.core import rng, vecmath as vm
from _torch_threads import one_torch_thread  # noqa: F401

N = 10_000


def bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def t32(x):
    return torch.from_numpy(np.array(x, np.float32))


@pytest.mark.parametrize("seed", [0, 1, 12345, 0x7FFFFFFF, 0xFFFFFFFF,
                                  3639132858])
def test_pcg_stream_equals_reference_stream(seed):
    want = jrng.reference_stream(seed, 8)
    s = torch.tensor([seed], dtype=torch.int64)
    got = []
    for _ in range(8):
        s, f = rng.next_float(s)
        got.append(f.item())
    np.testing.assert_array_equal(bits(got), bits(want))


def test_pcg_step_and_float_equal_jax_on_random_states():
    s = np.random.default_rng(0).integers(0, 2**32, N, dtype=np.uint64)
    js, jf = pm.rng_float(jnp.asarray(s.astype(np.uint32)))
    ts, tf = rng.next_float(torch.from_numpy(s.astype(np.int64)))
    np.testing.assert_array_equal(np.asarray(js).astype(np.int64),
                                  ts.numpy())
    np.testing.assert_array_equal(bits(jf), bits(tf.numpy()))


def test_seed_wraps_like_uint32():
    g = np.random.default_rng(1)
    x = g.integers(0, 4096, N)
    y = g.integers(0, 4096, N)
    time = g.integers(0, 2**32, N, dtype=np.uint64)
    time[:4] = [0, 1, 0xFFFFFFFF, 0x80000000]
    want = jrng.seed(jnp.asarray(x, jnp.uint32), jnp.asarray(y, jnp.uint32),
                     512, jnp.asarray(time.astype(np.uint32)))
    got = rng.seed(torch.from_numpy(x), torch.from_numpy(y), 512,
                   torch.from_numpy(time.astype(np.int64)))
    np.testing.assert_array_equal(np.asarray(want).astype(np.int64),
                                  got.numpy())


def test_u32_to_f32_bitwise():
    s = np.random.default_rng(2).integers(0, 2**32, N, dtype=np.uint64)
    s[:3] = [0, 0xFFFFFFFF, 0xFFFFFF7F]
    want = pm.u32_to_f32(jnp.asarray(s.astype(np.uint32)))
    got = rng.u32_to_f32(torch.from_numpy(s.astype(np.int64)))
    np.testing.assert_array_equal(bits(want), bits(got.numpy()))


def test_state_i32_round_trip():
    s = np.random.default_rng(3).integers(0, 2**32, N, dtype=np.uint64)
    t = torch.from_numpy(s.astype(np.int64))
    i32 = rng.to_i32(t)
    assert i32.dtype == torch.int32
    np.testing.assert_array_equal(i32.numpy().view(np.uint32),
                                  s.astype(np.uint32))
    np.testing.assert_array_equal(rng.from_i32(i32).numpy(),
                                  s.astype(np.int64))


def test_schlick_bitwise():
    g = np.random.default_rng(4)
    cosine = g.uniform(-1.0, 1.0, N).astype(np.float32)
    ref_idx = g.uniform(0.05, 10.0, N).astype(np.float32)
    want = pm.schlick(jnp.asarray(cosine), jnp.asarray(ref_idx))
    got = vm.schlick(t32(cosine), t32(ref_idx))
    np.testing.assert_array_equal(bits(want), bits(got.numpy()))


def _vec3(g, scale=1.0):
    return tuple((g.normal(size=N) * scale).astype(np.float32)
                 for _ in range(3))


@pytest.mark.parametrize("op", ["normalize3", "reflect3", "refract3",
                                "cross3", "normalize4", "normalize2"])
def test_vector_ops_bitwise(op):
    g = np.random.default_rng(5)
    a, b = _vec3(g), _vec3(g)
    ir = g.uniform(0.05, 10.0, N).astype(np.float32)
    ja, jb = tuple(map(jnp.asarray, a)), tuple(map(jnp.asarray, b))
    ta, tb = tuple(map(t32, a)), tuple(map(t32, b))
    if op == "normalize3":
        want, got = pm.normalize3(ja), vm.normalize3(ta)
    elif op == "reflect3":
        want, got = pm.reflect3(ja, jb), vm.reflect3(ta, tb)
    elif op == "refract3":
        want = pm.refract3(ja, jb, jnp.asarray(ir))
        got = vm.refract3(ta, tb, t32(ir))
    elif op == "cross3":
        want, got = pm.cross3(ja, jb), vm.cross3(ta, tb)
    elif op == "normalize4":
        want = pm.normalize4(ja + (jb[0],))
        got = vm.normalize4(ta + (tb[0],))
    else:
        want, got = pm.normalize2(ja[:2]), vm.normalize2(ta[:2])
    for w, t in zip(want, got):
        np.testing.assert_array_equal(bits(w), bits(t.numpy()))


def test_sqrt_is_correctly_rounded():
    x = np.random.default_rng(6).random(N, dtype=np.float32) * 100
    want = np.sqrt(x.astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(bits(vm.sqrt(t32(x)).numpy()), bits(want))
    np.testing.assert_array_equal(bits(jnp.sqrt(jnp.asarray(x))), bits(want))
