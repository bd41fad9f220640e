"""The port's counter RNG against the Pallas kernels' JAX helpers.

threefry2x32, the uniform constructions and the popcount are integer
arithmetic, so they must agree bit for bit. The Box-Muller normal also runs
log, sqrt and cos in f32, whose last ulp differs between XLA's CPU
functions and PyTorch's, so it is held to a few f32 ulps.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from blackjax_tpu.ops.fused_mclmc import _threefry2x32  # noqa: E402
from blackjax_tpu.ops.fused_nuts import _counter_uniforms, _popcount8  # noqa: E402
from blackjax_tpu.ops.fused_nuts_dc import _counter_uniforms2  # noqa: E402
from blackjax_tpu_torch.ops import counter_rng  # noqa: E402
from blackjax_tpu_torch.ops.fused_nuts_dc import LAUNCHES, threefry2x32_device  # noqa: E402

N = 100_000


def _words(rng, n):
    w = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    w[:16] = np.uint32(2**32 - 1) - np.arange(16, dtype=np.uint32)  # near 2^32
    w[16:24] = np.arange(8, dtype=np.uint32)
    return w


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


@pytest.mark.parametrize("key", [(0, 0x9E3779B9), (7, 0x9E3779B9), (2**32 - 1, 12345)])
def test_threefry2x32_bit_for_bit(key):
    rng = np.random.default_rng(key[0] % 1000)
    c0, c1 = _words(rng, N), _words(rng, N)[::-1].copy()
    r0, r1 = _threefry2x32(
        jnp.uint32(key[0]), jnp.uint32(key[1]), jnp.asarray(c0), jnp.asarray(c1)
    )
    p0, p1 = counter_rng.threefry2x32(key[0], key[1], _t(c0), _t(c1))
    np.testing.assert_array_equal(p0.numpy(), np.asarray(r0).astype(np.int64))
    np.testing.assert_array_equal(p1.numpy(), np.asarray(r1).astype(np.int64))


def test_threefry_device_wrapper_on_cpu_is_the_plain_version():
    rng = np.random.default_rng(1)
    c0, c1 = _t(_words(rng, 1000)), _t(_words(rng, 1000))
    before = dict(LAUNCHES)
    a = threefry2x32_device(3, counter_rng.KEY1, c0, c1)
    b = counter_rng.threefry2x32(3, counter_rng.KEY1, c0, c1)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert LAUNCHES == before


def test_popcount8_bit_for_bit():
    x = np.random.default_rng(2).integers(0, 2**30, N).astype(np.int32)
    x[:1024] = np.arange(1024)
    np.testing.assert_array_equal(
        counter_rng.popcount8(torch.from_numpy(x)).numpy(), np.asarray(_popcount8(jnp.asarray(x)))
    )


@pytest.mark.parametrize("seed", [7, -5, 2**31 - 1])
def test_counter_uniforms_bit_for_bit(seed):
    rng = np.random.default_rng(3)
    base = rng.integers(0, 2**31 - 1, N).astype(np.int32)
    sub = rng.integers(0, 1024, N).astype(np.int32)
    u = _counter_uniforms(jnp.int32(seed), jnp.asarray(base), 3, jnp.asarray(sub))
    v = counter_rng.counter_uniforms(seed, torch.from_numpy(base), 3, torch.from_numpy(sub))
    np.testing.assert_array_equal(v.numpy(), np.asarray(u))
    u1, u2 = _counter_uniforms2(jnp.int32(seed), jnp.asarray(base), 2, jnp.asarray(sub))
    v1, v2 = counter_rng.counter_uniforms2(
        seed, torch.from_numpy(base), 2, torch.from_numpy(sub)
    )
    np.testing.assert_array_equal(v1.numpy(), np.asarray(u1))
    np.testing.assert_array_equal(v2.numpy(), np.asarray(u2))


def test_momentum_normals_match_the_kernels_box_muller():
    """The draw of ``fused_nuts_dc.py:412-425`` for chains x dims."""
    C, d, S, seed = 512, 100, 256, 7
    steps = np.random.default_rng(4).integers(0, S, C).astype(np.int32)
    base_row = np.arange(C, dtype=np.int32) * S + steps
    rows = jnp.arange(d, dtype=jnp.uint32)[None, :]
    b1, b2 = _threefry2x32(
        jnp.uint32(seed),
        jnp.uint32(0x9E3779B9),
        jnp.broadcast_to(rows, (C, d)),
        (jnp.uint32(1) << jnp.uint32(24)) | jnp.asarray(base_row).astype(jnp.uint32)[:, None],
    )
    u1 = ((b1 >> jnp.uint32(8)).astype(jnp.int32).astype(jnp.float32) + 1.0) * (2.0**-24)
    u2 = (b2 >> jnp.uint32(8)).astype(jnp.int32).astype(jnp.float32) * (2.0**-24)
    z_ref = np.asarray(jnp.sqrt(-2.0 * jnp.log(u1)) * jnp.cos(6.283185307179586 * u2))
    z = counter_rng.momentum_normals(seed, torch.from_numpy(base_row), d).numpy()
    assert z.dtype == np.float32
    # the uniforms are bit-identical; log, sqrt and cos may each round to
    # the other neighbour, so the bound is a few f32 ulps at the normal's
    # scale. Measured: 11% of the draws differ, by at most 4.8e-7 (one ulp
    # for |z| in [4, 8)).
    np.testing.assert_allclose(z, z_ref, rtol=4 * 2.0**-23, atol=4 * 2.0**-23)
