"""The port's ``jax.random`` (``blackjax_tpu_torch.prng``) against
``jax.random`` itself, on 1,000 random keys and data words.

``key``, ``fold_in``, ``split``, ``bits`` (32 and 64), ``uniform`` (f32 and
f64), ``bernoulli`` and ``permutation`` agree bit for bit; ``normal`` and
``exponential`` bit for bit in f32 against XLA's default compile, and in
f64 ``normal`` to 1e-12 relative (35 of 2**20 draws differ, by at most 3
ulps, through ``log``) and ``exponential`` to 1e-13. The
constructions hold under ``jax_threefry_partitionable``, JAX's default,
which the test asserts.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from blackjax_tpu_torch import interop, prng  # noqa: E402
from blackjax_tpu_torch.ops import counter_rng  # noqa: E402

N = 1000
# the reference's vmapped draws, compiled once each at XLA's optimization
# level 0 (eagerly, each primitive compiles apart, at the default level); the
# draws with bounds keep the default level, whose fused multiply-add the
# port reproduces
OPT0 = {"xla_backend_optimization_level": 0}


def _vmap(fn, *args, **kwargs):
    return jax.jit(jax.vmap(fn, *args, **kwargs), compiler_options=OPT0)


DTYPES = {"f32": (jnp.float32, torch.float32), "f64": (jnp.float64, torch.float64)}


@pytest.fixture(scope="module")
def keys():
    assert jax.config.jax_threefry_partitionable
    words = np.random.default_rng(0).integers(0, 2**32, (N, 2), dtype=np.uint64)
    words = words.astype(np.uint32)
    return jax.random.wrap_key_data(jnp.asarray(words)), interop.prng_key(words)


def test_key_words_of_a_seed():
    for seed in [0, 1, 42, 2**31 - 1, 2**32 + 5, 123456789012]:
        expected = np.asarray(jax.random.key_data(jax.random.key(seed)))
        np.testing.assert_array_equal(prng.key(seed).numpy(), expected)


def test_fold_in_bit_for_bit(keys):
    jk, tk = keys
    data = np.random.default_rng(1).integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)
    expected = jax.random.key_data(_vmap(jax.random.fold_in)(jk, jnp.asarray(data)))
    got = prng.fold_in(tk, torch.from_numpy(data.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(expected))


@pytest.mark.parametrize("num", [2, 3, 5])
def test_split_bit_for_bit(keys, num):
    jk, tk = keys
    expected = jax.random.key_data(_vmap(lambda k: jax.random.split(k, num))(jk))
    np.testing.assert_array_equal(prng.split(tk, num).numpy(), np.asarray(expected))


@pytest.mark.parametrize("width, shape", [(32, ()), (32, (7,)), (64, ()), (64, (3, 2))])
def test_bits_bit_for_bit(keys, width, shape):
    jk, tk = keys
    dtype = jnp.uint32 if width == 32 else jnp.uint64
    expected = np.asarray(_vmap(lambda k: jax.random.bits(k, shape, dtype))(jk))
    got = prng.bits(tk, shape, width).numpy()
    if width == 64:
        got = got.view(np.uint64)
    np.testing.assert_array_equal(got, expected)


@pytest.mark.parametrize("shape", [(), (9,)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_uniform_bit_for_bit(keys, dtype, shape):
    jk, tk = keys
    jdt, tdt = DTYPES[dtype]
    expected = np.asarray(_vmap(lambda k: jax.random.uniform(k, shape, jdt))(jk))
    got = prng.uniform(tk, shape, tdt)
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.numpy(), expected)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_bernoulli_bit_for_bit(keys, dtype):
    jk, tk = keys
    jdt, tdt = DTYPES[dtype]
    p = np.random.default_rng(2).random(N).astype(np.dtype(jdt))
    expected = np.asarray(_vmap(jax.random.bernoulli)(jk, jnp.asarray(p)))
    np.testing.assert_array_equal(prng.bernoulli(tk, torch.from_numpy(p)).numpy(), expected)
    # a Python float in the default float dtype (f64 under the tests' x64)
    expected_half = np.asarray(_vmap(jax.random.bernoulli)(jk))
    np.testing.assert_array_equal(prng.bernoulli(tk, dtype=torch.float64).numpy(), expected_half)


def test_normal_f64_to_1e12(keys):
    jk, tk = keys
    expected = np.asarray(_vmap(lambda k: jax.random.normal(k, (5,), jnp.float64))(jk))
    got = prng.normal(tk, (5,), torch.float64).numpy()
    np.testing.assert_allclose(got, expected, rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("size", [1, counter_rng.PYTHON_INT_MAX, counter_rng.PYTHON_INT_MAX + 1])
def test_threefry_cpu_paths_agree(size):
    """The Python-int and numpy threefry give the same words on either side
    of the size switch, inputs reduced modulo 2**32 (negative or wide)."""
    words = np.random.default_rng(size).integers(-2**40, 2**40, (4, size))
    py = counter_rng._threefry_words(*(w.tolist() for w in words))
    npy = counter_rng._threefry_numpy(*words)
    np.testing.assert_array_equal(np.asarray(py), np.stack(npy))
    got = counter_rng.threefry2x32(*(torch.from_numpy(w) for w in words))
    np.testing.assert_array_equal(np.stack([g.numpy() for g in got]), np.stack(npy))


def test_draws_from_a_generator_are_key_words():
    words = prng.from_generator(torch.Generator().manual_seed(0), (4, 3))
    assert words.shape == (4, 3, 2) and words.dtype == torch.int64
    assert bool(((words >= 0) & (words < 2**32)).all())
    with pytest.raises(ValueError, match="uint32 key words"):
        interop.prng_key(np.zeros((3,), np.int32))


@pytest.mark.parametrize("shape", [(), (9,)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_exponential_is_log1p_of_the_same_uniforms(keys, dtype, shape):
    """``-log1p(-u)`` of the bit-for-bit uniforms: torch's ``log1p`` and
    XLA's differ in the last bits (XLA's CPU ``log1p`` is a rational
    approximation below sqrt(2) - 1), so the draws agree to 1e-13 in f64
    and to four ulps in f32, as ``normal`` does through ``erfinv``."""
    jk, tk = keys
    jdt, tdt = DTYPES[dtype]
    expected = np.asarray(_vmap(lambda k: jax.random.exponential(k, shape, jdt))(jk))
    got = prng.exponential(tk, shape, tdt)
    assert got.dtype == tdt
    tol = 1e-13 if dtype == "f64" else 4 * float(torch.finfo(tdt).eps)
    np.testing.assert_allclose(got.numpy(), expected, rtol=tol, atol=tol)


@pytest.mark.parametrize("n", [1, 2, 100, 16384, 70000])
def test_permutation_bit_for_bit(keys, n):
    """JAX's sort-based shuffle: one round below n = 1,626, two above (and
    three from n = 2**21.3); an int draws a permutation of ``arange(n)``, a
    tensor is shuffled along its first axis."""
    jk, tk = keys
    for i in range(3):
        expected = np.asarray(jax.random.permutation(jk[i], n))
        np.testing.assert_array_equal(prng.permutation(tk[i], n).numpy(), expected)
    x = np.random.default_rng(n).standard_normal((n, 2))
    expected = np.asarray(jax.random.permutation(jk[0], jnp.asarray(x)))
    np.testing.assert_array_equal(prng.permutation(tk[0], torch.from_numpy(x)).numpy(), expected)
    with pytest.raises(ValueError, match="one key"):
        prng.permutation(tk[:2], n)


@pytest.mark.parametrize("dtype", ["int64", "int32"])
@pytest.mark.parametrize("bounds, shape", [((1, 10), ()), ((0, 7), (5,)), ((-3, 100003), ()),
                                           ((0, 2**31), (2,)), ((5, 5), ())])
def test_randint_bit_for_bit(keys, dtype, bounds, shape):
    """JAX's own algorithm: two bit streams from ``split(key)``, combined
    modulo the span with its multiplier, in 64-bit words (x64's default
    integer) and in 32-bit ones."""
    jk, tk = keys
    lo, hi = bounds
    expected = np.asarray(_vmap(lambda k: jax.random.randint(
        k, shape, lo, hi, dtype=getattr(jnp, dtype)))(jk))
    got = prng.randint(tk, shape, lo, hi, dtype=getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.numpy(), expected)


@pytest.mark.parametrize("n, shape", [(3, ()), (6, ()), (16, ()), (17, ()), (40, (3,))])
def test_choice_with_p_bit_for_bit(keys, n, shape):
    """``choice(key, n, shape, p=p)``: the cumulative sum (in XLA's order,
    blocks of 16 beyond 16 entries) searched for ``total (1 - u)``, with a
    row of ``p`` a key, as under ``vmap``; and without ``p``, ``randint``."""
    jk, tk = keys
    p = np.random.default_rng(n).uniform(0.0, 1.0, (N, n)) ** 3
    expected = np.asarray(_vmap(lambda k, w: jax.random.choice(k, n, shape, p=w))(
        jk, jnp.asarray(p)))
    got = prng.choice(tk, n, shape, p=torch.from_numpy(p))
    np.testing.assert_array_equal(got.numpy(), expected)
    expected = np.asarray(_vmap(lambda k: jax.random.choice(k, n, shape))(jk))
    np.testing.assert_array_equal(prng.choice(tk, n, shape).numpy(), expected)


@pytest.mark.parametrize("n", [1, 5, 16, 17, 40, 300])
def test_xla_cumsum_bit_for_bit(n):
    x = np.random.default_rng(n).standard_normal((50, n)) * 10.0 ** np.random.default_rng(
        n + 1).uniform(-6, 6, (50, n))
    expected = np.asarray(jnp.cumsum(jnp.asarray(x), axis=-1))
    np.testing.assert_array_equal(prng.xla_cumsum(torch.from_numpy(x)).numpy(), expected)


def test_permutation_indices_per_key(keys):
    jk, tk = keys
    expected = np.asarray(_vmap(lambda k: jax.random.permutation(k, 9))(jk[:50]))
    np.testing.assert_array_equal(prng.permutation_indices(tk[:50], 9).numpy(), expected)


def test_uniform_with_bounds_per_key(keys):
    jk, tk = keys
    lo = np.random.default_rng(2).uniform(-7.0, 0.0, N)
    hi = lo + np.random.default_rng(3).uniform(0.0, 7.0, N)
    # at the default level, where XLA contracts u * (b - a) + a into an FMA
    expected = np.asarray(jax.vmap(lambda k, a, b: jax.random.uniform(
        k, (), jnp.float64, a, b))(jk, jnp.asarray(lo), jnp.asarray(hi)))
    got = prng.uniform(tk, (), torch.float64, torch.from_numpy(lo), torch.from_numpy(hi))
    np.testing.assert_array_equal(got.numpy(), expected)


# jax.random.normal as a user compiles it (XLA's default level, which
# contracts erf_inv's multiply-adds), on 2**20 draws of one key
NORMAL_DRAWS = 1 << 20
# float64: the draws where log1p takes log(1 + x), whose float64 log XLA
# takes from the C library and torch from its own vector code (PERF.md)
NORMAL_F64_DIFFER, NORMAL_F64_ULPS = 35, 3


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_normal_is_xla_bit_for_bit_on_a_million_draws(dtype):
    jdt, tdt = DTYPES[dtype]
    expected = np.asarray(jax.jit(lambda k: jax.random.normal(k, (NORMAL_DRAWS,), jdt))(
        jax.random.key(7)))
    got = prng.normal(prng.key(7), (NORMAL_DRAWS,), tdt).numpy()
    if dtype == "f32":
        np.testing.assert_array_equal(got, expected)
        exp_expected = np.asarray(jax.jit(lambda k: jax.random.exponential(k, (4096,), jdt))(
            jax.random.key(7)))
        np.testing.assert_array_equal(prng.exponential(prng.key(7), (4096,), tdt).numpy(),
                                      exp_expected)
        return
    ulps = np.abs(got.view(np.int64) - expected.view(np.int64))
    assert int((ulps > 0).sum()) <= NORMAL_F64_DIFFER and int(ulps.max()) <= NORMAL_F64_ULPS


def test_the_normal_kernel_takes_cuda_tensors_only():
    """On the CPU ``prng.normal`` runs the plain version and launches
    nothing; the kernel's wrapper refuses CPU tensors."""
    from blackjax_tpu_torch.ops import fused_nuts_dc as dc

    before = dict(dc.LAUNCHES)
    words = prng._words(prng.key(3), (5,))
    np.testing.assert_array_equal(prng.normal(prng.key(3), (5,)).numpy(),
                                  prng.normal_from_words(*words).numpy())
    assert dc.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        dc.normal_device(*words, torch.float32)
