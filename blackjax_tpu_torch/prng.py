"""The ``jax.random`` functions of the NUTS path, on JAX's own key words.

A key is an int64 tensor ``(..., 2)`` holding the two threefry2x32 key words
of ``jax.random.key_data`` (each in ``[0, 2**32)``); a batch of keys has
leading axes, one key per chain. The constructions are those of
``jax.random`` under ``jax_threefry_partitionable`` (the default), where
``t = threefry2x32(key, (0, i))`` is the block of counter ``i``:

- ``key(seed)`` is ``(seed >> 32, seed & 0xFFFFFFFF)``;
- ``fold_in(key, data)`` is ``t`` at ``i = data``;
- ``split(key, n)[i]`` is ``t`` at ``i``;
- 32-bit ``bits`` are ``t0 ^ t1``, 64-bit bits ``(t0 << 32) | t1``, with
  ``i`` the flat index into the per-key shape;
- ``uniform`` sets the top mantissa bits of 1.0 from the bits (64-bit words
  for f64, 32-bit for f32) and subtracts 1, then scales to ``[minval,
  maxval)`` by one fused multiply-add, as XLA contracts it;
- ``bernoulli(key, p)`` is ``uniform(key) < p`` in ``p``'s dtype (JAX takes
  a Python float in its default float dtype: f64 under x64, else f32);
- ``normal`` is ``sqrt(2) erfinv(u)`` with ``u`` uniform on
  ``[nextafter(-1, 0), 1)``;
- ``exponential`` is ``-log1p(-u)`` of a uniform ``u``;
- ``permutation`` is JAX's sort-based shuffle: ``ceil(3 ln n / ln(2**32 -
  1))`` rounds, each splitting the key into ``(key, subkey)`` and stably
  sorting by the subkey's 32-bit bits;
- ``randint`` splits the key in two, draws ``nbits``-wide bits from each
  half and combines them modulo the span, ``(hi % span) * (2**nbits %
  span) + lo % span``, all modulo the span, plus ``minval``;
- ``choice`` with probabilities ``p`` searches the cumulative sum of ``p``
  (summed in XLA's order, :func:`xla_cumsum`) for ``total * (1 - u)``.

So the port draws the numbers the JAX package draws from the same keys, bit
for bit, except ``normal``, whose ``erfinv`` differs from XLA's in the last
bits (and ``exponential``, whose ``log1p`` may). On a CUDA tensor each ``threefry2x32`` is one launch of the
hand-written kernel of ``csrc/fused_nuts_dc.cu`` (a key per element); on a
CPU tensor it is :func:`blackjax_tpu_torch.ops.counter_rng.threefry2x32`,
the plain version.
"""
import math

import torch

__all__ = [
    "key",
    "from_generator",
    "threefry2x32",
    "fold_in",
    "split",
    "bits",
    "uniform",
    "bernoulli",
    "normal",
    "exponential",
    "permutation",
    "permutation_indices",
    "randint",
    "choice",
    "xla_cumsum",
]

MASK32 = 0xFFFFFFFF
_MANT_ONE_F64 = 0x3FF0000000000000
_MANT_ONE_F32 = 0x3F800000


def key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.key(seed)``'s words: ``(seed >> 32, seed & 0xFFFFFFFF)``."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & MASK32, seed & MASK32], dtype=torch.int64, device=device)


def from_generator(generator: torch.Generator, batch_shape=(), device=None) -> torch.Tensor:
    """Fresh key words ``batch_shape + (2,)`` drawn from a generator, on
    ``device`` (the generator's own by default)."""
    words = torch.randint(
        0, 2**32, tuple(batch_shape) + (2,), generator=generator, dtype=torch.int64,
        device=generator.device,
    )
    return words if device is None else words.to(device)


def threefry2x32(k0, k1, c0, c1):
    """threefry2x32 of counter ``(c0, c1)`` under key ``(k0, k1)``, all four
    broadcast (a key per element). int64 words in ``[0, 2**32)``; returns
    the two output words the same way. A CUDA tensor launches the kernel.
    (The ops package is imported here, not at the top: it imports the
    samplers, which import this module.)"""
    from blackjax_tpu_torch.ops.fused_nuts_dc import threefry2x32_device

    return threefry2x32_device(k0, k1, c0, c1)


def _blocks(keys: torch.Tensor, counters: torch.Tensor):
    """The blocks of counters ``(0, counters)`` under ``keys (..., 2)``;
    ``counters`` broadcasts against the keys' batch shape (trailing axes
    appended to it)."""
    extra = counters.dim()
    k0 = keys[..., 0].reshape(keys.shape[:-1] + (1,) * extra)
    k1 = keys[..., 1].reshape(keys.shape[:-1] + (1,) * extra)
    return threefry2x32(k0, k1, torch.zeros_like(counters), counters)


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` of each key with ``data`` (an int, or an
    integer tensor broadcasting against the keys' batch shape)."""
    data = torch.as_tensor(data, dtype=torch.int64, device=keys.device)
    k0, k1 = keys[..., 0], keys[..., 1]
    t0, t1 = threefry2x32(k0, k1, torch.zeros_like(data), data)
    return torch.stack(torch.broadcast_tensors(t0, t1), dim=-1)


def split(keys: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` of each key: ``keys.shape[:-1] + (num, 2)``."""
    counters = torch.arange(num, dtype=torch.int64, device=keys.device)
    t0, t1 = _blocks(keys, counters)
    return torch.stack((t0, t1), dim=-1)


def _shape(shape) -> tuple:
    return (int(shape),) if isinstance(shape, int) else tuple(int(s) for s in shape)


def _words(keys: torch.Tensor, shape):
    """The two threefry words of every element of the per-key ``shape``:
    counter ``(0, flat index)``, as the partitionable ``random_bits``."""
    shape = _shape(shape)
    counters = torch.arange(math.prod(shape), dtype=torch.int64, device=keys.device)
    return _blocks(keys, counters.reshape(shape))


def bits(keys: torch.Tensor, shape=(), width: int = 32) -> torch.Tensor:
    """``jax.random.bits``: 32-bit words ``t0 ^ t1`` or 64-bit words
    ``(t0 << 32) | t1`` (as int64, two's complement), ``keys.shape[:-1] +
    shape``."""
    t0, t1 = _words(keys, shape)
    if width == 32:
        return t0 ^ t1
    if width == 64:
        return (t0 << 32) | t1  # wraps into int64 like a bitcast of the uint64
    raise ValueError(f"width must be 32 or 64, got {width}")


def _unit(t0: torch.Tensor, t1: torch.Tensor, dtype) -> torch.Tensor:
    """Floats in ``[0, 1)`` from threefry words, as ``jax.random.uniform``
    builds them: the top ``nmant`` bits of the 64-bit (f64) or 32-bit (f32)
    word as the mantissa of a number in ``[1, 2)``, minus 1."""
    if dtype == torch.float64:
        mant = (t0 << 20) | (t1 >> 12)  # (bits64 >> 12), 52 bits
        return (mant | _MANT_ONE_F64).view(torch.float64) - 1.0
    if dtype == torch.float32:
        mant = (t0 ^ t1) >> 9  # 23 bits
        return (mant | _MANT_ONE_F32).to(torch.int32).view(torch.float32) - 1.0
    raise NotImplementedError(f"uniform draws in {dtype} are not ported")


def uniform(keys: torch.Tensor, shape=(), dtype=torch.float32, minval=0.0, maxval=1.0):
    """``jax.random.uniform`` on ``[minval, maxval)``: ``keys.shape[:-1] +
    shape`` in ``dtype``. The bounds are numbers or tensors broadcasting
    against that shape (one interval per chain, as under ``vmap``)."""
    floats = _unit(*_words(keys, shape), dtype)
    bounded = torch.is_tensor(minval) or torch.is_tensor(maxval)
    if not bounded and minval == 0.0 and maxval == 1.0:
        return floats  # floats * 1 + 0, at least 0: the same bits
    lo = torch.as_tensor(minval, dtype=dtype, device=keys.device)
    hi = torch.as_tensor(maxval, dtype=dtype, device=keys.device)
    # XLA contracts floats * (hi - lo) + lo into one fused multiply-add
    return torch.maximum(lo, torch.addcmul(lo, floats, hi - lo))


def bernoulli(keys: torch.Tensor, p=0.5, dtype=torch.float32, shape=()) -> torch.Tensor:
    """``jax.random.bernoulli``: ``uniform(key, shape) < p`` in ``p``'s
    dtype, ``keys.shape[:-1] + shape`` draws; ``p`` broadcasts against them
    (one draw per key by default; ``shape=p.shape`` with one key is the
    reference's default). A Python float ``p`` is taken in ``dtype``, the
    counterpart of JAX's default float dtype."""
    if not torch.is_tensor(p):
        p = torch.tensor(p, dtype=dtype, device=keys.device)
    return uniform(keys, shape, p.dtype) < p


def normal(keys: torch.Tensor, shape=(), dtype=torch.float32) -> torch.Tensor:
    """``jax.random.normal``: ``sqrt(2) erfinv(u)``, ``u`` uniform on
    ``[nextafter(-1, 0), 1)``; ``keys.shape[:-1] + shape``."""
    lo = torch.nextafter(torch.tensor(-1.0, dtype=dtype), torch.tensor(0.0, dtype=dtype))
    u = uniform(keys, shape, dtype, float(lo), 1.0)
    return torch.tensor(math.sqrt(2), dtype=dtype, device=keys.device) * torch.special.erfinv(u)


def exponential(keys: torch.Tensor, shape=(), dtype=torch.float32) -> torch.Tensor:
    """``jax.random.exponential``: ``-log1p(-u)``, ``u`` uniform on ``[0, 1)``;
    ``keys.shape[:-1] + shape``."""
    return -torch.log1p(-uniform(keys, shape, dtype))


def permutation(key: torch.Tensor, x) -> torch.Tensor:
    """``jax.random.permutation`` of one key ``(2,)``: ``x`` an int (a
    permutation of ``arange(x)``) or a tensor shuffled along its first
    axis."""
    if key.shape != (2,):
        raise ValueError(f"permutation takes one key (2,), got {tuple(key.shape)}")
    if not torch.is_tensor(x):
        return permutation_indices(key, int(x))
    return x[permutation_indices(key, x.shape[0])]


def permutation_indices(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)`` for each key of a batch ``(...,
    2)``: ``(..., n)``, as the reference draws it under ``vmap``."""
    x = torch.arange(n, device=keys.device).expand(keys.shape[:-1] + (n,))
    rounds = math.ceil(3 * math.log(max(1, n)) / math.log(MASK32))
    for _ in range(rounds):
        keys, subkeys = split(keys).unbind(-2)
        order = torch.sort(bits(subkeys, (n,)), stable=True, dim=-1).indices
        x = torch.gather(x, -1, order)
    return x


def randint(keys: torch.Tensor, shape=(), minval=0, maxval=1, dtype=torch.int64) -> torch.Tensor:
    """``jax.random.randint`` on ``[minval, maxval)``: ``keys.shape[:-1] +
    shape`` in ``dtype`` (``torch.int64``: JAX's default integer under x64;
    ``torch.int32`` its 32-bit default). JAX's own algorithm, bit for bit:
    ``k1, k2 = split(key)``, ``nbits``-wide bits ``hi`` from ``k1`` and ``lo``
    from ``k2``, and ``minval + ((hi % span) * m + lo % span) % span`` with
    ``m = (2**(nbits / 2) % span)**2 % span``, in unsigned ``nbits``-bit
    arithmetic. The bounds are ints or integer tensors broadcasting against
    the output; a span of at most 2**31 is supported (64-bit words are
    reduced through their 32-bit halves)."""
    nbits = {torch.int64: 64, torch.int32: 32}.get(dtype)
    if nbits is None:
        raise NotImplementedError(f"randint in {dtype} is not ported")
    minval = torch.as_tensor(minval, dtype=torch.int64, device=keys.device)
    maxval = torch.as_tensor(maxval, dtype=torch.int64, device=keys.device)
    span = torch.where(maxval <= minval, torch.ones_like(maxval), maxval - minval)
    if bool((span > 2**31).any()):
        raise NotImplementedError("randint spans above 2**31 are not ported")
    k1, k2 = split(keys).unbind(-2)
    if nbits == 32:
        def mod_span(words):  # 32-bit words, below 2**32: int64 holds them
            return (words & MASK32) % span

        hi, lo = mod_span(bits(k1, shape, 32)), mod_span(bits(k2, shape, 32))
        multiplier = (2**16 % span) * (2**16 % span) & MASK32
        offset = ((hi * (multiplier % span)) & MASK32) + lo & MASK32
    else:
        def mod_span(words):  # the unsigned 64-bit word through its halves
            high, low = (words >> 32) & MASK32, words & MASK32
            return ((high % span) * (2**32 % span) + low % span) % span

        hi, lo = mod_span(bits(k1, shape, 64)), mod_span(bits(k2, shape, 64))
        multiplier = (2**32 % span) * (2**32 % span)
        offset = hi * (multiplier % span) + lo
    return (minval + offset % span).to(dtype)


def xla_cumsum(x: torch.Tensor, base: int = 16) -> torch.Tensor:
    """``jnp.cumsum`` over the last axis in the order XLA's CPU backend sums
    it, so that the same inputs give the same bits: sequential up to
    ``base`` elements; longer, sequential within blocks of ``base`` (zero
    padded) with the blocks' exclusive prefix, itself summed so, added to
    each block."""
    n = x.shape[-1]
    if n <= base:
        out = x.clone()
        for k in range(1, n):
            out[..., k] = out[..., k - 1] + x[..., k]
        return out
    padded = torch.nn.functional.pad(x, (0, -n % base))
    blocks = xla_cumsum(padded.reshape(x.shape[:-1] + (-1, base)), base)
    prefix = xla_cumsum(blocks[..., -1], base)
    exclusive = torch.cat((torch.zeros_like(prefix[..., :1]), prefix[..., :-1]), -1)
    return (blocks + exclusive[..., None]).reshape(padded.shape)[..., :n]


def choice(keys: torch.Tensor, a: int, shape=(), p=None) -> torch.Tensor:
    """``jax.random.choice(key, a, shape, replace=True, p=p)`` of an int
    ``a``: indices ``keys.shape[:-1] + shape``. With ``p`` (``(..., a)``,
    one row a key), ``searchsorted(cumsum(p), cumsum(p)[-1] * (1 - u))``
    with ``u`` uniform in ``p``'s dtype, as JAX draws it; without,
    ``randint(key, shape, 0, a)``."""
    if p is None:
        return randint(keys, shape, 0, int(a))
    if p.shape[-1] != int(a):
        raise ValueError(f"p must have {a} entries in its last axis, got {tuple(p.shape)}")
    cumulative = xla_cumsum(p)
    u = uniform(keys, shape, p.dtype)
    extra = len(_shape(shape))
    total = cumulative[..., -1].reshape(cumulative.shape[:-1] + (1,) * extra)
    r = total * (1 - u)
    flat_r = r.reshape(r.shape[: r.dim() - extra] + (-1,))
    index = torch.searchsorted(cumulative.contiguous(), flat_r.contiguous())
    return index.reshape(r.shape)
