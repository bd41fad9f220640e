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
  ``[nextafter(-1, 0), 1)``, ``erfinv`` XLA's own (:func:`erf_inv`);
- ``exponential`` is ``-log1p(-u)`` of a uniform ``u``, ``log1p`` XLA's
  CPU one (:func:`xla_log1p`);
- ``permutation`` is JAX's sort-based shuffle: ``ceil(3 ln n / ln(2**32 -
  1))`` rounds, each splitting the key into ``(key, subkey)`` and stably
  sorting by the subkey's 32-bit bits;
- ``randint`` splits the key in two, draws ``nbits``-wide bits from each
  half and combines them modulo the span, ``(hi % span) * (2**nbits %
  span) + lo % span``, all modulo the span, plus ``minval``;
- ``choice`` with probabilities ``p`` searches the cumulative sum of ``p``
  (summed in XLA's order, :func:`xla_cumsum`) for ``total * (1 - u)``.

So the port draws the numbers the JAX package draws from the same keys, bit
for bit, but for float64 ``normal`` and ``exponential``, measured over 2**20
draws of one key against ``jax.random`` compiled at XLA's default level: on
the CPU float64 ``normal`` differs on 35 draws (by at most 3 ulps), all where
``log1p`` takes ``log(1 + x)``, whose float64 ``log`` XLA takes from the C
library and torch from its own vector code; on an NVIDIA H100, where
``log`` is CUDA's, on 60 (3 ulps). Float32 ``normal`` and ``exponential``
are XLA's bits on both (``torch.special.erfinv``, which ``normal`` took
before, differed on 59 % of float32 draws, by up to 91 ulps). On a CUDA
tensor each ``threefry2x32`` is one launch of the hand-written kernel of
``csrc/fused_nuts_dc.cu`` (a key per element); on a CPU tensor it is
:func:`blackjax_tpu_torch.ops.counter_rng.threefry2x32`, the plain version.
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
    "normal_from_words",
    "erf_inv",
    "xla_log1p",
    "exact_sqrt",
    "exponential",
    "permutation",
    "permutation_indices",
    "randint",
    "choice",
    "xla_cumsum",
    "default_int_dtype",
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
    # a number is filled on the device: no upload for the host to wait on
    lo, hi = (torch.as_tensor(v, dtype=dtype, device=keys.device) if torch.is_tensor(v)
              else torch.full((), v, dtype=dtype, device=keys.device) for v in (minval, maxval))
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


# XLA's erf_inv as its compiled HLO holds it (Giles' single-precision
# polynomials in w = -log1p(-x * x), split at w = 5; the double-precision ones
# split at 6.25 and 16), highest coefficient first
_ERF_INV_F32 = (
    (5.0, 2.5, (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)),
    (None, 3.0, (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                 0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)),
)
_ERF_INV_F64 = (
    (6.25, 3.125, (
        -3.64441206401782e-21, -1.6850591381820166e-19, 1.28584807152564e-18,
        1.1157877678025181e-17, -1.333171662854621e-16, 2.0972767875968562e-17,
        6.637638134358324e-15, -4.054566272975207e-14, -8.151934197605472e-14,
        2.6335093153082323e-12, -1.2975133253453532e-11, -5.415412054294628e-11,
        1.0512122733215323e-09, -4.112633980346984e-09, -2.9070369957882005e-08,
        4.2347877827932404e-07, -1.3654692000834679e-06, -1.3882523362786469e-05,
        0.00018673420803405714, -0.000740702534166267, -0.006033670871430149,
        0.24015818242558962, 1.6536545626831027)),
    (16.0, 3.25, (
        2.2137376921775787e-09, 9.075656193888539e-08, -2.7517406297064545e-07,
        1.8239629214389228e-08, 1.5027403968909828e-06, -4.013867526981546e-06,
        2.9234449089955446e-06, 1.2475304481671779e-05, -4.7318229009055734e-05,
        6.828485145957318e-05, 2.4031110387097894e-05, -0.0003550375203628475,
        0.0009532893797373805, -0.0016882755560235047, 0.002491442096107851,
        -0.003751208507569241, 0.005370914553590064, 1.0052589676941592,
        3.0838856104922208)),
    (None, 5.0, (
        -2.7109920616438573e-11, -2.555641816996525e-10, 1.5076572693500548e-09,
        -3.789465440126737e-09, 7.61570120807834e-09, -1.496002662714924e-08,
        2.914795345090108e-08, -6.771199775845234e-08, 2.2900482228026655e-07,
        -9.9298272942317e-07, 4.526062597223154e-06, -1.968177810553167e-05,
        7.599527703001776e-05, -0.00021503011930044477, -0.00013871931833623122,
        1.0103004648645344, 4.849906401408584)),
)
# XLA's CPU log1p: below |x| = sqrt(2) - 1 Cephes' rational approximation
# (numerator and denominator, highest coefficient first), else log(1 + x);
# in float32 the log is XLA's own polynomial (Cephes' logf)
_LOG1P_SMALL = 0.41421356237309504880
_LOG1P_NUM = (4.5270000862445199635e-5, 4.9854102823193375972e-1, 6.5787325942061044846e0,
              2.9911919328553073277e1, 6.0949667980987787057e1, 5.7112963590585538103e1,
              2.0039553499201281259e1)
_LOG1P_DEN = (1.0, 1.5062909083469192598e1, 8.3047565967967209469e1, 2.2176239823732856465e2,
              3.0909872225312059774e2, 2.1642788614495947685e2, 6.0118660497603843919e1)
_LOGF = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
         1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
         3.3333331174e-1)


_CONSTANTS = {}


def _const(value, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a 0-d tensor of ``like``'s dtype and device, made once."""
    key = (value, like.dtype, like.device)
    if key not in _CONSTANTS:
        _CONSTANTS[key] = torch.tensor(value, dtype=like.dtype, device=like.device)
    return _CONSTANTS[key]


def _fma(a, b, c):
    """``a * b + c`` rounded once, as XLA contracts a multiply feeding an add
    (``torch.addcmul`` is fused on the CPU and on the card); ``b`` and ``c``
    may be numbers."""
    b = b if torch.is_tensor(b) else _const(b, a)
    return torch.addcmul(c if torch.is_tensor(c) else _const(c, a), a, b)


def _horner(coefficients, t):
    p = _fma(t, coefficients[0], coefficients[1])
    for c in coefficients[2:]:
        p = _fma(p, t, c)
    return p


def _logf(y):
    """XLA's float32 ``log`` of positive ``y``: ``y = m 2**e`` with ``m`` in
    ``[sqrt(1/2), sqrt(2))``, a degree-9 polynomial in ``m - 1`` and ``e``
    split as ``0.693359375 - 2.12194440e-4``; 0 gives -inf, +inf itself."""
    bits = torch.clamp(y, min=2.0**-126).view(torch.int32)
    e = ((bits >> 23) - 127).to(y.dtype) + 1.0
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)  # in [0.5, 1)
    low = m < 0.707106769
    e = e - low.to(y.dtype)
    x = (m - 1.0) + torch.where(low, m, torch.zeros_like(m))
    z = x * x
    z3 = z * x
    a, b, c = (_fma(_fma(x, _LOGF[i], _LOGF[i + 1]), x, _LOGF[i + 2]) for i in (0, 3, 6))
    r = _fma(_fma(_fma(a, z3, b), z3, c), z3, e * -2.12194440e-4)
    out = _fma(e, 0.693359375, _fma(-z, 0.5, x) + r)
    out = torch.where(y <= 0, torch.full_like(y, math.nan), out)
    out = torch.where(y == 0, torch.full_like(y, -math.inf), out)
    return torch.where(y == math.inf, y, out)


def xla_log1p(x: torch.Tensor) -> torch.Tensor:
    """``log1p`` as XLA computes it on the CPU (float32 bit for bit; in
    float64 the ``log(1 + x)`` branch is torch's ``log``)."""
    x2 = x * x
    num = _horner(_LOG1P_NUM, x)
    den = _horner(_LOG1P_DEN, x)
    small = x + _fma(x2, -0.5, (x * x2) * (num / den))
    large = _logf(x + 1.0) if x.dtype == torch.float32 else torch.log(x + 1.0)
    return torch.where(x.abs() < _LOG1P_SMALL, small, large)


def exact_sqrt(w: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root (torch's vector ``sqrt`` on the CPU
    is not): float32 through float64, float64 corrected to the neighbour
    whose square is nearest ``w``."""
    if w.dtype == torch.float32:
        return torch.sqrt(w.double()).float()
    s = torch.sqrt(w)
    best, gap = s, _fma(-s, s, w).abs()
    for t in (torch.nextafter(s, torch.zeros_like(s)), torch.nextafter(s, w + 1.0)):
        g = _fma(-t, t, w).abs()
        best, gap = torch.where(g < gap, t, best), torch.minimum(g, gap)
    return best


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """``jax.lax.erf_inv`` of float32 or float64 ``x`` in ``[-1, 1]``, in the
    order XLA's compiled kernel evaluates it: ``w = -log1p(-x * x)``, a
    polynomial in ``w - 2.5`` (``w - 3.125``) or ``sqrt(w) - 3`` (``- 3.25``,
    ``- 5``) chosen by ``w``, by fused multiply-adds; ``x * inf`` at ``|x| =
    1``."""
    branches = {torch.float32: _ERF_INV_F32, torch.float64: _ERF_INV_F64}.get(x.dtype)
    if branches is None:
        raise NotImplementedError(f"erf_inv in {x.dtype} is not ported")
    w = -xla_log1p(-x * x)
    root = exact_sqrt(w)
    p = None
    for i, (below, shift, coefficients) in reversed(list(enumerate(branches))):
        value = _horner(coefficients, (w if i == 0 else root) - shift)
        p = value if p is None else torch.where(w < below, value, p)
    return torch.where(x.abs() == 1, x * math.inf, p * x)


def normal(keys: torch.Tensor, shape=(), dtype=torch.float32) -> torch.Tensor:
    """``jax.random.normal``: ``sqrt(2) erf_inv(u)``, ``u`` uniform on
    ``[nextafter(-1, 0), 1)``; ``keys.shape[:-1] + shape``. On CUDA tensors
    the transform of the threefry words is one launch of the hand-written
    kernel of ``csrc/fused_nuts_dc.cu``; :func:`normal_from_words` is its
    plain version."""
    words = _words(keys, shape)
    if keys.device.type == "cuda":
        from blackjax_tpu_torch.ops.fused_nuts_dc import normal_device

        return normal_device(*words, dtype)
    return normal_from_words(*words, dtype)


def normal_from_words(t0: torch.Tensor, t1: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """``jax.random.normal`` of the threefry words ``(t0, t1)`` of its
    elements (:func:`_words`): the uniform on ``[nextafter(-1, 0), 1)`` from
    the words, then ``sqrt(2) erf_inv(u)``."""
    lo = torch.nextafter(torch.tensor(-1.0, dtype=dtype), torch.tensor(0.0, dtype=dtype))
    floats = _unit(t0, t1, dtype)
    lo, hi = (torch.tensor(v, dtype=dtype, device=floats.device) for v in (float(lo), 1.0))
    # XLA contracts floats * (hi - lo) + lo into one fused multiply-add
    u = torch.maximum(lo, torch.addcmul(lo, floats, hi - lo))
    return torch.tensor(math.sqrt(2), dtype=dtype, device=u.device) * erf_inv(u)


def exponential(keys: torch.Tensor, shape=(), dtype=torch.float32) -> torch.Tensor:
    """``jax.random.exponential``: ``-log1p(-u)``, ``u`` uniform on ``[0, 1)``;
    ``keys.shape[:-1] + shape``."""
    return -xla_log1p(-uniform(keys, shape, dtype))


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


def default_int_dtype(float_dtype: torch.dtype) -> torch.dtype:
    """JAX's default integer beside floats of ``float_dtype``: int64 under
    x64 (float64 data), int32 without. ``randint`` draws other numbers from
    the same keys in each, so a run draws its integers in this dtype."""
    return torch.int64 if float_dtype == torch.float64 else torch.int32


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
