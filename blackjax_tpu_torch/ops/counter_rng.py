"""Counter-based random numbers of the in-kernel NUTS machine, bit for bit.

Port of the threefry helpers the Pallas kernels share:
``blackjax_tpu/ops/fused_mclmc.py:50-69`` (``_rotl``, ``_threefry2x32``),
``blackjax_tpu/ops/fused_nuts.py:118-135`` (``_popcount8``,
``_counter_uniforms``), ``blackjax_tpu/ops/fused_nuts_dc.py:48-61``
(``_counter_uniforms2``), the Box-Muller momentum draw at
``fused_nuts_dc.py:412-425`` and the MCLMC kernel's refresh normals
``fused_mclmc.py:72-89`` (``_counter_normals``). The CUDA kernels
(``csrc/fused_nuts_dc.cu``, ``csrc/fused_mclmc.cu``) carry the same
functions as device code.

PyTorch on the CPU has no add or shift for ``uint32``, so every 32-bit word
here lives in an ``int64`` tensor holding a value in ``[0, 2**32)`` and is
masked with ``& 0xFFFFFFFF`` after each add or left shift. Any integer
tensor (or Python int) is accepted as input and reduced modulo ``2**32``,
which is what the reference's ``astype(jnp.uint32)`` does to an int32.
On the CPU, :func:`threefry2x32` runs its rounds on Python ints (a few
words, as a sampler's key derivation draws them) or in numpy's wrapping
``uint32`` arithmetic (larger batches) instead: the same words, for a
fraction of the int64 tensor ops' time.
"""
import numpy as np
import torch

__all__ = [
    "MASK32",
    "KEY1",
    "rotl",
    "threefry2x32",
    "popcount8",
    "counter_uniforms",
    "counter_uniforms2",
    "momentum_normals",
    "box_muller",
    "counter_normal_words",
    "counter_normals",
]

MASK32 = 0xFFFFFFFF
# second key word of every counter draw (the golden-ratio constant)
KEY1 = 0x9E3779B9
_TF_ROT = (13, 15, 26, 6, 17, 29, 16, 24)
_TF_PARITY = 0x1BD11BDA
_TWO_PI = 6.283185307179586
_U24 = 2.0**-24


def _u32(x, like=None) -> torch.Tensor:
    """A 32-bit word as int64 in [0, 2**32)."""
    if not torch.is_tensor(x):
        device = None if like is None else like.device
        return torch.tensor(int(x) & MASK32, dtype=torch.int64, device=device)
    return x.to(torch.int64) & MASK32


def rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    """32-bit rotate left of int64-held words."""
    return ((x << r) & MASK32) | (x >> (32 - r))


def _threefry_words(k0, k1, c0, c1):
    """:func:`threefry2x32` on lists of Python ints, one block per entry."""
    out0, out1 = [], []
    for a, b, x0, x1 in zip(k0, k1, c0, c1):
        a, b, x0, x1 = a & MASK32, b & MASK32, x0 & MASK32, x1 & MASK32
        keys = (b, a ^ b ^ _TF_PARITY, a, b, a ^ b ^ _TF_PARITY, a)
        x0, x1 = (x0 + a) & MASK32, (x1 + b) & MASK32
        for block in range(5):
            for r in _TF_ROT[(block % 2) * 4:(block % 2) * 4 + 4]:
                x0 = (x0 + x1) & MASK32
                x1 = x0 ^ (((x1 << r) & MASK32) | (x1 >> (32 - r)))
            x0 = (x0 + keys[block]) & MASK32
            x1 = (x1 + keys[block + 1] + block + 1) & MASK32
        out0.append(x0)
        out1.append(x1)
    return out0, out1


def _threefry_numpy(k0, k1, c0, c1):
    """:func:`threefry2x32` in numpy's wrapping ``uint32`` arithmetic."""
    k0, k1, c0, c1 = (v.astype(np.uint32) for v in (k0, k1, c0, c1))
    ks2 = k0 ^ k1 ^ np.uint32(_TF_PARITY)
    x0, x1 = c0 + k0, c1 + k1
    keys = (k1, ks2, k0, k1, ks2, k0)
    for block in range(5):
        for i in range(4):
            r = np.uint32(_TF_ROT[(block % 2) * 4 + i])
            x0 = x0 + x1
            x1 = x0 ^ ((x1 << r) | (x1 >> (np.uint32(32) - r)))
        x0 = x0 + keys[block]
        x1 = x1 + keys[block + 1] + np.uint32(block + 1)
    return x0.astype(np.int64), x1.astype(np.int64)


# The largest batch that runs on Python ints. numpy pays its ~120 ufunc
# calls a batch whatever the batch's size, Python ints pay per element; the
# two cross between 8 and 16 elements (:func:`time_cpu_paths` prints both
# times; PERF.md). A single chain's key derivation draws one to three words.
PYTHON_INT_MAX = 8


def _threefry_cpu(k0, k1, c0, c1):
    """:func:`threefry2x32` for CPU inputs: Python ints up to
    ``PYTHON_INT_MAX`` words, numpy ``uint32`` above; both far cheaper than
    int64 tensor ops on the CPU, and the words are the same."""
    words = torch.broadcast_tensors(*(torch.as_tensor(v) for v in (k0, k1, c0, c1)))
    shape = words[0].shape
    if words[0].numel() <= PYTHON_INT_MAX:
        x0, x1 = _threefry_words(*(w.reshape(-1).tolist() for w in words))
        return (torch.tensor(x0, dtype=torch.int64).reshape(shape),
                torch.tensor(x1, dtype=torch.int64).reshape(shape))
    # the cast to uint32 in _threefry_numpy reduces modulo 2**32
    x0, x1 = _threefry_numpy(*(np.atleast_1d(w.numpy()) for w in words))
    return torch.from_numpy(x0).reshape(shape), torch.from_numpy(x1).reshape(shape)


def threefry2x32(k0, k1, c0, c1):
    """20-round threefry2x32 of counter ``(c0, c1)`` under key ``(k0, k1)``.

    Returns the two output words as int64 tensors in ``[0, 2**32)``,
    broadcast over the inputs' shapes, on the inputs' device."""
    like = next((t for t in (c0, c1, k0, k1) if torch.is_tensor(t)), None)
    if like is None or like.device.type == "cpu":
        return _threefry_cpu(k0, k1, c0, c1)
    k0, k1, c0, c1 = (_u32(v, like) for v in (k0, k1, c0, c1))
    ks2 = k0 ^ k1 ^ _TF_PARITY
    x0 = (c0 + k0) & MASK32
    x1 = (c1 + k1) & MASK32
    keys = (k1, ks2, k0, k1, ks2, k0)
    for block in range(5):
        for i in range(4):
            x0 = (x0 + x1) & MASK32
            x1 = rotl(x1, _TF_ROT[(block % 2) * 4 + i])
            x1 = x0 ^ x1
        x0 = (x0 + keys[block]) & MASK32
        x1 = (x1 + keys[block + 1] + (block + 1)) & MASK32
    return x0, x1


def popcount8(x: torch.Tensor) -> torch.Tensor:
    """SWAR population count of small non-negative integers (< 2**30), the
    reference's ``_popcount8``; the CUDA kernel uses ``__popc``."""
    x = x.to(torch.int64)
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & MASK32) >> 24


def _to_unit(word: torch.Tensor, offset: float = 0.0) -> torch.Tensor:
    """The top 24 bits as an f32 in [0, 1) (or (0, 1] with offset 1)."""
    return ((word >> 8).to(torch.float32) + offset) * _U24


def _sub_word(tag: int, sub) -> torch.Tensor:
    """``(tag << 24) | sub``: the second counter word of a tagged draw."""
    if not torch.is_tensor(sub):
        return (tag << 24) | (int(sub) & MASK32)
    return (tag << 24) | _u32(sub)


def counter_uniforms(seed, c0, tag: int, sub) -> torch.Tensor:
    """One U[0,1) f32 per element, keyed by ``(seed, c0, tag|sub)``; the
    second threefry word is discarded (reference ``_counter_uniforms``)."""
    b1, _ = threefry2x32(seed, KEY1, c0, _sub_word(tag, sub))
    return _to_unit(b1)


def counter_uniforms2(seed, c0, tag: int, sub):
    """Two U[0,1) f32 per element from one threefry block (reference
    ``_counter_uniforms2``)."""
    b1, b2 = threefry2x32(seed, KEY1, c0, _sub_word(tag, sub))
    return _to_unit(b1), _to_unit(b2)


def momentum_normals(seed, base_row: torch.Tensor, dim: int) -> torch.Tensor:
    """The dc machine's standard-normal momentum draw, ``(C, dim)`` f32.

    Element ``(c, j)`` is keyed by ``c0 = j`` and ``c1 = (1 << 24) |
    base_row[c]`` with ``base_row = chain * num_steps + steps``; ``u1``
    carries the ``+1`` offset that keeps it off zero before the log.

    Reference fault kept for parity, as the JAX package is frozen this round
    (reference ``fused_nuts_dc.py:417``): the OR collides with the tag bit
    once ``base_row >= 2**24``, i.e. at ``chains * num_steps >= 2**24``, and
    chains ``2**24 / num_steps`` apart then draw the same momenta."""
    rows = torch.arange(dim, dtype=torch.int64, device=base_row.device)
    c1 = (1 << 24) | _u32(base_row)
    return box_muller(*threefry2x32(seed, KEY1, rows[None, :], c1[:, None]))


def box_muller(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """One f32 standard normal per threefry block; ``u1`` carries the ``+1``
    offset that keeps it off zero before the log."""
    u1 = _to_unit(b1, 1.0)
    u2 = _to_unit(b2)
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(_TWO_PI * u2)


def counter_normal_words(seed, chain_base, stream, shape, *, device=None):
    """The threefry words behind :func:`counter_normals`, two int64 tensors
    of ``shape`` in ``[0, 2**32)``.

    Element ``(row, lane)`` is keyed by ``c0 = (chain_base + row) *
    shape[1] + lane`` and ``c1 = stream`` under the key ``(seed,
    0x9E3779B9)``. The reference calls it on the lane-padded tile, so for
    a ``(C, d)`` block ``shape[1]`` is ``round_up(d, 128)`` and only the
    first ``d`` lanes are used."""
    rows = torch.arange(shape[0], dtype=torch.int64, device=device)[:, None]
    lanes = torch.arange(shape[1], dtype=torch.int64, device=device)[None, :]
    c0 = ((_u32(chain_base, rows) + rows) * shape[1] + lanes) & MASK32
    return threefry2x32(seed, KEY1, c0, _u32(stream, c0))


def counter_normals(seed, chain_base, stream, shape, *, device=None) -> torch.Tensor:
    """One f32 standard normal per element of ``shape`` by Box-Muller on a
    threefry block (reference ``fused_mclmc.py:_counter_normals``)."""
    return box_muller(*counter_normal_words(seed, chain_base, stream, shape, device=device))


def time_cpu_paths(sizes=(1, 2, 4, 8, 16, 32, 64, 1024)):
    """Print the microseconds a call of the two CPU paths takes against the
    batch size, the measurement behind ``PYTHON_INT_MAX``."""
    import time

    for size in sizes:
        words = np.random.default_rng(0).integers(0, 2**32, (4, size), dtype=np.uint64)
        words = words.astype(np.int64)
        times = {}
        for name, fn, args in (("python ints", _threefry_words, [w.tolist() for w in words]),
                               ("numpy", _threefry_numpy, list(words))):
            repeats = max(20, 20_000 // size)
            fn(*args)
            start = time.perf_counter()
            for _ in range(repeats):
                fn(*args)
            times[name] = (time.perf_counter() - start) / repeats * 1e6
        print(f"{size:5d} words: " + ", ".join(f"{k} {v:.1f} us" for k, v in times.items()))
