"""Particle resampling schemes, each a cumulative sum and a
``searchsorted`` (reference ``blackjax_tpu/smc/resampling.py``).

Each takes one key ``(2,)`` (:mod:`blackjax_tpu_torch.prng`) and draws what
the reference draws from it. The reference draws its uniforms and
exponentials in JAX's default float dtype, not the weights'; the port draws
them in the weights' dtype promoted with torch's default dtype, which is
the same dtype wherever the weights are in JAX's default (float64 under
x64, float32 without) and torch's default dtype stands for JAX's.
"""
import torch

from blackjax_tpu_torch import prng
from blackjax_tpu_torch.types import Array, PRNGKey

__all__ = ["systematic", "stratified", "multinomial", "residual"]


def _draw_dtype(weights: Array) -> torch.dtype:
    return torch.promote_types(weights.dtype, torch.get_default_dtype())


def _quantile_lookup(weights: Array, positions: Array) -> Array:
    """Map points in [0, 1) through the inverse empirical CDF of the weights
    (``searchsorted`` on the left side, clipped to the last particle)."""
    n = weights.shape[0]
    dtype = torch.promote_types(weights.dtype, positions.dtype)
    cdf = torch.cumsum(weights.to(dtype), 0)
    return torch.searchsorted(cdf, positions.to(dtype)).clamp(0, n - 1)


def _grid_positions(rng_key, num_samples, weights, common_offset: bool):
    offset_shape = () if common_offset else (num_samples,)
    u = prng.uniform(rng_key.to(weights.device), offset_shape, _draw_dtype(weights))
    grid = torch.arange(num_samples, dtype=weights.dtype, device=weights.device)
    return (grid + u) / num_samples


def systematic(rng_key: PRNGKey, weights: Array, num_samples: int) -> Array:
    """One shared uniform offset on a regular grid — the lowest-variance
    O(N) scheme and the default for large ensembles."""
    return _quantile_lookup(weights, _grid_positions(rng_key, num_samples, weights, True))


def stratified(rng_key: PRNGKey, weights: Array, num_samples: int) -> Array:
    """Independent uniform offset per grid cell."""
    return _quantile_lookup(weights, _grid_positions(rng_key, num_samples, weights, False))


def _sorted_uniforms(rng_key: PRNGKey, n: int, dtype, device) -> Array:
    """n sorted U(0,1) variates via normalized exponential spacings (O(n),
    no sort)."""
    spacings = prng.exponential(rng_key.to(device), (n + 1,), dtype)
    total = torch.cumsum(spacings, 0)
    return total[:-1] / total[-1]


def multinomial(rng_key: PRNGKey, weights: Array, num_samples: int) -> Array:
    """I.i.d. categorical draws (highest variance; use only when independent
    ancestry is required). Sorted uniforms keep the searchsorted fast."""
    uniforms = _sorted_uniforms(rng_key, num_samples, _draw_dtype(weights), weights.device)
    return _quantile_lookup(weights, uniforms)


def residual(rng_key: PRNGKey, weights: Array, num_samples: int) -> Array:
    """Deterministically copy ``floor(N w_i)`` of each particle, fill the
    remainder multinomially from the residual weights. Static-shape variant:
    the deterministic copies are laid out with a fixed-length
    ``repeat_interleave`` into an index array with an ``N``-th sink slot for
    the unused tail, and positions past the deterministic count take the
    multinomial draw."""
    key_residual, key_perm = prng.split(rng_key.to(weights.device))
    n = weights.shape[0]
    scaled = num_samples * weights
    copies = torch.floor(scaled).to(torch.int32)
    num_copies = copies.sum()

    residual_weights = (scaled - copies) / (num_samples - num_copies)
    residual_idx = multinomial(key_residual, residual_weights, num_samples)
    # multinomial outputs are sorted by construction; shuffle to restore
    # exchangeability before slotting into the tail
    residual_idx = prng.permutation(key_perm, residual_idx)

    repeats = torch.cat([copies, (num_samples - num_copies).reshape(1).to(torch.int32)])
    deterministic_idx = torch.repeat_interleave(
        torch.arange(n + 1, device=weights.device), repeats, output_size=num_samples
    )

    slots = torch.arange(num_samples, device=weights.device)
    return torch.where(slots >= num_copies, residual_idx, deterministic_idx)
