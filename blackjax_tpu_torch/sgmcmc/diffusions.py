"""Euler solvers for the stochastic-gradient diffusion families (reference
``blackjax_tpu/sgmcmc/diffusions.py``).

Positions are ``(C, d)`` blocks of chains or one ``(d,)`` position; the
noise comes from :func:`blackjax_tpu_torch.util.generate_gaussian_noise`
(key words, one key a chain, or a generator). The noise scale is a square
root taken in the position's dtype, as the reference takes it in its
default float dtype.
"""
from typing import Callable

import torch

from blackjax_tpu_torch.util import generate_gaussian_noise, tree_map

__all__ = ["overdamped_langevin", "sghmc", "sgnht"]


def _sqrt(value, like: torch.Tensor):
    """``jnp.sqrt`` of a number (or a tensor) in ``like``'s dtype."""
    return torch.sqrt(torch.as_tensor(value, dtype=like.dtype, device=like.device))


def overdamped_langevin() -> Callable:
    """One Euler step of ``dx = g dt + sqrt(2 T) dW``."""

    def one_step(rng_key, position, logdensity_grad, step_size, temperature=1.0):
        noise = generate_gaussian_noise(rng_key, position)
        scale = _sqrt(2.0 * temperature * step_size, position)
        return tree_map(
            lambda p, g, n: p + step_size * g + scale * n, position, logdensity_grad, noise
        )

    return one_step


def sghmc(alpha: float = 0.01, beta: float = 0.0) -> Callable:
    """Underdamped dynamics with friction ``alpha`` and gradient-noise
    estimate ``beta`` (Ma et al. 2015 scaling)."""

    def one_step(rng_key, position, momentum, logdensity_grad, step_size, temperature=1.0):
        noise = generate_gaussian_noise(rng_key, position)
        new_position = tree_map(lambda x, p: x + step_size * p, position, momentum)
        noise_scale = _sqrt(
            step_size * temperature * (2.0 * alpha - step_size * temperature * beta), position
        )
        new_momentum = tree_map(
            lambda p, g, n: (1.0 - alpha * step_size) * p + step_size * g + noise_scale * n,
            momentum,
            logdensity_grad,
            noise,
        )
        return new_position, new_momentum

    return one_step


def sgnht(alpha: float = 0.01, beta: float = 0.0) -> Callable:
    """SGHMC with an adaptive thermostat ``xi`` (one a chain) replacing the
    fixed friction; ``xi`` relaxes toward the kinetic temperature."""

    def one_step(
        rng_key, position, momentum, xi, logdensity_grad, step_size, temperature=1.0
    ):
        noise = generate_gaussian_noise(rng_key, position)
        new_position = tree_map(lambda x, p: x + step_size * p, position, momentum)
        noise_scale = _sqrt(
            step_size * temperature * (2.0 * alpha - step_size * temperature * beta), position
        )
        friction = 1.0 - xi * step_size
        if torch.is_tensor(friction):
            friction = friction[..., None]  # one a chain, over the chain's coordinates
        new_momentum = tree_map(
            lambda p, g, n: friction * p + step_size * g + noise_scale * n,
            momentum,
            logdensity_grad,
            noise,
        )
        # a chain's squared momentum over its own size: the last axis
        momentum_sq = (new_momentum * new_momentum).sum(-1)
        new_xi = xi + step_size * (momentum_sq / new_momentum.shape[-1] - temperature)
        return new_position, new_momentum, new_xi

    return one_step
