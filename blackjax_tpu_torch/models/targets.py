"""Benchmark and test posteriors (reference ``blackjax_tpu/models/targets.py``).

Every ``logdensity_fn`` maps a ``(..., d)`` batch to ``(...)``: one chain or
all chains at once, in the dtype and on the device of its input.
"""
import math
from typing import Callable, NamedTuple

import numpy as np
import torch

__all__ = [
    "Target",
    "standard_normal",
    "ill_conditioned_gaussian",
    "hierarchical_gaussian",
    "eight_schools_noncentered",
]


class Target(NamedTuple):
    """A named log-density with dimension and (when known) posterior moments."""

    logdensity_fn: Callable
    dim: int
    name: str
    mean: np.ndarray | None = None
    std: np.ndarray | None = None

    def sample_init(self, generator: torch.Generator, num_chains=None, *,
                    dtype=torch.float32, device=None):
        """``2 * N(0, I)`` initial positions, ``(dim,)`` or ``(num_chains, dim)``."""
        shape = (self.dim,) if num_chains is None else (num_chains, self.dim)
        return 2.0 * torch.randn(shape, generator=generator, dtype=dtype, device=device)


def _const(values, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(values, dtype=like.dtype, device=like.device)


def standard_normal(dim: int = 10) -> Target:
    def logdensity_fn(x):
        return -0.5 * (x**2).sum(-1)

    return Target(logdensity_fn, dim, f"std_normal_{dim}", np.zeros(dim), np.ones(dim))


def ill_conditioned_gaussian(dim: int = 100, condition_number: float = 100.0) -> Target:
    """Diagonal Gaussian with variances log-spaced over the condition number."""
    half = 0.5 * math.log10(condition_number)
    variances = np.logspace(-half, half, dim)

    def logdensity_fn(x):
        return -0.5 * (x**2 / _const(variances, x)).sum(-1)

    return Target(
        logdensity_fn, dim, f"ill_cond_gaussian_{dim}", np.zeros(dim), np.sqrt(variances)
    )


def hierarchical_gaussian(dim: int = 100) -> Target:
    """The flagship posterior: ``x = (log_tau, theta_1..theta_{d-1})`` with
    ``log_tau ~ N(0, 1)`` and ``theta_i | tau ~ N(0, exp(log_tau))``."""

    def logdensity_fn(x):
        log_tau = x[..., 0]
        theta = x[..., 1:]
        lp_tau = -0.5 * log_tau**2
        lp_theta = -0.5 * (theta**2).sum(-1) * torch.exp(-log_tau) - 0.5 * (
            dim - 1
        ) * log_tau
        return lp_tau + lp_theta

    return Target(logdensity_fn, dim, f"hierarchical_gaussian_{dim}")


def eight_schools_noncentered() -> Target:
    """Non-centered eight schools: ``x = (mu, log_tau, z_1..z_8)``, d = 10."""
    y = np.array([28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0])
    sigma = np.array([15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0])

    def logdensity_fn(x):
        mu, log_tau, z = x[..., 0], x[..., 1], x[..., 2:]
        theta = mu[..., None] + torch.exp(log_tau)[..., None] * z
        lp = -0.5 * (mu / 5.0) ** 2
        lp = lp - 0.5 * (log_tau / 5.0) ** 2
        lp = lp - 0.5 * (z**2).sum(-1)
        lp = lp + (-0.5 * ((_const(y, x) - theta) / _const(sigma, x)) ** 2).sum(-1)
        return lp

    return Target(logdensity_fn, 10, "eight_schools")
