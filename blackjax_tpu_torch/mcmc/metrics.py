"""Euclidean metrics: momentum sampling, kinetic energy, the U-turn criterion
and mass-matrix scaling (reference ``blackjax_tpu/mcmc/metrics.py``).

Every function takes one chain ``(d,)`` or a batch ``(..., d)`` and reduces
over the last axis. Diagonal and dense inverse mass matrices are ported; the
low-rank and Riemannian metrics come with later slices.
"""
from typing import Callable, NamedTuple, Optional

import torch

from blackjax_tpu_torch.types import Array, ArrayLikeTree, ArrayTree, Numeric, PRNGKey
from blackjax_tpu_torch.util import generate_gaussian_noise, linear_map

__all__ = ["Metric", "default_metric", "gaussian_euclidean"]


class Metric(NamedTuple):
    """The metric contract (reference ``metrics.py:38``).

    ``check_turning_batched(ckpt_momentum (..., k, d), ckpt_momentum_sum
    (..., k, d), momentum_right (..., d), momentum_sum (..., d), active
    (..., k)) -> (...) bool`` tests every checkpoint slot at once through
    the distributive matvec form."""

    sample_momentum: Callable[[PRNGKey, ArrayLikeTree], ArrayTree]
    kinetic_energy: Callable
    check_turning: Callable
    scale: Callable
    check_turning_batched: Optional[Callable] = None


def _dot(a, b):
    return (a * b).sum(-1)


def _batched_turning_from_apply(inverse_mass_times_row: Callable) -> Callable:
    """``check_turning_batched`` from a rowwise symmetric ``M^{-1}`` apply
    (reference ``metrics.py:60``)."""

    def check(ckpt_momentum, ckpt_momentum_sum, momentum_right, momentum_sum, active):
        m = momentum_right
        t = momentum_sum - 0.5 * m
        w = inverse_mass_times_row(m)
        u = inverse_mass_times_row(t)
        turn_right = (
            _dot(w, t)[..., None]
            - _dot(ckpt_momentum_sum, w[..., None, :])
            + 0.5 * _dot(ckpt_momentum, w[..., None, :])
        )
        V = inverse_mass_times_row(ckpt_momentum)
        turn_left = (
            _dot(ckpt_momentum, u[..., None, :])
            - _dot(V, ckpt_momentum_sum)
            + 0.5 * _dot(V, ckpt_momentum)
        )
        slot_turning = (turn_left <= 0) | (turn_right <= 0)
        return (active & slot_turning).any(-1)

    return check


def default_metric(metric) -> Metric:
    """A :class:`Metric` passes through; a 1-d or 2-d inverse mass matrix
    becomes :func:`gaussian_euclidean` (reference ``metrics.py:121``)."""
    if isinstance(metric, Metric):
        return metric
    if callable(metric):
        raise NotImplementedError("Riemannian metrics are not ported yet")
    if isinstance(metric, tuple):
        raise NotImplementedError("low-rank inverse mass matrices are not ported yet")
    return gaussian_euclidean(torch.as_tensor(metric))


def _sqrt_factors(inverse_mass_matrix: Array):
    """``(mass_sqrt, inv_mass_sqrt)`` with ``mass_sqrt @ mass_sqrt.T = M``;
    dense: ``M^{-1} = L L^T`` gives ``M^{1/2} = L^{-T}``."""
    if inverse_mass_matrix.dim() == 1:
        inv_sqrt = torch.sqrt(inverse_mass_matrix)
        return 1.0 / inv_sqrt, inv_sqrt
    if inverse_mass_matrix.dim() == 2:
        L = torch.linalg.cholesky(inverse_mass_matrix)
        identity = torch.eye(
            L.shape[0], dtype=L.dtype, device=L.device
        )
        mass_sqrt = torch.linalg.solve_triangular(L.T, identity, upper=True)
        return mass_sqrt, L
    raise ValueError(
        "The inverse mass matrix must be 1-d (diagonal) or 2-d (dense); got "
        f"ndim={inverse_mass_matrix.dim()}."
    )


def gaussian_euclidean(inverse_mass_matrix: Array) -> Metric:
    """Euclidean metric with Gaussian momentum ``p ~ N(0, M)`` for a static
    diagonal or dense inverse mass matrix (reference ``metrics.py:156``)."""
    inverse_mass_matrix = torch.as_tensor(inverse_mass_matrix)
    mass_sqrt, inv_mass_sqrt = _sqrt_factors(inverse_mass_matrix)

    def sample_momentum(rng_key: PRNGKey, position: ArrayLikeTree) -> ArrayTree:
        return generate_gaussian_noise(rng_key, position, sigma=mass_sqrt)

    def kinetic_energy(momentum, position=None) -> Numeric:
        del position
        return 0.5 * _dot(momentum, linear_map(inverse_mass_matrix, momentum))

    def check_turning(
        momentum_left, momentum_right, momentum_sum, position_left=None, position_right=None
    ):
        """The trajectory turns when the velocity at either end points
        against ``rho = sum - (m_left + m_right) / 2``."""
        del position_left, position_right
        rho = momentum_sum - 0.5 * (momentum_left + momentum_right)
        v_left = linear_map(inverse_mass_matrix, momentum_left)
        v_right = linear_map(inverse_mass_matrix, momentum_right)
        return (_dot(v_left, rho) <= 0) | (_dot(v_right, rho) <= 0)

    def scale(position, element, *, inv: bool, trans: bool):
        """``element`` times ``M^{1/2}`` (``inv=False``) or ``M^{-1/2}``
        (``inv=True``), optionally transposed."""
        del position
        factor = inv_mass_sqrt if inv else mass_sqrt
        if trans and factor.dim() == 2:
            factor = factor.T
        return linear_map(factor, element)

    if inverse_mass_matrix.dim() == 1:
        apply_row = lambda x: inverse_mass_matrix.to(x) * x  # noqa: E731
    else:
        apply_row = lambda x: x @ inverse_mass_matrix.to(x)  # noqa: E731 (symmetric)

    return Metric(
        sample_momentum,
        kinetic_energy,
        check_turning,
        scale,
        _batched_turning_from_apply(apply_row),
    )
