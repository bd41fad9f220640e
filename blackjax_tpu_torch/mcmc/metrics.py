"""Euclidean metrics: momentum sampling, kinetic energy, the U-turn criterion
and mass-matrix scaling (reference ``blackjax_tpu/mcmc/metrics.py``).

Every function takes one chain ``(d,)`` or a batch ``(..., d)`` and reduces
over the last axis. Diagonal, dense and low-rank-plus-diagonal inverse mass
matrices are ported; the Riemannian metric comes with a later slice.
"""
from typing import Callable, NamedTuple, Optional

import torch

from blackjax_tpu_torch.types import Array, ArrayLikeTree, ArrayTree, Numeric, PRNGKey
from blackjax_tpu_torch.util import generate_gaussian_noise, linear_map

__all__ = [
    "Metric",
    "LowRankInverseMassMatrix",
    "default_metric",
    "gaussian_euclidean",
    "gaussian_euclidean_low_rank",
    "lbfgs_inverse_hessian_to_low_rank_metric",
]


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


class LowRankInverseMassMatrix(NamedTuple):
    """The inverse mass matrix ``M^{-1} = diag(sigma) (I + U (Lam - I) U^T)
    diag(sigma)`` with orthonormal-column ``U`` ``(d, k)`` and positive
    ``lam`` ``(k,)`` (reference ``metrics.py:93``)."""

    sigma: Array
    U: Array
    lam: Array


def _low_rank_matvec(y: Array, U: Array, eigenvalue_scales: Array) -> Array:
    """``(I + U (diag(s) - I) U^T) y`` over the last axis of ``y``, in O(dk)
    (reference ``metrics.py:111``): ``s = lam`` gives the inverse-mass core,
    ``sqrt(lam)`` its square root, ``1 / sqrt(lam)`` its inverse square root."""
    return y + ((eigenvalue_scales - 1.0) * (y @ U)) @ U.T


def default_metric(metric) -> Metric:
    """A :class:`Metric` passes through, a :class:`LowRankInverseMassMatrix`
    becomes :func:`gaussian_euclidean_low_rank`, a 1-d or 2-d inverse mass
    matrix :func:`gaussian_euclidean` (reference ``metrics.py:121``)."""
    if isinstance(metric, LowRankInverseMassMatrix):
        return gaussian_euclidean_low_rank(metric.sigma, metric.U, metric.lam)
    if isinstance(metric, Metric):
        return metric
    if callable(metric):
        raise NotImplementedError("Riemannian metrics are not ported yet")
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


def _gaussian_euclidean_rows(inverse_mass_matrix: Array) -> Metric:
    """:func:`gaussian_euclidean` of a diagonal inverse mass matrix given per
    chain: row ``c`` of the ``(C, d)`` tensor is chain ``c``'s diagonal, the
    reference's ``vmap`` of a kernel over per-chain diagonals. A ``(C, d)``
    tensor passed to :func:`gaussian_euclidean` is one dense matrix instead,
    so this form is only ever asked for by name. It acts on ``(C, d)``
    batches (the batched U-turn check of NUTS's checkpoints is not
    provided)."""
    inverse_mass_matrix = torch.as_tensor(inverse_mass_matrix)
    if inverse_mass_matrix.dim() != 2:
        raise ValueError(
            "a per-chain diagonal inverse mass matrix is (C, d); got "
            f"ndim={inverse_mass_matrix.dim()}."
        )
    inv_mass_sqrt = torch.sqrt(inverse_mass_matrix)
    mass_sqrt = 1.0 / inv_mass_sqrt

    def sample_momentum(rng_key: PRNGKey, position: ArrayLikeTree) -> ArrayTree:
        return generate_gaussian_noise(rng_key, position) * mass_sqrt

    def kinetic_energy(momentum, position=None) -> Numeric:
        del position
        return 0.5 * _dot(momentum, inverse_mass_matrix * momentum)

    def check_turning(
        momentum_left, momentum_right, momentum_sum, position_left=None, position_right=None
    ):
        del position_left, position_right
        rho = momentum_sum - 0.5 * (momentum_left + momentum_right)
        v_left = inverse_mass_matrix * momentum_left
        v_right = inverse_mass_matrix * momentum_right
        return (_dot(v_left, rho) <= 0) | (_dot(v_right, rho) <= 0)

    def scale(position, element, *, inv: bool, trans: bool):
        del position, trans  # a diagonal is its own transpose
        return (inv_mass_sqrt if inv else mass_sqrt) * element

    return Metric(sample_momentum, kinetic_energy, check_turning, scale)


def gaussian_euclidean_low_rank(sigma: Array, U: Array, lam: Array) -> Metric:
    """Euclidean metric whose inverse mass matrix is the low-rank-plus-
    diagonal ``M^{-1} = D (I + U (Lam - I) U^T) D``, ``D = diag(sigma)``
    (reference ``metrics.py:220``); every operation is O(dk) per chain.

    With ``A* = I + U (sqrt(Lam) - I) U^T`` and ``B = I + U (Lam^{-1/2} - I)
    U^T``: ``M^{-1/2} = D A*`` and ``M^{1/2} = D^{-1} B``."""
    sigma, U, lam = (torch.as_tensor(a) for a in (sigma, U, lam))
    inv_sigma = 1.0 / sigma
    sqrt_lam = torch.sqrt(lam)
    inv_sqrt_lam = 1.0 / sqrt_lam

    def inverse_mass_times(p):
        return sigma * _low_rank_matvec(sigma * p, U, lam)

    def sample_momentum(rng_key: PRNGKey, position: ArrayLikeTree) -> ArrayTree:
        # p = M^{1/2} eps = D^{-1} B eps, so E[p p^T] = D^{-1} B^2 D^{-1} = M
        eps = generate_gaussian_noise(rng_key, position)
        return inv_sigma * _low_rank_matvec(eps, U, inv_sqrt_lam)

    def kinetic_energy(momentum, position=None) -> Numeric:
        del position
        q = sigma * momentum
        return 0.5 * _dot(q, _low_rank_matvec(q, U, lam))

    def check_turning(
        momentum_left, momentum_right, momentum_sum, position_left=None, position_right=None
    ):
        del position_left, position_right
        rho = momentum_sum - 0.5 * (momentum_left + momentum_right)
        v_left = inverse_mass_times(momentum_left)
        v_right = inverse_mass_times(momentum_right)
        return (_dot(v_left, rho) <= 0) | (_dot(v_right, rho) <= 0)

    def scale(position, element, *, inv: bool, trans: bool):
        """``element`` times ``M^{-1/2} = D A*`` (``inv=True``) or ``M^{1/2} =
        D^{-1} B``; transposing swaps the order of the two factors."""
        del position
        if inv:
            if trans:
                return _low_rank_matvec(sigma * element, U, sqrt_lam)
            return sigma * _low_rank_matvec(element, U, sqrt_lam)
        if trans:
            return _low_rank_matvec(inv_sigma * element, U, inv_sqrt_lam)
        return inv_sigma * _low_rank_matvec(element, U, inv_sqrt_lam)

    def apply_row(x):
        # M^{-1} x over the rows of a (..., k, d) or (..., d) batch
        z = sigma * x
        return sigma * (z + ((z @ U) * (lam - 1.0)) @ U.T)

    return Metric(
        sample_momentum,
        kinetic_energy,
        check_turning,
        scale,
        _batched_turning_from_apply(apply_row),
    )


def lbfgs_inverse_hessian_to_low_rank_metric(
    alpha: Array, beta: Array, gamma: Array
) -> LowRankInverseMassMatrix:
    """Rewrite an L-BFGS factored inverse Hessian ``H^{-1} = diag(alpha) +
    beta gamma beta^T`` (Pathfinder's form) as a
    :class:`LowRankInverseMassMatrix` (reference ``metrics.py:366``).

    With ``sigma = sqrt(alpha)``, ``H^{-1} = D (I + D^{-1} beta gamma beta^T
    D^{-1}) D``; an orthonormal basis ``Q`` of ``D^{-1} beta`` (thin QR)
    turns the inner correction into ``Q C Q^T``, whose eigendecomposition
    gives ``(U, lam)``. ``eigh``'s columns carry arbitrary signs, so two
    payloads agree through ``U diag(lam) U^T``, not through ``U``."""
    sigma = torch.sqrt(alpha)
    Q, R = torch.linalg.qr(beta / sigma[:, None])
    core = R @ gamma @ R.T
    core = 0.5 * (core + core.T)
    eigvals, V = torch.linalg.eigh(core)
    return LowRankInverseMassMatrix(sigma=sigma, U=Q @ V, lam=1.0 + eigvals)
