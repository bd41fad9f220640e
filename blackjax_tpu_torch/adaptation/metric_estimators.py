"""Metric estimators: draws, gradients or moment blocks to inverse mass
matrices (reference ``blackjax_tpu/adaptation/metric_estimators.py``).

Everything runs on the device and in the dtype of its inputs, except the
Fisher low-rank pipeline (:func:`_compute_low_rank_metric`), which always
computes in float64 and casts back: the reference promotes it to f64
whenever x64 is on, which is how it is tested, because its condition numbers
reach ``1 / gamma``. Spectra are floored relative to their own scale.

Eigenvectors and singular vectors are defined up to sign (and, for equal
eigenvalues, up to a rotation), and LAPACK and PyTorch may pick differently:
the payloads agree with the reference through the inverse mass matrix they
reconstruct, ``D (I + U (Lam - I) U^T) D``, not column by column.
"""
from typing import Literal, Optional, Union

import torch

from blackjax_tpu_torch.adaptation.mass_matrix import welford_algorithm
from blackjax_tpu_torch.mcmc.metrics import LowRankInverseMassMatrix
from blackjax_tpu_torch.types import Array

__all__ = [
    "eigenvalue_informativeness",
    "select_top_eigenvalues_by_informativeness",
    "fisher_score_low_rank",
    "draws_singular_value_low_rank",
    "sample_covariance_eigh_low_rank",
    "welford_diagonal",
    "welford_dense",
    "fisher_score_diagonal_from_moments",
    "fisher_score_diagonal",
    "sample_variance_diagonal",
]


def _relative_pd_floor(vals: Array) -> Array:
    """An eps floor scaled to the spectrum's own magnitude."""
    finfo = torch.finfo(vals.dtype)
    scale = torch.clamp(vals.abs().max(), min=finfo.tiny)
    return finfo.eps * scale


def _spd_mean(A: Array, B: Array) -> Array:
    """The AIRM geometric mean ``A # B = B^{1/2} (B^{-1/2} A B^{-1/2})^{1/2}
    B^{1/2}``, with relative floors on both intermediate spectra."""
    vals_b, vecs_b = torch.linalg.eigh(B)
    vals_b = torch.maximum(vals_b, _relative_pd_floor(vals_b))
    sqrt_b = torch.sqrt(vals_b)
    inv_sqrt_b = 1.0 / sqrt_b

    inner = vecs_b.T @ A @ vecs_b
    M = inv_sqrt_b[:, None] * inner * inv_sqrt_b[None, :]
    vals_m, vecs_m = torch.linalg.eigh(M)
    vals_m = torch.maximum(vals_m, _relative_pd_floor(vals_m))

    W = vecs_b @ (sqrt_b[:, None] * vecs_m)
    return (W * torch.sqrt(vals_m)[None, :]) @ W.T


def eigenvalue_informativeness(eigenvalues: Array) -> Array:
    """``|lambda - 1|``: how far each direction is from isotropic."""
    return (eigenvalues - 1.0).abs()


def select_top_eigenvalues_by_informativeness(
    eigenvalues: Array,
    eigenvectors: Array,
    max_rank: int,
    *,
    tail_handling: Literal["mask_pad", "raw"] = "mask_pad",
    cutoff: float = 2.0,
) -> tuple[Array, Array]:
    """The ``max_rank`` most informative eigenpairs, padded with inert pairs
    (zero vectors, ``lam = 1``) when fewer exist. ``"mask_pad"`` also sets
    eigenvalues inside ``[1 / cutoff, cutoff]`` to 1; ``"raw"`` keeps them.
    Ties are ordered as the reference's stable ``argsort`` orders them."""
    if tail_handling not in ("mask_pad", "raw"):
        raise ValueError(
            f"tail_handling must be 'mask_pad' or 'raw', got {tail_handling!r}"
        )
    q = eigenvalues.shape[0]
    scores = eigenvalue_informativeness(eigenvalues)
    if tail_handling == "mask_pad":
        order = torch.argsort(-scores, stable=True)
    else:
        order = torch.argsort(scores, stable=True).flip(0)
    top = order[: min(max_rank, q)]
    U_out = eigenvectors[:, top]
    lam_out = eigenvalues[top]
    if tail_handling == "mask_pad":
        is_informative = (lam_out < 1.0 / cutoff) | (lam_out > cutoff)
        lam_out = torch.where(is_informative, lam_out, torch.ones_like(lam_out))
    pad = max_rank - top.shape[0]
    if pad > 0:
        U_out = torch.cat([U_out, U_out.new_zeros((U_out.shape[0], pad))], dim=1)
        lam_out = torch.cat([lam_out, lam_out.new_ones(pad)])
    return U_out, lam_out


def _compute_low_rank_metric(
    draws_buffer: Array,
    grads_buffer: Array,
    n,
    max_rank: int,
    gamma: float,
    cutoff: float,
):
    """The Fisher-divergence low-rank estimator on a buffer whose first
    ``n`` rows are valid (nutpie Algorithm 1, steps 1-9), in float64.
    Returns ``(sigma, mu_star, U, lam)`` in the buffer's dtype."""
    orig_dtype = draws_buffer.dtype
    f64 = torch.float64
    draws_buffer = draws_buffer.to(f64)
    grads_buffer = grads_buffer.to(f64)
    B, d = draws_buffer.shape
    # writes past the capacity wrap around: every row is valid then
    n = min(int(n), B)
    mask = (torch.arange(B, device=draws_buffer.device) < n).to(f64)
    n_safe = float(max(n, 2))

    # step 1: sigma = (Var[x] / Var[grad])^(1/4) with population variances,
    # and the optimal translation mu*
    mean_x = (mask[:, None] * draws_buffer).sum(0) / n_safe
    mean_g = (mask[:, None] * grads_buffer).sum(0) / n_safe
    diff_x = mask[:, None] * (draws_buffer - mean_x[None, :])
    diff_g = mask[:, None] * (grads_buffer - mean_g[None, :])
    var_x = (diff_x**2).sum(0) / n_safe
    var_g = (diff_g**2).sum(0) / n_safe
    sigma = torch.clamp(var_x / torch.clamp(var_g, min=1e-10), min=0.0) ** 0.25
    sigma = torch.clamp(sigma, 1e-20, 1e20)
    mu_star = mean_x + sigma**2 * mean_g

    # steps 2-4: whiten both streams, combine their principal subspaces
    X = diff_x / sigma[None, :]
    A = diff_g * sigma[None, :]
    Vt_x = torch.linalg.svd(X, full_matrices=False)[2]
    Vt_a = torch.linalg.svd(A, full_matrices=False)[2]
    combined = torch.cat([Vt_x[:max_rank].T, Vt_a[:max_rank].T], dim=1)
    Q, _ = torch.linalg.qr(combined)
    q = Q.shape[1]

    # steps 5-7: projected covariances regularized by gamma, and their AIRM
    # geometric mean against the inverted score covariance (Theorem 2.3)
    P_x = Q.T @ X.T
    P_a = Q.T @ A.T
    eye = torch.eye(q, dtype=f64, device=Q.device)
    C_x = (P_x @ P_x.T) / gamma + eye
    C_a = (P_a @ P_a.T) / gamma + eye
    Sigma = _spd_mean(C_x, torch.linalg.inv(C_a))

    # steps 8-9: eigendecompose, floor, select, mask and pad
    vals, vecs = torch.linalg.eigh(Sigma)
    vals = torch.maximum(vals, _relative_pd_floor(vals))
    U_out, lam_out = select_top_eigenvalues_by_informativeness(
        vals, Q @ vecs, max_rank, tail_handling="mask_pad", cutoff=cutoff
    )
    return tuple(a.to(orig_dtype) for a in (sigma, mu_star, U_out, lam_out))


def fisher_score_low_rank(
    draws: Array,
    grads: Array,
    max_rank: int,
    *,
    gamma: float = 1e-5,
    cutoff: float = 2.0,
) -> LowRankInverseMassMatrix:
    """The Fisher-divergence-minimizing low-rank-plus-diagonal inverse mass
    matrix from draws and their score gradients (every row valid); nutpie's
    defaults ``gamma=1e-5``, ``cutoff=2``."""
    sigma, _, U, lam = _compute_low_rank_metric(
        draws, grads, draws.shape[0], max_rank, gamma, cutoff
    )
    return LowRankInverseMassMatrix(sigma=sigma, U=U, lam=lam)


def draws_singular_value_low_rank(
    draws: Array, max_rank: int, row_mask: Optional[Array] = None
) -> LowRankInverseMassMatrix:
    """A low-rank payload from the thin SVD of standardized draws (raw
    eigenvalues, no regularization). ``row_mask`` marks the valid rows of a
    partly filled buffer; masked rows are zeroed after standardization, which
    leaves the singular structure of the valid rows."""
    if row_mask is None:
        n = draws.shape[0]
        mean = draws.mean(0)
        var = ((draws - mean[None, :]) ** 2).mean(0)
    else:
        n = torch.clamp(row_mask.sum().to(draws.dtype), min=1.0)
        masked = torch.where(row_mask[:, None], draws, torch.zeros_like(draws))
        mean = masked.sum(0) / n
        sq = torch.where(
            row_mask[:, None], (draws - mean[None, :]) ** 2, torch.zeros_like(draws)
        )
        var = sq.sum(0) / n
    sigma = torch.sqrt(var)
    sigma = torch.where(sigma == 0.0, torch.ones_like(sigma), sigma)
    standardized = (draws - mean[None, :]) / sigma[None, :]
    if row_mask is not None:
        standardized = torch.where(
            row_mask[:, None], standardized, torch.zeros_like(standardized)
        )
    _, S, Vt = torch.linalg.svd(standardized, full_matrices=False)
    lam = S**2 / n
    U_k, lam_k = select_top_eigenvalues_by_informativeness(
        lam, Vt.T, max_rank, tail_handling="raw"
    )
    return LowRankInverseMassMatrix(sigma=sigma, U=U_k, lam=lam_k)


def sample_covariance_eigh_low_rank(
    m2: Array, count: Union[Array, int], max_rank: int
) -> LowRankInverseMassMatrix:
    """A low-rank payload from an accumulated ``M2`` matrix: the
    Bessel-corrected covariance, its correlation, eigh, raw top-k."""
    count = torch.as_tensor(count, dtype=m2.dtype, device=m2.device)
    covariance = m2 / torch.clamp(count - 1.0, min=1.0)
    variance = torch.diagonal(covariance)
    sigma = torch.sqrt(torch.clamp(variance, min=0.0))
    sigma = torch.where(sigma <= 0.0, torch.ones_like(sigma), sigma)
    inv_sigma = 1.0 / sigma
    correlation = covariance * inv_sigma[:, None] * inv_sigma[None, :]
    lam_all, V = torch.linalg.eigh(correlation)
    U, lam = select_top_eigenvalues_by_informativeness(
        lam_all, V, max_rank, tail_handling="raw"
    )
    return LowRankInverseMassMatrix(sigma=sigma, U=U, lam=lam)


def _welford_covariance(draws: Array, is_diagonal: bool) -> Array:
    wc_init, wc_update, wc_final = welford_algorithm(is_diagonal)
    state = wc_init(draws.shape[1], dtype=draws.dtype, device=draws.device)
    return wc_final(wc_update(state, draws))[0]


def welford_diagonal(draws: Array) -> Array:
    """The Bessel-corrected per-coordinate sample variance (Welford)."""
    return _welford_covariance(draws, True)


def welford_dense(draws: Array) -> Array:
    """The Bessel-corrected sample covariance matrix (Welford)."""
    return _welford_covariance(draws, False)


def fisher_score_diagonal_from_moments(variance: Array, gradient_variance: Array) -> Array:
    """The diagonal Fisher inverse mass matrix ``sigma^2`` with ``sigma =
    (Var[x] / Var[grad log p])^(1/4)`` clipped to ``[1e-20, 1e20]`` before
    squaring (nutpie's range)."""
    sigma = torch.clamp(variance / torch.clamp(gradient_variance, min=1e-10), min=0.0) ** 0.25
    sigma = torch.clamp(sigma, 1e-20, 1e20)
    return sigma**2


def fisher_score_diagonal(draws: Array, grads: Array) -> Array:
    """The diagonal Fisher inverse mass matrix from raw draws and gradients."""
    return fisher_score_diagonal_from_moments(welford_diagonal(draws), welford_diagonal(grads))


def sample_variance_diagonal(draws: Array) -> Array:
    """The population per-coordinate variance ``E[x^2] - E[x]^2``."""
    x_average = draws.mean(0)
    return (draws**2).mean(0) - x_average**2
