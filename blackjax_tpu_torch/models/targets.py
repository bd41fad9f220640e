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
    "finnish_horseshoe",
    "horseshoe_data",
    "logistic_regression",
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
        """``2 * N(0, I)`` initial positions, ``(dim,)`` or ``(num_chains, dim)``,
        on ``device``, by default the generator's."""
        shape = (self.dim,) if num_chains is None else (num_chains, self.dim)
        device = generator.device if device is None else device
        return 2.0 * torch.randn(shape, generator=generator, dtype=dtype, device=device)


def _const(values) -> Callable:
    """``values`` as a tensor in the dtype and on the device of a log
    density's input, uploaded once for each: an upload from host memory
    at every call would make each evaluation on the card wait for it."""
    copies = {}

    def like(x: torch.Tensor) -> torch.Tensor:
        key = (x.dtype, x.device)
        if key not in copies:
            copies[key] = torch.as_tensor(values, dtype=x.dtype, device=x.device)
        return copies[key]

    return like


def standard_normal(dim: int = 10) -> Target:
    def logdensity_fn(x):
        return -0.5 * (x**2).sum(-1)

    return Target(logdensity_fn, dim, f"std_normal_{dim}", np.zeros(dim), np.ones(dim))


def ill_conditioned_gaussian(dim: int = 100, condition_number: float = 100.0) -> Target:
    """Diagonal Gaussian with variances log-spaced over the condition number."""
    half = 0.5 * math.log10(condition_number)
    variances = np.logspace(-half, half, dim)
    variances_like = _const(variances)

    def logdensity_fn(x):
        return -0.5 * (x**2 / variances_like(x)).sum(-1)

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
    y_like, sigma_like = _const(y), _const(sigma)

    def logdensity_fn(x):
        mu, log_tau, z = x[..., 0], x[..., 1], x[..., 2:]
        theta = mu[..., None] + torch.exp(log_tau)[..., None] * z
        lp = -0.5 * (mu / 5.0) ** 2
        lp = lp - 0.5 * (log_tau / 5.0) ** 2
        lp = lp - 0.5 * (z**2).sum(-1)
        lp = lp + (-0.5 * ((y_like(x) - theta) / sigma_like(x)) ** 2).sum(-1)
        return lp

    return Target(logdensity_fn, 10, "eight_schools")


def horseshoe_data(num_points: int = 100, num_predictors: int = 200, seed: int = 42):
    """The horseshoe's synthetic regression data ``(X (N, M), y (N,))`` as
    f32 numpy arrays, drawn from ``np.random.default_rng(seed)`` exactly as
    the reference draws them: about 5% of the true coefficients are hot
    (``N(10, 1)``), the rest zero, and ``y = X truth + N(0, 1)`` is formed in
    f64 before the cast."""
    M, N = num_predictors, num_points
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((N, M)).astype(np.float32)
    truth = np.zeros(M)
    hot = rng.random(M) < 0.05
    truth[hot] = rng.standard_normal(int(hot.sum())) + 10.0
    y = (X @ truth + rng.standard_normal(N)).astype(np.float32)
    return X, y


def finnish_horseshoe(
    num_points: int = 100,
    num_predictors: int = 200,
    expected_nonzero: int = 10,
    slab_scale: float = 3.0,
    slab_df: float = 25.0,
    seed: int = 42,
) -> Target:
    """Regularized ("Finnish") horseshoe sparse regression (Piironen and
    Vehtari, 2017) on :func:`horseshoe_data`.

    Unconstrained layout ``x = (alpha, log_sigma, log_tau, log_c2,
    log_lambda[M], beta_tilde[M])``, so ``dim = 4 + 2 M``; positive
    parameters ride in log space with the Jacobian folded into the log
    density, and normalization constants are dropped.
    """
    M, N = num_predictors, num_points
    X_np, y_np = horseshoe_data(N, M, seed)
    tau0 = expected_nonzero / ((M - expected_nonzero) * math.sqrt(N))
    half_df = 0.5 * slab_df
    slab2 = slab_scale**2
    X_like, y_like = _const(X_np), _const(y_np)

    def logdensity_fn(x):
        X, y = X_like(x), y_like(x)
        alpha = x[..., 0]
        log_sigma = x[..., 1]
        log_tau = x[..., 2]
        log_c2 = x[..., 3]
        log_lam = x[..., 4 : 4 + M]
        beta_t = x[..., 4 + M :]

        sigma = torch.exp(log_sigma)
        tau = tau0 * sigma * torch.exp(log_tau)
        c2 = slab2 * torch.exp(log_c2)[..., None]
        lam2 = torch.exp(2.0 * log_lam)
        # slab-regularized local scales: lam_reg^2 = c2 lam^2 / (c2 + tau^2 lam^2)
        lam_reg = torch.sqrt(c2 * lam2 / (c2 + tau[..., None] ** 2 * lam2))
        beta = tau[..., None] * lam_reg * beta_t

        resid = y - (beta @ X.T + alpha[..., None])
        loglik = -N * log_sigma - 0.5 * ((resid / sigma[..., None]) ** 2).sum(-1)

        lp = -0.125 * alpha**2  # alpha ~ N(0, 2)
        lp = lp + (-0.125 * sigma**2 + log_sigma)  # sigma ~ HalfNormal(2), + Jacobian
        lp = lp + (-torch.log1p(torch.exp(2.0 * log_tau)) + log_tau)  # HalfCauchy(1)
        # c2_tilde ~ InvGamma(df/2, df/2), + Jacobian
        lp = lp + (-half_df * log_c2 - half_df * torch.exp(-log_c2))
        lp = lp + (-torch.log1p(lam2) + log_lam).sum(-1)  # HalfCauchy(1)
        lp = lp - 0.5 * (beta_t**2).sum(-1)
        return lp + loglik

    return Target(logdensity_fn, 4 + 2 * M, f"finnish_horseshoe_{N}x{M}")


def logistic_regression(
    rng=None,
    num_points: int = 512,
    dim: int = 25,
    *,
    X=None,
    y=None,
    device=None,
    dtype=torch.float32,
):
    """Synthetic logistic regression with a ``N(0, I)`` prior; returns
    ``(target, X, y)`` so that minibatching samplers can use the same data.

    ``rng`` draws the data: ``X ~ N(0, 1)``, true weights ``~ N(0, 1)``, ``y ~
    Bernoulli(sigmoid(X w))``. Key words ``(2,)`` draw them as the reference's
    ``logistic_regression(rng_key, ...)`` does (``split(key, 3)`` into the
    keys of X, the weights and y; :mod:`blackjax_tpu_torch.prng`), X in
    ``dtype`` and y in float32, as the reference casts it; a ``torch.Generator`` (a fresh one seeded 0 if None) draws
    them with torch's own stream. Pass ``X`` and ``y`` (arrays or tensors)
    to use given data, such as the reference's.

    The data live on ``device`` (by default the key's, the generator's or
    the given X's), made there once; a log density evaluated in another
    dtype or on another device converts them once and keeps the copy.
    """
    if X is None or y is None:
        if torch.is_tensor(rng):
            from blackjax_tpu_torch import prng

            keys = rng.to(rng.device if device is None else device)
            kx, kw, ky = prng.split(keys, 3).unbind(-2)
            X = prng.normal(kx, (num_points, dim), dtype)
            true_w = prng.normal(kw, (dim,), dtype)
            y = prng.bernoulli(ky, torch.sigmoid(X @ true_w), shape=(num_points,)).float()
        else:
            generator = torch.Generator().manual_seed(0) if rng is None else rng
            X = torch.randn(num_points, dim, generator=generator, device=generator.device)
            true_w = torch.randn(dim, generator=generator, device=generator.device)
            y = torch.bernoulli(torch.sigmoid(X @ true_w), generator=generator)
    X, y = (t if isinstance(t, torch.Tensor) else torch.from_numpy(np.array(t)) for t in (X, y))
    if device is not None:
        X, y = X.to(device), y.to(device)
    num_points, dim = X.shape
    converted = {(X.dtype, X.device): (X, y.to(X.dtype))}

    def data_like(w):
        key = (w.dtype, w.device)
        if key not in converted:
            converted[key] = (X.to(dtype=w.dtype, device=w.device),
                              y.to(dtype=w.dtype, device=w.device))
        return converted[key]

    def logdensity_fn(w):
        xs, yy = data_like(w)
        logits = w @ xs.T
        loglik = (
            yy * torch.nn.functional.logsigmoid(logits)
            + (1 - yy) * torch.nn.functional.logsigmoid(-logits)
        ).sum(-1)
        return loglik - 0.5 * (w**2).sum(-1)

    return Target(logdensity_fn, dim, f"logreg_{num_points}x{dim}"), X, y
