"""Full-rank Gaussian ADVI with a Cholesky parameterisation; reference
``blackjax_tpu/vi/fullrank_vi.py``.

The position is a ``(d,)`` tensor; ``mu`` is ``(d,)`` and ``chol_params``
``(d (d + 1) / 2,)``, both in its dtype, on its device: the log-diagonal, then
the strict lower triangle in ``torch.tril_indices(d, d, -1)`` order, which is
``jnp.tril_indices(d, k=-1)``'s (row by row). A draw is ``mu + eps L^T`` with
``eps = normal(key, (num_samples, d))`` through :func:`prng.normal`; the log
density solves all draws in one triangular solve with a ``(d, n)`` right-hand
side. ``logdensity_fn`` maps a ``(n, d)`` batch to ``(n,)``.
"""
import math
from typing import Callable, NamedTuple

import torch

from blackjax_tpu_torch import prng
from blackjax_tpu_torch.base import VIAlgorithm
from blackjax_tpu_torch.types import Array, ArrayLikeTree, ArrayTree, PRNGKey
from blackjax_tpu_torch.util import chain_keys, require_tensor_position
from blackjax_tpu_torch.vi._gaussian_vi import KL, Objective, elbo_step

__all__ = ["FRVIState", "FRVIInfo", "init", "step", "sample", "as_top_level_api"]


class FRVIState(NamedTuple):
    mu: ArrayTree
    chol_params: Array  # (d + d(d-1)/2,): log-diagonal, then the strict lower triangle
    opt_state: object


class FRVIInfo(NamedTuple):
    elbo: torch.Tensor


def init(position: ArrayLikeTree, optimizer, *optimizer_args, **optimizer_kwargs) -> FRVIState:
    """Zero mean, identity covariance (log-diagonal zeros)."""
    require_tensor_position(position, "fullrank_vi")
    mu = torch.zeros_like(position)
    dim = position.shape[-1]
    chol_params = position.new_zeros(dim * (dim + 1) // 2)
    return FRVIState(mu, chol_params, optimizer.init((mu, chol_params)))


def _unflatten_cholesky(chol_params, dim):
    """The lower-triangular factor with an exp-positive diagonal: the first
    ``dim`` entries are the log-diagonal, the rest fill the strict lower
    triangle row by row."""
    rows, cols = torch.tril_indices(dim, dim, -1, device=chol_params.device)
    L = chol_params.new_zeros((dim, dim)).index_put((rows, cols), chol_params[dim:])
    return L + torch.diag(torch.exp(chol_params[:dim]))


def _sample(rng_key, mu, chol_params, num_samples):
    dim = mu.shape[-1]
    L = _unflatten_cholesky(chol_params, dim)
    eps = prng.normal(chain_keys(rng_key, mu), (num_samples, dim), mu.dtype)
    return mu + eps @ L.T


def generate_fullrank_logdensity(mu, chol_params):
    """The log density straight from the Cholesky factor, of a ``(..., d)``
    batch (no refactorisation)."""
    dim = mu.shape[-1]
    L = _unflatten_cholesky(chol_params, dim)
    log_det = 2.0 * torch.log(torch.diagonal(L)).sum()
    const = -0.5 * dim * math.log(2.0 * math.pi)

    def logdensity(position):
        centred = (position - mu).reshape(-1, dim)
        y = torch.linalg.solve_triangular(L, centred.T, upper=False)
        return const - 0.5 * (log_det + torch.square(y).sum(0).reshape(position.shape[:-1]))

    return logdensity


def step(
    rng_key: PRNGKey,
    state: FRVIState,
    logdensity_fn: Callable,
    optimizer,
    num_samples: int = 5,
    objective: Objective = KL(),
    stl_estimator: bool = True,
) -> tuple[FRVIState, FRVIInfo]:
    (mu, chol_params), opt_state, loss = elbo_step(
        rng_key,
        (state.mu, state.chol_params),
        state.opt_state,
        logdensity_fn,
        optimizer,
        lambda key, params, n: _sample(key, params[0], params[1], n),
        lambda params: generate_fullrank_logdensity(params[0], params[1]),
        num_samples,
        objective=objective,
        stl_estimator=stl_estimator,
    )
    return FRVIState(mu, chol_params, opt_state), FRVIInfo(loss)


def sample(rng_key: PRNGKey, state: FRVIState, num_samples: int = 1):
    return _sample(rng_key, state.mu, state.chol_params, num_samples)


def as_top_level_api(
    logdensity_fn: Callable,
    optimizer,
    num_samples: int = 100,
    objective: Objective = KL(),
    stl_estimator: bool = True,
) -> VIAlgorithm:
    """``blackjax_tpu_torch.fullrank_vi(...)``."""

    def init_fn(position):
        return init(position, optimizer)

    def step_fn(rng_key, state):
        return step(rng_key, state, logdensity_fn, optimizer, num_samples, objective=objective,
                    stl_estimator=stl_estimator)

    def sample_fn(rng_key, state, num_samples):
        return sample(rng_key, state, num_samples)

    return VIAlgorithm(init_fn, step_fn, sample_fn)
