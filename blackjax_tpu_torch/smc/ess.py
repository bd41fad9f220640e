"""Effective sample size of weighted particles + the tempering ESS solver
(reference ``blackjax_tpu/smc/ess.py``)."""
import math
from typing import Callable, Union

import torch

from blackjax_tpu_torch.types import Array, ArrayLikeTree

__all__ = ["ess", "log_ess", "ess_solver"]


def log_ess(log_weights: Array) -> Array:
    """``log ESS = 2 lse(w) - lse(2w)`` (Kong's estimator in log space)."""
    return 2.0 * torch.logsumexp(log_weights, 0) - torch.logsumexp(2.0 * log_weights, 0)


def ess(log_weights: Array) -> Array:
    return torch.exp(log_ess(log_weights))


def ess_solver(
    logdensity_fn: Callable,
    particles: ArrayLikeTree,
    target_ess: Union[float, Array],
    max_delta: Union[float, Array],
    root_solver: Callable,
) -> Array:
    """Find the tempering increment ``delta`` such that the incremental
    weights ``delta * loglik`` have ESS equal to ``target_ess * N``.

    The sign of the weights here MUST match the tempered-SMC weight update
    (``delta * loglikelihood``): a flipped sign finds an increment targeting
    the wrong distribution, silently for symmetric log-likelihoods.
    """
    loglik = logdensity_fn(particles)
    n = loglik.shape[0]
    target_log_ess = torch.log(
        torch.as_tensor(n * target_ess, dtype=loglik.dtype, device=loglik.device)
    )

    def objective(delta):
        return log_ess(torch.nan_to_num(delta * loglik)) - target_log_ess

    return root_solver(objective, 0.0, max_delta)
