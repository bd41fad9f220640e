"""Stochastic Gradient Nosé-Hoover Thermostat (Ding et al. 2014; reference
``blackjax_tpu/sgmcmc/sgnht.py``). The thermostat ``xi`` is one a chain:
a ``(C,)`` tensor for a ``(C, d)`` position, a 0-d one for a ``(d,)``
position, in the position's dtype."""
from typing import Callable, NamedTuple

import torch

from blackjax_tpu_torch.base import SamplingAlgorithm
from blackjax_tpu_torch.sgmcmc import diffusions
from blackjax_tpu_torch.types import ArrayLikeTree, ArrayTree, PRNGKey
from blackjax_tpu_torch.util import generate_gaussian_noise

__all__ = ["SGNHTState", "init", "build_kernel", "as_top_level_api"]


class SGNHTState(NamedTuple):
    position: ArrayTree
    momentum: ArrayTree
    xi: float


def init(position: ArrayLikeTree, rng_key: PRNGKey, xi: float) -> SGNHTState:
    momentum = generate_gaussian_noise(rng_key, position)
    xi = torch.as_tensor(xi, dtype=position.dtype, device=position.device)
    return SGNHTState(position, momentum, xi.expand(position.shape[:-1]).clone())


def build_kernel(alpha: float = 0.01, beta: float = 0.0) -> Callable:
    integrator = diffusions.sgnht(alpha, beta)

    def kernel(
        rng_key: PRNGKey,
        state: SGNHTState,
        grad_estimator: Callable,
        minibatch: ArrayLikeTree,
        step_size: float,
        temperature: float = 1.0,
    ) -> SGNHTState:
        grad = grad_estimator(state.position, minibatch)
        position, momentum, xi = integrator(
            rng_key, state.position, state.momentum, state.xi, grad, step_size, temperature
        )
        return SGNHTState(position, momentum, xi)

    return kernel


def as_top_level_api(
    grad_estimator: Callable, alpha: float = 0.01, beta: float = 0.0
) -> SamplingAlgorithm:
    """``blackjax_tpu_torch.sgnht(...)``; ``init(position, rng_key, xi)``."""
    kernel = build_kernel(alpha, beta)

    def init_fn(position, rng_key, xi=0.0):
        xi = xi if xi != 0.0 else alpha
        return init(position, rng_key, xi)

    def step_fn(rng_key, state, minibatch, step_size, temperature=1.0):
        return kernel(rng_key, state, grad_estimator, minibatch, step_size, temperature)

    return SamplingAlgorithm(init_fn, step_fn)
