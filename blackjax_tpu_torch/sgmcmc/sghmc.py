"""Stochastic Gradient HMC (Chen et al. 2014; reference
``blackjax_tpu/sgmcmc/sghmc.py``): ``num_integration_steps`` Euler steps
with a fresh momentum each transition. The momentum is drawn from the
transition's key, and step ``i`` draws its noise from ``split(key,
num_integration_steps)[i]``, as the reference's scan does (a generator
draws them in that order)."""
from typing import Callable

import torch

from blackjax_tpu_torch import prng
from blackjax_tpu_torch.base import SamplingAlgorithm
from blackjax_tpu_torch.sgmcmc import diffusions
from blackjax_tpu_torch.types import ArrayLikeTree, ArrayTree, PRNGKey
from blackjax_tpu_torch.util import generate_gaussian_noise

__all__ = ["init", "build_kernel", "as_top_level_api"]


def init(position: ArrayLikeTree) -> ArrayLikeTree:
    return position


def build_kernel(alpha: float = 0.01, beta: float = 0.0) -> Callable:
    integrator = diffusions.sghmc(alpha, beta)

    def kernel(
        rng_key: PRNGKey,
        position: ArrayLikeTree,
        grad_estimator: Callable,
        minibatch: ArrayLikeTree,
        step_size: float,
        num_integration_steps: int,
        temperature: float = 1.0,
    ) -> ArrayTree:
        momentum = generate_gaussian_noise(rng_key, position)
        if isinstance(rng_key, torch.Generator):
            keys = [rng_key] * num_integration_steps
        else:
            keys = prng.split(rng_key.to(position.device), num_integration_steps).unbind(-2)
        for key in keys:
            grad = grad_estimator(position, minibatch)
            position, momentum = integrator(
                key, position, momentum, grad, step_size, temperature
            )
        return position

    return kernel


def as_top_level_api(
    grad_estimator: Callable,
    num_integration_steps: int = 10,
    alpha: float = 0.01,
    beta: float = 0.0,
) -> SamplingAlgorithm:
    """``blackjax_tpu_torch.sghmc(...)``."""
    kernel = build_kernel(alpha, beta)

    def init_fn(position, rng_key=None):
        del rng_key
        return init(position)

    def step_fn(rng_key, state, minibatch, step_size, temperature=1.0):
        return kernel(
            rng_key,
            state,
            grad_estimator,
            minibatch,
            step_size,
            num_integration_steps,
            temperature,
        )

    return SamplingAlgorithm(init_fn, step_fn)
