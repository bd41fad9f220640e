"""Stochastic Gradient Langevin Dynamics (reference
``blackjax_tpu/sgmcmc/sgld.py``). The kernel is stateless: the state IS the
position, a ``(C, d)`` block of chains or one ``(d,)`` position, and the
minibatch is an explicit argument of every step."""
from typing import Callable

from blackjax_tpu_torch.base import SamplingAlgorithm
from blackjax_tpu_torch.sgmcmc import diffusions
from blackjax_tpu_torch.types import ArrayLikeTree, ArrayTree, PRNGKey

__all__ = ["init", "build_kernel", "as_top_level_api"]


def init(position: ArrayLikeTree) -> ArrayLikeTree:
    return position


def build_kernel() -> Callable:
    integrator = diffusions.overdamped_langevin()

    def kernel(
        rng_key: PRNGKey,
        position: ArrayLikeTree,
        grad_estimator: Callable,
        minibatch: ArrayLikeTree,
        step_size: float,
        temperature: float = 1.0,
    ) -> ArrayTree:
        grad = grad_estimator(position, minibatch)
        return integrator(rng_key, position, grad, step_size, temperature)

    return kernel


def as_top_level_api(grad_estimator: Callable) -> SamplingAlgorithm:
    """``blackjax_tpu_torch.sgld(...)``; ``step(key, position, minibatch,
    step_size, temperature)``."""
    kernel = build_kernel()

    def init_fn(position, rng_key=None):
        del rng_key
        return init(position)

    def step_fn(rng_key, state, minibatch, step_size, temperature=1.0):
        return kernel(rng_key, state, grad_estimator, minibatch, step_size, temperature)

    return SamplingAlgorithm(init_fn, step_fn)
