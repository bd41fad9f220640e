"""Minibatch gradient estimators for stochastic-gradient MCMC (reference
``blackjax_tpu/sgmcmc/gradients.py``).

``loglikelihood_fn(position, point)`` is the log-likelihood of ONE data
point, as in the reference: the estimator maps it over the leading axis of
every leaf of the minibatch with ``torch.func.vmap`` (the reference's
``jax.vmap(..., in_axes=(None, 0))``). ``position`` is a ``(C, d)`` block of
chains or one ``(d,)`` position, so ``loglikelihood_fn`` maps ``(..., d)``
to ``(...)`` for the point it is given, and the estimate is one value a
chain. Gradients are autograd of the chains' summed estimate
(:func:`blackjax_tpu_torch.util.value_and_grad`): chains are independent,
so each gets its own gradient, the reference's ``jax.grad`` of one chain.
"""
from typing import Callable

import torch

from blackjax_tpu_torch.types import ArrayLikeTree, ArrayTree
from blackjax_tpu_torch.util import tree_map, value_and_grad

__all__ = ["logdensity_estimator", "grad_estimator", "control_variates"]


def logdensity_estimator(
    logprior_fn: Callable, loglikelihood_fn: Callable, data_size: int
) -> Callable:
    """Unbiased log-posterior estimate from a minibatch:
    ``prior + N * mean(loglik over batch)``."""
    batch_loglik = torch.func.vmap(loglikelihood_fn, in_dims=(None, 0))

    def estimate(position: ArrayLikeTree, minibatch: ArrayLikeTree) -> ArrayTree:
        return logprior_fn(position) + data_size * batch_loglik(position, minibatch).mean(0)

    return estimate


def grad_estimator(
    logprior_fn: Callable, loglikelihood_fn: Callable, data_size: int
) -> Callable:
    """Gradient of :func:`logdensity_estimator` with respect to the
    position, one a chain."""
    estimate = logdensity_estimator(logprior_fn, loglikelihood_fn, data_size)

    def grad(position: ArrayLikeTree, minibatch: ArrayLikeTree) -> ArrayTree:
        return value_and_grad(lambda x: estimate(x, minibatch), position)[1]

    return grad


def control_variates(
    logdensity_grad_estimator: Callable,
    centering_position: ArrayLikeTree,
    data: ArrayLikeTree,
) -> Callable:
    """Variance-reduced gradient estimator centered at a reference position
    (typically the MAP): ``grad_full(c) + grad_batch(x) - grad_batch(c)``."""
    center_full_grad = logdensity_grad_estimator(centering_position, data)

    def estimate(position: ArrayLikeTree, minibatch: ArrayLikeTree) -> ArrayTree:
        batch_grad = logdensity_grad_estimator(position, minibatch)
        center_batch_grad = logdensity_grad_estimator(centering_position, minibatch)
        return tree_map(
            lambda g, cg, cf: cf + g - cg, batch_grad, center_batch_grad, center_full_grad
        )

    return estimate
