"""Elliptical slice sampling for posteriors with a Gaussian prior (Murray,
Adams & MacKay 2010; reference ``blackjax_tpu/mcmc/elliptical_slice.py``).

One transition moves every chain of a ``(C, d)`` block. The reference's
shrink ``while_loop`` runs per chain under ``vmap``; here one loop runs
until every chain has found its slice, a finished chain frozen by masks.
Each chain draws its angle at step ``subiter`` from ``fold_in(key_slice,
subiter)`` on its own counter, so a chain's draws never depend on another
chain's trip count, and ``subiter`` is reported per chain. The loop reads
whether any chain goes on to the host once an iteration. Randomness is a key
per chain (a ``torch.Generator`` draws one key a chain first).
"""
import math
from typing import Callable, NamedTuple

import torch

from blackjax_tpu_torch import prng
from blackjax_tpu_torch.base import SamplingAlgorithm, build_sampling_algorithm
from blackjax_tpu_torch.mcmc.proposal import tree_select
from blackjax_tpu_torch.types import Array, ArrayLikeTree, ArrayTree, PRNGKey
from blackjax_tpu_torch.util import chain_keys, generate_gaussian_noise, require_tensor_position

__all__ = ["EllipSliceState", "EllipSliceInfo", "init", "build_kernel", "as_top_level_api"]


class EllipSliceState(NamedTuple):
    position: ArrayTree
    logdensity: ArrayTree


class EllipSliceInfo(NamedTuple):
    momentum: ArrayTree
    theta: ArrayTree
    subiter: ArrayTree


def init(position: ArrayLikeTree, logdensity_fn: Callable) -> EllipSliceState:
    require_tensor_position(position, "elliptical_slice")
    return EllipSliceState(position, logdensity_fn(position))


def _rows(angle: Array, like: Array) -> Array:
    return angle.reshape(angle.shape + (1,) * (like.dim() - angle.dim()))


def ellipsis(position, momentum, theta, mean):
    """Rotate ``(position, momentum)`` by ``theta`` (one angle a chain) on
    the ellipse through both, centred at the prior mean."""
    cos_t, sin_t = _rows(torch.cos(theta), position), _rows(torch.sin(theta), position)
    new_position = (position - mean) * cos_t + (momentum - mean) * sin_t + mean
    new_momentum = (momentum - mean) * cos_t - (position - mean) * sin_t + mean
    return new_position, new_momentum


def elliptical_proposal(logdensity_fn: Callable, momentum_generator: Callable, mean) -> Callable:
    """Slice-sample an angle on the ellipse through the position and a fresh
    prior draw, shrinking the bracket toward ``theta = 0`` on rejection."""

    def generate(rng_key: PRNGKey, state: EllipSliceState):
        position, logdensity = state
        dtype = position.dtype
        mean_rows = torch.broadcast_to(
            torch.as_tensor(mean, dtype=dtype, device=position.device), position.shape)
        keys = chain_keys(rng_key, position)
        key_slice, key_momentum, key_uniform, key_theta = prng.split(keys, 4).unbind(-2)
        momentum = momentum_generator(key_momentum, position)
        log_slice = logdensity + torch.log(prng.uniform(key_uniform, (), dtype))
        theta = 2.0 * math.pi * prng.uniform(key_theta, (), dtype)
        theta_min, theta_max = theta - 2.0 * math.pi, theta
        proposed, new_momentum = ellipsis(position, momentum, theta, mean_rows)
        proposed_logdensity = logdensity_fn(proposed)
        subiter = torch.ones(logdensity.shape, dtype=torch.int64, device=position.device)
        going = proposed_logdensity <= log_slice
        while bool(going.any()):
            theta_new = prng.uniform(
                prng.fold_in(key_slice, subiter), (), dtype, theta_min, theta_max)
            position_new, momentum_new = ellipsis(position, momentum, theta_new, mean_rows)
            logdensity_new = logdensity_fn(position_new)
            theta_min_new = torch.where(theta_new < 0, theta_new, theta_min)
            theta_max_new = torch.where(theta_new > 0, theta_new, theta_max)
            (proposed_logdensity, subiter, theta, theta_min, theta_max, proposed,
             new_momentum) = tree_select(
                going,
                (logdensity_new, subiter + 1, theta_new, theta_min_new, theta_max_new,
                 position_new, momentum_new),
                (proposed_logdensity, subiter, theta, theta_min, theta_max, proposed,
                 new_momentum),
            )
            going = proposed_logdensity <= log_slice
        return (
            EllipSliceState(proposed, proposed_logdensity),
            EllipSliceInfo(new_momentum, theta, subiter),
        )

    return generate


def build_kernel(cov_matrix: Array, mean: Array):
    """The elliptical slice kernel for a Gaussian prior ``N(mean,
    cov_matrix)``, the covariance diagonal ``(d,)`` or dense ``(d, d)``."""
    cov_matrix = torch.as_tensor(cov_matrix)
    if cov_matrix.dim() == 1:
        cov_sqrt = torch.sqrt(cov_matrix)
    elif cov_matrix.dim() == 2:
        cov_sqrt = torch.linalg.cholesky(cov_matrix)
    else:
        raise ValueError(f"The covariance matrix must be 1-d or 2-d; got ndim={cov_matrix.dim()}.")

    def momentum_generator(rng_key, position):
        mu = torch.as_tensor(mean, dtype=position.dtype, device=position.device)
        return generate_gaussian_noise(rng_key, position, mu, cov_sqrt.to(position))

    def kernel(rng_key: PRNGKey, state: EllipSliceState, logdensity_fn: Callable):
        generate = elliptical_proposal(logdensity_fn, momentum_generator, mean)
        return generate(rng_key, state)

    return kernel


def as_top_level_api(loglikelihood_fn: Callable, *, mean: Array, cov: Array) -> SamplingAlgorithm:
    """``blackjax_tpu_torch.elliptical_slice(...)``: ``loglikelihood_fn`` is
    the likelihood alone; ``mean`` and ``cov`` give the Gaussian prior."""
    kernel = build_kernel(cov, mean)
    return build_sampling_algorithm(kernel, init, loglikelihood_fn)
