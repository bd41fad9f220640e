"""Barker's robust gradient-based proposal (Livingstone & Zanella 2022;
reference ``blackjax_tpu/mcmc/barker.py``).

Each Gaussian increment of the whitened proposal keeps its sign with
probability ``sigmoid(c z)``, where ``c`` is the whitened gradient; a
Metropolis-Hastings step corrects the skew. One transition moves every
chain of a ``(C, d)`` block; its randomness is a key per chain, split as
the reference splits it (a ``torch.Generator`` draws one key a chain
first).
"""
from typing import Callable, NamedTuple, Optional

import torch

from blackjax_tpu_torch import prng
from blackjax_tpu_torch.base import SamplingAlgorithm, build_sampling_algorithm
from blackjax_tpu_torch.mcmc import metrics
from blackjax_tpu_torch.mcmc.proposal import static_binomial_sampling
from blackjax_tpu_torch.types import ArrayLikeTree, ArrayTree, PRNGKey
from blackjax_tpu_torch.util import (
    chain_keys,
    generate_gaussian_noise,
    require_tensor_position,
    value_and_grad,
)

__all__ = ["BarkerState", "BarkerInfo", "init", "build_kernel", "as_top_level_api"]


class BarkerState(NamedTuple):
    position: ArrayTree
    logdensity: ArrayTree
    logdensity_grad: ArrayTree


class BarkerInfo(NamedTuple):
    acceptance_rate: ArrayTree
    is_accepted: ArrayTree
    proposal: BarkerState


def init(position: ArrayLikeTree, logdensity_fn: Callable) -> BarkerState:
    require_tensor_position(position, "barker")
    logdensity, logdensity_grad = value_and_grad(logdensity_fn, position)
    return BarkerState(position, logdensity, logdensity_grad)


def _log1pexp(a):
    return torch.log1p(torch.exp(a))


def _barker_sample(key, mean, grad, scale, metric):
    """A draw of the metric-aware Barker proposal centred at ``mean``: the
    increment's signs kept with probability ``sigmoid(c z)``, one Bernoulli
    per coordinate from ``split(key_flip, 1)[0]`` (the reference's one key a
    leaf)."""
    key_noise, key_flip = prng.split(key).unbind(-2)
    z = generate_gaussian_noise(key_noise, mean, sigma=scale)
    c = metric.scale(mean, grad, inv=False, trans=True)
    p = torch.exp(-_log1pexp(-c * z))
    leaf_key = prng.split(key_flip, 1)[..., 0, :]
    keep = prng.uniform(leaf_key, mean.shape[key.dim() - 1:], p.dtype) < p
    flipped = torch.where(keep, z, -z)
    return mean + metric.scale(mean, flipped, inv=False, trans=False)


def build_kernel():
    """The Barker Metropolis-Hastings kernel, with an optional metric."""

    def log_acceptance_ratio(state: BarkerState, proposal: BarkerState, metric: metrics.Metric):
        x, y = state.position, proposal.position
        y_minus_x = y - x
        x_minus_y = -y_minus_x
        z_xy = metric.scale(x, y_minus_x, inv=True, trans=True)
        z_yx = metric.scale(y, x_minus_y, inv=True, trans=True)
        c_xy = metric.scale(x, state.logdensity_grad, inv=False, trans=True)
        c_yx = metric.scale(y, proposal.logdensity_grad, inv=False, trans=True)
        sum_log1pexp_yx = _log1pexp(-z_yx * c_yx).sum(-1)
        sum_log1pexp_xy = _log1pexp(-z_xy * c_xy).sum(-1)
        # the n-fold kinetic term of the reference's broadcast-then-sum form
        n = x.shape[-1]
        ratio_proposal = (
            n * metric.kinetic_energy(x_minus_y, y)
            - sum_log1pexp_yx
            - n * metric.kinetic_energy(y_minus_x, x)
            + sum_log1pexp_xy
        )
        return proposal.logdensity - state.logdensity + ratio_proposal

    def kernel(
        rng_key: PRNGKey,
        state: BarkerState,
        logdensity_fn: Callable,
        step_size: float,
        inverse_mass_matrix=None,
    ) -> tuple[BarkerState, BarkerInfo]:
        position = state.position
        if inverse_mass_matrix is None:
            inverse_mass_matrix = torch.ones(
                position.shape[-1], dtype=position.dtype, device=position.device)
        metric = metrics.default_metric(inverse_mass_matrix)
        key_sample, key_accept = prng.split(chain_keys(rng_key, position)).unbind(-2)
        proposed_position = _barker_sample(
            key_sample, position, state.logdensity_grad, step_size, metric
        )
        proposed = BarkerState(proposed_position, *value_and_grad(logdensity_fn, proposed_position))
        log_p_accept = log_acceptance_ratio(state, proposed, metric)
        uniform = prng.uniform(key_accept, (), log_p_accept.dtype)
        accepted, (do_accept, p_accept, _) = static_binomial_sampling(
            uniform, log_p_accept, state, proposed
        )
        return accepted, BarkerInfo(p_accept, do_accept, proposed)

    return kernel


def as_top_level_api(
    logdensity_fn: Callable,
    step_size: float,
    inverse_mass_matrix: Optional[metrics.Metric] = None,
) -> SamplingAlgorithm:
    """``blackjax_tpu_torch.barker(...)``."""
    kernel = build_kernel()
    return build_sampling_algorithm(
        kernel, init, logdensity_fn, kernel_args=(step_size, inverse_mass_matrix)
    )

