"""Data-tempered SMC: anneal by growing the observation set (reference
``blackjax_tpu/smc/partial_posteriors_path.py``).

Instead of tempering the likelihood exponent (``tempered.py``), the path of
intermediate distributions adds observations: a ``data_mask`` selects which
datapoints enter the likelihood, and each SMC step moves the cloud from the
posterior under the current mask to the one under the next. The
incremental importance weights are the log-posterior ratio of the two
masked targets, so the caller controls the annealing schedule entirely
through the masks it feeds to ``step``.
"""
from typing import Callable, NamedTuple, Optional

import torch

from blackjax_tpu_torch.base import SamplingAlgorithm
from blackjax_tpu_torch.smc.base import uniform_weights, update_and_take_last
from blackjax_tpu_torch.smc.from_mcmc import build_kernel as smc_from_mcmc
from blackjax_tpu_torch.types import Array, ArrayLikeTree, ArrayTree, PRNGKey

__all__ = ["PartialPosteriorsSMCState", "init", "build_kernel", "as_top_level_api"]


class PartialPosteriorsSMCState(NamedTuple):
    """Particles, weights, and the mask of active observations."""

    particles: ArrayTree
    weights: Array
    data_mask: Array


def init(particles: ArrayLikeTree, num_datapoints: int) -> PartialPosteriorsSMCState:
    weights = uniform_weights(particles)
    mask = torch.zeros(num_datapoints, dtype=weights.dtype, device=weights.device)
    return PartialPosteriorsSMCState(particles, weights, mask)


def build_kernel(
    mcmc_step_fn: Callable, mcmc_init_fn: Callable, resampling_fn: Callable,
    num_mcmc_steps: Optional[int], mcmc_parameters: ArrayTree,
    partial_logposterior_factory: Callable,
    update_strategy=update_and_take_last, batch_size: int = 0,
) -> Callable:
    """One data-tempering step toward the posterior under ``data_mask``.

    ``partial_logposterior_factory(mask) -> logposterior_fn`` builds the
    masked target; the mutation kernel targets the *new* mask while the
    incremental weights bridge from the old one.
    """
    mutate = smc_from_mcmc(
        mcmc_step_fn, mcmc_init_fn, resampling_fn, update_strategy, batch_size
    )

    def step(key, state: PartialPosteriorsSMCState, data_mask: Array):
        target = partial_logposterior_factory(data_mask)
        source = partial_logposterior_factory(state.data_mask)

        def bridge_weights(x):
            return target(x) - source(x)

        moved, info = mutate(
            key, state, num_mcmc_steps, mcmc_parameters, target, bridge_weights
        )
        return PartialPosteriorsSMCState(moved.particles, moved.weights, data_mask), info

    return step


def as_top_level_api(
    mcmc_step_fn: Callable, mcmc_init_fn: Callable, mcmc_parameters: dict,
    resampling_fn: Callable, num_mcmc_steps,
    partial_logposterior_factory: Callable,
    update_strategy=update_and_take_last, batch_size: int = 0,
) -> SamplingAlgorithm:
    """``blackjax_tpu_torch.partial_posteriors_smc(...)``."""
    kernel = build_kernel(
        mcmc_step_fn, mcmc_init_fn, resampling_fn, num_mcmc_steps,
        mcmc_parameters, partial_logposterior_factory, update_strategy,
        batch_size,
    )

    def init_fn(position: ArrayLikeTree, num_observations, rng_key=None):
        del rng_key
        return init(position, num_observations)

    def step_fn(key: PRNGKey, state: PartialPosteriorsSMCState, data_mask: Array):
        return kernel(key, state, data_mask)

    return SamplingAlgorithm(init_fn, step_fn)
