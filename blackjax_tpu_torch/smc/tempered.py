"""Tempered SMC: anneal from the prior to the posterior along
``p_lambda ∝ prior * exp(lambda * loglikelihood)`` (reference
``blackjax_tpu/smc/tempered.py``).

The tempering parameter is a 0-d tensor on the particles' device; a
caller's loop reads it to the host once per step, as the reference's does.
"""
from typing import Callable, NamedTuple, Optional, Union

import torch

from blackjax_tpu_torch.base import SamplingAlgorithm
from blackjax_tpu_torch.smc import base as smc_base
from blackjax_tpu_torch.smc import from_mcmc as smc_from_mcmc
from blackjax_tpu_torch.smc.base import update_and_take_last
from blackjax_tpu_torch.types import Array, ArrayLikeTree, PRNGKey

__all__ = ["TemperedSMCState", "init", "build_kernel", "as_top_level_api"]


class TemperedSMCState(NamedTuple):
    particles: ArrayLikeTree
    weights: Array
    tempering_param: Union[float, Array]


def init(particles: ArrayLikeTree) -> TemperedSMCState:
    weights = smc_base.uniform_weights(particles)
    return TemperedSMCState(particles, weights, torch.zeros_like(weights[0]))


def _annealed_target(logprior_fn, loglikelihood_fn, lam):
    """log p_lam = log prior + lam * loglik — the rejuvenation target."""

    def logdensity(position):
        return logprior_fn(position) + lam * loglikelihood_fn(position)

    return logdensity


def _weight_increment(loglikelihood_fn, delta):
    """Incremental importance log-weight for a tempering move of ``delta``."""

    def log_weight(position):
        return delta * loglikelihood_fn(position)

    return log_weight


def build_kernel(
    logprior_fn: Callable,
    loglikelihood_fn: Callable,
    mcmc_step_fn: Callable,
    mcmc_init_fn: Callable,
    resampling_fn: Callable,
    update_strategy: Callable = update_and_take_last,
    update_particles_fn: Optional[Callable] = None,
    batch_size: int = 0,
) -> Callable:
    """One tempering move from the current ``lambda`` to ``tempering_param``:
    incremental weights ``delta * loglik``, MCMC rejuvenation targeting
    ``prior + lambda * loglik``."""
    update_particles = (
        smc_from_mcmc.build_kernel(
            mcmc_step_fn, mcmc_init_fn, resampling_fn, update_strategy,
            batch_size=batch_size,
        )
        if update_particles_fn is None
        else update_particles_fn
    )

    def kernel(
        rng_key: PRNGKey,
        state: TemperedSMCState,
        num_mcmc_steps: int,
        tempering_param: Union[float, Array],
        mcmc_parameters: dict,
    ) -> tuple[TemperedSMCState, smc_base.SMCInfo]:
        lam = state.tempering_param
        delta = tempering_param - lam
        moved, info = update_particles(
            rng_key,
            state,
            num_mcmc_steps,
            mcmc_parameters,
            _annealed_target(logprior_fn, loglikelihood_fn, lam),
            _weight_increment(loglikelihood_fn, delta),
        )
        return TemperedSMCState(moved.particles, moved.weights, lam + delta), info

    return kernel


def as_top_level_api(
    logprior_fn: Callable,
    loglikelihood_fn: Callable,
    mcmc_step_fn: Callable,
    mcmc_init_fn: Callable,
    mcmc_parameters: dict,
    resampling_fn: Callable,
    num_mcmc_steps: Optional[int] = 10,
    update_strategy: Callable = update_and_take_last,
    update_particles_fn: Optional[Callable] = None,
    batch_size: int = 0,
) -> SamplingAlgorithm:
    """``blackjax_tpu_torch.tempered_smc(...)``; ``step(key, state, lam)``
    moves to the requested tempering parameter."""
    kernel = build_kernel(
        logprior_fn,
        loglikelihood_fn,
        mcmc_step_fn,
        mcmc_init_fn,
        resampling_fn,
        update_strategy,
        update_particles_fn,
        batch_size=batch_size,
    )

    def init_fn(position, rng_key=None):
        del rng_key
        return init(position)

    def step_fn(rng_key: PRNGKey, state, tempering_param):
        return kernel(rng_key, state, num_mcmc_steps, tempering_param, mcmc_parameters)

    return SamplingAlgorithm(init_fn, step_fn)
