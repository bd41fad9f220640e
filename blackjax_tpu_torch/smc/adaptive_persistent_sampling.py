"""Adaptive Persistent Sampling: the next tempering parameter is chosen so
the persistent ensemble's ESS hits a target, which may exceed 1 (reference
``blackjax_tpu/smc/adaptive_persistent_sampling.py``).

The root is found by ``root_solver`` (bisection, a host loop over the
device's ESS: :mod:`blackjax_tpu_torch.smc.solver`). The mixture
denominator of the persistent weights does not depend on the new tempering
parameter, so a step computes it once, and each bisection and the move's
weights at the chosen parameter evaluate only the new target against it;
the numbers are those of recomputing it.
"""
from typing import Callable, Union

import torch

from blackjax_tpu_torch.base import SamplingAlgorithm
from blackjax_tpu_torch.smc import persistent_sampling, solver
from blackjax_tpu_torch.smc.base import update_and_take_last
from blackjax_tpu_torch.types import Array, PRNGKey

__all__ = ["init", "build_kernel", "as_top_level_api"]

init = persistent_sampling.init


def build_kernel(
    logprior_fn: Callable,
    loglikelihood_fn: Callable,
    mcmc_step_fn: Callable,
    mcmc_init_fn: Callable,
    resampling_fn: Callable,
    target_ess: Union[float, Array],
    update_strategy: Callable = update_and_take_last,
    root_solver: Callable = solver.dichotomy,
    batch_size: int = 0,
) -> Callable:
    ps_kernel = persistent_sampling.build_kernel(
        logprior_fn=logprior_fn,
        loglikelihood_fn=loglikelihood_fn,
        mcmc_step_fn=mcmc_step_fn,
        mcmc_init_fn=mcmc_init_fn,
        resampling_fn=resampling_fn,
        update_strategy=update_strategy,
        batch_size=batch_size,
    )

    def calculate_lambda(state: persistent_sampling.PersistentSMCState, weight_fn) -> Array:
        logliks = state.persistent_log_likelihoods
        target_val = torch.log(torch.tensor(state.num_particles * target_ess,
                                            dtype=logliks.dtype, device=logliks.device))
        current = state.tempering_schedule[state.iteration]
        max_delta = 1.0 - current
        slot = state.iteration + 1

        def objective(delta):
            schedule = state.tempering_schedule.clone()
            schedule[slot] = current + delta
            log_weights, _ = weight_fn(logliks, state.persistent_log_Z, schedule, slot,
                                       normalize_to_one=True)
            ess_val = torch.log(persistent_sampling.compute_persistent_ess(log_weights))
            return ess_val - target_val

        # unsolvable -> delta 0: add a plain persistent iteration and retry
        delta = torch.nan_to_num(root_solver(objective, 0.0, max_delta))
        return current + torch.minimum(torch.maximum(delta, torch.zeros_like(delta)), max_delta)

    def kernel(rng_key: PRNGKey, state, num_mcmc_steps, mcmc_parameters: dict):
        # the mixture over the filled slots, for every weighting of this step
        slot = state.iteration + 1
        log_mix = persistent_sampling._log_mixture(
            state.persistent_log_likelihoods, state.persistent_log_Z,
            state.tempering_schedule, slot)

        def weight_fn(logliks, log_Z, schedule, iteration, normalize_to_one=False):
            return persistent_sampling._weights_from_mixture(
                log_mix, logliks, schedule, iteration, iteration, normalize_to_one)

        lmbda = calculate_lambda(state, weight_fn)
        return ps_kernel(rng_key, state, num_mcmc_steps, lmbda, mcmc_parameters,
                         weight_fn=weight_fn)

    return kernel


def as_top_level_api(
    logprior_fn: Callable,
    loglikelihood_fn: Callable,
    n_schedule,
    mcmc_step_fn: Callable,
    mcmc_init_fn: Callable,
    mcmc_parameters: dict,
    resampling_fn: Callable,
    target_ess: float,
    num_mcmc_steps: int = 10,
    update_strategy: Callable = update_and_take_last,
    root_solver: Callable = solver.dichotomy,
    batch_size: int = 0,
) -> SamplingAlgorithm:
    """``blackjax_tpu_torch.adaptive_persistent_sampling_smc(...)``."""
    kernel = build_kernel(
        logprior_fn,
        loglikelihood_fn,
        mcmc_step_fn,
        mcmc_init_fn,
        resampling_fn,
        target_ess,
        update_strategy,
        root_solver,
        batch_size,
    )

    def init_fn(position, rng_key=None):
        del rng_key
        return init(position, loglikelihood_fn, n_schedule, batch_size)

    def step_fn(rng_key: PRNGKey, state):
        return kernel(rng_key, state, num_mcmc_steps, mcmc_parameters)

    return SamplingAlgorithm(init_fn, step_fn)
