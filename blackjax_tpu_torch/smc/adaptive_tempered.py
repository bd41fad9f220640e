"""Adaptive tempered SMC: the next tempering increment is chosen so the
incremental weights keep a target effective sample size (reference
``blackjax_tpu/smc/adaptive_tempered.py``).

A step solves for the increment with ``root_solver`` (bisection, a host
loop over the device's ESS: :mod:`blackjax_tpu_torch.smc.solver`), then
runs the tempered kernel to the new parameter.
"""
from typing import Any, Callable, Union

import torch

from blackjax_tpu_torch.base import SamplingAlgorithm
from blackjax_tpu_torch.smc import base as smc_base
from blackjax_tpu_torch.smc import ess, solver, tempered
from blackjax_tpu_torch.types import Array, PRNGKey

__all__ = ["init", "build_kernel", "as_top_level_api"]

init = tempered.init


def build_kernel(
    logprior_fn: Callable,
    loglikelihood_fn: Callable,
    mcmc_step_fn: Callable,
    mcmc_init_fn: Callable,
    resampling_fn: Callable,
    target_ess: Union[float, Array],
    root_solver: Callable = solver.dichotomy,
    batch_size: int = 0,
    **extra_parameters: Any,
) -> Callable:
    batched_loglikelihood = smc_base.map_fn(loglikelihood_fn, batch_size)

    def compute_delta(state: tempered.TemperedSMCState):
        max_delta = 1.0 - state.tempering_param
        delta = ess.ess_solver(
            batched_loglikelihood, state.particles, target_ess, max_delta, root_solver
        )
        # clip(delta, 0, max_delta), NaN passing through as in the reference
        return torch.minimum(torch.maximum(delta, torch.zeros_like(delta)), max_delta)

    tempered_kernel = tempered.build_kernel(
        logprior_fn,
        loglikelihood_fn,
        mcmc_step_fn,
        mcmc_init_fn,
        resampling_fn,
        batch_size=batch_size,
        **extra_parameters,
    )

    def kernel(rng_key: PRNGKey, state, num_mcmc_steps, mcmc_parameters: dict):
        tempering_param = state.tempering_param + compute_delta(state)
        return tempered_kernel(
            rng_key, state, num_mcmc_steps, tempering_param, mcmc_parameters
        )

    return kernel


def as_top_level_api(
    logprior_fn: Callable,
    loglikelihood_fn: Callable,
    mcmc_step_fn: Callable,
    mcmc_init_fn: Callable,
    mcmc_parameters: dict,
    resampling_fn: Callable,
    target_ess: float,
    root_solver: Callable = solver.dichotomy,
    num_mcmc_steps: int = 10,
    batch_size: int = 0,
    **extra_parameters: Any,
) -> SamplingAlgorithm:
    """``blackjax_tpu_torch.adaptive_tempered_smc(...)``."""
    kernel = build_kernel(
        logprior_fn,
        loglikelihood_fn,
        mcmc_step_fn,
        mcmc_init_fn,
        resampling_fn,
        target_ess,
        root_solver,
        batch_size=batch_size,
        **extra_parameters,
    )

    def init_fn(position, rng_key=None):
        del rng_key
        return init(position)

    def step_fn(rng_key: PRNGKey, state):
        return kernel(rng_key, state, num_mcmc_steps, mcmc_parameters)

    return SamplingAlgorithm(init_fn, step_fn)
