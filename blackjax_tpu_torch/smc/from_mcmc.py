"""Bridge from MCMC kernels to the SMC particle-update interface (reference
``blackjax_tpu/smc/from_mcmc.py``).

Parameters whose leading axis has length 1 are shared across all particles
(bound into the step function); others are per-particle, ``(n, ...)``, and
handed to the kernel beside the particles.
"""
from functools import partial
from typing import Callable

from blackjax_tpu_torch.smc import base as smc_base
from blackjax_tpu_torch.smc.base import SMCState, map_fn, update_and_take_last
from blackjax_tpu_torch.types import PRNGKey

__all__ = ["unshared_parameters_and_step_fn", "build_kernel"]


def unshared_parameters_and_step_fn(mcmc_parameters: dict, mcmc_step_fn: Callable):
    """Split parameters into (per-particle dict, step_fn with shared params
    bound)."""
    shared, unshared = {}, {}
    for name, value in mcmc_parameters.items():
        if value.shape[0] == 1:
            shared[name] = value[0, ...]
        else:
            unshared[name] = value
    return unshared, partial(mcmc_step_fn, **shared)


def build_kernel(
    mcmc_step_fn: Callable,
    mcmc_init_fn: Callable,
    resampling_fn: Callable,
    update_strategy: Callable = update_and_take_last,
    batch_size: int = 0,
) -> Callable:
    """Adapt an ``(init, step)`` MCMC pair into an SMC particle-update step."""

    def step(
        rng_key: PRNGKey,
        state,
        num_mcmc_steps: int,
        mcmc_parameters: dict,
        logposterior_fn: Callable,
        log_weights_fn: Callable,
    ):
        unshared, shared_step_fn = unshared_parameters_and_step_fn(
            mcmc_parameters, mcmc_step_fn
        )
        update_fn, num_resampled = update_strategy(
            mcmc_init_fn,
            logposterior_fn,
            shared_step_fn,
            n_particles=state.weights.shape[0],
            num_mcmc_steps=num_mcmc_steps,
            **({"batch_size": batch_size} if batch_size else {}),
        )
        weight_fn = map_fn(log_weights_fn, batch_size)
        return smc_base.step(
            rng_key,
            SMCState(state.particles, state.weights, unshared),
            update_fn,
            weight_fn,
            resampling_fn,
            num_resampled,
        )

    return step
