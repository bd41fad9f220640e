"""Inner-kernel tuning for SMC: between outer steps, re-tune the mutation
kernel's parameters from the current particle cloud (reference
``blackjax_tpu/smc/inner_kernel_tuning.py``).

The wrapped SMC algorithm runs one step with the live parameter override;
afterwards ``mcmc_parameter_update_fn(key, state, info)`` derives the next
override from the new particles (e.g. a mass matrix from the particle
covariance, a random-walk scale from the acceptance rate — see
:mod:`blackjax_tpu_torch.smc.tuning`). Parameter values carry a leading
particle axis; a length-1 axis means the value is shared across particles
(:func:`blackjax_tpu_torch.smc.base.extend_params`).
"""
from typing import Callable, NamedTuple

from blackjax_tpu_torch import prng
from blackjax_tpu_torch.base import SamplingAlgorithm
from blackjax_tpu_torch.smc.base import SMCInfo
from blackjax_tpu_torch.types import ArrayTree, PRNGKey

__all__ = ["StateWithParameterOverride", "init", "build_kernel", "as_top_level_api"]


class StateWithParameterOverride(NamedTuple):
    """Inner SMC state plus the live parameter-override dict."""

    sampler_state: ArrayTree
    parameter_override: dict


def init(alg_init_fn, position, initial_parameter_value):
    return StateWithParameterOverride(alg_init_fn(position), initial_parameter_value)


def _instantiate(smc_algorithm, fixed_kwargs: dict, mcmc_parameters):
    """Construct the wrapped SMC algorithm with the given live parameters."""
    return smc_algorithm(mcmc_parameters=mcmc_parameters, **fixed_kwargs)


def _fixed_kwargs(logprior_fn, loglikelihood_fn, mcmc_step_fn, mcmc_init_fn,
                  resampling_fn, num_mcmc_steps, extra_parameters) -> dict:
    return dict(
        logprior_fn=logprior_fn,
        loglikelihood_fn=loglikelihood_fn,
        mcmc_step_fn=mcmc_step_fn,
        mcmc_init_fn=mcmc_init_fn,
        resampling_fn=resampling_fn,
        num_mcmc_steps=num_mcmc_steps,
        **extra_parameters,
    )


def build_kernel(
    smc_algorithm, logprior_fn: Callable, loglikelihood_fn: Callable,
    mcmc_step_fn: Callable, mcmc_init_fn: Callable, resampling_fn: Callable,
    mcmc_parameter_update_fn: Callable, num_mcmc_steps: int = 10,
    smc_returns_state_with_parameter_override: bool = False,
    **extra_parameters,
) -> Callable:
    """One tuned outer step.

    When the wrapped algorithm itself returns a
    :class:`StateWithParameterOverride` (pretuning composition), the fresh
    override is merged into the returned dict instead of replacing it.
    """
    fixed_kwargs = _fixed_kwargs(logprior_fn, loglikelihood_fn, mcmc_step_fn, mcmc_init_fn,
                                 resampling_fn, num_mcmc_steps, extra_parameters)
    nests_override = smc_returns_state_with_parameter_override

    def kernel(
        rng_key: PRNGKey, state: StateWithParameterOverride, **extra_step_parameters
    ) -> tuple[StateWithParameterOverride, SMCInfo]:
        algorithm = _instantiate(smc_algorithm, fixed_kwargs, state.parameter_override)
        key_tune, key_move = prng.split(rng_key)
        inner = state if nests_override else state.sampler_state
        moved, info = algorithm.step(key_move, inner, **extra_step_parameters)
        override = mcmc_parameter_update_fn(key_tune, moved, info)
        if nests_override:
            retuned = StateWithParameterOverride(
                moved.sampler_state, moved.parameter_override | override
            )
        else:
            retuned = StateWithParameterOverride(moved, override)
        return retuned, info

    return kernel


def as_top_level_api(
    smc_algorithm, logprior_fn: Callable, loglikelihood_fn: Callable,
    mcmc_step_fn: Callable, mcmc_init_fn: Callable, resampling_fn: Callable,
    mcmc_parameter_update_fn: Callable, initial_parameter_value,
    num_mcmc_steps: int = 10,
    smc_returns_state_with_parameter_override: bool = False,
    **extra_parameters,
) -> SamplingAlgorithm:
    """``blackjax_tpu_torch.inner_kernel_tuning(...)``."""
    fixed_kwargs = _fixed_kwargs(logprior_fn, loglikelihood_fn, mcmc_step_fn, mcmc_init_fn,
                                 resampling_fn, num_mcmc_steps, extra_parameters)
    kernel = build_kernel(
        smc_algorithm, logprior_fn, loglikelihood_fn, mcmc_step_fn,
        mcmc_init_fn, resampling_fn, mcmc_parameter_update_fn, num_mcmc_steps,
        smc_returns_state_with_parameter_override, **extra_parameters,
    )

    def init_fn(position, rng_key=None):
        del rng_key
        algorithm = _instantiate(smc_algorithm, fixed_kwargs, initial_parameter_value)
        return init(algorithm.init, position, initial_parameter_value)

    def step_fn(rng_key: PRNGKey, state, **extra_step_parameters):
        return kernel(rng_key, state, **extra_step_parameters)

    return SamplingAlgorithm(init_fn, step_fn)
