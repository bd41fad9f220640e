"""Metropolis-adjusted MCLMC with a trajectory length drawn afresh at every
transition (reference ``blackjax_tpu/mcmc/adjusted_mclmc_dynamic.py``).

A lift of the static kernel (:mod:`blackjax_tpu_torch.mcmc.adjusted_mclmc`)
through :func:`blackjax_tpu_torch.mcmc.dynamic_hmc.lift_drawn_steps`: each
chain draws its step count from its carried argument (a key or a Halton
index), runs the masked fixed-length kernel and advances the argument.
"""
import math
from typing import Callable

import torch

from blackjax_tpu_torch import prng
from blackjax_tpu_torch.base import SamplingAlgorithm, build_sampling_algorithm
from blackjax_tpu_torch.mcmc import integrators
from blackjax_tpu_torch.mcmc.adjusted_mclmc import build_kernel as build_static_kernel
from blackjax_tpu_torch.mcmc.dynamic_hmc import (
    DynamicHMCState,
    _fresh_key,
    _uniform_steps,
    halton_sequence,
    lift_drawn_steps,
    rescale,
)
from blackjax_tpu_torch.mcmc.dynamic_hmc import init as _dynamic_init
from blackjax_tpu_torch.types import Array, ArrayLikeTree, PRNGKey

__all__ = [
    "init",
    "build_kernel",
    "as_top_level_api",
    "trajectory_length",
    "make_random_trajectory_length_fn",
]


def init(
    position: ArrayLikeTree, logdensity_fn: Callable, random_generator_arg
) -> DynamicHMCState:
    """As :func:`blackjax_tpu_torch.mcmc.dynamic_hmc.init`."""
    return _dynamic_init(position, logdensity_fn, random_generator_arg)


def build_kernel(
    integration_steps_fn: Callable = _uniform_steps,
    integrator: Callable = integrators.isokinetic_mclachlan,
    divergence_threshold: float = 1000,
    next_random_arg_fn: Callable = _fresh_key,
    max_integration_steps: int = None,
):
    """Adjusted MCLMC whose step count each chain redraws every transition;
    ``max_integration_steps`` bounds the masked loop."""
    static_kernel = build_static_kernel(
        integrator=integrator,
        divergence_threshold=divergence_threshold,
        max_integration_steps=max_integration_steps,
    )

    def kernel(
        rng_key: PRNGKey,
        state: DynamicHMCState,
        logdensity_fn: Callable,
        step_size: float,
        L_proposal_factor: float = math.inf,
        inverse_mass_matrix=1.0,
        integration_steps_params: tuple = (),
    ):
        def stepped(key, chain, n):
            return static_kernel(
                key, chain, logdensity_fn, step_size, (n,), inverse_mass_matrix, L_proposal_factor
            )

        lifted = lift_drawn_steps(stepped, integration_steps_fn, next_random_arg_fn)
        return lifted(rng_key, state, integration_steps_params)

    return kernel


def as_top_level_api(
    logdensity_fn: Callable,
    step_size: float,
    L_proposal_factor: float = math.inf,
    inverse_mass_matrix=1.0,
    *,
    divergence_threshold: int = 1000,
    integrator: Callable = integrators.isokinetic_mclachlan,
    next_random_arg_fn: Callable = _fresh_key,
    integration_steps_fn: Callable = _uniform_steps,
    integration_steps_params: tuple = (),
    max_integration_steps: int = None,
) -> SamplingAlgorithm:
    """``blackjax_tpu_torch.adjusted_mclmc_dynamic(...)``; ``init(position,
    rng_key)``."""
    kernel = build_kernel(
        integration_steps_fn=integration_steps_fn, integrator=integrator,
        next_random_arg_fn=next_random_arg_fn,
        divergence_threshold=divergence_threshold,
        max_integration_steps=max_integration_steps,
    )
    return build_sampling_algorithm(
        kernel, init, logdensity_fn,
        kernel_args=(step_size, L_proposal_factor, inverse_mass_matrix,
                     integration_steps_params),
        pass_rng_key_to_init=True,
    )


def trajectory_length(t, mu):
    """A Halton quasi-random trajectory length of mean ``mu``, one per
    element of ``t``."""
    return torch.round(0.5 + halton_sequence(t).double() * rescale(mu))


def make_random_trajectory_length_fn(random_trajectory_length: bool) -> Callable:
    """``(random_generator_arg, avg_num_integration_steps) -> (C,) int32``:
    a uniformly jittered step count of the requested mean per chain (a
    uniform of each chain's key, in float64, the counterpart of JAX's
    default float under x64), or the ceiling of the mean."""
    if random_trajectory_length:
        def integration_steps_fn(key: Array, avg_num_integration_steps):
            jittered = prng.uniform(key, (), torch.float64) * rescale(avg_num_integration_steps)
            return torch.clamp(torch.ceil(jittered), min=1).to(torch.int32)
    else:
        def integration_steps_fn(key: Array, avg_num_integration_steps):
            n = max(math.ceil(float(avg_num_integration_steps)), 1)
            return torch.full(key.shape[:-1], n, dtype=torch.int32, device=key.device)
    return integration_steps_fn
