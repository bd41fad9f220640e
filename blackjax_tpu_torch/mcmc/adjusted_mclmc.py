"""Metropolis-adjusted microcanonical Langevin Monte Carlo with a static
trajectory length (reference ``blackjax_tpu/mcmc/adjusted_mclmc.py``).

The energy change of the isokinetic flow, the kinetic changes summed along
the trajectory less the log density's change, takes the place of the
Hamiltonian's in the Metropolis-Hastings correction. One transition moves
every chain of a ``(C, d)`` block. Its randomness is a key per chain (a
``torch.Generator`` draws one key a chain first): split into the momentum
key and the trajectory key, and the trajectory key split again at every
step into that step's key and the next, per chain, as the reference's
loop carries it; the accept draws from the key the loop ends with. A step
count per chain ``(C,)`` runs a masked loop that freezes a chain's state,
kinetic sum and key past its count.
"""
import math
import warnings
from typing import Callable, Optional

import torch

from blackjax_tpu_torch import prng
from blackjax_tpu_torch.base import SamplingAlgorithm, build_sampling_algorithm
from blackjax_tpu_torch.mcmc import integrators
from blackjax_tpu_torch.mcmc.dynamic_hmc import rescale  # the reference defines it twice
from blackjax_tpu_torch.mcmc.hmc import HMCInfo, HMCState
from blackjax_tpu_torch.mcmc.proposal import static_binomial_sampling, tree_select
from blackjax_tpu_torch.types import ArrayLikeTree, PRNGKey
from blackjax_tpu_torch.util import (
    chain_keys,
    generate_unit_vector,
    require_tensor_position,
    value_and_grad,
)

__all__ = ["init", "build_kernel", "as_top_level_api", "adjusted_mclmc_proposal", "rescale"]


def init(position: ArrayLikeTree, logdensity_fn: Callable) -> HMCState:
    require_tensor_position(position, "adjusted_mclmc")
    logdensity, logdensity_grad = value_and_grad(logdensity_fn, position)
    return HMCState(position, logdensity, logdensity_grad)


def adjusted_mclmc_proposal(
    integrator: Callable,
    step_size,
    L_proposal_factor,
    num_integration_steps=1,
    divergence_threshold: float = 1000,
    *,
    sample_proposal: Callable = static_binomial_sampling,
    max_num_integration_steps: int = None,
) -> Callable:
    """Integrate the stochastic isokinetic dynamics ``num_integration_steps``
    times (an int, or one a chain) and Metropolis-accept the endpoint
    against the summed energy change; ``generate(rng_key, state)`` takes key
    words, one a chain."""

    def one_step(carry):
        state, kinetic_sum, rng_key = carry
        step_key, next_key = prng.split(rng_key).unbind(-2)
        next_state, dK = integrator(state, step_size, L_proposal_factor, step_key)
        return next_state, kinetic_sum + dK, next_key

    def generate(rng_key, state: integrators.IntegratorState):
        carry = (state, torch.zeros_like(state.logdensity), rng_key)
        if max_num_integration_steps is None and not torch.is_tensor(num_integration_steps):
            for _ in range(int(num_integration_steps)):
                carry = one_step(carry)
        else:
            trips = max_num_integration_steps
            if trips is None:
                trips = int(num_integration_steps.max())
            num = torch.as_tensor(num_integration_steps, device=state.logdensity.device)
            for i in range(int(trips)):
                carry = tree_select(num > i, one_step(carry), carry)
        end_state, kinetic_sum, rng_key = carry
        new_energy = -end_state.logdensity
        delta_energy = end_state.logdensity - state.logdensity - kinetic_sum
        delta_energy = torch.where(torch.isnan(delta_energy), -torch.inf, delta_energy)
        is_diverging = -delta_energy > divergence_threshold
        uniform = prng.uniform(rng_key, (), delta_energy.dtype)
        sampled, (do_accept, p_accept, other_info) = sample_proposal(
            uniform, delta_energy, state, end_state
        )
        info = HMCInfo(
            state.momentum,
            p_accept,
            do_accept,
            is_diverging,
            new_energy,
            end_state,
            num_integration_steps,
        )
        return sampled, info, other_info

    return generate


def build_kernel(
    integrator: Callable = integrators.isokinetic_mclachlan,
    divergence_threshold: float = 1000,
    max_integration_steps: int = None,
):
    """The adjusted MCLMC kernel, with a full momentum refresh a transition.
    ``max_integration_steps`` bounds the masked loop of per-chain step
    counts (by default their largest, read to the host)."""

    def kernel(
        rng_key: PRNGKey,
        state: HMCState,
        logdensity_fn: Callable,
        step_size: float,
        integration_steps_params: tuple = (1,),
        inverse_mass_matrix=1.0,
        L_proposal_factor: float = math.inf,
    ) -> tuple[HMCState, HMCInfo]:
        (num_integration_steps,) = integration_steps_params
        keys = chain_keys(rng_key, state.position)
        key_momentum, key_integrator = prng.split(keys).unbind(-2)
        momentum = generate_unit_vector(key_momentum, state.position)
        stochastic_integrator = integrators.with_isokinetic_maruyama(
            integrator(logdensity_fn, inverse_mass_matrix)
        )
        if isinstance(L_proposal_factor, (int, float)) and math.isinf(L_proposal_factor):
            L_proposal = math.inf  # no refresh, as inf * (n eps) is for n > 0
        else:
            n = num_integration_steps
            if torch.is_tensor(n):  # a count per chain, in the position's dtype
                n = n.to(state.position.dtype)
            L_proposal = L_proposal_factor * (n * step_size)
        generate = adjusted_mclmc_proposal(
            stochastic_integrator,
            step_size,
            L_proposal,
            num_integration_steps,
            divergence_threshold,
            max_num_integration_steps=max_integration_steps,
        )
        proposal, info, _ = generate(
            key_integrator,
            integrators.IntegratorState(
                state.position, momentum, state.logdensity, state.logdensity_grad
            ),
        )
        return HMCState(proposal.position, proposal.logdensity, proposal.logdensity_grad), info

    return kernel


def as_top_level_api(
    logdensity_fn: Callable,
    step_size: float,
    L_proposal_factor: float = math.inf,
    inverse_mass_matrix=1.0,
    *,
    divergence_threshold: int = 1000,
    integrator: Callable = integrators.isokinetic_mclachlan,
    num_integration_steps: Optional[int] = None,
    integration_steps_params: Optional[tuple] = None,
) -> SamplingAlgorithm:
    """``blackjax_tpu_torch.adjusted_mclmc(...)``."""
    if integration_steps_params is not None and num_integration_steps is not None:
        warnings.warn(
            "Both `num_integration_steps` and `integration_steps_params` "
            "given; using `integration_steps_params`.",
            DeprecationWarning,
            stacklevel=2,
        )
    if integration_steps_params is None:
        if num_integration_steps is None:
            raise ValueError("Provide `num_integration_steps` or `integration_steps_params`.")
        integration_steps_params = (num_integration_steps,)
    kernel = build_kernel(integrator=integrator, divergence_threshold=divergence_threshold)
    return build_sampling_algorithm(
        kernel,
        init,
        logdensity_fn,
        kernel_args=(step_size, integration_steps_params, inverse_mass_matrix, L_proposal_factor),
    )
