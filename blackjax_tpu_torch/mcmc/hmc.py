"""Hamiltonian Monte Carlo with a static trajectory length (reference
``blackjax_tpu/mcmc/hmc.py``).

One transition: draw the momentum from the metric, integrate the
Hamiltonian flow for a fixed number of leapfrog steps, then
Metropolis-accept the momentum-flipped endpoint. The kernel moves every
chain of a ``(C, d)`` block at once. Its randomness is a key per chain
(:mod:`blackjax_tpu_torch.prng`), split into the momentum key and the
accept key as the reference splits it, so the port draws what the
reference draws from the same keys (SMC moves its particles so); or a
``torch.Generator``, from which it draws the momentum first and then the
accept uniforms. The proposal itself takes the uniforms, so that a test
can hand it the reference's.

Ported: the endpoint proposal. ``multinomial_hmc_proposal`` and traced
per-chain step counts (``max_num_integration_steps``) come with a later
slice (ROADMAP queue 1, item 3).
"""
from typing import Callable, NamedTuple

import torch

from blackjax_tpu_torch import prng
from blackjax_tpu_torch.base import SamplingAlgorithm, build_sampling_algorithm
from blackjax_tpu_torch.mcmc import integrators, metrics, trajectory
from blackjax_tpu_torch.mcmc.proposal import safe_energy_diff, static_binomial_sampling
from blackjax_tpu_torch.mcmc.trajectory import hmc_energy
from blackjax_tpu_torch.types import ArrayLikeTree, ArrayTree, PRNGKey
from blackjax_tpu_torch.util import value_and_grad

__all__ = [
    "HMCState",
    "HMCInfo",
    "init",
    "build_kernel",
    "as_top_level_api",
    "hmc_proposal",
    "flip_momentum",
]


class HMCState(NamedTuple):
    """Positions of every chain plus their cached logdensity and gradient."""

    position: ArrayTree
    logdensity: ArrayTree
    logdensity_grad: ArrayTree


class HMCInfo(NamedTuple):
    """Per-transition diagnostics."""

    momentum: ArrayTree
    acceptance_rate: ArrayTree
    is_accepted: ArrayTree
    is_divergent: ArrayTree
    energy: ArrayTree
    proposal: integrators.IntegratorState
    num_integration_steps: ArrayTree


def init(position: ArrayLikeTree, logdensity_fn: Callable) -> HMCState:
    """State of ``(C, d)`` positions (or one ``(d,)`` position);
    ``logdensity_fn`` maps ``(..., d)`` to ``(...)``."""
    logdensity, logdensity_grad = value_and_grad(logdensity_fn, position)
    return HMCState(position, logdensity, logdensity_grad)


def flip_momentum(state: integrators.IntegratorState) -> integrators.IntegratorState:
    """Negate the endpoint momentum, which makes the proposal map an
    involution: the requirement for detailed balance."""
    return state._replace(momentum=-state.momentum)


def build_kernel(
    integrator: Callable = integrators.velocity_verlet,
    divergence_threshold: float = 1000,
    build_proposal: Callable = None,
):
    """The HMC kernel: momentum refresh, trajectory, proposal rule.

    ``step_size``, ``inverse_mass_matrix`` and ``num_integration_steps``
    are per-call arguments, so adaptation can retune them."""
    propose = hmc_proposal if build_proposal is None else build_proposal

    def kernel(
        rng_key: PRNGKey,
        state: HMCState,
        logdensity_fn: Callable,
        step_size: float,
        inverse_mass_matrix,
        num_integration_steps: int,
    ) -> tuple[HMCState, HMCInfo]:
        metric = metrics.default_metric(inverse_mass_matrix)
        generate = propose(
            integrator(logdensity_fn, metric.kinetic_energy),
            metric.kinetic_energy,
            step_size,
            num_integration_steps,
            divergence_threshold,
        )
        position = state.position
        if isinstance(rng_key, torch.Generator):
            momentum = metric.sample_momentum(rng_key, position)
            uniform = torch.rand(
                position.shape[:-1], generator=rng_key, dtype=position.dtype,
                device=position.device,
            )
        else:
            key_momentum, key_accept = prng.split(rng_key.to(position.device)).unbind(-2)
            momentum = metric.sample_momentum(key_momentum, position)
            # bernoulli(key_accept, p_accept): a uniform in p_accept's dtype below it
            uniform = prng.uniform(key_accept, (), position.dtype)
        head = integrators.IntegratorState(
            position, momentum, state.logdensity, state.logdensity_grad
        )
        landed, info, _ = generate(uniform, head)
        return HMCState(landed.position, landed.logdensity, landed.logdensity_grad), info

    return kernel


def hmc_proposal(
    integrator: Callable,
    kinetic_energy: Callable,
    step_size,
    num_integration_steps: int = 1,
    divergence_threshold: float = 1000,
    *,
    sample_proposal: Callable = static_binomial_sampling,
) -> Callable:
    """Endpoint HMC: the proposal is the momentum-flipped end of the
    trajectory, accepted with probability ``min(1, exp(H(z0) - H(z1)))``.

    Returns ``generate(uniform, head) -> (state, info, extra)``, where
    ``uniform`` holds the accept draws ``U[0, 1)``, one per chain (the
    reference's ``generate`` takes the key they come from)."""
    roll_forward = trajectory.static_integration(integrator)
    total_energy = hmc_energy(kinetic_energy)

    def generate(uniform, head: integrators.IntegratorState):
        tail = flip_momentum(roll_forward(head, step_size, num_integration_steps))
        h_tail = total_energy(tail)
        energy_drop = safe_energy_diff(total_energy(head), h_tail)
        landed, (accepted, p_accept, extra) = sample_proposal(
            uniform, energy_drop, head, tail
        )
        info = HMCInfo(
            head.momentum,
            p_accept,
            accepted,
            -energy_drop > divergence_threshold,
            h_tail,
            tail,
            num_integration_steps,
        )
        return landed, info, extra

    return generate


def as_top_level_api(
    logdensity_fn: Callable,
    step_size: float,
    inverse_mass_matrix,
    num_integration_steps: int,
    *,
    divergence_threshold: int = 1000,
    integrator: Callable = integrators.velocity_verlet,
    build_proposal: Callable = None,
) -> SamplingAlgorithm:
    """``blackjax_tpu_torch.hmc(...)``: the kernel over fixed tunables."""
    kernel = build_kernel(integrator, divergence_threshold, build_proposal)
    metric = metrics.default_metric(inverse_mass_matrix)
    return build_sampling_algorithm(
        kernel,
        init,
        logdensity_fn,
        kernel_args=(step_size, metric, num_integration_steps),
    )
