"""Hamiltonian Monte Carlo with a static trajectory length (reference
``blackjax_tpu/mcmc/hmc.py``).

One transition: draw the momentum from the metric, integrate the
Hamiltonian flow for a fixed number of leapfrog steps, then either
Metropolis-accept the momentum-flipped endpoint (classic HMC) or draw one
state of the whole trajectory in proportion to ``exp(-H)`` (multinomial
HMC). The kernel moves every chain of a ``(C, d)`` block at once. Its
randomness is a key per chain (:mod:`blackjax_tpu_torch.prng`), split into
the momentum key and the proposal key as the reference splits it, so the
port draws what the reference draws from the same keys (SMC moves its
particles so); or a ``torch.Generator``, from which it draws the momentum
first and then the proposal's uniforms. The step count is an int, or one
per chain ``(C,)`` run by the masked loop of
:func:`blackjax_tpu_torch.mcmc.trajectory.static_integration` (dynamic HMC
draws it so).

A proposal's ``generate(rng_key, head)`` takes the proposal key: key words,
a generator, or the draws themselves as a floating tensor, one a chain (a
test hands in the reference's accept uniforms; GHMC its slice variable).
"""
from typing import Callable, NamedTuple

import torch

from blackjax_tpu_torch import prng
from blackjax_tpu_torch.base import SamplingAlgorithm, build_sampling_algorithm
from blackjax_tpu_torch.mcmc import integrators, metrics, trajectory
from blackjax_tpu_torch.mcmc.proposal import safe_energy_diff, static_binomial_sampling
from blackjax_tpu_torch.mcmc.trajectory import hmc_energy
from blackjax_tpu_torch.types import ArrayLikeTree, ArrayTree, PRNGKey
from blackjax_tpu_torch.util import require_tensor_position, value_and_grad

__all__ = [
    "HMCState",
    "HMCInfo",
    "init",
    "build_kernel",
    "as_top_level_api",
    "hmc_proposal",
    "multinomial_hmc_proposal",
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
    require_tensor_position(position, "hmc")
    logdensity, logdensity_grad = value_and_grad(logdensity_fn, position)
    return HMCState(position, logdensity, logdensity_grad)


def flip_momentum(state: integrators.IntegratorState) -> integrators.IntegratorState:
    """Negate the endpoint momentum, which makes the proposal map an
    involution: the requirement for detailed balance."""
    return state._replace(momentum=-state.momentum)


def _accept_draws(rng_key, like: torch.Tensor) -> torch.Tensor:
    """The accept uniforms ``U[0, 1)`` of ``bernoulli(rng_key, p)``, one a
    chain, in ``like``'s dtype (``p``'s): from key words, from a generator,
    or ``rng_key`` itself where it already holds the draws (a floating
    tensor)."""
    if isinstance(rng_key, torch.Generator):
        return torch.rand(like.shape, generator=rng_key, dtype=like.dtype, device=like.device)
    if rng_key.is_floating_point():
        return rng_key
    return prng.uniform(rng_key.to(like.device), (), like.dtype)


def build_kernel(
    integrator: Callable = integrators.velocity_verlet,
    divergence_threshold: float = 1000,
    build_proposal: Callable = None,
    max_num_integration_steps: int = None,
):
    """The HMC kernel: momentum refresh, trajectory, proposal rule.

    ``step_size``, ``inverse_mass_matrix`` and ``num_integration_steps``
    are per-call arguments, so adaptation can retune them.
    ``max_num_integration_steps`` bounds the masked loop of per-chain step
    counts."""
    propose = hmc_proposal if build_proposal is None else build_proposal
    propose_kwargs = {}
    if max_num_integration_steps is not None:
        propose_kwargs["max_num_integration_steps"] = max_num_integration_steps

    def kernel(
        rng_key: PRNGKey,
        state: HMCState,
        logdensity_fn: Callable,
        step_size: float,
        inverse_mass_matrix,
        num_integration_steps,
    ) -> tuple[HMCState, HMCInfo]:
        metric = metrics.default_metric(inverse_mass_matrix)
        generate = propose(
            integrator(logdensity_fn, metric.kinetic_energy),
            metric.kinetic_energy,
            step_size,
            num_integration_steps,
            divergence_threshold,
            **propose_kwargs,
        )
        position = state.position
        if isinstance(rng_key, torch.Generator):
            key_momentum = key_propose = rng_key
        else:
            key_momentum, key_propose = prng.split(rng_key.to(position.device)).unbind(-2)
        head = integrators.IntegratorState(
            position, metric.sample_momentum(key_momentum, position), state.logdensity,
            state.logdensity_grad,
        )
        landed, info, _ = generate(key_propose, head)
        return HMCState(landed.position, landed.logdensity, landed.logdensity_grad), info

    return kernel


def hmc_proposal(
    integrator: Callable,
    kinetic_energy: Callable,
    step_size,
    num_integration_steps=1,
    divergence_threshold: float = 1000,
    *,
    sample_proposal: Callable = static_binomial_sampling,
    max_num_integration_steps: int = None,
) -> Callable:
    """Endpoint HMC: the proposal is the momentum-flipped end of the
    trajectory, accepted with probability ``min(1, exp(H(z0) - H(z1)))``.

    Returns ``generate(rng_key, head) -> (state, info, extra)``; the accept
    draws come from ``rng_key`` (see :func:`_accept_draws`), and
    ``sample_proposal`` gets them in the reference's key slot."""
    roll_forward = trajectory.static_integration(integrator)
    total_energy = hmc_energy(kinetic_energy)

    def generate(rng_key, head: integrators.IntegratorState):
        tail = flip_momentum(
            roll_forward(head, step_size, num_integration_steps, max_num_integration_steps)
        )
        h_tail = total_energy(tail)
        energy_drop = safe_energy_diff(total_energy(head), h_tail)
        landed, (accepted, p_accept, extra) = sample_proposal(
            _accept_draws(rng_key, energy_drop), energy_drop, head, tail
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


def multinomial_hmc_proposal(
    integrator: Callable,
    kinetic_energy: Callable,
    step_size,
    num_integration_steps=1,
    divergence_threshold: float = 1000,
) -> Callable:
    """Multinomial HMC: draw one state of the whole trajectory with weight
    ``exp(-H)`` by progressive reservoir sampling (reference ``hmc.py:174``).
    There is no rejection step, so ``is_accepted`` is identically True, and
    ``acceptance_rate`` is the trajectory's mean ``min(1, exp(-dH))``."""
    sample_trajectory = trajectory.static_progressive_integration(
        integrator, kinetic_energy, num_integration_steps, divergence_threshold
    )

    def generate(rng_key, head: integrators.IntegratorState):
        reservoir, diverged = sample_trajectory(rng_key, head, step_size)
        info = HMCInfo(
            momentum=head.momentum,
            acceptance_rate=torch.exp(reservoir.sum_log_p_accept) / num_integration_steps,
            is_accepted=torch.ones_like(diverged),
            is_divergent=diverged,
            energy=reservoir.energy,
            proposal=reservoir.state,
            num_integration_steps=num_integration_steps,
        )
        return reservoir.state, info, None

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
