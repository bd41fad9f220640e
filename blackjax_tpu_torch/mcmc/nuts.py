"""No-U-Turn Sampler, iterative and multinomial (reference
``blackjax_tpu/mcmc/nuts.py``).

The kernel moves every chain of a ``(C, d)`` batch one transition, on the
flattened engine :func:`blackjax_tpu_torch.mcmc.trajectory.flattened_nuts`.
The nested engine and the continuous runner ``build_fused_many_steps`` come
with later slices; the in-kernel machine is
:func:`blackjax_tpu_torch.ops.fused_nuts_dc.fused_nuts_run_dc`.
"""
from typing import Callable, NamedTuple

import torch

from blackjax_tpu_torch.base import SamplingAlgorithm, build_sampling_algorithm
from blackjax_tpu_torch.mcmc import hmc, integrators, metrics, trajectory
from blackjax_tpu_torch.types import ArrayTree, PRNGKey

__all__ = ["NUTSInfo", "init", "build_kernel", "as_top_level_api"]


init = hmc.init


class NUTSInfo(NamedTuple):
    """Per-transition diagnostics, one entry per chain."""

    momentum: ArrayTree
    is_divergent: ArrayTree
    is_turning: ArrayTree
    energy: ArrayTree
    trajectory_leftmost_state: integrators.IntegratorState
    trajectory_rightmost_state: integrators.IntegratorState
    num_trajectory_expansions: ArrayTree
    num_integration_steps: ArrayTree
    acceptance_rate: ArrayTree


def iterative_nuts_proposal(
    integrator: Callable,
    kinetic_energy: Callable,
    uturn_check_fn: Callable,
    max_num_expansions: int = 10,
    divergence_threshold: float = 1000,
    *,
    engine: str = "flattened",
    batched_uturn_check_fn: Callable = None,
) -> Callable:
    """The NUTS proposal: trajectory doubling with multinomial progressive
    sampling and checkpointed U-turn termination (reference ``nuts.py:50``)."""
    if engine == "nested":
        raise NotImplementedError("the nested NUTS engine is not ported yet")
    if engine != "flattened":
        raise ValueError(f"Unknown NUTS engine {engine!r}; use 'flattened' or 'nested'.")
    flat_propose = trajectory.flattened_nuts(
        integrator,
        kinetic_energy,
        uturn_check_fn,
        max_num_expansions,
        divergence_threshold,
        batched_uturn_check_fn=batched_uturn_check_fn,
    )

    def propose(rng_key, initial_state: integrators.IntegratorState, step_size):
        state, info = flat_propose(rng_key, initial_state, step_size)
        proposal, left, right, _, num_states, depth, is_diverging, is_turning = info
        acceptance_rate = torch.exp(proposal.sum_log_p_accept) / num_states.clamp(min=1)
        return state, NUTSInfo(
            initial_state.momentum,
            is_diverging,
            is_turning,
            proposal.energy,
            left,
            right,
            depth,
            num_states,
            acceptance_rate,
        )

    return propose


def build_kernel(
    integrator: Callable = integrators.velocity_verlet,
    divergence_threshold: int = 1000,
    *,
    engine: str = "flattened",
    batched_uturn: bool = False,
):
    """Build the NUTS kernel (reference ``nuts.py:164``).
    ``batched_uturn=True`` takes the metric's distributive-matvec slot check
    instead of the per-slot loop."""

    def kernel(
        rng_key: PRNGKey,
        state: hmc.HMCState,
        logdensity_fn: Callable,
        step_size: float,
        inverse_mass_matrix,
        max_num_doublings: int = 10,
    ) -> tuple[hmc.HMCState, NUTSInfo]:
        metric = metrics.default_metric(inverse_mass_matrix)
        symplectic_integrator = integrator(logdensity_fn, metric.kinetic_energy)
        proposal_generator = iterative_nuts_proposal(
            symplectic_integrator,
            metric.kinetic_energy,
            metric.check_turning,
            max_num_doublings,
            divergence_threshold,
            engine=engine,
            batched_uturn_check_fn=(
                metric.check_turning_batched if batched_uturn else None
            ),
        )
        position, logdensity, logdensity_grad = state
        momentum = metric.sample_momentum(rng_key, position)
        integrator_state = integrators.IntegratorState(
            position, momentum, logdensity, logdensity_grad
        )
        proposal, info = proposal_generator(rng_key, integrator_state, step_size)
        return (
            hmc.HMCState(proposal.position, proposal.logdensity, proposal.logdensity_grad),
            info,
        )

    return kernel


def as_top_level_api(
    logdensity_fn: Callable,
    step_size: float,
    inverse_mass_matrix,
    *,
    max_num_doublings: int = 10,
    divergence_threshold: int = 1000,
    integrator: Callable = integrators.velocity_verlet,
    engine: str = "flattened",
) -> SamplingAlgorithm:
    """``blackjax_tpu_torch.nuts(...)`` (reference ``nuts.py:216``)."""
    kernel = build_kernel(integrator, divergence_threshold, engine=engine)
    metric = metrics.default_metric(inverse_mass_matrix)
    return build_sampling_algorithm(
        kernel,
        init,
        logdensity_fn,
        kernel_args=(step_size, metric, max_num_doublings),
    )
