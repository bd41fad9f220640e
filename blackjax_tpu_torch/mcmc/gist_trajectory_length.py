"""GIST instance: self-tuned trajectory length from the U-turn path
(reference ``blackjax_tpu/mcmc/gist_trajectory_length.py``).

The tuning parameter is the leapfrog step count, drawn uniformly from the
tail ``[floor(psi * U), U]`` of the forward U-turn path, a linear
one-step-at-a-time rollout to the first U-turn (Bou-Rabee et al. §2.2).
Detailed balance compares the forward draw interval with the interval the
reverse rollout (from the momentum-flipped proposal) would have offered: a
draw outside it is a "no-return" rejection (``-inf`` tuning log-ratio);
otherwise the log-ratio of the two widths, taken in float32 as the
reference takes it, enters the acceptance exponent.

The reference's rollout is a ``while_loop`` a chain (under ``vmap``). Here
it is one loop over the batch that goes on while any chain rolls out, each
chain frozen by masks once it has turned or reached ``max_num_steps``, so
each chain keeps its own count. The drawn step counts run through the
masked loop of :func:`blackjax_tpu_torch.mcmc.trajectory.static_integration`.
"""
from typing import Callable, NamedTuple

import torch

from blackjax_tpu_torch import prng
from blackjax_tpu_torch.base import SamplingAlgorithm, build_sampling_algorithm
from blackjax_tpu_torch.mcmc import gist, hmc, integrators, metrics, trajectory
from blackjax_tpu_torch.mcmc.integrators import IntegratorState
from blackjax_tpu_torch.mcmc.proposal import tree_select
from blackjax_tpu_torch.types import Array, PRNGKey
from blackjax_tpu_torch.util import value_and_grad

__all__ = [
    "GISTTrajectoryLengthInfo",
    "init",
    "num_steps_to_uturn",
    "build_kernel",
    "as_top_level_api",
]

init = gist.init


class _TrajectoryLengthExtra(NamedTuple):
    num_integration_steps: Array
    num_steps_to_uturn_forward: Array
    num_steps_to_uturn_reverse: Array
    is_no_return_rejected: Array


class GISTTrajectoryLengthInfo(NamedTuple):
    """GISTInfo fields plus forward/reverse U-turn step counts and the
    no-return rejection category."""

    momentum: Array
    tuning_parameter: Array
    is_accepted: Array
    is_divergent: Array
    acceptance_rate: Array
    energy: float
    num_integration_steps: Array
    num_steps_to_uturn_forward: Array
    num_steps_to_uturn_reverse: Array
    is_no_return_rejected: Array


def num_steps_to_uturn(
    integrator: Callable, step_size: float, metric: metrics.Metric, max_num_steps: int
) -> Callable:
    """``U(theta, rho)``, one a chain: leapfrog one step at a time until the
    displacement-velocity inner product ``<theta_n - theta_0, M^-1 rho_n>``
    goes negative, capped at ``max_num_steps``."""

    def uturn_fn(state: IntegratorState, logdensity_fn: Callable) -> Array:
        one_step = integrator(logdensity_fn, metric.kinetic_energy)
        origin = state.position
        batch, device = state.logdensity.shape, state.logdensity.device
        count = torch.zeros(batch, dtype=torch.int64, device=device)
        turned = torch.zeros(batch, dtype=torch.bool, device=device)
        here = state
        while True:
            outbound = ~turned & (count < max_num_steps)
            if not bool(outbound.any()):
                break
            there = one_step(here, step_size)
            velocity = value_and_grad(metric.kinetic_energy, there.momentum)[1]
            inner = ((there.position - origin) * velocity).sum(-1)
            count = torch.where(outbound, count + 1, count)
            here = tree_select(outbound, there, here)
            turned = torch.where(outbound, inner < 0.0, turned)
        return count

    return uturn_fn


def _draw_interval(uturn_steps: Array, path_fraction: float):
    """``([Lo, U], width)`` of the uniform step-count draw (eqs. 34-35)."""
    lo = torch.clamp(torch.floor(path_fraction * uturn_steps.double()).to(torch.int32), min=1)
    width = uturn_steps - lo + 1
    return lo, width


def _randint(rng_key: PRNGKey, lo: Array, hi: Array, dtype: torch.dtype) -> Array:
    """One integer a chain on ``[lo, hi)`` in ``dtype``: ``jax.random.randint``
    of the chain's key, or from a generator."""
    if isinstance(rng_key, torch.Generator):
        u = torch.rand(hi.shape, generator=rng_key, dtype=torch.float64, device=hi.device)
        return lo + torch.floor(u * (hi - lo)).to(dtype)
    return prng.randint(rng_key.to(hi.device), (), lo, hi, dtype)


def _gibbs_draw(integrator, step_size, max_num_steps, path_fraction):
    def tuning_parameter_fn(rng_key, state, logdensity_fn, metric):
        uturn_fn = num_steps_to_uturn(integrator, step_size, metric, max_num_steps)
        forward = uturn_fn(state, logdensity_fn)
        lo, _ = _draw_interval(forward, path_fraction)
        dtype = prng.default_int_dtype(state.logdensity.dtype)
        return _randint(rng_key, lo, forward + 1, dtype), forward

    return tuning_parameter_fn


def _involution(integrator, step_size, max_num_steps, path_fraction):
    def apply_fn(state, alpha, aux, logdensity_fn, metric):
        num_steps, forward = alpha, aux
        one_step = integrator(logdensity_fn, metric.kinetic_energy)
        roll_forward = trajectory.static_integration(one_step)
        proposal = hmc.flip_momentum(roll_forward(state, step_size, num_steps))

        uturn_fn = num_steps_to_uturn(integrator, step_size, metric, max_num_steps)
        reverse = uturn_fn(proposal, logdensity_fn)

        _, forward_width = _draw_interval(forward, path_fraction)
        reverse_lo, reverse_width = _draw_interval(reverse, path_fraction)
        returnable = (num_steps >= reverse_lo) & (num_steps <= reverse)
        width_ratio = torch.log(forward_width.to(torch.float32)) - torch.log(
            reverse_width.to(torch.float32))
        log_ratio = torch.where(returnable, width_ratio, -torch.inf)
        extra = _TrajectoryLengthExtra(num_steps, forward, reverse, ~returnable)
        return proposal, log_ratio, extra

    return apply_fn


def build_kernel(
    integrator: Callable = integrators.velocity_verlet,
    divergence_threshold: float = 1000,
    path_fraction: float = 0.5,
    max_num_steps: int = 1024,
) -> Callable:
    """``gist_trajectory_length`` kernel (``path_fraction`` = psi; 0.5 per
    the paper's recommendation)."""
    transition = gist.build_transition(divergence_threshold)

    def kernel(
        rng_key: PRNGKey, state: gist.GISTState, logdensity_fn: Callable,
        step_size: float, inverse_mass_matrix: Array,
    ) -> tuple[gist.GISTState, GISTTrajectoryLengthInfo]:
        new_state, info, extra = transition(
            rng_key, state, logdensity_fn,
            _gibbs_draw(integrator, step_size, max_num_steps, path_fraction),
            _involution(integrator, step_size, max_num_steps, path_fraction),
            inverse_mass_matrix,
        )
        return new_state, GISTTrajectoryLengthInfo(
            *info,
            extra.num_steps_to_uturn_forward,
            extra.num_steps_to_uturn_reverse,
            extra.is_no_return_rejected,
        )

    return kernel


def as_top_level_api(
    logdensity_fn: Callable, inverse_mass_matrix: Array,
    step_size: float, *, path_fraction: float = 0.5,
    max_num_steps: int = 1024, divergence_threshold: float = 1000,
    integrator: Callable = integrators.velocity_verlet,
) -> SamplingAlgorithm:
    """``blackjax_tpu_torch.gist_trajectory_length(...)``."""
    kernel = build_kernel(integrator, divergence_threshold, path_fraction, max_num_steps)
    return build_sampling_algorithm(
        kernel, init, logdensity_fn,
        kernel_args=(step_size, inverse_mass_matrix),
    )
