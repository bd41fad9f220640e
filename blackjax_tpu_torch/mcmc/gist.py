"""GIST: Gibbs self-tuning, the family spine (Bou-Rabee, Carpenter & Marsden
2024, Algorithm 1; reference ``blackjax_tpu/mcmc/gist.py``).

The chain lives on phase space augmented with a tuning parameter ``alpha``.
A transition is three Gibbs/Metropolis moves: refresh the momentum ``rho``
from the metric; draw ``alpha ~ p(. | theta, rho)`` (each instance's
self-tuning rule); Metropolis-test the involution ``S o F(alpha)`` with the
tuning-density log-ratio folded into the acceptance exponent. Instances
implement ``(tuning_parameter_fn, apply_fn)``; ``apply_fn`` returns the
log-ratio directly.

The transition moves a ``(C, d)`` block of chains at once (or one ``(d,)``
position). Its key is one a chain, split into the refresh, draw and test
keys as the reference splits it, so the port draws what the reference draws
from the same keys; or a ``torch.Generator``, from which the three moves
draw in that order.
"""
from typing import Callable, NamedTuple

import torch

from blackjax_tpu_torch import prng
from blackjax_tpu_torch.base import SamplingAlgorithm, build_sampling_algorithm
from blackjax_tpu_torch.mcmc import hmc, metrics
from blackjax_tpu_torch.mcmc.integrators import IntegratorState
from blackjax_tpu_torch.mcmc.proposal import safe_energy_diff, tree_select
from blackjax_tpu_torch.types import Array, ArrayLikeTree, ArrayTree, PRNGKey

__all__ = [
    "GISTState",
    "GISTInfo",
    "init",
    "build_transition",
    "build_kernel",
    "as_top_level_api",
]


class GISTState(NamedTuple):
    position: ArrayTree
    logdensity: float
    logdensity_grad: ArrayTree


class GISTInfo(NamedTuple):
    """Transition diagnostics; ``acceptance_rate`` is the realized GIST
    acceptance probability with the tuning-density-ratio factor included."""

    momentum: ArrayTree
    tuning_parameter: ArrayTree
    is_accepted: Array
    is_divergent: Array
    acceptance_rate: Array
    energy: Array
    num_integration_steps: Array


def init(position: ArrayLikeTree, logdensity_fn: Callable) -> GISTState:
    state = hmc.init(position, logdensity_fn)
    return GISTState(state.position, state.logdensity, state.logdensity_grad)


def build_transition(divergence_threshold: float = 1000) -> Callable:
    """The shared GIST transition, returning ``(new_state, info,
    extra_info)``; instance modules splice ``extra_info`` into their own
    Info tuples, :func:`build_kernel` narrows it to ``(state, info)``."""

    def transition(
        rng_key: PRNGKey, state: GISTState, logdensity_fn: Callable,
        tuning_parameter_fn: Callable, apply_fn: Callable,
        inverse_mass_matrix: Array,
    ):
        metric = metrics.default_metric(inverse_mass_matrix)

        def total_energy(s):
            return metric.kinetic_energy(s.momentum) - s.logdensity

        if isinstance(rng_key, torch.Generator):
            key_refresh = key_draw = key_test = rng_key
        else:
            key_refresh, key_draw, key_test = prng.split(
                rng_key.to(state.position.device), 3).unbind(-2)

        # Gibbs moves: momentum, then the tuning parameter.
        rho = metric.sample_momentum(key_refresh, state.position)
        z = IntegratorState(state.position, rho, state.logdensity, state.logdensity_grad)
        alpha, aux = tuning_parameter_fn(key_draw, z, logdensity_fn, metric)

        # Metropolis move through the alpha-indexed involution.
        z_star, log_tuning_ratio, extra_info = apply_fn(z, alpha, aux, logdensity_fn, metric)
        energy_star = total_energy(z_star)
        energy_drop = safe_energy_diff(total_energy(z), energy_star)
        log_accept = energy_drop + log_tuning_ratio
        p_accept = torch.exp(torch.clamp(log_accept, max=0.0))
        accepted = hmc._accept_draws(key_test, p_accept) < p_accept

        landed = GISTState(z_star.position, z_star.logdensity, z_star.logdensity_grad)
        new_state = tree_select(accepted, landed, state)
        info = GISTInfo(
            rho,
            alpha,
            accepted,
            -energy_drop > divergence_threshold,
            p_accept,
            energy_star,
            extra_info.num_integration_steps,
        )
        return new_state, info, extra_info

    return transition


def build_kernel(divergence_threshold: float = 1000) -> Callable:
    """General GIST kernel over the ``(tuning_parameter_fn, apply_fn)``
    seam: ``tuning_parameter_fn(key, state, logdensity_fn, metric) ->
    (alpha, aux)`` is the Gibbs draw, ``apply_fn(state, alpha, aux,
    logdensity_fn, metric) -> (proposal, log_tuning_density_ratio,
    extra_info)`` the involution."""
    transition = build_transition(divergence_threshold)

    def kernel(
        rng_key: PRNGKey, state: GISTState, logdensity_fn: Callable,
        tuning_parameter_fn: Callable, apply_fn: Callable,
        inverse_mass_matrix: Array,
    ) -> tuple[GISTState, GISTInfo]:
        new_state, info, _ = transition(
            rng_key, state, logdensity_fn, tuning_parameter_fn, apply_fn,
            inverse_mass_matrix,
        )
        return new_state, info

    return kernel


def as_top_level_api(
    logdensity_fn: Callable, inverse_mass_matrix: Array,
    tuning_parameter_fn: Callable, apply_fn: Callable, *,
    divergence_threshold: float = 1000,
) -> SamplingAlgorithm:
    """Internal building block; users call ``gist_step_size`` or
    ``gist_trajectory_length``."""
    kernel = build_kernel(divergence_threshold)
    return build_sampling_algorithm(
        kernel, init, logdensity_fn,
        kernel_args=(tuning_parameter_fn, apply_fn, inverse_mass_matrix),
    )
