"""Microcanonical Langevin Monte Carlo, unadjusted (reference
``blackjax_tpu/mcmc/mclmc.py``).

The state is a bare :class:`~blackjax_tpu_torch.mcmc.integrators.IntegratorState`
of every chain; the dynamics are the isokinetic ESH flow with Maruyama O-U
partial momentum refreshes, parametrized by the decoherence length ``L`` and
the step size. A transition with a non-finite state, or with an energy
change above the cutoff, is reverted to the previous position with a fresh
unit momentum, chain by chain.

A transition takes four draws from the caller's generator, in the order of
:class:`MCLMCDraws`, whether or not a revert uses them. The kernel also
accepts those draws in place of the generator, so that a test can hand it
the reference's own.
"""
import math
from typing import Callable, NamedTuple

import torch

from blackjax_tpu_torch.base import SamplingAlgorithm, build_sampling_algorithm
from blackjax_tpu_torch.mcmc.integrators import (
    IntegratorState,
    _normal,
    isokinetic_mclachlan,
    with_isokinetic_maruyama,
)
from blackjax_tpu_torch.mcmc.proposal import tree_select
from blackjax_tpu_torch.types import Array, ArrayLike, PRNGKey
from blackjax_tpu_torch.util import generate_unit_vector, value_and_grad

__all__ = [
    "MCLMCInfo",
    "MCLMCDraws",
    "draw",
    "init",
    "handle_nans",
    "handle_high_energy",
    "build_kernel",
    "as_top_level_api",
]


class MCLMCInfo(NamedTuple):
    logdensity: Array
    kinetic_change: Array
    energy_change: Array
    nonans: Array


class MCLMCDraws(NamedTuple):
    """The random draws of one transition, each shaped like the position,
    in the order the kernel takes them from its generator."""

    refresh_before: Array  # standard normals of the O-U refresh before the step
    refresh_after: Array  # ... and after it
    revert_energy: Array  # unit rows: the momentum of a high-energy revert
    revert_nan: Array  # unit rows: the momentum of a NaN revert


def draw(rng_key: PRNGKey, position: Array) -> MCLMCDraws:
    """One transition's draws from ``rng_key``, in the documented order."""
    before = _normal(rng_key, position)
    after = _normal(rng_key, position)
    return MCLMCDraws(
        before, after, generate_unit_vector(rng_key, position),
        generate_unit_vector(rng_key, position),
    )


def init(position: ArrayLike, logdensity_fn: Callable, rng_key: PRNGKey) -> IntegratorState:
    """State of ``(C, d)`` positions (or one ``(d,)`` position) with a
    uniform unit momentum per chain."""
    position = torch.as_tensor(position)
    if position.dim() == 0 or position.shape[-1] < 2:
        raise ValueError("MCLMC requires a target with more than 1 dimension.")
    logdensity, logdensity_grad = value_and_grad(logdensity_fn, position)
    return IntegratorState(
        position, generate_unit_vector(rng_key, position), logdensity, logdensity_grad
    )


def _unit_rows(rng_key, position):
    """A unit vector per chain: drawn from a generator, or handed in."""
    if torch.is_tensor(rng_key):
        return rng_key.to(position)
    return generate_unit_vector(rng_key, position)


def _revert(previous_state: IntegratorState, info: MCLMCInfo, unit, nonans):
    """Rejected-transition state: the previous position with the unit
    momentum ``unit``, zeroed energy changes."""
    return (
        IntegratorState(
            previous_state.position, unit, previous_state.logdensity,
            previous_state.logdensity_grad,
        ),
        MCLMCInfo(
            previous_state.logdensity,
            torch.zeros_like(info.kinetic_change),
            torch.zeros_like(info.energy_change),
            nonans,
        ),
    )


def handle_nans(previous_state, next_state, info, rng_key):
    """Revert the chains whose position, momentum or log density is not
    finite, and flag them in ``info.nonans``. ``rng_key`` is a generator or
    the revert's unit rows."""
    nonans = (
        torch.isfinite(next_state.position).all(-1)
        & torch.isfinite(next_state.momentum).all(-1)
        & torch.isfinite(next_state.logdensity)
    )
    unit = _unit_rows(rng_key, previous_state.position)
    reverted_state, reverted_info = _revert(previous_state, info, unit, nonans)
    return tree_select(nonans, next_state, reverted_state), tree_select(nonans, info, reverted_info)


def handle_high_energy(previous_state, next_state, info, rng_key, cutoff):
    """Revert the chains whose |energy change| exceeds ``cutoff`` (the
    divergence guard of an unadjusted sampler)."""
    ok = torch.abs(info.energy_change) <= cutoff
    unit = _unit_rows(rng_key, previous_state.position)
    reverted_state, reverted_info = _revert(previous_state, info, unit, info.nonans)
    return tree_select(ok, next_state, reverted_state), tree_select(ok, info, reverted_info)


def build_kernel(
    integrator: Callable = isokinetic_mclachlan,
    desired_energy_var_max_ratio: float = math.inf,
    desired_energy_var: float = 5e-4,
):
    """MCLMC kernel: one stochastic isokinetic step plus the high-energy and
    NaN reverts. ``inverse_mass_matrix`` is a scalar or a ``(d,)``
    diagonal; ``L`` and ``step_size`` are numbers or 0-d tensors.

    ``rng_key`` is a ``torch.Generator`` or an :class:`MCLMCDraws`."""

    def kernel(
        rng_key,
        state: IntegratorState,
        logdensity_fn: Callable,
        inverse_mass_matrix,
        L,
        step_size,
    ) -> tuple[IntegratorState, MCLMCInfo]:
        draws = rng_key if isinstance(rng_key, MCLMCDraws) else draw(rng_key, state.position)
        step = with_isokinetic_maruyama(integrator(logdensity_fn, inverse_mass_matrix))
        new_state, kinetic_change = step(
            state, step_size, L, (draws.refresh_before, draws.refresh_after)
        )
        energy_change = kinetic_change - new_state.logdensity + state.logdensity
        info = MCLMCInfo(
            new_state.logdensity,
            kinetic_change,
            energy_change,
            torch.ones_like(energy_change, dtype=torch.bool),
        )
        ndims = state.position.shape[-1]
        cutoff = math.sqrt(ndims * float(desired_energy_var_max_ratio) * desired_energy_var)
        new_state, info = handle_high_energy(state, new_state, info, draws.revert_energy, cutoff)
        return handle_nans(state, new_state, info, draws.revert_nan)

    return kernel


def as_top_level_api(
    logdensity_fn: Callable,
    L,
    step_size,
    integrator=isokinetic_mclachlan,
    inverse_mass_matrix=1.0,
    desired_energy_var_max_ratio=math.inf,
) -> SamplingAlgorithm:
    """``blackjax_tpu_torch.mclmc(...)``: the kernel over fixed ``L``, step
    size and inverse mass matrix; ``init(position, generator)``."""
    kernel = build_kernel(
        integrator=integrator, desired_energy_var_max_ratio=desired_energy_var_max_ratio
    )
    return build_sampling_algorithm(
        kernel,
        init,
        logdensity_fn,
        kernel_args=(inverse_mass_matrix, L, step_size),
        pass_rng_key_to_init=True,
    )
