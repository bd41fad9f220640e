"""Periodic orbital MCMC (Neklyudov & Welling 2022, Algorithm 2; reference
``blackjax_tpu/mcmc/periodic_orbital.py``): a transition emits a whole
weighted Hamiltonian orbit; the next resamples a point of it by weight and
rebuilds the orbit around it.

Every state tensor has a leading chain axis: a chain holds a ``(period,
d)`` block of positions with their weights, their indices along the orbit
and their log densities and gradients. The reference's scan over the
period runs as one loop whose step direction is each chain's own (``sign(i)
step_size`` with ``i = k - direction[c]``). Randomness is a key per chain
(a ``torch.Generator`` draws one key a chain first), split into the choice
key (``prng.choice`` with the weights) and the momentum key.
"""
from typing import Callable, NamedTuple

import torch

from blackjax_tpu_torch import prng
from blackjax_tpu_torch.base import SamplingAlgorithm, build_sampling_algorithm
from blackjax_tpu_torch.mcmc import integrators, metrics
from blackjax_tpu_torch.mcmc.proposal import tree_select
from blackjax_tpu_torch.types import Array, ArrayLikeTree, ArrayTree, PRNGKey
from blackjax_tpu_torch.util import chain_keys, require_tensor_position, value_and_grad

__all__ = ["PeriodicOrbitalState", "init", "build_kernel", "as_top_level_api"]


class PeriodicOrbitalState(NamedTuple):
    """A weighted orbit a chain: ``period`` positions, their weights, each
    point's index along the orbit, and their log densities and gradients."""

    positions: ArrayTree
    weights: Array
    directions: Array
    logdensities: Array
    logdensities_grad: ArrayTree


class PeriodicOrbitalInfo(NamedTuple):
    momentums: ArrayTree
    weights_mean: Array
    weights_variance: Array


def init(position: ArrayLikeTree, logdensity_fn: Callable, period: int) -> PeriodicOrbitalState:
    """The degenerate orbit: each chain's ``(d,)`` position repeated
    ``period`` times, weights uniform."""
    require_tensor_position(position, "orbital_hmc")
    positions = position.unsqueeze(-2).expand(position.shape[:-1] + (period,) + position.shape[-1:])
    positions = positions.contiguous()
    logdensities, logdensities_grad = value_and_grad(logdensity_fn, positions)
    batch = position.shape[:-1]
    weights = torch.full(batch + (period,), 1.0 / period, dtype=position.dtype,
                         device=position.device)
    directions = torch.arange(period, device=position.device).expand(batch + (period,))
    return PeriodicOrbitalState(positions, weights, directions, logdensities, logdensities_grad)


def periodic_orbital_proposal(
    bijection: Callable, kinetic_energy_fn: Callable, period: int, step_size: float
) -> Callable:
    """Rebuild the orbit around a start: integrate back to index 0 and on to
    ``period - 1``, weighting each point by ``exp(logdensity - K)``."""

    def generate(direction: Array, init_state: integrators.IntegratorState):
        steps = torch.arange(period, device=direction.device) - direction[..., None]
        batch_dims = init_state.logdensity.dim()
        dtype = init_state.position.dtype
        state = init_state
        states, weights = [], []
        for k in range(period):
            i = steps[..., k]
            stepped = bijection(state, torch.sign(i).to(dtype) * step_size)
            state = tree_select(i != 0, stepped, init_state)
            weights.append(torch.exp(state.logdensity - kinetic_energy_fn(state.momentum)))
            states.append(state)
        stacked = integrators.IntegratorState(*(torch.stack(f, batch_dims) for f in zip(*states)))
        weights = torch.stack(weights, -1)
        directions = torch.where(steps < 0, -(steps + 1), steps + direction[..., None])
        new_state = PeriodicOrbitalState(
            stacked.position,
            weights / weights.sum(-1, keepdim=True),
            directions,
            stacked.logdensity,
            stacked.logdensity_grad,
        )
        info = PeriodicOrbitalInfo(
            stacked.momentum, weights.mean(-1), weights.var(-1, correction=0))
        return new_state, info

    return generate


def build_kernel(bijection: Callable = integrators.velocity_verlet):
    """The periodic orbital kernel: sample a point of each chain's orbit by
    weight, shift its index by half a period, draw a fresh momentum and
    rebuild."""

    def kernel(
        rng_key: PRNGKey,
        state: PeriodicOrbitalState,
        logdensity_fn: Callable,
        step_size: float,
        inverse_mass_matrix: Array,
        period: int,
    ):
        metric = metrics.gaussian_euclidean(inverse_mass_matrix)
        bijection_fn = bijection(logdensity_fn, metric.kinetic_energy)
        generate = periodic_orbital_proposal(bijection_fn, metric.kinetic_energy, period, step_size)
        keys = chain_keys(rng_key, state.logdensities)
        key_choice, key_momentum = prng.split(keys).unbind(-2)
        idx = prng.choice(key_choice, state.weights.shape[-1], p=state.weights)

        def pick(x):
            index = idx.reshape(idx.shape + (1,) * (x.dim() - idx.dim()))
            if x.dim() > idx.dim() + 1:
                index = index.expand(idx.shape + (1,) + x.shape[idx.dim() + 1:])
            return torch.gather(x, idx.dim(), index).squeeze(idx.dim())

        position = pick(state.positions)
        orbit_period = state.directions.max(-1).values + 1
        direction = torch.remainder(pick(state.directions) + orbit_period // 2, orbit_period)
        start = integrators.IntegratorState(
            position,
            metric.sample_momentum(key_momentum, position),
            pick(state.logdensities),
            pick(state.logdensities_grad),
        )
        return generate(direction, start)

    return kernel


def as_top_level_api(
    logdensity_fn: Callable,
    step_size: float,
    inverse_mass_matrix: Array,
    period: int,
    *,
    bijection: Callable = integrators.velocity_verlet,
) -> SamplingAlgorithm:
    """``blackjax_tpu_torch.orbital_hmc(...)``."""
    kernel = build_kernel(bijection)
    return build_sampling_algorithm(
        kernel,
        init,
        logdensity_fn,
        init_args=(period,),
        kernel_args=(step_size, inverse_mass_matrix, period),
    )
