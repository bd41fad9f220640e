"""Nested sampling core: delete the worst-likelihood live points, resurrect
them through a likelihood-constrained inner kernel (reference
``blackjax_tpu/ns/base.py``).

Particle states hold the whole live set, a leading axis of ``n`` on every
field; an ``init_state_fn`` maps ``(n, d)`` positions to such a state (the
reference's ``vmap`` of its per-particle function).
"""
import math
from typing import Callable, NamedTuple

import torch

from blackjax_tpu_torch import prng
from blackjax_tpu_torch.types import Array, ArrayLikeTree, PRNGKey
from blackjax_tpu_torch.util import tree_map

__all__ = ["StateWithLogLikelihood", "NSState", "NSInfo", "init", "build_kernel", "delete_fn"]


class StateWithLogLikelihood(NamedTuple):
    """Particles: position, prior log-density, likelihood, and the
    likelihood contour each was born above."""

    position: ArrayLikeTree
    logdensity: Array
    loglikelihood: Array
    loglikelihood_birth: Array


class NSState(NamedTuple):
    particles: StateWithLogLikelihood


class NSInfo(NamedTuple):
    """The particles deleted ("dead") this step plus the inner update info."""

    particles: StateWithLogLikelihood
    update_info: NamedTuple


def init_state_strategy(
    position: ArrayLikeTree,
    logprior_fn: Callable,
    loglikelihood_fn: Callable,
    loglikelihood_birth=math.nan,
) -> StateWithLogLikelihood:
    """The particle states of ``position`` (a leading particle axis, or the
    ``(..., d)`` points of a slice)."""
    loglikelihood = loglikelihood_fn(position)
    return StateWithLogLikelihood(
        position,
        logprior_fn(position),
        loglikelihood,
        loglikelihood_birth * torch.ones_like(loglikelihood),
    )


def init(
    positions: ArrayLikeTree,
    init_state_fn: Callable,
    loglikelihood_birth=math.nan,
) -> NSState:
    state = init_state_fn(positions)
    return NSState(
        state._replace(
            loglikelihood_birth=loglikelihood_birth
            * torch.ones_like(state.loglikelihood_birth)
        )
    )


def _scatter(live: Array, index: Array, new: Array) -> Array:
    out = live.clone()
    out[index] = new.to(out.dtype)
    return out


def build_kernel(delete_fn: Callable, inner_kernel: Callable) -> Callable:
    """One NS step: identify the dead set, resurrect replacements above the
    highest dead likelihood through ``inner_kernel``, scatter them back."""

    def kernel(rng_key: PRNGKey, state: NSState) -> tuple[NSState, NSInfo]:
        dead_idx, target_idx = delete_fn(state)
        dead_particles = tree_map(lambda x: x[dead_idx], state.particles)

        rng_key, inner_key = prng.split(rng_key.to(dead_idx.device))
        loglikelihood_0 = dead_particles.loglikelihood.max()
        new_particles, update_info = inner_kernel(inner_key, state, loglikelihood_0)

        state = state._replace(
            particles=tree_map(
                lambda p, n: _scatter(p, target_idx, n), state.particles, new_particles
            )
        )
        return state, NSInfo(dead_particles, update_info)

    return kernel


def delete_fn(state: NSState, num_delete: int) -> tuple[Array, Array]:
    """The ``num_delete`` lowest-likelihood particles die; their slots are
    overwritten. Ties are broken as ``lax.top_k`` breaks them, the lower
    index first: a stable sort of the negated log likelihoods, descending."""
    order = torch.argsort(-state.particles.loglikelihood, descending=True, stable=True)
    dead_idx = order[:num_delete]
    return dead_idx, dead_idx
