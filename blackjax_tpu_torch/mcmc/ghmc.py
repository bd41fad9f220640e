"""Generalized HMC: a persistent momentum and Neal's non-reversible slice
acceptance (reference ``blackjax_tpu/mcmc/ghmc.py``).

One transition moves every chain of a ``(C, d)`` block: a partial momentum
refresh, one velocity-Verlet step, and an accept against the persistent
slice variable, which moves deterministically (and by ``noise_fn``); the
momentum is flipped on the way out, so a rejection reverses direction. Its
randomness is a key per chain, split as the reference splits it (a
``torch.Generator`` draws one key a chain first).

The kernel's parameters are shared by every chain, or given per chain as
the reference's ``vmap`` over them gives them (MEADS): a ``(C,)`` step size,
``alpha`` and ``delta``, and a per-chain diagonal momentum scale wrapped by
:func:`_per_chain_diagonal`, never guessed from a ``(C, d)`` shape, which
stays one dense matrix.
"""
import math
from typing import Callable, NamedTuple

import torch

from blackjax_tpu_torch import prng
from blackjax_tpu_torch.base import SamplingAlgorithm, build_sampling_algorithm
from blackjax_tpu_torch.mcmc import hmc, integrators, metrics
from blackjax_tpu_torch.mcmc.integrators import _per_row
from blackjax_tpu_torch.mcmc.proposal import nonreversible_slice_sampling
from blackjax_tpu_torch.types import ArrayLikeTree, ArrayTree, PRNGKey
from blackjax_tpu_torch.util import (
    chain_keys,
    generate_gaussian_noise,
    require_tensor_position,
    value_and_grad,
)

__all__ = ["GHMCState", "init", "build_kernel", "as_top_level_api", "update_momentum"]


class GHMCState(NamedTuple):
    """Chain state with its persistent momentum and slice variable."""

    position: ArrayTree
    momentum: ArrayTree
    logdensity: ArrayTree
    logdensity_grad: ArrayTree
    slice: ArrayTree


def init(position: ArrayLikeTree, logdensity_fn: Callable, rng_key: PRNGKey) -> GHMCState:
    """State of ``(C, d)`` positions: a standard normal momentum and a slice
    variable uniform on ``[-1, 1)`` per chain, from ``split(key)``; the slice
    variable in the position's dtype (the counterpart of JAX's default
    float)."""
    require_tensor_position(position, "ghmc")
    key_momentum, key_slice = prng.split(chain_keys(rng_key, position)).unbind(-2)
    logdensity, logdensity_grad = value_and_grad(logdensity_fn, position)
    return GHMCState(
        position,
        generate_gaussian_noise(key_momentum, position),
        logdensity,
        logdensity_grad,
        prng.uniform(key_slice, (), position.dtype, -1.0, 1.0),
    )


def _metric_from_momentum_inverse_scale(momentum_inverse_scale) -> metrics.Metric:
    """A metric, a low-rank payload or a dense ``(d, d)`` matrix passes to
    ``default_metric``; a number or a ``(d,)`` vector is a per-dimension
    inverse scale, squared into an inverse variance (the MEADS
    convention)."""
    x = momentum_inverse_scale
    if isinstance(x, (metrics.Metric, metrics.LowRankInverseMassMatrix)) or callable(x):
        return metrics.default_metric(x)
    x = torch.as_tensor(x)
    if x.dim() >= 2:
        return metrics.default_metric(x)
    return metrics.default_metric(x.reshape(-1) ** 2)


def _per_chain_diagonal(momentum_inverse_scale) -> metrics.Metric:
    """The metric of a per-chain momentum inverse scale ``(C, d)``: row ``c``
    is chain ``c``'s per-dimension scale, squared into its diagonal inverse
    mass matrix (the MEADS convention), as the reference's ``vmap`` of the
    kernel over the scales builds one metric a chain."""
    return metrics._gaussian_euclidean_rows(torch.as_tensor(momentum_inverse_scale) ** 2)


def update_momentum(rng_key, state, alpha, momentum_generator):
    """Partial momentum refresh ``p <- sqrt(1 - alpha) p + sqrt(alpha) eps``,
    which preserves the momentum's marginal; a ``(C,)`` ``alpha`` refreshes
    each chain's row at its own rate."""
    sqrt = torch.sqrt if torch.is_tensor(alpha) else math.sqrt
    keep, inject = sqrt(1.0 - alpha), sqrt(alpha)
    fresh = momentum_generator(rng_key, state.position)
    return _per_row(keep, state.momentum) * state.momentum + _per_row(inject, fresh) * fresh


def _advance_slice(slice_var, delta, noise):
    """Translate the slice variable on the wrapped interval ``[-1, 1)``."""
    return torch.remainder(slice_var + delta + noise + 1.0, 2.0) - 1.0


def build_kernel(noise_fn: Callable = lambda _: 0.0, divergence_threshold: float = 1000):
    """One velocity-Verlet step with persistent momentum, accepted by the
    persistent slice variable (Neal 2020)."""

    def kernel(
        rng_key: PRNGKey,
        state: GHMCState,
        logdensity_fn: Callable,
        step_size: float,
        momentum_inverse_scale,
        alpha: float,
        delta: float,
    ) -> tuple[GHMCState, hmc.HMCInfo]:
        metric = _metric_from_momentum_inverse_scale(momentum_inverse_scale)
        integrator = integrators.velocity_verlet(logdensity_fn, metric.kinetic_energy)
        generate = hmc.hmc_proposal(
            integrator,
            metric.kinetic_energy,
            step_size,
            divergence_threshold=divergence_threshold,
            sample_proposal=nonreversible_slice_sampling,
        )
        key_momentum, key_noise = prng.split(chain_keys(rng_key, state.position)).unbind(-2)
        momentum = update_momentum(key_momentum, state, alpha, metric.sample_momentum)
        slice_var = _advance_slice(state.slice, delta, noise_fn(key_noise))
        head = integrators.IntegratorState(
            state.position, momentum, state.logdensity, state.logdensity_grad
        )
        # the slice variable rides in the proposal's key slot: the
        # non-reversible accept consumes it in place of a uniform
        proposal, info, next_slice = generate(slice_var, head)
        proposal = hmc.flip_momentum(proposal)
        return (
            GHMCState(
                proposal.position,
                proposal.momentum,
                proposal.logdensity,
                proposal.logdensity_grad,
                next_slice,
            ),
            info,
        )

    return kernel


def as_top_level_api(
    logdensity_fn: Callable,
    step_size: float,
    momentum_inverse_scale,
    alpha: float,
    delta: float,
    *,
    divergence_threshold: int = 1000,
    noise_gn: Callable = lambda _: 0.0,
) -> SamplingAlgorithm:
    """``blackjax_tpu_torch.ghmc(...)``; ``init(position, rng_key)``."""
    kernel = build_kernel(noise_gn, divergence_threshold)
    return build_sampling_algorithm(
        kernel,
        init,
        logdensity_fn,
        kernel_args=(step_size, momentum_inverse_scale, alpha, delta),
        pass_rng_key_to_init=True,
    )
