"""Nested slice sampling: NS with constrained slice moves whose directions
are shaped by the live-point covariance (hit and run) or the per-axis live
widths (slice within Gibbs) (reference ``blackjax_tpu/ns/nss.py``).

The constrained slice is the port's batched slice kernel
(:mod:`blackjax_tpu_torch.mcmc.slice`, stepping out and shrinkage as masked
loops over the chains): the ``num_delete`` resurrected particles move as one
batch, a key a chain. Positions are ``(n, d)`` tensors; each chain's
direction is drawn from its own key, and the coordinate sweep visits each
chain's coordinates in that chain's own order.
"""
from functools import partial
from typing import Callable, Optional

import torch

from blackjax_tpu_torch import prng
from blackjax_tpu_torch.base import SamplingAlgorithm
from blackjax_tpu_torch.mcmc.slice import SliceInfo, _along, _expand
from blackjax_tpu_torch.mcmc.slice import build_kernel as build_slice_kernel
from blackjax_tpu_torch.mcmc.slice import random_order, stepping_out
from blackjax_tpu_torch.ns.adaptive import init as adaptive_init
from blackjax_tpu_torch.ns.base import init_state_strategy
from blackjax_tpu_torch.ns.from_mcmc import build_kernel as build_from_mcmc_kernel
from blackjax_tpu_torch.smc.tuning.from_particles import (
    particles_covariance_matrix,
    particles_stds,
)
from blackjax_tpu_torch.types import Array, ArrayTree, PRNGKey

__all__ = [
    "as_top_level_api",
    "swig_as_top_level_api",
    "build_kernel",
    "build_swig_kernel",
    "covariance_proposal",
    "coordinate_proposal",
    "coordinate_constrained_step",
    "slice_constrained_step",
    "live_covariance",
    "live_covariance_factor",
    "live_widths",
    "init",
]

init = adaptive_init


def sample_direction_from_covariance_factor(
    rng_key: PRNGKey, position: ArrayTree, covariance_factor: Array
) -> ArrayTree:
    """Direction with Mahalanobis length 2 under the live covariance:
    ``2 L z / ||z||`` for ``z ~ N(0, I)`` and ``L L^T = C``, one a key."""
    d = covariance_factor.shape[-1]
    z = prng.normal(rng_key.to(position.device), (d,), covariance_factor.dtype)
    scaled = 2.0 * (z @ covariance_factor.T)
    return (scaled / torch.linalg.vector_norm(z, dim=-1, keepdim=True)).reshape(position.shape)


def sample_direction_from_covariance(rng_key, position, cov):
    return sample_direction_from_covariance_factor(
        rng_key, position, torch.linalg.cholesky(cov)
    )


def covariance_proposal(
    init_state_fn: Callable,
    loglikelihood_0: Array,
    cov: Optional[Array] = None,
    *,
    covariance_factor: Optional[Array] = None,
) -> Callable:
    """Hit-and-run proposal along a covariance-shaped direction, gating the
    likelihood contour into ``is_valid``. The kernel passes a precomputed
    Cholesky factor so the factorization is done once an outer NS step."""
    if (cov is None) == (covariance_factor is None):
        raise ValueError("Specify exactly one of cov and covariance_factor")
    factor = covariance_factor if cov is None else torch.linalg.cholesky(cov)

    def proposal_generator(rng_key, position, logdensity_fn):
        del logdensity_fn  # NS slices on the recorded prior density + contour
        direction = sample_direction_from_covariance_factor(rng_key, position, factor)

        def slice_fn(t):
            probe = init_state_fn(_along(position, t, direction),
                                  loglikelihood_birth=loglikelihood_0)
            return probe, probe.loglikelihood > loglikelihood_0

        return slice_fn

    return proposal_generator


def coordinate_proposal(
    init_state_fn: Callable, loglikelihood_0: Array, i: Array, width: Array
) -> Callable:
    """Per-axis proposal ``width * e_i`` (an axis and a width a chain) with
    the likelihood gate."""

    def proposal_generator(rng_key, position, logdensity_fn):
        del rng_key, logdensity_fn
        index = torch.as_tensor(i, device=position.device)
        axis = torch.arange(position.shape[-1], device=position.device) == index[..., None]
        axis = axis.to(position.dtype)
        scale = torch.as_tensor(width, dtype=position.dtype, device=position.device)

        def slice_fn(t):
            # x_i + t width on axis i; every other coordinate plus 0
            shifted = _along(position, t * _expand(scale, t), axis)
            probe = init_state_fn(shifted, loglikelihood_birth=loglikelihood_0)
            return probe, probe.loglikelihood > loglikelihood_0

        return slice_fn

    return proposal_generator


def live_covariance(rng_key, state, info, params=None):
    """Adaptive callback: dense live-point covariance."""
    del rng_key, info, params
    return {"cov": torch.atleast_2d(particles_covariance_matrix(state.particles.position))}


def live_covariance_factor(rng_key, state, info, params=None):
    """Adaptive callback: Cholesky factor of the live-point covariance,
    computed once an outer step."""
    del rng_key, info, params
    cov = torch.atleast_2d(particles_covariance_matrix(state.particles.position))
    return {"covariance_factor": torch.linalg.cholesky(cov)}


def live_widths(rng_key, state, info, params=None):
    """Adaptive callback: per-axis live-point standard deviations (SwiG)."""
    del rng_key, info, params
    return {"widths": particles_stds(state.particles.position)}


def slice_constrained_step(
    init_state_fn: Callable, slice_kernel: Callable, proposal: Callable
) -> Callable:
    """Constrained inner step of the slice family: the slice shrinks until
    it lands inside the likelihood contour, no wasted rejections."""

    def step(rng_key, state, loglikelihood_0, **params):
        proposal_generator = proposal(init_state_fn, loglikelihood_0, **params)
        return slice_kernel(rng_key, state, None, proposal_generator)

    return step


def _resolve_inner_kernel_params(proposal, inner_kernel_params):
    if inner_kernel_params is None:
        is_hit_and_run = proposal is covariance_proposal
        return live_covariance_factor if is_hit_and_run else live_covariance
    return inner_kernel_params


def build_kernel(
    init_state_fn: Callable, num_inner_steps: int, num_delete: int = 1,
    max_steps: int = 10, max_shrinkage: int = 100,
    proposal: Callable = covariance_proposal,
    inner_kernel_params: Optional[Callable] = None,
) -> Callable:
    """Hit-and-run NSS kernel."""
    inner_kernel_params = _resolve_inner_kernel_params(proposal, inner_kernel_params)
    slice_kernel = build_slice_kernel(
        interval=stepping_out, max_expansions=max_steps, max_shrinkage=max_shrinkage
    )
    constrained_step = slice_constrained_step(init_state_fn, slice_kernel, proposal)
    return build_from_mcmc_kernel(
        constrained_step, num_inner_steps, inner_kernel_params, num_delete
    )


def coordinate_constrained_step(
    init_state_fn: Callable, slice_kernel: Callable,
    proposal: Callable = coordinate_proposal,
    coordinate_order: Callable = random_order,
) -> Callable:
    """Constrained coordinate sweep: every axis updated once by a unit-width
    slice along ``width_i * e_i``, each chain in its own order."""

    def step(rng_key, state, loglikelihood_0, widths):
        order_key, sweep_key = prng.split(rng_key).unbind(-2)
        position = state.position
        d = position.shape[-1]
        order = coordinate_order(order_key, d).expand(position.shape[:-1] + (d,))
        widths = torch.as_tensor(widths, dtype=position.dtype, device=position.device)
        ordered_widths = widths[order]
        keys = prng.split(sweep_key, d)
        swept = []
        for n in range(d):
            proposal_generator = proposal(
                init_state_fn, loglikelihood_0, order[..., n], ordered_widths[..., n])
            state, info = slice_kernel(keys[..., n, :], state, None, proposal_generator)
            swept.append(info)

        # re-scatter the per-axis sweep records back into position order
        def stitch(values):
            stacked = torch.stack(values, -1)
            return torch.zeros_like(stacked).scatter(-1, order, stacked)

        info = SliceInfo(
            torch.stack([s.is_accepted for s in swept], -1).all(-1),
            torch.stack([s.num_expansions for s in swept], -1).sum(-1),
            torch.stack([s.num_shrink for s in swept], -1).sum(-1),
            stitch([s.bracket_left for s in swept]),
            stitch([s.bracket_right for s in swept]),
        )
        return state, info

    return step


def build_swig_kernel(
    init_state_fn: Callable, num_inner_steps: int, num_delete: int = 1,
    max_steps: int = 10, max_shrinkage: int = 100,
    proposal: Callable = coordinate_proposal,
    coordinate_order: Callable = random_order,
    inner_kernel_params: Callable = live_widths,
) -> Callable:
    """Slice-within-Gibbs NSS kernel."""
    slice_kernel = build_slice_kernel(
        interval=stepping_out, max_expansions=max_steps, max_shrinkage=max_shrinkage
    )
    sweep = coordinate_constrained_step(
        init_state_fn, slice_kernel, proposal=proposal,
        coordinate_order=coordinate_order,
    )
    return build_from_mcmc_kernel(sweep, num_inner_steps, inner_kernel_params, num_delete)


def _package(kernel, init_state_fn, inner_kernel_params) -> SamplingAlgorithm:
    """Assemble the public (init, step) pair shared by both variants."""

    def init_fn(position, rng_key=None):
        return init(
            position,
            init_state_fn=init_state_fn,
            update_inner_kernel_params_fn=inner_kernel_params,
            rng_key=rng_key,
        )

    return SamplingAlgorithm(init_fn, lambda rng_key, state: kernel(rng_key, state))


def as_top_level_api(
    logprior_fn: Callable, loglikelihood_fn: Callable, num_inner_steps: int,
    num_delete: int = 1, max_steps: int = 10, max_shrinkage: int = 100,
    proposal: Callable = covariance_proposal,
    inner_kernel_params: Optional[Callable] = None,
) -> SamplingAlgorithm:
    """``blackjax_tpu_torch.nss(...)``. Use ``num_inner_steps >= max(5,
    2*dim)`` for reliable decorrelation. Live particles are not posterior
    draws: pass the dead set through ``ns.utils.finalise`` and
    ``ns.utils.sample``. ``logprior_fn`` and ``loglikelihood_fn`` map ``(...,
    d)`` positions to ``(...)``."""
    inner_kernel_params = _resolve_inner_kernel_params(proposal, inner_kernel_params)
    init_state_fn = partial(
        init_state_strategy, logprior_fn=logprior_fn, loglikelihood_fn=loglikelihood_fn
    )
    kernel = build_kernel(
        init_state_fn, num_inner_steps, num_delete, max_steps=max_steps,
        max_shrinkage=max_shrinkage, proposal=proposal,
        inner_kernel_params=inner_kernel_params,
    )
    return _package(kernel, init_state_fn, inner_kernel_params)


def swig_as_top_level_api(
    logprior_fn: Callable, loglikelihood_fn: Callable, num_inner_steps: int,
    num_delete: int = 1, max_steps: int = 10, max_shrinkage: int = 100,
    proposal: Callable = coordinate_proposal,
    coordinate_order: Callable = random_order,
    inner_kernel_params: Callable = live_widths,
) -> SamplingAlgorithm:
    """``blackjax_tpu_torch.nsswig(...)``: the axis-aligned coordinate
    variant."""
    init_state_fn = partial(
        init_state_strategy, logprior_fn=logprior_fn, loglikelihood_fn=loglikelihood_fn
    )
    kernel = build_swig_kernel(
        init_state_fn, num_inner_steps, num_delete, max_steps=max_steps,
        max_shrinkage=max_shrinkage, proposal=proposal,
        coordinate_order=coordinate_order,
        inner_kernel_params=inner_kernel_params,
    )
    return _package(kernel, init_state_fn, inner_kernel_params)
