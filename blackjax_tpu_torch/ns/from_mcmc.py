"""NS inner kernels from MCMC kernels under a hard likelihood constraint
(reference ``blackjax_tpu/ns/from_mcmc.py``).

The reference ``vmap``s one chain a resurrected particle, each a
``lax.scan`` over its MCMC steps; here the ``num_delete`` chains move
together, a batch, their keys split as the reference splits them (the
sample key into a key a chain, each chain's key into a key a step).
"""
from functools import partial
from typing import Callable, NamedTuple

import torch

from blackjax_tpu_torch import prng
from blackjax_tpu_torch.mcmc.proposal import tree_select
from blackjax_tpu_torch.ns.adaptive import build_kernel as build_adaptive_kernel
from blackjax_tpu_torch.ns.base import delete_fn as default_delete_fn
from blackjax_tpu_torch.smc.base import _stack_steps
from blackjax_tpu_torch.types import Array, PRNGKey
from blackjax_tpu_torch.util import tree_map

__all__ = ["ConstrainedMCMCInfo", "update_with_mcmc_take_last", "reject_constrained_step", "build_kernel"]


class ConstrainedMCMCInfo(NamedTuple):
    info: NamedTuple
    is_accepted: Array


def update_with_mcmc_take_last(constrained_mcmc_step_fn, num_mcmc_steps, num_delete):
    """Resurrect ``num_delete`` particles: start each from a random survivor
    above the contour (``prng.choice`` with float32 probabilities, as the
    reference draws it), run the constrained kernel ``num_mcmc_steps`` times,
    keep the final state. Infos come out ``(num_delete, num_mcmc_steps,
    ...)``."""

    def update(rng_key: PRNGKey, state, loglikelihood_0, **step_parameters):
        choice_key, sample_key = prng.split(rng_key)
        particles = state.particles

        survivors = (particles.loglikelihood > loglikelihood_0).to(torch.float32)
        survivors = torch.where(survivors.sum() > 0.0, survivors, torch.ones_like(survivors))
        start_idx = prng.choice(
            choice_key, survivors.shape[0], (num_delete,), p=survivors / survivors.sum()
        )
        chains = tree_map(lambda x: x[start_idx], particles)

        step = partial(
            constrained_mcmc_step_fn, loglikelihood_0=loglikelihood_0, **step_parameters
        )
        keys = prng.split(prng.split(sample_key, num_delete), num_mcmc_steps)
        infos = []
        for i in range(num_mcmc_steps):
            chains, info = step(keys[:, i], chains)
            infos.append(info)
        return chains, _stack_steps(infos, num_delete, keys.device)

    return update


def reject_constrained_step(
    init_state_fn: Callable,
    logdensity_fn: Callable,
    mcmc_init_fn: Callable,
    mcmc_step_fn: Callable,
) -> Callable:
    """Propose-then-reject constraint wrapper for kernels that cannot gate the
    contour inside their proposal: a move counts only where the MCMC step
    accepted and the new point is above the likelihood threshold."""

    def step(rng_key, state, loglikelihood_0, **params):
        mcmc_state = mcmc_init_fn(state.position, logdensity_fn)
        new_mcmc_state, mcmc_info = mcmc_step_fn(rng_key, mcmc_state, logdensity_fn, **params)
        proposed = init_state_fn(new_mcmc_state.position, loglikelihood_birth=loglikelihood_0)
        within_contour = proposed.loglikelihood > loglikelihood_0
        is_accepted = getattr(mcmc_info, "is_accepted", True) & within_contour
        new_state = tree_select(is_accepted, proposed, state)
        return new_state, ConstrainedMCMCInfo(mcmc_info, is_accepted)

    return step


def build_kernel(
    constrained_step_fn: Callable,
    num_inner_steps: int,
    update_inner_kernel_params_fn: Callable,
    num_delete: int = 1,
    delete_fn: Callable = default_delete_fn,
) -> Callable:
    """Generic NS engine from a constrained inner step (take-last update,
    adaptive parameter refresh, evidence integration)."""
    inner_kernel = update_with_mcmc_take_last(
        constrained_step_fn, num_inner_steps, num_delete
    )
    return build_adaptive_kernel(
        partial(delete_fn, num_delete=num_delete),
        inner_kernel,
        update_inner_kernel_params_fn=update_inner_kernel_params_fn,
    )
