"""Metropolis-Adjusted Langevin Algorithm (reference
``blackjax_tpu/mcmc/mala.py``).

One transition moves every chain of a ``(C, d)`` block: an overdamped
Langevin Euler proposal, then a Metropolis-Hastings accept with the
forward and reverse transition energies of the asymmetric proposal. Its
randomness is a key per chain (:mod:`blackjax_tpu_torch.prng`), split into
the diffusion key and the accept key as the reference splits it, so the
port draws what the reference draws from the same keys. The step size is
a number, a 0-d tensor (shared), or a ``(C,)`` tensor (one per chain, as
SMC hands per-particle parameters). Positions are tensors; pytree
positions come with ROADMAP queue 1, item 11.
"""
from typing import Callable, NamedTuple

import torch

from blackjax_tpu_torch import prng
from blackjax_tpu_torch.base import SamplingAlgorithm, build_sampling_algorithm
from blackjax_tpu_torch.mcmc import diffusions, proposal
from blackjax_tpu_torch.types import ArrayLikeTree, ArrayTree, PRNGKey
from blackjax_tpu_torch.util import value_and_grad

__all__ = ["MALAState", "MALAInfo", "init", "build_kernel", "as_top_level_api"]


class MALAState(NamedTuple):
    position: ArrayTree
    logdensity: ArrayTree
    logdensity_grad: ArrayTree


class MALAInfo(NamedTuple):
    acceptance_rate: ArrayTree
    is_accepted: ArrayTree


def init(position: ArrayLikeTree, logdensity_fn: Callable) -> MALAState:
    """State of ``(C, d)`` positions (or one ``(d,)`` position);
    ``logdensity_fn`` maps ``(..., d)`` to ``(...)``."""
    if not torch.is_tensor(position):
        raise ValueError(
            f"mala takes a (C, d) or (d,) tensor position, got {type(position).__name__}: "
            "pytree positions come with ROADMAP queue 1, item 11"
        )
    logdensity, logdensity_grad = value_and_grad(logdensity_fn, position)
    return MALAState(position, logdensity, logdensity_grad)


def build_kernel():
    """One overdamped-Langevin Euler proposal + MH correction. The proposal
    is asymmetric, so the acceptance ratio uses the forward/reverse
    transition energies ``-logpi(y) + ||x - y - eps*grad(y)||^2 / (4 eps)``."""

    def transition_energy(state, new_state, step_size):
        step = diffusions._per_chain(step_size, state.position)
        displaced = state.position - new_state.position - step * new_state.logdensity_grad
        sq_norm = (displaced * displaced).sum(-1)
        return -new_state.logdensity + 0.25 * sq_norm / step_size

    log_acceptance_ratio = proposal.compute_asymmetric_acceptance_ratio(transition_energy)

    def kernel(
        rng_key: PRNGKey, state: MALAState, logdensity_fn: Callable, step_size
    ) -> tuple[MALAState, MALAInfo]:
        position = state.position
        integrator = diffusions.overdamped_langevin(lambda x: value_and_grad(logdensity_fn, x))
        key_diffusion, key_accept = prng.split(rng_key.to(position.device)).unbind(-2)
        step = torch.as_tensor(step_size, dtype=position.dtype, device=position.device)
        new_state = MALAState(*integrator(key_diffusion, state, step))
        log_p_accept = log_acceptance_ratio(state, new_state, step_size=step)
        # bernoulli(key_accept, p_accept): a uniform in p_accept's dtype below it
        uniform = prng.uniform(key_accept, (), log_p_accept.dtype)
        accepted, (do_accept, p_accept, _) = proposal.static_binomial_sampling(
            uniform, log_p_accept, state, new_state
        )
        return accepted, MALAInfo(p_accept, do_accept)

    return kernel


def as_top_level_api(logdensity_fn: Callable, step_size) -> SamplingAlgorithm:
    """``blackjax_tpu_torch.mala(...)``."""
    kernel = build_kernel()
    return build_sampling_algorithm(kernel, init, logdensity_fn, kernel_args=(step_size,))
