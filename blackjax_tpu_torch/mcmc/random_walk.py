"""The random-walk Metropolis-Hastings family (reference
``blackjax_tpu/mcmc/random_walk.py``): the additive-step random walk, the
independent RMH (IRMH) and the general RMH with an asymmetric proposal's
correction.

One transition moves every chain of a ``(C, d)`` block. Its randomness is a
key per chain, split into the proposal key and the accept key as the
reference splits it (a ``torch.Generator`` draws one key a chain first); a
user's ``transition_generator(key, position)`` and
``proposal_distribution(key)`` take the proposal keys, one a chain.
"""
from typing import Callable, NamedTuple, Optional

from blackjax_tpu_torch import prng
from blackjax_tpu_torch.base import SamplingAlgorithm, build_sampling_algorithm
from blackjax_tpu_torch.mcmc import proposal
from blackjax_tpu_torch.types import Array, ArrayLikeTree, ArrayTree, PRNGKey
from blackjax_tpu_torch.util import chain_keys, generate_gaussian_noise, require_tensor_position

__all__ = [
    "RWState",
    "RWInfo",
    "init",
    "normal",
    "build_additive_step",
    "build_irmh",
    "build_rmh",
    "normal_random_walk",
    "additive_step_random_walk",
    "irmh_as_top_level_api",
    "rmh_as_top_level_api",
]


class RWState(NamedTuple):
    position: ArrayTree
    logdensity: ArrayTree


class RWInfo(NamedTuple):
    acceptance_rate: ArrayTree
    is_accepted: ArrayTree
    proposal: RWState


def init(position: ArrayLikeTree, logdensity_fn: Callable) -> RWState:
    require_tensor_position(position, "random walk")
    return RWState(position, logdensity_fn(position))


def normal(sigma: Array) -> Callable:
    """A symmetric Gaussian move of scale ``sigma`` (a number, a diagonal or
    a dense matrix)."""

    def propose(rng_key: PRNGKey, position: ArrayLikeTree) -> ArrayTree:
        return generate_gaussian_noise(rng_key, position, sigma=sigma)

    return propose


def _transition_energy(proposal_logdensity_fn: Optional[Callable]) -> Callable:
    """Symmetric: ``-logpi(y)``; asymmetric: less the reverse proposal's log
    density ``log q(y -> x)``."""
    if proposal_logdensity_fn is None:
        return lambda prev_state, new_state: -new_state.logdensity
    return (
        lambda prev_state, new_state: -new_state.logdensity
        - proposal_logdensity_fn(new_state, prev_state)
    )


def _rmh_step(
    logdensity_fn: Callable,
    transition_generator: Callable,
    proposal_logdensity_fn: Optional[Callable],
    sample_proposal: Callable = proposal.static_binomial_sampling,
):
    log_acceptance_ratio = proposal.compute_asymmetric_acceptance_ratio(
        _transition_energy(proposal_logdensity_fn)
    )

    def step(rng_key, state: RWState):
        keys = chain_keys(rng_key, state.position)
        key_proposal, key_accept = prng.split(keys).unbind(-2)
        new_position = transition_generator(key_proposal, state.position)
        proposed = RWState(new_position, logdensity_fn(new_position))
        log_p_accept = log_acceptance_ratio(state, proposed)
        uniform = prng.uniform(key_accept, (), log_p_accept.dtype)
        accepted, (do_accept, p_accept, _) = sample_proposal(
            uniform, log_p_accept, state, proposed
        )
        return accepted, do_accept, p_accept

    return step


def build_rmh():
    """The general Rosenbluth-Metropolis-Hastings kernel: any transition
    generator, with an optional asymmetric proposal's correction."""

    def kernel(
        rng_key: PRNGKey,
        state: RWState,
        logdensity_fn: Callable,
        transition_generator: Callable,
        proposal_logdensity_fn: Optional[Callable] = None,
    ) -> tuple[RWState, RWInfo]:
        step = _rmh_step(logdensity_fn, transition_generator, proposal_logdensity_fn)
        new_state, do_accept, p_accept = step(rng_key, state)
        return new_state, RWInfo(p_accept, do_accept, new_state)

    return kernel


def build_additive_step():
    """Random-walk MH whose proposal adds a symmetric random step."""
    rmh = build_rmh()

    def kernel(
        rng_key: PRNGKey, state: RWState, logdensity_fn: Callable, random_step: Callable
    ) -> tuple[RWState, RWInfo]:
        def transition_generator(key, position):
            return position + random_step(key, position)

        return rmh(rng_key, state, logdensity_fn, transition_generator)

    return kernel


def build_irmh() -> Callable:
    """Independent RMH: the proposal does not depend on the position."""
    rmh = build_rmh()

    def kernel(
        rng_key: PRNGKey,
        state: RWState,
        logdensity_fn: Callable,
        proposal_distribution: Callable,
        proposal_logdensity_fn: Optional[Callable] = None,
    ) -> tuple[RWState, RWInfo]:
        def transition_generator(key, position):
            del position
            return proposal_distribution(key)

        return rmh(rng_key, state, logdensity_fn, transition_generator, proposal_logdensity_fn)

    return kernel


def additive_step_random_walk(logdensity_fn: Callable, random_step: Callable) -> SamplingAlgorithm:
    """``blackjax_tpu_torch.additive_step_random_walk(...)``."""
    kernel = build_additive_step()
    return build_sampling_algorithm(kernel, init, logdensity_fn, kernel_args=(random_step,))


def normal_random_walk(logdensity_fn: Callable, sigma) -> SamplingAlgorithm:
    """The additive-step random walk with a Gaussian step of scale ``sigma``."""
    return additive_step_random_walk(logdensity_fn, normal(sigma))


def irmh_as_top_level_api(
    logdensity_fn: Callable,
    proposal_distribution: Callable,
    proposal_logdensity_fn: Optional[Callable] = None,
) -> SamplingAlgorithm:
    """``blackjax_tpu_torch.irmh(...)``."""
    kernel = build_irmh()
    return build_sampling_algorithm(
        kernel, init, logdensity_fn, kernel_args=(proposal_distribution, proposal_logdensity_fn)
    )


def rmh_as_top_level_api(
    logdensity_fn: Callable,
    proposal_generator: Callable,
    proposal_logdensity_fn: Optional[Callable] = None,
) -> SamplingAlgorithm:
    """``blackjax_tpu_torch.rmh(...)``."""
    kernel = build_rmh()
    return build_sampling_algorithm(
        kernel, init, logdensity_fn, kernel_args=(proposal_generator, proposal_logdensity_fn)
    )
