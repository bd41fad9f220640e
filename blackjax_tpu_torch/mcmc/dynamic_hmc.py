"""HMC with a number of integration steps drawn afresh at every transition
(reference ``blackjax_tpu/mcmc/dynamic_hmc.py``).

- :func:`lift_drawn_steps` turns a fixed-length kernel into one whose step
  count is drawn from a carried generator argument (a key, a Halton
  index), which the state carries as ``random_generator_arg``.
- The base-2 Halton (van der Corput) sequence, with :func:`rescale` and
  :func:`halton_trajectory_length`, gives quasi-random lengths of a chosen
  mean.

Every chain carries its own argument and draws its own count: by default a
key per chain, ``randint(key, (), 1, 10)`` through
:func:`blackjax_tpu_torch.prng.randint` in the state's
:func:`~blackjax_tpu_torch.prng.default_int_dtype`, advanced to
``split(key)[1]`` (the reference's ``_fresh_key``). The counts, one per chain ``(C,)``, run
through the masked loop of
:func:`blackjax_tpu_torch.mcmc.trajectory.static_integration`.
"""
import functools
import math
from typing import Callable, NamedTuple

import torch

from blackjax_tpu_torch import prng
from blackjax_tpu_torch.base import SamplingAlgorithm, build_sampling_algorithm
from blackjax_tpu_torch.mcmc import integrators
from blackjax_tpu_torch.mcmc.hmc import HMCState, hmc_proposal
from blackjax_tpu_torch.mcmc.hmc import build_kernel as build_static_hmc_kernel
from blackjax_tpu_torch.types import Array, ArrayLikeTree, ArrayTree, PRNGKey
from blackjax_tpu_torch.util import chain_keys, require_tensor_position, value_and_grad

__all__ = [
    "DynamicHMCState",
    "init",
    "build_kernel",
    "as_top_level_api",
    "halton_sequence",
    "halton_trajectory_length",
    "rescale",
    "lift_drawn_steps",
]


def _fresh_key(key):
    return prng.split(key)[..., 1, :]


def _uniform_steps(key, dtype=torch.int64):
    return prng.randint(key, (), 1, 10, dtype)


class DynamicHMCState(NamedTuple):
    """HMC chain state with the argument that seeds the next transition's
    step-count draw."""

    position: ArrayTree
    logdensity: ArrayTree
    logdensity_grad: ArrayTree
    random_generator_arg: Array


def init(position: ArrayLikeTree, logdensity_fn: Callable, random_generator_arg):
    """State of ``(C, d)`` positions; ``random_generator_arg`` is what the
    step-count draw reads: key words (one key a chain), a Halton index, or a
    ``torch.Generator``, from which one key a chain is drawn."""
    require_tensor_position(position, "dynamic_hmc")
    if isinstance(random_generator_arg, torch.Generator):
        random_generator_arg = chain_keys(random_generator_arg, position)
    logdensity, logdensity_grad = value_and_grad(logdensity_fn, position)
    return DynamicHMCState(position, logdensity, logdensity_grad, random_generator_arg)


def lift_drawn_steps(
    stepped_kernel: Callable,
    integration_steps_fn: Callable,
    next_random_arg_fn: Callable,
):
    """Lift ``stepped_kernel(rng_key, hmc_state, num_steps) -> (state,
    info)`` into a kernel over :class:`DynamicHMCState`: draw the step
    counts from the carried argument, run the fixed-length kernel, advance
    the argument."""

    def kernel(rng_key, state: DynamicHMCState, integration_steps_params=()):
        num_steps = integration_steps_fn(state.random_generator_arg, *integration_steps_params)
        chain = HMCState(state.position, state.logdensity, state.logdensity_grad)
        moved, info = stepped_kernel(rng_key, chain, num_steps)
        return (
            DynamicHMCState(
                moved.position,
                moved.logdensity,
                moved.logdensity_grad,
                next_random_arg_fn(state.random_generator_arg),
            ),
            info,
        )

    return kernel


def build_kernel(
    integrator: Callable = integrators.velocity_verlet,
    divergence_threshold: float = 1000,
    next_random_arg_fn: Callable = _fresh_key,
    integration_steps_fn: Callable = _uniform_steps,
    build_proposal: Callable = hmc_proposal,
    max_integration_steps: int = None,
    integration_unroll: int = 1,
):
    """Dynamic-length HMC as a lift of the static HMC kernel.
    ``max_integration_steps`` bounds the masked loop (by default the largest
    drawn count, read to the host). ``integration_unroll`` is accepted for
    the reference's signature and has no effect: there it only blocks the
    trajectory's ``scan`` and changes no bits, and the port's loop is a
    Python loop."""
    del integration_unroll
    static_kernel = build_static_hmc_kernel(
        integrator,
        divergence_threshold,
        build_proposal,
        max_num_integration_steps=max_integration_steps,
    )

    def kernel(
        rng_key: PRNGKey,
        state: DynamicHMCState,
        logdensity_fn: Callable,
        step_size: float,
        inverse_mass_matrix: Array,
        integration_steps_params: tuple = (),
    ):
        def stepped(key, chain, n):
            return static_kernel(key, chain, logdensity_fn, step_size, inverse_mass_matrix, n)

        # the default draw takes the state's integer width; a caller's own
        # integration_steps_fn takes the carried argument alone
        steps_fn = integration_steps_fn
        if integration_steps_fn is _uniform_steps:
            steps_fn = functools.partial(
                _uniform_steps, dtype=prng.default_int_dtype(state.logdensity.dtype))
        lifted = lift_drawn_steps(stepped, steps_fn, next_random_arg_fn)
        return lifted(rng_key, state, integration_steps_params)

    return kernel


def as_top_level_api(
    logdensity_fn: Callable,
    step_size: float,
    inverse_mass_matrix: Array,
    *,
    divergence_threshold: int = 1000,
    integrator: Callable = integrators.velocity_verlet,
    next_random_arg_fn: Callable = _fresh_key,
    integration_steps_fn: Callable = _uniform_steps,
    integration_steps_params: tuple = (),
    build_proposal: Callable = hmc_proposal,
    max_integration_steps: int = None,
) -> SamplingAlgorithm:
    """``blackjax_tpu_torch.dynamic_hmc(...)``; ``init(position, rng_key)``
    takes the keys (or a generator) that seed the step-count draws."""
    kernel = build_kernel(
        integrator, divergence_threshold, next_random_arg_fn,
        integration_steps_fn, build_proposal, max_integration_steps,
    )
    return build_sampling_algorithm(
        kernel, init, logdensity_fn,
        kernel_args=(step_size, inverse_mass_matrix, integration_steps_params),
        pass_rng_key_to_init=True,
    )


# ---------------------------------------------------------------------------
# Low-discrepancy trajectory-length jitter
# ---------------------------------------------------------------------------


def halton_sequence(i: Array, max_bits: int = 10) -> Array:
    """Element ``i`` (0-based; any integer tensor, one element a chain) of
    the base-2 van der Corput sequence, by bit reversal of ``i + 1`` over
    ``max_bits`` bits, in torch's default float dtype (exact: at most
    ``max_bits`` binary digits)."""
    i = torch.as_tensor(i)
    width = torch.iinfo(i.dtype).bits
    if max_bits >= width:
        raise ValueError(
            f"max_bits ({max_bits}) must be smaller than the bit width of {i.dtype} ({width})"
        )
    place_value = 2 ** torch.arange(max_bits, dtype=i.dtype, device=i.device)
    digits = ((i[..., None] + 1) // place_value) % 2
    return torch.sum(digits * 0.5 / place_value, dim=-1).to(torch.get_default_dtype())


def rescale(mu):
    """The scale ``s`` for which ``round(U(0, 1) * s + 0.5)`` has mean
    ``mu``: a number for a number, a tensor for a tensor."""
    floor = torch.floor if torch.is_tensor(mu) else math.floor
    k = floor(2 * mu - 1)
    x = k * (mu - 0.5 * (k + 1)) / (k + 1 - mu)
    return k + x


def halton_trajectory_length(i: Array, trajectory_length_adjustment, max_bits: int = 10):
    """A quasi-random integer trajectory length of the requested mean, one
    per element of ``i``, computed in float64 (the sequence's values are
    exact in any float dtype)."""
    scale = rescale(trajectory_length_adjustment)
    return torch.round(0.5 + halton_sequence(i, max_bits).double() * scale).to(torch.int64)
