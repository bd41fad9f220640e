"""Step-size adaptation (reference ``blackjax_tpu/adaptation/step_size.py``):
dual averaging on the acceptance-rate error, the doubling/halving search for
a reasonable first step size, and the bracketing bisection controller.

Step sizes are Python numbers (double precision), as the dual-averaging
state is (:mod:`blackjax_tpu_torch.optimizers.dual_averaging`).
"""
import math
import sys
from typing import Callable, NamedTuple

import torch

from blackjax_tpu_torch.optimizers.dual_averaging import DualAveragingState, dual_averaging
from blackjax_tpu_torch.types import PRNGKey

__all__ = [
    "DualAveragingAdaptationState",
    "dual_averaging_adaptation",
    "find_reasonable_step_size",
    "bisection_monotonic_fn",
]


class DualAveragingAdaptationState(NamedTuple):
    log_step_size: float
    log_step_size_avg: float
    step: int
    avg_error: float
    mu: float


def dual_averaging_adaptation(
    target: float, t0: int = 10, gamma: float = 0.05, kappa: float = 0.75
) -> tuple[Callable, Callable, Callable]:
    """Tune the step size so the observed acceptance rate converges to
    ``target``: dual averaging on the error ``target - acceptance_rate``."""
    da_init, da_update, da_final = dual_averaging(t0, gamma, kappa)

    def init(initial_step_size: float) -> DualAveragingAdaptationState:
        return DualAveragingAdaptationState(*da_init(initial_step_size))

    def update(
        state: DualAveragingAdaptationState, acceptance_rate: float
    ) -> DualAveragingAdaptationState:
        return DualAveragingAdaptationState(
            *da_update(DualAveragingState(*state), target - float(acceptance_rate))
        )

    def final(state: DualAveragingAdaptationState) -> float:
        return math.exp(state.log_step_size_avg)

    return init, update, final


def find_reasonable_step_size(
    rng_key: PRNGKey,
    kernel_generator: Callable[[float], Callable],
    reference_state,
    initial_step_size: float,
    target_accept: float = 0.65,
) -> float:
    """Double or halve the step size until the kernel's acceptance rate
    crosses ``target_accept``, probing from ``reference_state`` each time
    (the chain never moves). Every probe draws from ``rng_key``; for a block
    of chains the mean acceptance rate decides."""
    largest, smallest = sys.float_info.max, sys.float_info.min
    direction, previous_direction = 0, 0
    step_size = float(initial_step_size)
    while (
        (step_size < largest or direction <= 0)
        and (step_size > smallest or direction >= 0)
        and (previous_direction == 0 or direction == previous_direction)
    ):
        step_size = (2.0**direction) * step_size
        _, info = kernel_generator(step_size)(rng_key, reference_state)
        rate = float(torch.as_tensor(info.acceptance_rate).mean())
        previous_direction, direction = direction, (1 if target_accept < rate else -1)
    return step_size


def bisection_monotonic_fn(acc_prob_wanted, reduce_shift=math.log(2.0), tolerance=0.03):
    """Bracketing bisection on the log step size against an acceptance rate
    that decreases with the step size; needs no initial bracket. Returns
    ``update((bounds, terminated), step_size, acc_rate) -> ((bounds,
    terminated), new_step_size)`` with ``bounds = (lower, upper)`` in log
    step size, ``(-inf, inf)`` to start."""

    def update(state, current_step_size, acc_rate):
        (lower, upper), terminated = state
        x = math.log(current_step_size)
        acc_high = acc_rate > acc_prob_wanted
        if acc_high:
            lower = max(lower, x)
        else:
            upper = min(upper, x)
        probe = lower + reduce_shift if acc_high else upper - reduce_shift
        bracketing = math.isfinite(lower) and math.isfinite(upper)
        x_new = (lower + upper) / 2.0 if bracketing else probe
        step_size = current_step_size if terminated else math.exp(x_new)
        new_terminated = abs(acc_rate - acc_prob_wanted) < tolerance or bool(terminated)
        return ((lower, upper), new_terminated), step_size

    return update
