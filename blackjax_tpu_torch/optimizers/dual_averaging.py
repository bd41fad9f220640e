"""Nesterov primal-dual averaging (Hoffman & Gelman 2014, §3.2.1); reference
``blackjax_tpu/optimizers/dual_averaging.py``.

The state is a handful of scalars, kept as Python numbers (double precision)
on the host: the warmup reads the step size back once per transition anyway,
and a kernel takes it as a number.
"""
import math
from typing import Callable, NamedTuple

__all__ = ["DualAveragingState", "dual_averaging"]


class DualAveragingState(NamedTuple):
    log_x: float
    log_x_avg: float
    step: int
    avg_error: float
    mu: float


def dual_averaging(
    t0: int = 10, gamma: float = 0.05, kappa: float = 0.75
) -> tuple[Callable, Callable, Callable]:
    """Return ``(init, update, final)`` minimizing an observed error signal
    by primal-dual subgradient averaging. ``t0`` damps early iterations,
    ``gamma`` the primal gain, ``kappa`` the Polyak averaging decay."""

    def init(x_init: float) -> DualAveragingState:
        x_init = float(x_init)
        return DualAveragingState(
            log_x=math.log(x_init),
            log_x_avg=0.0,
            step=1,
            avg_error=0.0,
            mu=math.log(10.0 * x_init),
        )

    def update(state: DualAveragingState, gradient) -> DualAveragingState:
        log_x, log_x_avg, step, avg_error, mu = state
        reg_step = step + t0
        eta = step ** (-kappa)
        avg_error = (1.0 - 1.0 / reg_step) * avg_error + float(gradient) / reg_step
        new_log_x = mu - (math.sqrt(step) / gamma) * avg_error
        # Polyak-averages the *previous* iterate, as the reference does
        new_log_x_avg = eta * log_x + (1.0 - eta) * log_x_avg
        return DualAveragingState(new_log_x, new_log_x_avg, step + 1, avg_error, mu)

    def final(state: DualAveragingState) -> float:
        return math.exp(state.log_x_avg)

    return init, update, final
