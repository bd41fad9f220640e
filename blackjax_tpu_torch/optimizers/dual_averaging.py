"""Nesterov primal-dual averaging (Hoffman & Gelman 2014, §3.2.1); reference
``blackjax_tpu/optimizers/dual_averaging.py``.

The state is a handful of scalars, kept as Python numbers (double precision)
on the host: the warmup reads the step size back once per transition anyway,
and a kernel takes it as a number. ``tensor_init`` and ``tensor_update`` are
the same update on tensors on the device, which a warmup steps without a
host read: ChEES's one controller (0-d tensors) and Pathfinder's warmup, a
controller a chain (``(C,)`` tensors).
"""
import math
from typing import Callable, NamedTuple

import torch

from blackjax_tpu_torch import prng

__all__ = ["DualAveragingState", "dual_averaging", "tensor_init", "tensor_update"]


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


# the reference's defaults (t0, gamma, kappa), which both tensor warmups use
_DA_T0, _DA_GAMMA, _DA_KAPPA = 10, 0.05, 0.75


def _fma(a, b, c):
    """``a * b + c`` rounded once, where XLA contracts the reference's
    multiply-add; ``b`` may be a number."""
    return torch.addcmul(c, a, b if torch.is_tensor(b) else torch.full_like(a, b))


def tensor_init(x_init: torch.Tensor) -> DualAveragingState:
    """The reference's ``dual_averaging()`` state of ``x_init`` (a tensor of
    any shape, a controller an element), on its device: ``step`` an integer
    tensor of the same shape (a rejected update keeps the old one)."""
    zero = torch.zeros_like(x_init)
    step = torch.ones(x_init.shape, dtype=prng.default_int_dtype(x_init.dtype),
                      device=x_init.device)
    return DualAveragingState(torch.log(x_init), zero, step, zero, torch.log(10.0 * x_init))


def tensor_update(state: DualAveragingState, gradient) -> DualAveragingState:
    """The reference's dual-averaging update on tensors, its multiply-adds
    fused as XLA contracts them."""
    log_x, log_x_avg, step, avg_error, mu = state
    step_f = step.to(avg_error.dtype)
    reg_step = step_f + _DA_T0
    eta = step_f ** (-_DA_KAPPA)
    avg_error = _fma(avg_error, 1.0 - 1.0 / reg_step, gradient / reg_step)
    new_log_x = _fma(-(torch.sqrt(step_f) / _DA_GAMMA), avg_error, mu)
    new_log_x_avg = _fma(eta, log_x, (1.0 - eta) * log_x_avg)
    return DualAveragingState(new_log_x, new_log_x_avg, step + 1, avg_error, mu)
