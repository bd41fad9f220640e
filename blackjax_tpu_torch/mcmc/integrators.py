"""Symplectic integrators for Hamiltonian dynamics with a fixed (Euclidean)
metric (reference ``blackjax_tpu/mcmc/integrators.py``).

A scheme is a palindromic list of coefficients ``[b1, a1, b2, ...]``:
momentum kicks at even slots, position drifts at odd slots. The gradient of
the log-density and the velocity ``dK/dp`` come from autograd of the
batch-summed value, so one call integrates every chain of a ``(C, d)``
batch; the step size may be one number or one per chain ``(C,)``.
The isokinetic, implicit-midpoint and Riemannian integrators come with
later slices.
"""
from typing import Any, Callable, NamedTuple, TypeAlias

import torch

from blackjax_tpu_torch.types import ArrayTree
from blackjax_tpu_torch.util import value_and_grad

__all__ = [
    "IntegratorState",
    "new_integrator_state",
    "velocity_verlet",
    "mclachlan",
    "yoshida",
    "omelyan",
    "generate_euclidean_integrator",
]


class IntegratorState(NamedTuple):
    """Point in phase space with its cached logdensity and gradient."""

    position: ArrayTree
    momentum: ArrayTree
    logdensity: Any
    logdensity_grad: ArrayTree


Integrator: TypeAlias = Callable[[IntegratorState, float], IntegratorState]


def _axpy(x, update, scale):
    """``x + scale * update``; a per-chain ``(C,)`` scale applies to rows."""
    if torch.is_tensor(scale) and 0 < scale.dim() < x.dim():
        scale = scale.reshape(scale.shape + (1,) * (x.dim() - scale.dim()))
    return x + scale * update


def new_integrator_state(logdensity_fn, position, momentum) -> IntegratorState:
    logdensity, logdensity_grad = value_and_grad(logdensity_fn, position)
    return IntegratorState(position, momentum, logdensity, logdensity_grad)


velocity_verlet_coefficients = [0.5, 1.0, 0.5]

_mn2_b = 0.1931833275037836
mclachlan_coefficients = [_mn2_b, 0.5, 1.0 - 2.0 * _mn2_b, 0.5, _mn2_b]

_y_b1, _y_a1 = 0.11888010966548, 0.29619504261126
yoshida_coefficients = [
    _y_b1, _y_a1, 0.5 - _y_b1, 1.0 - 2.0 * _y_a1, 0.5 - _y_b1, _y_a1, _y_b1,
]

_o_b1, _o_a1 = 0.08398315262876693, 0.2539785108410595
_o_b2, _o_a2 = 0.6822365335719091, -0.03230286765269967
_o_b3 = 0.5 - _o_b1 - _o_b2
_o_a3 = 1.0 - 2.0 * (_o_a1 + _o_a2)
omelyan_coefficients = [
    _o_b1, _o_a1, _o_b2, _o_a2, _o_b3, _o_a3, _o_b3, _o_a2, _o_b2, _o_a1, _o_b1,
]


def generate_euclidean_integrator(coefficients: list[float]):
    """Integrator factory for Newtonian dynamics with a fixed metric
    (reference ``integrators.py:105``)."""

    def integrator(logdensity_fn: Callable, kinetic_energy_fn: Callable) -> Integrator:
        def one_step(state: IntegratorState, step_size) -> IntegratorState:
            position, momentum, logdensity, grad = state
            for stage, coef in enumerate(coefficients):
                if stage % 2 == 0:  # momentum kick along the potential gradient
                    momentum = _axpy(momentum, grad, coef * step_size)
                else:  # position drift along the velocity M^-1 p
                    _, velocity = value_and_grad(kinetic_energy_fn, momentum)
                    position = _axpy(position, velocity, coef * step_size)
                    logdensity, grad = value_and_grad(logdensity_fn, position)
            return IntegratorState(position, momentum, logdensity, grad)

        return one_step

    return integrator


velocity_verlet = generate_euclidean_integrator(velocity_verlet_coefficients)
mclachlan = generate_euclidean_integrator(mclachlan_coefficients)
yoshida = generate_euclidean_integrator(yoshida_coefficients)
omelyan = generate_euclidean_integrator(omelyan_coefficients)
