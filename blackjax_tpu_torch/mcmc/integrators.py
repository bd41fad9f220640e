"""Symplectic integrators for Hamiltonian dynamics with a fixed (Euclidean)
metric (reference ``blackjax_tpu/mcmc/integrators.py``).

A scheme is a palindromic list of coefficients ``[b1, a1, b2, ...]``:
momentum kicks at even slots, position drifts at odd slots. The gradient of
the log-density and the velocity ``dK/dp`` come from autograd of the
batch-summed value, so one call integrates every chain of a ``(C, d)``
batch; the step size may be one number or one per chain ``(C,)``.

The isokinetic (ESH / MCLMC) family works on the event axis, the last one:
norms, dot products and the dimension ``d`` are taken per chain, so ``(C, d)``
and ``(d,)`` positions both work. The implicit-midpoint and Riemannian
integrators come with later slices.
"""
import math
from typing import Any, Callable, NamedTuple, TypeAlias

import torch

from blackjax_tpu_torch import prng
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
    "esh_momentum_kick",
    "generate_isokinetic_integrator",
    "isokinetic_velocity_verlet",
    "isokinetic_mclachlan",
    "isokinetic_yoshida",
    "isokinetic_omelyan",
    "partially_refresh_momentum",
    "with_isokinetic_maruyama",
]


class IntegratorState(NamedTuple):
    """Point in phase space with its cached logdensity and gradient."""

    position: ArrayTree
    momentum: ArrayTree
    logdensity: Any
    logdensity_grad: ArrayTree


Integrator: TypeAlias = Callable[[IntegratorState, float], IntegratorState]


def _per_row(scale, x):
    """A per-chain ``(C,)`` scale shaped to multiply the rows of ``x``; a
    number or a 0-d tensor passes through."""
    if torch.is_tensor(scale) and 0 < scale.dim() < x.dim():
        scale = scale.reshape(scale.shape + (1,) * (x.dim() - scale.dim()))
    return scale


def _axpy(x, update, scale):
    """``x + scale * update``; a per-chain ``(C,)`` scale applies to rows."""
    return x + _per_row(scale, x) * update


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


# ------------------------------------------------------------------------
# Isokinetic (ESH / microcanonical Langevin) family (reference
# ``integrators.py:135-272``), per chain over the last axis.
# ------------------------------------------------------------------------


def _unit(x, tol=1e-13):
    """``(x / |x|, |x|)`` per row; a row whose norm is at most ``tol`` is
    returned as it is. The norm keeps the event axis, as ``(..., 1)``."""
    norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return torch.where(norm > tol, x / norm, x), norm


def esh_momentum_kick(inverse_mass_matrix=1.0):
    """One momentum update of the ESH dynamics in the overflow-free form,
    through ``zeta = exp(-delta)`` only (reference ``integrators.py:145``).

    ``inverse_mass_matrix`` is a scalar or a ``(d,)`` diagonal. Returns
    ``(kick, velocity_scale)``: ``kick(momentum, grad, delta_t) ->
    (new_momentum, kinetic_energy_change)`` on ``(..., d)`` rows, with a
    ``(...)`` energy change, and ``velocity_scale(u)`` maps a unit momentum
    to the position-space velocity direction.
    """
    if isinstance(inverse_mass_matrix, tuple):
        raise NotImplementedError(
            "low-rank inverse mass matrices (LowRankInverseMassMatrix) are not "
            "ported yet: ROADMAP queue 1, item 6"
        )
    sqrt_imm = torch.sqrt(torch.as_tensor(inverse_mass_matrix))

    def adjoint_L(g):
        return g * sqrt_imm.to(g)

    def forward_L(u):
        return u * sqrt_imm.to(u)

    def kick(momentum, grad, delta_t):
        dims = momentum.shape[-1]
        g = adjoint_L(grad)
        e, grad_norm = _unit(g)
        proj = (momentum * e).sum(-1, keepdim=True)
        delta = _per_row(delta_t, momentum) * grad_norm / (dims - 1)
        zeta = torch.exp(-delta)
        unnormalized = (
            e * ((1.0 - zeta) * (1.0 + zeta + proj * (1.0 - zeta)))
            + 2.0 * zeta * momentum
        )
        new_momentum, _ = _unit(unnormalized)
        dK = (dims - 1) * (
            delta - math.log(2.0) + torch.log1p(proj + (1.0 - proj) * zeta**2)
        )
        return new_momentum, dK.squeeze(-1)

    return kick, forward_L


def generate_isokinetic_integrator(coefficients: list[float]):
    """Isokinetic integrator factory from a palindromic scheme (reference
    ``integrators.py:202``). The step is ``(state, step_size) -> (state,
    dK)``, with ``dK`` the summed kinetic-energy change of the kicks, one
    per chain."""

    def integrator(logdensity_fn: Callable, inverse_mass_matrix=1.0):
        kick, forward_L = esh_momentum_kick(inverse_mass_matrix)

        def one_step(state: IntegratorState, step_size):
            position, momentum, logdensity, grad = state
            kinetic_change = 0.0
            for stage, coef in enumerate(coefficients):
                if stage % 2 == 0:
                    momentum, dK = kick(momentum, grad, coef * step_size)
                    kinetic_change = kinetic_change + dK
                else:
                    position = _axpy(position, forward_L(momentum), coef * step_size)
                    logdensity, grad = value_and_grad(logdensity_fn, position)
            return IntegratorState(position, momentum, logdensity, grad), kinetic_change

        return one_step

    return integrator


isokinetic_velocity_verlet = generate_isokinetic_integrator(velocity_verlet_coefficients)
isokinetic_mclachlan = generate_isokinetic_integrator(mclachlan_coefficients)
isokinetic_yoshida = generate_isokinetic_integrator(yoshida_coefficients)
isokinetic_omelyan = generate_isokinetic_integrator(omelyan_coefficients)


def _normal(rng_key, like):
    """Standard normals shaped like ``like``: drawn from ``rng_key``, a
    ``torch.Generator``, or ``rng_key`` itself where the caller hands in the
    draw (as a test hands in the reference's)."""
    if torch.is_tensor(rng_key):
        return rng_key.to(like)
    return torch.randn(like.shape, generator=rng_key, dtype=like.dtype, device=like.device)


def partially_refresh_momentum(momentum, rng_key, step_size, L):
    """Ornstein-Uhlenbeck partial momentum refresh on the unit sphere with
    decoherence length ``L`` (reference ``integrators.py:243``).

    ``rng_key`` is a ``torch.Generator``, or the standard normals it would
    draw, shaped like ``momentum``. ``step_size`` and ``L`` are numbers or
    tensors (0-d, or one per chain); ``L = inf`` leaves the momentum as it
    is."""
    normal = _normal(rng_key, momentum)
    dim = momentum.shape[-1]
    step_size = torch.as_tensor(step_size, dtype=momentum.dtype, device=momentum.device)
    L = torch.as_tensor(L, dtype=momentum.dtype, device=momentum.device)
    nu = torch.sqrt((torch.exp(2.0 * step_size / L) - 1.0) / dim)
    noisy = momentum + _per_row(nu, momentum) * normal
    refreshed = noisy / torch.linalg.vector_norm(noisy, dim=-1, keepdim=True)
    return torch.where(_per_row(torch.isinf(L), momentum), momentum, refreshed)


def with_isokinetic_maruyama(integrator):
    """Strang-split the deterministic isokinetic step between two half-step
    O-U momentum refreshes (reference ``integrators.py:255``).

    The step is ``(state, step_size, L, rng_key) -> (state, dK)``. ``rng_key``
    is key words (one key a chain), split into the refresh before the step
    and the one after it as the reference splits them, each drawing
    ``jax.random.normal`` over the momentum's last axis; or a
    ``torch.Generator``, from which the refresh before the step draws its
    normals first and the refresh after it second; or that pair of normals
    ``(before, after)``, each shaped like the momentum. Where ``L`` is the
    number ``inf`` the refreshes leave the momentum as it is and draw
    nothing."""

    def stochastic_step(state: IntegratorState, step_size, L_proposal, rng_key):
        if isinstance(L_proposal, (int, float)) and math.isinf(L_proposal):
            return integrator(state, step_size)
        if isinstance(rng_key, tuple):
            before, after = rng_key
        elif torch.is_tensor(rng_key) and not rng_key.is_floating_point():
            key_pre, key_post = prng.split(rng_key).unbind(-2)
            shape, dtype = state.momentum.shape[rng_key.dim() - 1:], state.momentum.dtype
            before, after = prng.normal(key_pre, shape, dtype), prng.normal(key_post, shape, dtype)
        else:
            before = after = rng_key
        momentum = partially_refresh_momentum(state.momentum, before, 0.5 * step_size, L_proposal)
        state, kinetic_change = integrator(state._replace(momentum=momentum), step_size)
        momentum = partially_refresh_momentum(state.momentum, after, 0.5 * step_size, L_proposal)
        return state._replace(momentum=momentum), kinetic_change

    return stochastic_step
