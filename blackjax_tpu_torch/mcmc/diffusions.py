"""Euler solvers for diffusion processes used by gradient-based samplers
(reference ``blackjax_tpu/mcmc/diffusions.py``).

Every chain of a ``(C, d)`` block moves at once; the noise is a ``(d,)``
draw per chain from its key (:func:`blackjax_tpu_torch.util.generate_gaussian_noise`).
"""
from typing import NamedTuple

import torch

from blackjax_tpu_torch.types import ArrayTree
from blackjax_tpu_torch.util import generate_gaussian_noise

__all__ = ["DiffusionState", "overdamped_langevin"]


class DiffusionState(NamedTuple):
    position: ArrayTree
    logdensity: ArrayTree
    logdensity_grad: ArrayTree


def _per_chain(step_size, position):
    """The step size as a tensor of ``position``'s dtype that broadcasts
    over its last axis: a number or a 0-d tensor is shared, a ``(C,)``
    tensor is one step size per chain."""
    step = torch.as_tensor(step_size, dtype=position.dtype, device=position.device)
    return step.unsqueeze(-1) if step.dim() > 0 else step


def overdamped_langevin(logdensity_grad_fn):
    """Euler-Maruyama step of the overdamped Langevin SDE
    ``dx = grad(logpi)(x) dt + sqrt(2) dW``; ``logdensity_grad_fn`` maps
    ``(C, d)`` positions to ``((C,), (C, d))``."""

    def one_step(rng_key, state: DiffusionState, step_size, batch: tuple = ()):
        position, _, grad = state
        noise = generate_gaussian_noise(rng_key, position)
        step = _per_chain(step_size, position)
        new_position = position + step * grad + torch.sqrt(2.0 * step) * noise
        logdensity, logdensity_grad = logdensity_grad_fn(new_position, *batch)
        return DiffusionState(new_position, logdensity, logdensity_grad)

    return one_step
