"""HMC chain state (reference ``blackjax_tpu/mcmc/hmc.py``).

This slice ports the state, the info record and ``init``, which NUTS
shares; the static and multinomial HMC kernels come with a later slice.
"""
from typing import Callable, NamedTuple

from blackjax_tpu_torch.mcmc import integrators
from blackjax_tpu_torch.types import ArrayLikeTree, ArrayTree
from blackjax_tpu_torch.util import value_and_grad

__all__ = ["HMCState", "HMCInfo", "init"]


class HMCState(NamedTuple):
    """Positions of every chain plus their cached logdensity and gradient."""

    position: ArrayTree
    logdensity: ArrayTree
    logdensity_grad: ArrayTree


class HMCInfo(NamedTuple):
    """Per-transition diagnostics."""

    momentum: ArrayTree
    acceptance_rate: ArrayTree
    is_accepted: ArrayTree
    is_divergent: ArrayTree
    energy: ArrayTree
    proposal: integrators.IntegratorState
    num_integration_steps: ArrayTree


def init(position: ArrayLikeTree, logdensity_fn: Callable) -> HMCState:
    """State of ``(C, d)`` positions (or one ``(d,)`` position);
    ``logdensity_fn`` maps ``(..., d)`` to ``(...)``."""
    logdensity, logdensity_grad = value_and_grad(logdensity_fn, position)
    return HMCState(position, logdensity, logdensity_grad)
