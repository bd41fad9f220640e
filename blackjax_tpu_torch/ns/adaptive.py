"""Adaptive nested sampling: the inner kernel's parameters are retuned from
the live set once an outer step, the evidence accumulated on the fly
(reference ``blackjax_tpu/ns/adaptive.py``)."""
import math
from functools import partial
from typing import Callable, NamedTuple, Optional

from blackjax_tpu_torch import prng
from blackjax_tpu_torch.ns.base import NSInfo, StateWithLogLikelihood
from blackjax_tpu_torch.ns.base import build_kernel as base_build_kernel
from blackjax_tpu_torch.ns.base import init as base_init
from blackjax_tpu_torch.ns.integrator import NSIntegrator, init_integrator, update_integrator
from blackjax_tpu_torch.types import ArrayLikeTree, PRNGKey

__all__ = ["AdaptiveNSState", "init", "build_kernel"]


class AdaptiveNSState(NamedTuple):
    particles: StateWithLogLikelihood
    integrator: NSIntegrator
    inner_kernel_params: dict


def init(
    positions: ArrayLikeTree,
    init_state_fn: Callable,
    loglikelihood_birth=math.nan,
    update_inner_kernel_params_fn: Optional[Callable] = None,
    rng_key: Optional[PRNGKey] = None,
) -> AdaptiveNSState:
    base_state = base_init(positions, init_state_fn, loglikelihood_birth)
    params = {}
    if update_inner_kernel_params_fn is not None:
        params = update_inner_kernel_params_fn(rng_key, base_state, None, {})
    return AdaptiveNSState(
        base_state.particles, init_integrator(base_state.particles), params
    )


def build_kernel(
    delete_fn: Callable,
    inner_kernel: Callable,
    update_inner_kernel_params_fn: Callable,
) -> Callable:
    """Each step: run the base NS kernel with the carried inner-kernel
    parameters, retune them from the new live set and this step's info, and
    advance the evidence integrator."""

    def kernel(rng_key: PRNGKey, state: AdaptiveNSState) -> tuple[AdaptiveNSState, NSInfo]:
        step = base_build_kernel(
            delete_fn, partial(inner_kernel, **state.inner_kernel_params)
        )
        new_state, info = step(rng_key, state)
        params_key, rng_key = prng.split(rng_key.to(state.integrator.logX.device))
        new_params = update_inner_kernel_params_fn(
            params_key, new_state, info, new_state.inner_kernel_params
        )
        new_integrator = update_integrator(
            state.integrator, new_state.particles, info.particles
        )
        return AdaptiveNSState(new_state.particles, new_integrator, new_params), info

    return kernel
