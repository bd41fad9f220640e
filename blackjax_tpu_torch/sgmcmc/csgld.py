"""Contour SGLD: flat-histogram dynamic importance sampling over energy bins
for multimodal targets (Deng et al. 2020/2022; reference
``blackjax_tpu/sgmcmc/csgld.py``).

The energy axis ``[min_energy, min_energy + m * gap]`` is split into ``m``
bins. Each step (1) rescales the Langevin drift by one plus the local
log-slope of the estimated bin-occupation histogram and (2) nudges the
histogram toward the one-hot indicator of the bin the chain landed in. Every
chain of a ``(C, d)`` block carries its own histogram ``(C, m)`` and bin
index ``(C,)``; the indicator is a ``scatter_add_`` of ones at each chain's
bin, and the histogram is kept in the position's dtype.
"""
from typing import Callable, NamedTuple

import torch

from blackjax_tpu_torch.base import SamplingAlgorithm
from blackjax_tpu_torch.sgmcmc.diffusions import overdamped_langevin
from blackjax_tpu_torch.types import Array, ArrayLikeTree, ArrayTree, PRNGKey

__all__ = ["ContourSGLDState", "init", "build_kernel", "as_top_level_api"]


class ContourSGLDState(NamedTuple):
    """Position, the running estimate of the energy-bin occupation
    probabilities, and the current bin index (one a chain)."""

    position: ArrayTree
    energy_pdf: Array
    energy_idx: int


def _locate_bin(energy, min_energy, energy_gap, num_partitions):
    """Bin index of an energy value (int32); the two edge bins absorb the
    tails."""
    raw = torch.floor((energy - min_energy) / energy_gap) + 1
    return torch.clamp(raw, 1, num_partitions - 1).to(torch.int32)


def _at(energy_pdf, idx):
    """Each chain's histogram value at its bin ``idx``."""
    return torch.gather(energy_pdf, -1, idx.to(torch.int64)[..., None])[..., 0]


def _flattening_scale(energy_pdf, idx, zeta, temperature, energy_gap):
    """Drift multiplier from the local log-slope of the bin histogram:
    ``1 + zeta * T * d(log pdf)/du`` as the backward difference across one
    bin; ``zeta = 0`` recovers plain SGLD."""
    log_slope = (torch.log(_at(energy_pdf, idx)) - torch.log(_at(energy_pdf, idx - 1))) / energy_gap
    return 1.0 + zeta * temperature * log_slope


def _histogram_push(energy_pdf, idx):
    """Stochastic-approximation move of the histogram toward the one-hot
    indicator of bin ``idx``, with gain the bin's mass: the unscaled drift,
    which the caller multiplies by the stochastic step size."""
    index = idx.to(torch.int64)[..., None]
    indicator = torch.zeros_like(energy_pdf).scatter_add_(
        -1, index, torch.ones_like(index, dtype=energy_pdf.dtype))
    return _at(energy_pdf, idx)[..., None] * (indicator - energy_pdf)


def init(position: ArrayLikeTree, num_partitions: int = 512) -> ContourSGLDState:
    """A linearly decaying prior over the bins, the start attributed to the
    top bin, for every chain of ``position``."""
    ramp = torch.arange(num_partitions, 0.0, -1.0, dtype=position.dtype, device=position.device)
    batch = position.shape[:-1]
    pdf = (ramp / ramp.sum()).expand(batch + (num_partitions,)).clone()
    idx = torch.full(batch, num_partitions - 1, dtype=torch.int32, device=position.device)
    return ContourSGLDState(position, pdf, idx)


def build_kernel(num_partitions=512, energy_gap=10, min_energy=0) -> Callable:
    """The contour-SGLD transition over ``num_partitions`` energy bins of
    width ``energy_gap`` starting at ``min_energy``."""
    langevin = overdamped_langevin()

    def kernel(
        rng_key: PRNGKey,
        state: ContourSGLDState,
        logdensity_estimator: Callable,
        gradient_estimator: Callable,
        minibatch: ArrayLikeTree,
        step_size_diff: float,
        step_size_stoch: float = 1e-3,
        zeta: float = 1,
        temperature: float = 1.0,
    ) -> ContourSGLDState:
        scale = _flattening_scale(
            state.energy_pdf, state.energy_idx, zeta, temperature, energy_gap
        )
        flattened_grad = scale[..., None] * gradient_estimator(state.position, minibatch)
        position = langevin(
            rng_key, state.position, flattened_grad, step_size_diff, temperature
        )
        energy = -logdensity_estimator(position, minibatch)
        idx = _locate_bin(energy, min_energy, energy_gap, num_partitions)
        energy_pdf = state.energy_pdf + step_size_stoch * _histogram_push(
            state.energy_pdf, idx
        )
        return ContourSGLDState(position, energy_pdf, idx)

    return kernel


def as_top_level_api(
    logdensity_estimator: Callable,
    gradient_estimator: Callable,
    zeta: float = 1,
    temperature: float = 0.01,
    num_partitions: int = 512,
    energy_gap: float = 100,
    min_energy: float = 0,
) -> SamplingAlgorithm:
    """``blackjax_tpu_torch.csgld(...)``."""
    kernel = build_kernel(num_partitions, energy_gap, min_energy)

    def init_fn(position, rng_key=None):
        del rng_key
        return init(position, num_partitions)

    def step_fn(rng_key, state, minibatch, step_size_diff, step_size_stoch=1e-3):
        return kernel(
            rng_key,
            state,
            logdensity_estimator,
            gradient_estimator,
            minibatch,
            step_size_diff,
            step_size_stoch,
            zeta,
            temperature,
        )

    return SamplingAlgorithm(init_fn, step_fn)
