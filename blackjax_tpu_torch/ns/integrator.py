"""Evidence (log Z) accumulation for nested sampling (reference
``blackjax_tpu/ns/integrator.py``).

Every operation runs in the log likelihoods' dtype, as the reference's do
in a float32 run; the cumulative volume sums in XLA's order
(:func:`blackjax_tpu_torch.prng.xla_cumsum`).
"""
import math
from typing import NamedTuple

import torch

from blackjax_tpu_torch.ns.base import StateWithLogLikelihood
from blackjax_tpu_torch.prng import xla_cumsum
from blackjax_tpu_torch.types import Array

__all__ = ["NSIntegrator", "init_integrator", "update_integrator"]


def log1mexp(x: Array) -> Array:
    """Stable ``log(1 - exp(x))`` for x <= 0 (clamped against f32 drift)."""
    x = torch.clamp(x, max=-torch.finfo(x.dtype).eps)
    return torch.where(x > -0.6931472, torch.log(-torch.expm1(x)), torch.log1p(-torch.exp(x)))


def _logmeanexp(x: Array) -> Array:
    n = torch.tensor(float(x.shape[0]), dtype=x.dtype, device=x.device)
    return torch.logsumexp(x, 0) - torch.log(n)


class NSIntegrator(NamedTuple):
    """Accumulated log prior volume, dead-point evidence and live-point
    evidence estimate."""

    logX: Array
    logZ: Array
    logZ_live: Array


def init_integrator(particle_state: StateWithLogLikelihood) -> NSIntegrator:
    loglikelihood = particle_state.loglikelihood
    logX = torch.zeros((), dtype=loglikelihood.dtype, device=loglikelihood.device)
    return NSIntegrator(
        logX,
        torch.full_like(logX, -math.inf),
        _logmeanexp(loglikelihood) + logX,
    )


def update_integrator(
    integrator: NSIntegrator,
    particle_state: StateWithLogLikelihood,
    dead_particles: StateWithLogLikelihood,
) -> NSIntegrator:
    """Shrink the volume by ``1/n_live`` per deletion and add each dead
    point's likelihood shell, anchored on the pre-deletion volume
    (anchoring post-deletion biases log Z low by about 1/n)."""
    loglikelihood = particle_state.loglikelihood
    dead_loglikelihood = dead_particles.loglikelihood
    dtype, device = loglikelihood.dtype, loglikelihood.device

    n = loglikelihood.shape[0]
    k = dead_loglikelihood.shape[0]
    num_live = torch.arange(n, n - k, -1, device=device).to(dtype)
    delta_logX = -1.0 / num_live
    logX = integrator.logX + xla_cumsum(delta_logX)
    logX_prev = torch.cat([integrator.logX[None], logX[:-1]])
    log_shell = logX_prev + log1mexp(delta_logX)

    logZ = torch.logaddexp(integrator.logZ,
                           torch.logsumexp(dead_loglikelihood + log_shell, 0))
    return NSIntegrator(logX[-1], logZ, _logmeanexp(loglikelihood) + logX[-1])
