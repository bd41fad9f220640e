"""Mean-field (diagonal Gaussian) ADVI; reference
``blackjax_tpu/vi/meanfield_vi.py``.

The position is a ``(d,)`` tensor; ``mu`` and ``rho`` (the log standard
deviations) are ``(d,)`` tensors in its dtype, on its device. A draw is ``mu +
exp(rho) * normal(key, (num_samples, d))`` through :func:`prng.normal`, the
JAX package's numbers from the same key words (or fresh key words from a
``torch.Generator``). ``logdensity_fn`` maps a ``(n, d)`` batch to ``(n,)``.
"""
import math
from typing import Callable, NamedTuple

import torch

from blackjax_tpu_torch import prng
from blackjax_tpu_torch.base import VIAlgorithm
from blackjax_tpu_torch.types import ArrayLikeTree, ArrayTree, PRNGKey
from blackjax_tpu_torch.util import chain_keys, require_tensor_position
from blackjax_tpu_torch.vi._gaussian_vi import KL, Objective, elbo_step

__all__ = ["MFVIState", "MFVIInfo", "init", "step", "sample", "as_top_level_api"]


class MFVIState(NamedTuple):
    mu: ArrayTree
    rho: ArrayTree  # log standard deviations
    opt_state: object


class MFVIInfo(NamedTuple):
    elbo: torch.Tensor


def init(position: ArrayLikeTree, optimizer, *optimizer_args, **optimizer_kwargs) -> MFVIState:
    """Zero mean, log-scale -2 (sd about 0.135)."""
    require_tensor_position(position, "meanfield_vi")
    mu = torch.zeros_like(position)
    rho = torch.full_like(position, -2.0)
    return MFVIState(mu, rho, optimizer.init((mu, rho)))


def _sample(rng_key, mu, rho, num_samples):
    """Reparameterised draws ``mu + exp(rho) * eps``, ``(num_samples, d)``."""
    white = prng.normal(chain_keys(rng_key, mu), (num_samples, mu.shape[-1]), mu.dtype)
    return mu + torch.exp(rho) * white


def generate_meanfield_logdensity(mu, rho):
    """The diagonal Gaussian's log density in closed form, of a ``(..., d)``
    batch."""
    norm_const = -rho.sum() - 0.5 * mu.shape[-1] * math.log(2.0 * math.pi)

    def logdensity(position):
        standardized = (position - mu) * torch.exp(-rho)
        return norm_const - 0.5 * torch.square(standardized).sum(-1)

    return logdensity


def step(
    rng_key: PRNGKey,
    state: MFVIState,
    logdensity_fn: Callable,
    optimizer,
    num_samples: int = 5,
    objective: Objective = KL(),
    stl_estimator: bool = True,
) -> tuple[MFVIState, MFVIInfo]:
    """One reparameterised-gradient update of ``(mu, rho)``."""
    (mu, rho), opt_state, loss = elbo_step(
        rng_key,
        (state.mu, state.rho),
        state.opt_state,
        logdensity_fn,
        optimizer,
        lambda key, params, n: _sample(key, params[0], params[1], n),
        lambda params: generate_meanfield_logdensity(params[0], params[1]),
        num_samples,
        objective=objective,
        stl_estimator=stl_estimator,
    )
    return MFVIState(mu, rho, opt_state), MFVIInfo(loss)


def sample(rng_key: PRNGKey, state: MFVIState, num_samples: int = 1):
    return _sample(rng_key, state.mu, state.rho, num_samples)


def as_top_level_api(
    logdensity_fn: Callable,
    optimizer,
    num_samples: int = 100,
    objective: Objective = KL(),
    stl_estimator: bool = True,
) -> VIAlgorithm:
    """``blackjax_tpu_torch.meanfield_vi(...)``."""

    def init_fn(position):
        return init(position, optimizer)

    def step_fn(rng_key, state):
        return step(rng_key, state, logdensity_fn, optimizer, num_samples, objective=objective,
                    stl_estimator=stl_estimator)

    def sample_fn(rng_key, state, num_samples):
        return sample(rng_key, state, num_samples)

    return VIAlgorithm(init_fn, step_fn, sample_fn)
