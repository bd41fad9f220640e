"""The Schrödinger-Föllmer sampler: a diffusion bridge from a Dirac at zero
to the target over unit time, its drift estimated by inner Monte Carlo (Huang
et al. 2021); reference ``blackjax_tpu/vi/schrodinger_follmer.py``.

A state holds one bridge, ``(d,)`` with a 0-d time, or a batch of bridges,
``(B, d)`` with ``(B,)`` times and a key a bridge ``(B, 2)`` (key words, or
a ``torch.Generator`` that draws them); the time is in
the position's dtype (the reference's ``sample`` starts it in JAX's default
float type). Each bridge's key splits into the drift key and the SDE key, and
each bridge draws its own ``(n_samples, d)`` inner normals, as the reference's
``vmap`` of ``step`` does. ``logdensity_fn`` maps a ``(..., d)`` batch to
``(...)``.
"""
import math
from typing import Callable, NamedTuple

import torch

from blackjax_tpu_torch import prng
from blackjax_tpu_torch.base import VIAlgorithm
from blackjax_tpu_torch.types import ArrayLike, ArrayLikeTree, PRNGKey
from blackjax_tpu_torch.util import chain_keys, require_tensor_position

__all__ = ["SchrodingerFollmerState", "SchrodingerFollmerInfo", "init", "step", "sample"]


class SchrodingerFollmerState(NamedTuple):
    position: ArrayLikeTree
    time: ArrayLike


class SchrodingerFollmerInfo(NamedTuple):
    drift: ArrayLikeTree


def _relative_to_gaussian(position, logdensity_fn):
    """The density with respect to the standard Gaussian base measure: the
    Gaussian's negative log density added back."""
    return logdensity_fn(position) + 0.5 * torch.square(position).sum(-1)


def init(example_position: ArrayLikeTree) -> SchrodingerFollmerState:
    require_tensor_position(example_position, "schrodinger_follmer")
    return SchrodingerFollmerState(torch.zeros_like(example_position),
                                   example_position.new_zeros(example_position.shape[:-1]))


def step(
    rng_key: PRNGKey,
    state: SchrodingerFollmerState,
    logdensity_fn: Callable,
    step_size: float,
    n_samples: int,
) -> tuple[SchrodingerFollmerState, SchrodingerFollmerInfo]:
    """One Euler-Maruyama step of every bridge; the drift is a
    self-normalised Monte Carlo ratio over ``n_samples`` Gaussian
    perturbations at scale ``sqrt(1 - t)``, shifted by its largest log
    weight over the inner draws."""
    position = state.position
    keys = prng.split(chain_keys(rng_key, position))
    drift_key, sde_key = keys[..., 0, :], keys[..., 1, :]
    dim = position.shape[-1]
    scale = torch.sqrt(1.0 - state.time)

    eps = prng.normal(drift_key, (n_samples, dim), position.dtype)
    perturbed = position[..., None, :] + scale[..., None, None] * eps
    log_pdf = _relative_to_gaussian(perturbed, logdensity_fn)
    log_pdf = log_pdf - log_pdf.max(-1, keepdim=True).values
    pdf = torch.exp(log_pdf)

    numerator = (pdf[..., None, :] @ eps)[..., 0, :]
    denominator = scale * pdf.sum(-1)
    drift = numerator / denominator[..., None]

    noise = prng.normal(sde_key, (dim,), position.dtype)
    next_position = position + step_size * drift + math.sqrt(step_size) * noise
    return (SchrodingerFollmerState(next_position, state.time + step_size),
            SchrodingerFollmerInfo(drift))


def sample(
    rng_key: PRNGKey,
    initial_state: SchrodingerFollmerState,
    log_density_fn: Callable,
    n_steps: int,
    n_inner_samples: int,
    n_samples: int = 1,
):
    """Integrate ``n_samples`` independent bridges over ``n_steps`` Euler
    steps from zero; returns the terminal states. Step ``i`` draws with
    ``split(fold_in(rng_key, i), n_samples)``, a key a bridge; the keys of
    every step are folded in one call before a host loop that reads nothing
    back."""
    position = initial_state.position
    require_tensor_position(position, "schrodinger_follmer")
    dt = 1.0 / n_steps
    states = SchrodingerFollmerState(
        position.new_zeros((n_samples, *position.shape)),
        position.new_zeros((n_samples,) + position.shape[:-1]))
    step_keys = prng.fold_in(chain_keys(rng_key, position),
                             torch.arange(n_steps, device=position.device))
    for i in range(n_steps):
        states, _ = step(prng.split(step_keys[i], n_samples), states, log_density_fn, dt,
                         n_inner_samples)
    return states


def as_top_level_api(
    logdensity_fn: Callable, n_steps: int, n_inner_samples: int
) -> VIAlgorithm:
    """``blackjax_tpu_torch.schrodinger_follmer(...)``."""

    def init_fn(position):
        return init(position)

    def step_fn(rng_key, state):
        return step(rng_key, state, logdensity_fn, 1.0 / n_steps, n_inner_samples)

    def sample_fn(rng_key, state, n_samples):
        return sample(rng_key, state, logdensity_fn, n_steps, n_inner_samples, n_samples)

    return VIAlgorithm(init_fn, step_fn, sample_fn)
