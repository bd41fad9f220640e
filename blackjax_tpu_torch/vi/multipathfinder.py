"""Multi-path Pathfinder: independent Pathfinder runs plus PSIS importance
resampling across the pooled draws (Zhang et al. 2022, Algorithm 2);
reference ``blackjax_tpu/vi/multipathfinder.py``.

The paths run as one batch (``pathfinder._approximate``), each from its own
key of ``split(approx_key, n_paths)``, as the reference's ``vmap`` runs
them.
"""
from typing import Callable, NamedTuple

import torch

from blackjax_tpu_torch import prng
from blackjax_tpu_torch.base import VIAlgorithm
from blackjax_tpu_torch.diagnostics import psis_weights as _psis_weights
from blackjax_tpu_torch.types import Array, ArrayLikeTree, ArrayTree, PRNGKey
from blackjax_tpu_torch.util import require_tensor_position
from blackjax_tpu_torch.vi.pathfinder import PathfinderInfo, PathfinderState, _approximate, sample

__all__ = ["MultipathfinderState", "multi_approximate", "psis_weights", "as_top_level_api"]


class MultipathfinderState(NamedTuple):
    path_states: PathfinderState
    samples: ArrayTree  # (n_paths, num_samples, d)
    logp: Array
    logq: Array


def multi_approximate(
    rng_key: PRNGKey,
    logdensity_fn: Callable,
    initial_positions: ArrayLikeTree,
    num_samples: int = 200,
    *,
    maxiter: int = 30,
    maxcor: int = 10,
    maxls: int = 1000,
    gtol: float = 1e-08,
    ftol: float = 1e-05,
) -> tuple[MultipathfinderState, PathfinderInfo]:
    """Run one Pathfinder per row of ``initial_positions`` ``(n_paths, d)``
    and collect each path's draws with their log-densities for PSIS."""
    require_tensor_position(initial_positions, "multipathfinder")
    n_paths = initial_positions.shape[0]
    approx_key, sample_key = prng.split(rng_key).unbind(-2)
    path_states, _ = _approximate(prng.split(approx_key, n_paths), logdensity_fn,
                                  initial_positions, num_samples, maxiter, maxcor, maxls, gtol,
                                  ftol)
    samples, logq = sample(prng.split(sample_key, n_paths), path_states, num_samples)
    logp = logdensity_fn(samples)
    return (
        MultipathfinderState(path_states, samples, logp, logq),
        PathfinderInfo(path=path_states),
    )


def psis_weights(state: MultipathfinderState) -> tuple[Array, Array]:
    """Pareto-smoothed, normalized log importance weights over the pooled
    draws and the Pareto k-hat diagnostic."""
    smoothed, k = _psis_weights((state.logp - state.logq).reshape(-1))
    return smoothed - torch.logsumexp(smoothed, dim=0), k


def as_top_level_api(logdensity_fn: Callable) -> VIAlgorithm:
    """``blackjax_tpu_torch.multipathfinder(...)``: ``sample``
    importance-resamples the pooled per-path draws by their PSIS
    weights."""

    def init_fn(rng_key, initial_positions, num_samples: int = 200, **lbfgs_parameters):
        return multi_approximate(
            rng_key, logdensity_fn, initial_positions, num_samples, **lbfgs_parameters
        )

    def step_fn(rng_key, state):
        return state, None

    def sample_fn(rng_key, state: MultipathfinderState, num_samples: int):
        log_w, _ = psis_weights(state)
        pool = state.samples.reshape(-1, state.samples.shape[-1])
        idx = prng.choice(rng_key, log_w.shape[0], (num_samples,), p=torch.exp(log_w))
        return pool[idx]

    return VIAlgorithm(init_fn, step_fn, sample_fn)
