"""Pathfinder: normal approximations along an L-BFGS optimization path, the
best-ELBO iterate selected (Zhang et al. 2022, Algorithm 3); reference
``blackjax_tpu/vi/pathfinder.py``.

``approximate`` runs one path from a ``(d,)`` position. Multi-path
Pathfinder runs ``_approximate`` on a batch of ``P`` starts, a key a path:
one batched L-BFGS, then the iterates' Gaussians one iterate at a time over
all paths (the reference ``vmap``s every iterate at once, which at 4,096
paths, 31 iterates and 200 draws of 100 dimensions is 10 GB in float32),
keeping each path's best iterate as it goes.
"""
from typing import Callable, NamedTuple, Union

import torch

from blackjax_tpu_torch import prng
from blackjax_tpu_torch.base import VIAlgorithm
from blackjax_tpu_torch.mcmc.proposal import tree_select
from blackjax_tpu_torch.optimizers.lbfgs import (
    _minimize_lbfgs_flat,
    bfgs_sample,
    lbfgs_inverse_hessian_factors,
)
from blackjax_tpu_torch.types import Array, ArrayLikeTree, ArrayTree, PRNGKey
from blackjax_tpu_torch.util import require_tensor_position

__all__ = ["PathfinderState", "PathfinderInfo", "approximate", "sample", "as_top_level_api"]


class PathfinderState(NamedTuple):
    """One point of the path: ELBO of its local Gaussian plus the factored
    inverse Hessian needed to sample from it."""

    elbo: Array
    position: ArrayTree
    grad_position: ArrayTree
    alpha: Array
    beta: Array
    gamma: Array


class PathfinderInfo(NamedTuple):
    path: PathfinderState


def approximate(
    rng_key: PRNGKey,
    logdensity_fn: Callable,
    initial_position: ArrayLikeTree,
    num_samples: int = 200,
    *,
    maxiter=30,
    maxcor=10,
    maxls=1000,
    gtol=1e-08,
    ftol=1e-05,
    **lbfgs_kwargs,
) -> tuple[PathfinderState, PathfinderInfo]:
    """Run L-BFGS on ``-logdensity``, build a factored Gaussian at every
    iterate from its trailing (s, z) window, estimate each ELBO with
    ``num_samples`` draws, and return the argmax iterate (plus the full
    path). ``initial_position`` is a ``(d,)`` tensor, ``rng_key`` key words
    ``(2,)``, ``logdensity_fn`` maps ``(..., d)`` to ``(...)``."""
    require_tensor_position(initial_position, "pathfinder")
    state, path = _approximate(rng_key[None], logdensity_fn, initial_position[None],
                               num_samples, maxiter, maxcor, maxls, gtol, ftol, keep_path=True)
    return (PathfinderState(*(leaf[0] for leaf in state)),
            PathfinderInfo(PathfinderState(*(leaf[0] for leaf in path))))


def _approximate(keys, logdensity_fn, x0, num_samples, maxiter, maxcor, maxls, gtol, ftol,
                 keep_path=False):
    """Pathfinder on each row of ``x0`` ``(P, d)`` with the key words of
    its row of ``keys`` ``(P, 2)``: each path's best state (leaves ``(P,
    ...)``), and with ``keep_path`` every iterate's (``(P, maxiter + 1,
    ...)``), else None. Without ``keep_path`` the iterates past every path's
    last eligible one are not drawn: their ELBO would be ``-inf``."""

    def objective(x):
        return -logdensity_fn(x)

    (_, status), history = _minimize_lbfgs_flat(objective, x0, maxiter, maxcor, gtol, ftol,
                                                 maxls)
    position, grad_position, alpha = history.x, history.g, history.alpha
    update_mask = history.update_mask[:, 1:]
    s = torch.where(update_mask, torch.diff(position, dim=1), torch.zeros_like(position[:, 1:]))
    z = torch.where(update_mask, torch.diff(grad_position, dim=1),
                    torch.zeros_like(position[:, 1:]))
    # left-pad so every iterate has a maxcor-long trailing window
    pad = torch.zeros_like(s[:, :1]).expand(-1, maxcor, -1)
    s = torch.cat((pad, s), dim=1)
    z = torch.cat((pad, z), dim=1)

    path_size = maxiter + 1
    iterate_keys = prng.split(keys, path_size)
    eligible = torch.arange(path_size, device=x0.device) < status.iter_num[:, None]
    last = path_size if keep_path else max(int(status.iter_num.max()), 1)
    best = path = None
    for i in range(last):
        beta, gamma = lbfgs_inverse_hessian_factors(
            s[:, i:i + maxcor].transpose(-1, -2), z[:, i:i + maxcor].transpose(-1, -2),
            alpha[:, i])
        phi, logq = bfgs_sample(iterate_keys[:, i], num_samples, position[:, i],
                                grad_position[:, i], alpha[:, i], beta, gamma)
        logp = -objective(phi)
        elbo = (logp - logq).mean(-1)
        # iterates at or past convergence, or with a non-finite ELBO, are
        # ineligible
        elbo = torch.where(eligible[:, i] & torch.isfinite(elbo), elbo,
                           torch.full_like(elbo, -torch.inf))
        here = PathfinderState(elbo, position[:, i], grad_position[:, i], alpha[:, i], beta,
                               gamma)
        if keep_path:
            path = [here] if path is None else path + [here]
        # argmax's first maximum: a later iterate replaces the best only
        # when its ELBO is larger
        best = here if best is None else tree_select(here.elbo > best.elbo, here, best)
    if keep_path:
        path = PathfinderState(*(torch.stack(leaves, dim=1) for leaves in zip(*path)))
    return best, path


def sample(
    rng_key: PRNGKey,
    state: PathfinderState,
    num_samples: Union[int, tuple] = (),
) -> ArrayTree:
    """Draw from the chosen factored Gaussian; returns ``(samples, logq)``:
    ``(*num_samples, d)`` and ``num_samples``."""
    require_tensor_position(state.position, "pathfinder")
    return bfgs_sample(rng_key, num_samples, state.position, state.grad_position, state.alpha,
                       state.beta, state.gamma)


def as_top_level_api(logdensity_fn: Callable) -> VIAlgorithm:
    """``blackjax_tpu_torch.pathfinder(...)``: one-shot; all the work
    happens in ``init``, and ``step`` is a no-op kept for the interface."""

    def init_fn(rng_key, position, num_samples: int = 200, **lbfgs_parameters):
        return approximate(rng_key, logdensity_fn, position, num_samples, **lbfgs_parameters)

    def step_fn(rng_key, state):
        return state, PathfinderInfo(path=state)

    def sample_fn(rng_key, state, num_samples):
        return sample(rng_key, state, num_samples)

    return VIAlgorithm(init_fn, step_fn, sample_fn)
