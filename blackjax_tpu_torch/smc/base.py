"""Generic SMC step: resample -> move -> reweight (reference
``blackjax_tpu/smc/base.py``).

Particles are ``(n, ...)`` tensors, or pytrees of them (nested tuples,
NamedTuples, lists and dicts, mapped with :func:`~blackjax_tpu_torch.util.tree_map`).
Where the reference ``vmap``s a per-particle function, the port calls it
once on the whole leading axis: a log density or weight function maps
``(n, d)`` to ``(n,)``, and an MCMC kernel moves ``n`` chains with ``n``
keys. ``batch_size > 0`` runs the leading axis in chunks of that size,
which gives what the reference's ``lax.map(..., batch_size=)`` gives.

Keys are key words (:mod:`blackjax_tpu_torch.prng`), split as the reference
splits them: the step's key into the update key and the resampling key,
the update key into one key per resampled particle, and each particle's key
into one key per MCMC step. Weights and every intermediate stay on the
particles' device.
"""
import math
from typing import Callable, NamedTuple, Optional, Union

import torch

from blackjax_tpu_torch import prng
from blackjax_tpu_torch.types import Array, ArrayLikeTree, ArrayTree, PRNGKey
from blackjax_tpu_torch.util import tree_leaves, tree_map

__all__ = [
    "SMCState",
    "SMCInfo",
    "init",
    "step",
    "extend_params",
    "map_fn",
    "map_kernel",
    "update_and_take_last",
]


class SMCState(NamedTuple):
    """Particles ``(n_particles, ...)`` per leaf, normalized weights, and the
    (possibly per-particle) parameters handed to the update function."""

    particles: ArrayTree
    weights: Array
    update_parameters: ArrayTree


class SMCInfo(NamedTuple):
    """Ancestor indices chosen by resampling, the log-normalizing-constant
    increment, and the inner update's info."""

    ancestors: Array
    log_likelihood_increment: Union[float, Array]
    update_info: NamedTuple


def uniform_weights(particles: ArrayLikeTree) -> Array:
    """``1 / n`` for each of the ``n`` particles, on their device, in the
    particles' floating dtype promoted with torch's default dtype (the
    counterpart of the reference's default float dtype)."""
    leaf = tree_leaves(particles)[0]
    dtype = torch.promote_types(leaf.dtype, torch.get_default_dtype())
    n = leaf.shape[0]
    return torch.full((n,), 1.0 / n, dtype=dtype, device=leaf.device)


def init(particles: ArrayLikeTree, init_update_params: ArrayTree) -> SMCState:
    return SMCState(particles, uniform_weights(particles), init_update_params)


def step(
    rng_key: PRNGKey,
    state: SMCState,
    update_fn: Callable,
    weight_fn: Callable,
    resample_fn: Callable,
    num_resampled: Optional[int] = None,
) -> tuple[SMCState, SMCInfo]:
    """One Feynman-Kac step: ancestors from ``resample_fn(weights)``, moved
    through the (batched) ``update_fn`` Markov kernel, reweighted by the
    (batched) ``weight_fn`` potential. ``num_resampled < N`` enables
    waste-free variants where the update returns N particles from M seeds."""
    key_update, key_resample = prng.split(rng_key.to(state.weights.device))
    n = state.weights.shape[0]
    if num_resampled is None:
        num_resampled = n

    ancestors = resample_fn(key_resample, state.weights, num_resampled)
    particles = tree_map(lambda x: x[ancestors], state.particles)

    keys = prng.split(key_update, num_resampled)
    particles, update_info = update_fn(keys, particles, state.update_parameters)

    log_weights = weight_fn(particles)
    log_total = torch.logsumexp(log_weights, 0)
    normalizing_constant_increment = log_total - math.log(n)
    weights = torch.exp(log_weights - log_total)

    return (
        SMCState(particles, weights, state.update_parameters),
        SMCInfo(ancestors, normalizing_constant_increment, update_info),
    )


def extend_params(params: ArrayTree) -> ArrayTree:
    """Mark parameters as shared across particles by giving every leaf a
    leading axis of length 1."""
    return tree_map(lambda x: torch.as_tensor(x)[None, ...], params)


def _chunks(batch_size: int, args):
    """The leading axis of every leaf of ``args`` in slices of
    ``batch_size``."""
    n = tree_leaves(args)[0].shape[0]
    for start in range(0, n, batch_size):
        yield tree_map(lambda x: x[start:start + batch_size], args)


def _concatenate(outputs):
    return tree_map(lambda *xs: torch.cat(xs), *outputs)


def map_fn(fn: Callable, batch_size: int) -> Callable:
    """``fn`` over the whole leading axis, or in chunks of ``batch_size``
    when ``batch_size > 0`` (the reference's vmap or ``lax.map``)."""
    if batch_size > 0:
        return lambda xs: _concatenate([fn(x) for x in _chunks(batch_size, xs)])
    return fn


def map_kernel(kernel: Callable, batch_size: int) -> Callable:
    """An n-ary kernel over the leading particle axis of all its arguments,
    whole or in chunks of ``batch_size``."""
    if batch_size > 0:
        return lambda *args: _concatenate(
            [kernel(*chunk) for chunk in _chunks(batch_size, args)]
        )
    return kernel


def _stack_steps(infos, n: int, device):
    """Per-step infos stacked along a new axis 1: ``(n, num_steps, ...)``, the
    reference's layout of a vmap over a scan. A leaf that is not per
    particle (a number, or a 0-d tensor) is broadcast over the particles."""

    def stack(*leaves):
        tensors = [torch.as_tensor(leaf, device=device) for leaf in leaves]
        tensors = [t.expand(n) if t.dim() == 0 else t for t in tensors]
        return torch.stack(tensors, dim=1)

    return tree_map(stack, *infos)


def update_and_take_last(
    mcmc_init_fn: Callable,
    tempered_logposterior_fn: Callable,
    shared_mcmc_step_fn: Callable,
    num_mcmc_steps: int,
    n_particles: Union[int, Array],
    batch_size: int = 0,
) -> tuple[Callable, Union[int, Array]]:
    """Update strategy: run ``num_mcmc_steps`` of the kernel from each
    particle and keep only the final position. Infos come out
    ``(n, num_mcmc_steps)``."""

    def mcmc_kernel(rng_key, position, step_parameters):
        state = mcmc_init_fn(position, tempered_logposterior_fn)
        keys = prng.split(rng_key, num_mcmc_steps)
        infos = []
        for i in range(num_mcmc_steps):
            state, info = shared_mcmc_step_fn(
                keys[:, i], state, tempered_logposterior_fn, **step_parameters
            )
            infos.append(info)
        return state.position, _stack_steps(infos, keys.shape[0], keys.device)

    return map_kernel(mcmc_kernel, batch_size), n_particles
