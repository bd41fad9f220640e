"""Waste-free SMC update strategy (Dau & Chopin 2020, Algorithm 2; reference
``blackjax_tpu/smc/waste_free.py``): resample ``N/p`` seeds, run ``p-1``
MCMC steps per seed, keep ALL intermediate states so the particle cloud
stays at ``N``. Infos come out ``(N/p, p-1)``.
"""
import functools

import torch

from blackjax_tpu_torch import prng
from blackjax_tpu_torch.smc.base import _stack_steps, map_kernel
from blackjax_tpu_torch.util import tree_map

__all__ = ["update_waste_free", "waste_free_smc"]


def update_waste_free(
    mcmc_init_fn,
    logposterior_fn,
    mcmc_step_fn,
    n_particles: int,
    p: int,
    num_resampled,
    num_mcmc_steps=None,
    batch_size: int = 0,
):
    """Return ``(update_fn, num_resampled)``: each of the ``num_resampled``
    seed particles contributes itself plus the ``p-1`` states of its chain."""
    if num_mcmc_steps is not None:
        raise ValueError(
            "Waste-free SMC derives its chain length from p; pass num_mcmc_steps=None."
        )
    num_mcmc_steps = p - 1

    def chain_from(rng_key, position, step_parameters):
        state = mcmc_init_fn(position, logposterior_fn)
        keys = prng.split(rng_key, num_mcmc_steps)
        positions, infos = [], []
        for i in range(num_mcmc_steps):
            state, info = mcmc_step_fn(keys[:, i], state, logposterior_fn, **step_parameters)
            positions.append(state.position)
            infos.append(info)
        n = keys.shape[0]
        return _stack_steps(positions, n, keys.device), _stack_steps(infos, n, keys.device)

    def update(rng_key, position, step_parameters):
        chains, infos = map_kernel(chain_from, batch_size)(rng_key, position, step_parameters)
        # (seeds, steps, ...) -> (seeds * steps, ...), seed-major
        chain_particles = tree_map(lambda x: x.flatten(0, 1), chains)
        all_particles = tree_map(
            lambda seed, chain: torch.cat([seed, chain]), position, chain_particles
        )
        return all_particles, infos

    return update, num_resampled


def waste_free_smc(n_particles, p):
    """Build the ``update_strategy`` closure for ``p``-step waste-free SMC."""
    if n_particles % p != 0:
        raise ValueError("p must divide n_particles.")
    return functools.partial(update_waste_free, num_resampled=n_particles // p, p=p)
