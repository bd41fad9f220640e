"""Nested sampling post-processing: effective live counts, stochastic
volume simulation, importance weights, evidence and posterior resampling
(reference ``blackjax_tpu/ns/utils.py``).

Random draws follow the reference on the same keys: the volumes' uniforms
in the log likelihoods' dtype promoted with torch's default dtype (the
reference's default float), the posterior's indices through
:func:`blackjax_tpu_torch.prng.choice`.
"""
import math

import torch

from blackjax_tpu_torch import prng
from blackjax_tpu_torch.ns.base import NSInfo, NSState
from blackjax_tpu_torch.ns.integrator import log1mexp
from blackjax_tpu_torch.types import Array, ArrayTree, PRNGKey
from blackjax_tpu_torch.util import tree_map

__all__ = [
    "compute_num_live",
    "logX",
    "log_weights",
    "finalise",
    "ess",
    "sample",
    "uniform_prior",
    "log1mexp",
]


def _lexsort(keys) -> Array:
    """``jnp.lexsort(keys)``: the last key the primary one, by successive
    stable sorts, the first key first."""
    order = torch.arange(keys[0].shape[0], device=keys[0].device)
    for key in keys:
        order = order[torch.argsort(key[order], stable=True)]
    return order


def compute_num_live(info: NSInfo) -> Array:
    """Effective number of live points at each death contour, from the merged
    birth/death event stream (handles batched deletions). Expects the
    finalised output (dead + final live) so every birth is present."""
    birth = info.particles.loglikelihood_birth
    death = info.particles.loglikelihood

    events_logL = torch.cat([birth, death])
    events_delta = torch.cat([
        torch.ones(birth.shape, dtype=torch.int64, device=birth.device),
        -torch.ones(death.shape, dtype=torch.int64, device=death.device),
    ])
    order = _lexsort((events_delta, events_logL, ~torch.isnan(events_logL)))
    sorted_delta = events_delta[order]
    running = torch.clamp(torch.cumsum(sorted_delta, 0), min=0)
    return running[sorted_delta == -1] + 1


def _draw_dtype(loglikelihood: Array) -> torch.dtype:
    return torch.promote_types(loglikelihood.dtype, torch.get_default_dtype())


def logX(rng_key: PRNGKey, dead_info: NSInfo, shape: int = 100):
    """Simulate ``shape`` stochastic volume-shrinkage paths (Skilling 2006);
    returns ``(cumulative logX, trapezoidal log dX)``, both ``(n_dead,
    shape)``. Particles must be sorted by death likelihood."""
    loglikelihood = dead_info.particles.loglikelihood
    device, dtype = loglikelihood.device, _draw_dtype(loglikelihood)
    rng_key, subkey = prng.split(rng_key.to(device))
    n = loglikelihood.shape[0]
    u = prng.uniform(subkey, (n, shape), dtype)
    shrinkage = torch.log1p(-u) / compute_num_live(dead_info)[:, None]
    cumulative = torch.cumsum(shrinkage, 0)

    prev = torch.cat([torch.zeros((1, shape), dtype=dtype, device=device), cumulative[:-1]])
    nxt = torch.cat([cumulative[1:], torch.full((1, shape), -math.inf, dtype=dtype,
                                                device=device)])
    log_dX = log1mexp(nxt - prev) + prev - math.log(2.0)
    return cumulative, log_dX


def log_weights(
    rng_key: PRNGKey, dead_info: NSInfo, shape: int = 100, beta: float = 1.0
) -> Array:
    """Log importance weights ``L^beta dX`` per particle (original order
    preserved), ``(n_dead, shape)``. Only the particles are reordered: the
    update infos, which hold no entry for the final live set, are not
    read."""
    loglikelihood = dead_info.particles.loglikelihood
    order = torch.argsort(loglikelihood, stable=True)
    inverse = torch.empty_like(order)
    inverse[order] = torch.arange(order.shape[0], device=order.device)
    sorted_info = NSInfo(tree_map(lambda x: x[order], dead_info.particles), None)
    _, log_dX = logX(rng_key, sorted_info, shape)
    log_w = log_dX + beta * sorted_info.particles.loglikelihood[..., None]
    return log_w[inverse]


def _concatenate(*xs):
    return torch.cat(xs, 0)


def finalise(live: NSState, dead: list, update_info: bool = True) -> NSInfo:
    """Concatenate all dead particles with the final live set (whose update
    info has no entries)."""
    if update_info:
        final_update_info = tree_map(_concatenate, *[d.update_info for d in dead])
    else:
        final_update_info = None
    all_particles = [d.particles for d in dead] + [live.particles]
    return NSInfo(tree_map(_concatenate, *all_particles), final_update_info)


def ess(rng_key: PRNGKey, dead: NSInfo) -> Array:
    """Kish effective sample size of the mean importance weights."""
    logw = log_weights(rng_key, dead).mean(-1)
    logw = logw - logw.max()
    return torch.exp(2 * torch.logsumexp(logw, 0) - torch.logsumexp(2 * logw, 0))


def sample(rng_key: PRNGKey, dead: NSInfo, shape: int = 1000) -> ArrayTree:
    """Resample posterior draws proportional to the importance weights."""
    logw = log_weights(rng_key, dead).mean(-1)
    idx = prng.choice(
        rng_key.to(logw.device),
        dead.particles.loglikelihood.shape[0],
        (shape,),
        p=torch.exp(logw.squeeze() - torch.max(logw)),
    )
    return tree_map(lambda leaf: leaf[idx], dead.particles)


def get_first_row(x: ArrayTree) -> ArrayTree:
    return tree_map(lambda leaf: leaf[0], x)


def uniform_prior(rng_key: PRNGKey, num_particles: int, bounds: dict, dtype=None):
    """Convenience uniform box prior: returns ``(particles, logprior_fn)``
    for a dict of per-parameter ``(low, high)`` bounds. The draws are in
    ``dtype`` (torch's default by default: the reference's default float);
    ``logprior_fn`` maps a dict of ``(n, ...)`` values to ``(n,)``."""
    dtype = torch.get_default_dtype() if dtype is None else dtype
    keys = prng.split(rng_key, len(bounds))
    particles = {}
    total_log_volume = 0.0
    for i, (name, (low, high)) in enumerate(bounds.items()):
        low = torch.as_tensor(low, dtype=dtype, device=rng_key.device)
        high = torch.as_tensor(high, dtype=dtype, device=rng_key.device)
        shape = (num_particles,) + tuple(low.shape)
        particles[name] = prng.uniform(keys[i], shape, dtype, minval=low, maxval=high)
        total_log_volume += torch.sum(torch.log(high - low))

    def logprior_fn(params):
        inside = None
        for name, (low, high) in bounds.items():
            x = params[name]
            low = torch.as_tensor(low, dtype=x.dtype, device=x.device)
            high = torch.as_tensor(high, dtype=x.dtype, device=x.device)
            within = (x >= low) & (x <= high)
            within = within.reshape(within.shape[:within.dim() - low.dim()] + (-1,)).all(-1)
            inside = within if inside is None else inside & within
        volume = torch.as_tensor(total_log_volume, device=inside.device)
        return torch.where(inside, -volume, -math.inf)

    return particles, logprior_fn
