"""Persistent Sampling (Karamanis et al. 2025): tempered SMC that keeps every
past particle and resamples each iteration from the whole history with
mixture-importance weights (reference
``blackjax_tpu/smc/persistent_sampling.py``).

The history is preallocated to ``n_schedule + 1`` slots, as in the
reference, so :func:`remove_padding` trims the same shapes; ``iteration``
is a Python int, the number of filled slots less one, so that the host
knows how many slots hold particles. The mixture denominator is the
reference's streaming logsumexp (a running max and a sum rescaled onto it)
as a host loop over the filled slots, in the reference's order: the
reference's scan over the empty slots adds ``-inf`` terms, which leave the
running max and sum as they are, so looping over the filled ones alone
gives the same numbers. Rows past the filled slots get ``-inf`` weights.
"""
from typing import Callable, NamedTuple

import torch

from blackjax_tpu_torch import prng
from blackjax_tpu_torch.base import SamplingAlgorithm
from blackjax_tpu_torch.smc.base import map_fn, update_and_take_last
from blackjax_tpu_torch.smc.from_mcmc import unshared_parameters_and_step_fn
from blackjax_tpu_torch.types import Array, ArrayLikeTree, ArrayTree, PRNGKey
from blackjax_tpu_torch.util import tree_map

__all__ = [
    "PersistentSMCState",
    "PersistentStateInfo",
    "init",
    "remove_padding",
    "compute_log_Z",
    "compute_log_persistent_weights",
    "resample_from_persistent",
    "compute_persistent_ess",
    "step",
    "build_kernel",
    "as_top_level_api",
]


class PersistentSMCState(NamedTuple):
    """Full particle history, zero-padded to ``n_schedule + 1`` iterations."""

    persistent_particles: ArrayLikeTree  # leaves (n_schedule+1, N, ...)
    persistent_log_likelihoods: Array  # (n_schedule+1, N)
    persistent_log_Z: Array  # (n_schedule+1,)
    tempering_schedule: Array  # (n_schedule+1,)
    iteration: int

    @property
    def particles(self) -> ArrayTree:
        return tree_map(lambda x: x[self.iteration], self.persistent_particles)

    @property
    def tempering_param(self):
        return self.tempering_schedule[self.iteration]

    @property
    def log_Z(self):
        return self.persistent_log_Z[self.iteration]

    @property
    def num_particles(self) -> int:
        return self.persistent_log_likelihoods.shape[1]

    @property
    def persistent_weights(self) -> Array:
        logw, _ = compute_log_persistent_weights(
            self.persistent_log_likelihoods,
            self.persistent_log_Z,
            self.tempering_schedule,
            self.iteration,
            include_current=True,
        )
        return torch.exp(logw)


class PersistentStateInfo(NamedTuple):
    ancestors: Array
    update_info: NamedTuple


def init(
    particles: ArrayLikeTree,
    loglikelihood_fn: Callable,
    n_schedule: int,
    batch_size: int = 0,
) -> PersistentSMCState:
    """Allocate the padded history and write iteration 0 (prior draws). The
    log likelihoods, log Z and the schedule are in the log likelihoods'
    dtype promoted with torch's default dtype (the reference's default
    float)."""
    slots = int(n_schedule) + 1

    def alloc(x):
        history = torch.zeros((slots, *x.shape), dtype=x.dtype, device=x.device)
        history[0] = x
        return history

    logliks = map_fn(loglikelihood_fn, batch_size)(particles)
    dtype = torch.promote_types(logliks.dtype, torch.get_default_dtype())
    persistent_logliks = torch.zeros((slots, logliks.shape[0]), dtype=dtype,
                                     device=logliks.device)
    persistent_logliks[0] = logliks
    zeros = torch.zeros(slots, dtype=dtype, device=logliks.device)
    return PersistentSMCState(
        tree_map(alloc, particles), persistent_logliks, zeros, zeros.clone(), 0
    )


def remove_padding(state: PersistentSMCState) -> PersistentSMCState:
    """Trim the padded arrays to the current iteration."""
    upto = state.iteration + 1
    return PersistentSMCState(
        tree_map(lambda x: x[:upto], state.persistent_particles),
        state.persistent_log_likelihoods[:upto],
        state.persistent_log_Z[:upto],
        state.tempering_schedule[:upto],
        state.iteration,
    )


def _log(value: int, like: Array) -> Array:
    """``log(value)`` in ``like``'s dtype (the reference's ``jnp.log`` of an
    integer, in its default float)."""
    return torch.log(torch.tensor(float(value), dtype=like.dtype, device=like.device))


def compute_log_Z(log_weights: Array, iteration: int) -> Array:
    """Normalizing-constant estimate (eq. 16): the mean of the unnormalized
    weights over the ``iteration * N`` live slots."""
    n = log_weights.shape[1]
    return torch.logsumexp(log_weights.reshape(-1), 0) - _log(n * iteration, log_weights)


def _streaming_mixture_logsumexp(log_terms_fn: Callable, horizon: int) -> Array:
    """logsumexp of ``log_terms_fn(i)`` over ``i < horizon``, a loop carrying
    (running max, sum rescaled onto it), in the reference's order."""
    init_term = log_terms_fn(0)
    run_max = torch.full_like(init_term, -torch.inf)
    run_sum = torch.zeros_like(init_term)
    minus_inf = torch.full_like(init_term, -torch.inf)
    for i in range(horizon):
        term = init_term if i == 0 else log_terms_fn(i)
        new_max = torch.maximum(run_max, term)
        # rescale both contributions onto the new max, guarding the
        # exp(-inf - -inf) case while nothing has been accumulated yet
        safe_max = torch.where(torch.isfinite(new_max), new_max, 0.0)
        run_sum = run_sum * torch.exp(
            torch.where(torch.isfinite(run_max), run_max - safe_max, minus_inf)
        ) + torch.exp(torch.where(torch.isfinite(term), term - safe_max, minus_inf))
        run_max = new_max
    return torch.where(torch.isfinite(run_max), run_max + torch.log(run_sum), minus_inf)


def _log_mixture(persistent_log_likelihoods, persistent_log_Z, tempering_schedule,
                 horizon: int) -> Array:
    """The log density of the equal-weight mixture of the first ``horizon``
    tempered targets at the particles of the first ``horizon`` slots,
    ``(horizon, N)``. It reads no schedule entry at or past ``horizon``."""
    logliks = persistent_log_likelihoods[:horizon]

    def component(i):
        # log density (up to Z) of mixture member i at every live particle
        return tempering_schedule[i] * logliks - persistent_log_Z[i]

    return _streaming_mixture_logsumexp(component, horizon) - _log(horizon, logliks)


def _weights_from_mixture(log_mix, persistent_log_likelihoods, tempering_schedule,
                          iteration: int, horizon: int, normalize_to_one: bool):
    """The persistent log weights and log Z from the mixture's log density
    (the second half of :func:`compute_log_persistent_weights`)."""
    live_logliks = persistent_log_likelihoods[:horizon]
    raw = torch.full_like(persistent_log_likelihoods, -torch.inf)
    raw[:horizon] = tempering_schedule[iteration] * live_logliks - log_mix
    log_Z = compute_log_Z(raw[:horizon], horizon)
    logw = raw - log_Z
    if normalize_to_one:
        logw = logw - _log(horizon * persistent_log_likelihoods.shape[1], logw)
    return logw, log_Z


def compute_log_persistent_weights(
    persistent_log_likelihoods: Array,
    persistent_log_Z: Array,
    tempering_schedule: Array,
    iteration: int,
    include_current: bool = False,
    normalize_to_one: bool = False,
):
    """Mixture importance weights of every historical particle against the
    current tempered target (eqs. 14-15): numerator ``L^lambda_t``,
    denominator the equal-weight mixture of all past tempered distributions.
    Rows beyond the horizon get ``-inf``. Weights sum to ``iteration * N``
    unless ``normalize_to_one``."""
    horizon = iteration + 1 if include_current else iteration
    log_mix = _log_mixture(persistent_log_likelihoods, persistent_log_Z, tempering_schedule,
                           horizon)
    return _weights_from_mixture(log_mix, persistent_log_likelihoods, tempering_schedule,
                                 iteration, horizon, normalize_to_one)


def resample_from_persistent(
    rng_key: PRNGKey,
    persistent_particles: ArrayLikeTree,
    persistent_weights: Array,
    resample_fn: Callable,
):
    """Draw N particles from the ``history x N`` ensemble; flat ancestor
    draws are mapped back to (slot, particle) coordinates with divmod."""
    n = persistent_weights.shape[1]
    ancestors = resample_fn(rng_key, persistent_weights.reshape(-1), n)
    slot_idx, within_idx = torch.div(ancestors, n, rounding_mode="floor"), ancestors % n
    particles = tree_map(lambda x: x[slot_idx, within_idx], persistent_particles)
    return particles, ancestors


def compute_persistent_ess(log_persistent_weights: Array, normalize_weights: bool = False):
    """Kish ESS of the persistent ensemble (eq. 17; can exceed 1), computed
    in log space: ``exp(-logsumexp(2 log w))``."""
    flat = log_persistent_weights.reshape(-1)
    if normalize_weights:
        flat = flat - torch.logsumexp(flat, 0)
    return torch.exp(-torch.logsumexp(2.0 * flat, 0))


def _set_slot(history: Array, slot: int, value) -> Array:
    out = history.clone()
    out[slot] = value
    return out


def step(
    rng_key: PRNGKey,
    state: PersistentSMCState,
    lmbda,
    loglikelihood_fn: Callable,
    update_fn: Callable,
    resample_fn: Callable,
    weight_fn: Callable = compute_log_persistent_weights,
    batch_size: int = 0,
) -> tuple[PersistentSMCState, PersistentStateInfo]:
    """One persistent-sampling move to tempering parameter ``lmbda``
    (Karamanis et al. Algorithm 2): weight the whole history against the new
    target, resample N seeds from it, mutate them with the inner kernel, and
    append the result as the next history slot."""
    device = state.persistent_log_likelihoods.device
    move_key, seed_key = prng.split(rng_key.to(device))
    slot = state.iteration + 1
    schedule = _set_slot(state.tempering_schedule, slot, lmbda)

    logw, log_Z = weight_fn(
        state.persistent_log_likelihoods,
        state.persistent_log_Z,
        schedule,
        slot,
        normalize_to_one=True,
    )
    seeds, ancestors = resample_from_persistent(
        seed_key, state.persistent_particles, torch.exp(logw), resample_fn
    )

    moved, update_info = update_fn(prng.split(move_key, state.num_particles), seeds)
    moved_logliks = map_fn(loglikelihood_fn, batch_size)(moved)

    new_state = PersistentSMCState(
        tree_map(lambda hist, cur: _set_slot(hist, slot, cur), state.persistent_particles,
                 moved),
        _set_slot(state.persistent_log_likelihoods, slot, moved_logliks),
        _set_slot(state.persistent_log_Z, slot, log_Z),
        schedule,
        slot,
    )
    return new_state, PersistentStateInfo(ancestors, update_info)


def build_kernel(
    logprior_fn: Callable,
    loglikelihood_fn: Callable,
    mcmc_step_fn: Callable,
    mcmc_init_fn: Callable,
    resampling_fn: Callable,
    update_strategy: Callable = update_and_take_last,
    batch_size: int = 0,
) -> Callable:
    """Persistent-sampling kernel with a fixed tempering schedule. The
    prior must be normalized (Z_0 = 1) for the weighting scheme. The
    kernel's ``weight_fn`` is :func:`step`'s."""

    def kernel(
        rng_key: PRNGKey,
        state: PersistentSMCState,
        num_mcmc_steps,
        lmbda,
        mcmc_parameters: dict,
        weight_fn: Callable = compute_log_persistent_weights,
    ) -> tuple[PersistentSMCState, PersistentStateInfo]:
        def tempered_logdensity(x):
            return logprior_fn(x) + lmbda * loglikelihood_fn(x)

        unshared, shared_step_fn = unshared_parameters_and_step_fn(
            mcmc_parameters, mcmc_step_fn
        )
        extra = {"batch_size": batch_size} if batch_size else {}
        mutate, _ = update_strategy(
            mcmc_init_fn,
            tempered_logdensity,
            shared_step_fn,
            num_mcmc_steps=num_mcmc_steps,
            n_particles=state.num_particles,
            **extra,
        )
        return step(
            rng_key,
            state,
            lmbda,
            loglikelihood_fn,
            lambda keys, particles: mutate(keys, particles, unshared),
            resampling_fn,
            weight_fn,
            batch_size=batch_size,
        )

    return kernel


def as_top_level_api(
    logprior_fn: Callable,
    loglikelihood_fn: Callable,
    n_schedule,
    mcmc_step_fn: Callable,
    mcmc_init_fn: Callable,
    mcmc_parameters: dict,
    resampling_fn: Callable,
    num_mcmc_steps: int = 10,
    update_strategy: Callable = update_and_take_last,
    batch_size: int = 0,
) -> SamplingAlgorithm:
    """``blackjax_tpu_torch.persistent_sampling_smc(...)``. ``n_schedule``
    must cover the schedule's length (the history holds ``n_schedule + 1``
    slots)."""
    kernel = build_kernel(
        logprior_fn,
        loglikelihood_fn,
        mcmc_step_fn,
        mcmc_init_fn,
        resampling_fn,
        update_strategy,
        batch_size,
    )

    def init_fn(position, rng_key=None):
        del rng_key
        return init(position, loglikelihood_fn, n_schedule, batch_size)

    def step_fn(rng_key: PRNGKey, state, lmbda):
        return kernel(rng_key, state, num_mcmc_steps, lmbda, mcmc_parameters)

    return SamplingAlgorithm(init_fn, step_fn)
