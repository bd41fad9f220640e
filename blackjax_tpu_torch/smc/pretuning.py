"""SMC pretuning (Buchholz et al. 2018): keep a distribution of inner-kernel
parameters across particles, reweighted each step by a measured mixing
criterion (ESJD) from a probe step taken before the real move (reference
``blackjax_tpu/smc/pretuning.py``).

Positions are flattened a particle at a time by
:func:`~blackjax_tpu_torch.smc.tuning.from_particles.particles_as_rows`
(the leaves in the reference's order: dicts by sorted key), the
counterpart of the reference's ``ravel_pytree``. Parameters listed in
``natural_parameters`` are rounded to the particles'
:func:`~blackjax_tpu_torch.prng.default_int_dtype`, the reference's
default integer with and without x64.
"""
from typing import Callable, NamedTuple, Optional

import torch

from blackjax_tpu_torch import prng
from blackjax_tpu_torch.base import SamplingAlgorithm
from blackjax_tpu_torch.smc.base import SMCInfo, update_and_take_last
from blackjax_tpu_torch.smc.from_mcmc import build_kernel as smc_from_mcmc
from blackjax_tpu_torch.smc.from_mcmc import unshared_parameters_and_step_fn
from blackjax_tpu_torch.smc.inner_kernel_tuning import StateWithParameterOverride
from blackjax_tpu_torch.smc.resampling import stratified
from blackjax_tpu_torch.smc.tuning.from_particles import particles_as_rows
from blackjax_tpu_torch.types import Array, ArrayLikeTree, PRNGKey
from blackjax_tpu_torch.util import generate_gaussian_noise, tree_leaves, tree_map

__all__ = [
    "SMCInfoWithParameterDistribution",
    "esjd",
    "update_parameter_distribution",
    "build_pretune",
    "build_kernel",
    "init",
    "as_top_level_api",
]


class SMCInfoWithParameterDistribution(NamedTuple):
    smc_info: SMCInfo
    parameter_override: dict


def esjd(m):
    """Per-chain expected squared jumping distance in the Mahalanobis metric
    of ``m`` (weighted by acceptance probability): ``(n, ...)`` particles
    and ``(n, ...)`` acceptance probabilities to ``(n, ...)``."""
    factor = torch.linalg.cholesky(torch.as_tensor(m))

    def measure(previous_position, next_position, acceptance_probability):
        jump = particles_as_rows(previous_position) - particles_as_rows(next_position)
        projected = jump @ factor.to(jump).T
        squared = (projected * projected).sum(-1)
        extra = acceptance_probability.dim() - 1
        return acceptance_probability * squared.reshape(squared.shape + (1,) * extra)

    return measure


def update_parameter_distribution(
    key: PRNGKey,
    previous_param_samples: ArrayLikeTree,
    previous_particles: ArrayLikeTree,
    latest_particles: ArrayLikeTree,
    measure_of_chain_mixing: Callable,
    alpha: float,
    sigma_parameters: ArrayLikeTree,
    acceptance_probability: Array,
):
    """Random-walk the per-particle parameter population (float32 noise, as
    the reference draws it), then importance-resample it with weights
    ``alpha + mixing_measure`` (eq. 4 of Fearnhead & Taylor 2010)."""
    noise_key, resampling_key = prng.split(key)
    noisy = tree_map(
        lambda x, s: x + generate_gaussian_noise(noise_key, x.to(torch.float32), sigma=s),
        previous_param_samples,
        sigma_parameters,
    )
    mixing = measure_of_chain_mixing(
        previous_particles, latest_particles, acceptance_probability
    )
    weights = alpha + mixing
    weights = weights / torch.sum(weights)
    idx = stratified(resampling_key, weights.reshape(-1), mixing.shape[0])
    return tree_map(lambda x: x[idx], noisy), mixing


def default_measure_factory(state):
    imm = state.parameter_override["inverse_mass_matrix"]
    if not (len(imm.shape) == 3 and imm.shape[0] == 1):
        raise ValueError("ESJD requires a shared inverse_mass_matrix across chains.")
    return esjd(imm[0])


def build_pretune(
    mcmc_init_fn: Callable,
    mcmc_step_fn: Callable,
    alpha: float,
    sigma_parameters: ArrayLikeTree,
    n_particles: int,
    performance_of_chain_measure_factory: Callable = default_measure_factory,
    natural_parameters: Optional[list] = None,
    positive_parameters: Optional[list] = None,
):
    """Build the pretune callable: one probe MCMC step per particle (then
    discarded), mixing measured, parameter population reweighted. Integer
    parameters listed in ``natural_parameters`` are rounded (min 1);
    ``positive_parameters`` take absolute values."""
    # per-name domain constraints applied after the random walk; a name in
    # both lists gets the integer rule (which already implies positivity)
    constraint_rules = {}
    for name in positive_parameters or ():
        constraint_rules[name] = lambda a, int_dtype: torch.abs(a)
    for name in natural_parameters or ():
        constraint_rules[name] = lambda a, int_dtype: torch.clamp(
            torch.abs(torch.round(a)).to(int_dtype), min=1
        )

    def constrain(params, int_dtype):
        return {
            name: tree_map(lambda a: constraint_rules[name](a, int_dtype), value)
            if name in constraint_rules
            else value
            for name, value in params.items()
        }

    def pretune(key, state, logposterior):
        unshared, shared_step_fn = unshared_parameters_and_step_fn(
            state.parameter_override, mcmc_step_fn
        )
        probe_step, _ = update_and_take_last(
            mcmc_init_fn, logposterior, shared_step_fn, 1, n_particles
        )
        particles = state.sampler_state.particles
        probed, info = probe_step(prng.split(key, n_particles), particles, unshared)
        measure = performance_of_chain_measure_factory(state)
        new_distribution, mixing = update_parameter_distribution(
            key,
            previous_param_samples={
                name: state.parameter_override[name] for name in sigma_parameters
            },
            previous_particles=particles,
            latest_particles=probed,
            measure_of_chain_mixing=measure,
            alpha=alpha,
            sigma_parameters=sigma_parameters,
            acceptance_probability=info.acceptance_rate,
        )
        int_dtype = prng.default_int_dtype(tree_leaves(particles)[0].dtype)
        return constrain(new_distribution, int_dtype), mixing

    def pretune_and_update(key, state: StateWithParameterOverride, logposterior):
        new_distribution, _ = pretune(key, state, logposterior)
        updated = dict(state.parameter_override)
        updated.update(new_distribution)
        return updated

    return pretune_and_update


def build_kernel(
    smc_algorithm,
    logprior_fn: Callable,
    loglikelihood_fn: Callable,
    mcmc_step_fn: Callable,
    mcmc_init_fn: Callable,
    resampling_fn: Callable,
    pretune_fn: Callable,
    num_mcmc_steps: int = 10,
    update_strategy=update_and_take_last,
    **extra_parameters,
) -> Callable:
    """Wrap the SMC particle update with a pretune phase whose retuned
    parameter distribution is used for this step's real mutation."""
    delegate = smc_from_mcmc(mcmc_step_fn, mcmc_init_fn, resampling_fn, update_strategy)

    def pretuned_step(
        rng_key, state, num_mcmc_steps, mcmc_parameters, logposterior_fn, log_weights_fn
    ):
        pretune_key, _ = prng.split(rng_key)
        pretuned = pretune_fn(
            pretune_key, StateWithParameterOverride(state, mcmc_parameters), logposterior_fn
        )
        state, info = delegate(
            rng_key, state, num_mcmc_steps, pretuned, logposterior_fn, log_weights_fn
        )
        return state, SMCInfoWithParameterDistribution(info, pretuned)

    def kernel(rng_key: PRNGKey, state: StateWithParameterOverride, **extra_step_parameters):
        extra_parameters["update_particles_fn"] = pretuned_step
        step_fn = smc_algorithm(
            logprior_fn=logprior_fn,
            loglikelihood_fn=loglikelihood_fn,
            mcmc_step_fn=mcmc_step_fn,
            mcmc_init_fn=mcmc_init_fn,
            mcmc_parameters=state.parameter_override,
            resampling_fn=resampling_fn,
            num_mcmc_steps=num_mcmc_steps,
            **extra_parameters,
        ).step
        new_state, info = step_fn(rng_key, state.sampler_state, **extra_step_parameters)
        return StateWithParameterOverride(new_state, info.parameter_override), info.smc_info

    return kernel


def init(alg_init_fn, position, initial_parameter_value):
    return StateWithParameterOverride(alg_init_fn(position), initial_parameter_value)


def as_top_level_api(
    smc_algorithm,
    logprior_fn: Callable,
    loglikelihood_fn: Callable,
    mcmc_step_fn: Callable,
    mcmc_init_fn: Callable,
    resampling_fn: Callable,
    num_mcmc_steps: int,
    initial_parameter_value: ArrayLikeTree,
    pretune_fn: Callable,
    **extra_parameters,
) -> SamplingAlgorithm:
    """``blackjax_tpu_torch.pretuning(...)``."""
    kernel = build_kernel(
        smc_algorithm,
        logprior_fn,
        loglikelihood_fn,
        mcmc_step_fn,
        mcmc_init_fn,
        resampling_fn,
        pretune_fn,
        num_mcmc_steps,
        **extra_parameters,
    )

    def init_fn(position, rng_key=None):
        del rng_key
        return init(smc_algorithm.init, position, initial_parameter_value)

    def step_fn(rng_key: PRNGKey, state, **extra_step_parameters):
        return kernel(rng_key, state, **extra_step_parameters)

    return SamplingAlgorithm(init_fn, step_fn)
