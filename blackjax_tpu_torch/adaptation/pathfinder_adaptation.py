"""Pathfinder-seeded warmup (reference
``blackjax_tpu/adaptation/pathfinder_adaptation.py``): stage 1 runs
(multi-path) Pathfinder for an inverse mass matrix and a typical-set start,
stage 2 adapts only the step size by dual averaging.

One chain and one path is the classic scheme. Otherwise multi-path
Pathfinder runs its paths as one batch, the chains start from PSIS
resampling of the pooled draws, the dense inverse mass matrix is the
PSIS-weighted mixture covariance, and every chain dual-averages its own step
size: the controllers are ``(C,)`` tensors on the chains' device
(:func:`blackjax_tpu_torch.optimizers.dual_averaging.tensor_update`), so a
step of the kernel and its controllers makes no host read. The metric of
the frozen inverse mass matrix is built once, before the loop. The per-step
info is stacked as the reference's ``vmap`` of a ``scan`` stacks it:
``(num_steps, ...)`` for one chain, ``(num_chains, num_steps, ...)`` for
many (the adaptation state's inverse mass matrix a per-chain view of the
shared one).
"""
from typing import Callable, NamedTuple, Optional

import torch

from blackjax_tpu_torch import prng
from blackjax_tpu_torch.adaptation.base import AdaptationResults, return_all_adapt_info
from blackjax_tpu_torch.adaptation.step_size import DualAveragingAdaptationState
from blackjax_tpu_torch.base import AdaptationAlgorithm
from blackjax_tpu_torch.mcmc import metrics
from blackjax_tpu_torch.optimizers import dual_averaging
from blackjax_tpu_torch.optimizers.lbfgs import lbfgs_inverse_hessian_formula_1
from blackjax_tpu_torch.types import Array, ArrayLikeTree, PRNGKey
from blackjax_tpu_torch.util import require_tensor_position, tree_leaves, tree_map
from blackjax_tpu_torch.vi import multipathfinder as mpf
from blackjax_tpu_torch.vi import pathfinder

__all__ = ["PathfinderAdaptationState", "base", "pathfinder_adaptation"]


class PathfinderAdaptationState(NamedTuple):
    ss_state: DualAveragingAdaptationState
    step_size: float
    inverse_mass_matrix: Array


def _psis_weighted_mixture_covariance(mpf_state, log_weights: Array) -> Array:
    """Law-of-total-variance covariance of the PSIS-weighted mixture of the
    per-path Laplace approximations: within-path IMMs plus between-path mean
    spread. Reduces exactly to the single path's inverse Hessian when
    ``n_paths = 1``."""
    per_path = mpf_state.logp.shape[1]
    n_paths = log_weights.shape[0] // per_path
    log_w_paths = torch.logsumexp(log_weights.reshape(n_paths, per_path), dim=1)
    w = torch.exp(log_w_paths - torch.logsumexp(log_w_paths, dim=0))

    states = mpf_state.path_states
    mu = states.position
    sigmas = lbfgs_inverse_hessian_formula_1(states.alpha, states.beta, states.gamma)
    mu_mix = torch.einsum("i,id->d", w, mu)
    within = torch.einsum("i,ijk->jk", w, sigmas)
    delta = mu - mu_mix[None, :]
    between = torch.einsum("i,ij,ik->jk", w, delta, delta)
    return within + between


def base(target_acceptance_rate: float = 0.80):
    """Return ``(init, init_from_imm, update, final)``: the inverse mass
    matrix frozen from Pathfinder's inverse Hessian, the step size
    dual-averaged. The step size is a tensor: 0-d for one chain, ``(C,)``
    for a controller a chain."""

    def init(alpha, beta, gamma, initial_step_size) -> PathfinderAdaptationState:
        imm = lbfgs_inverse_hessian_formula_1(alpha, beta, gamma)
        return init_from_imm(imm, torch.as_tensor(initial_step_size, dtype=imm.dtype,
                                                  device=imm.device))

    def init_from_imm(inverse_mass_matrix, initial_step_size) -> PathfinderAdaptationState:
        step_size = torch.as_tensor(initial_step_size)
        return PathfinderAdaptationState(
            DualAveragingAdaptationState(*dual_averaging.tensor_init(step_size)), step_size,
            inverse_mass_matrix)

    def update(adaptation_state: PathfinderAdaptationState, position,
               acceptance_rate) -> PathfinderAdaptationState:
        new_ss = DualAveragingAdaptationState(*dual_averaging.tensor_update(
            adaptation_state.ss_state, target_acceptance_rate - acceptance_rate))
        return PathfinderAdaptationState(new_ss, torch.exp(new_ss.log_step_size),
                                         adaptation_state.inverse_mass_matrix)

    def final(state: PathfinderAdaptationState):
        return torch.exp(state.ss_state.log_step_size_avg), state.inverse_mass_matrix

    return init, init_from_imm, update, final


def _stack(records, axis):
    """The per-step records stacked along ``axis``; a number (the kernel's
    integration-step count) becomes a tensor on the chains' device first,
    broadcast over the chains (``axis = 1``) as the reference's ``vmap``
    broadcasts it."""
    like = next((x for x in tree_leaves(records[0]) if torch.is_tensor(x) and x.dim() > 0), None)

    def stack(*leaves):
        leaves = [torch.as_tensor(x, device=None if like is None else like.device)
                  for x in leaves]
        if axis == 1 and leaves[0].dim() == 0 and like is not None:
            leaves = [x.expand(like.shape[0]) for x in leaves]
        return torch.stack(leaves, dim=min(axis, leaves[0].dim()))

    return tree_map(stack, *records)


def _step_size_loop(mcmc_kernel, logdensity_fn, adapt_update, adaptation_info_fn,
                    extra_parameters, step_keys, state, adaptation_state, axis):
    """Stage 2: a kernel step and a dual-averaging update for every key of
    ``step_keys`` along ``axis`` (``(num_steps, 2)`` keys for one chain,
    ``axis = 0``; ``(C, num_steps, 2)``, a chain's own keys a row, ``axis =
    1``). The frozen inverse mass matrix's metric is built once. Returns the
    last state and adaptation state and the stacked info (None for no
    step)."""
    metric = metrics.default_metric(adaptation_state.inverse_mass_matrix[(0,) * axis])
    records = []
    for i in range(step_keys.shape[axis]):
        state, info = mcmc_kernel(step_keys.select(axis, i), state, logdensity_fn,
                                  adaptation_state.step_size, metric, **extra_parameters)
        adaptation_state = adapt_update(adaptation_state, state.position, info.acceptance_rate)
        records.append(adaptation_info_fn(state, info, adaptation_state))
    return state, adaptation_state, (_stack(records, axis) if records else None)


def pathfinder_adaptation(
    algorithm,
    logdensity_fn: Callable,
    *,
    num_chains: int = 1,
    n_paths: Optional[int] = None,
    num_samples_per_path: int = 200,
    initial_step_size: float = 1.0,
    target_acceptance_rate: float = 0.80,
    adaptation_info_fn: Callable = return_all_adapt_info,
    **extra_parameters,
) -> AdaptationAlgorithm:
    """Warm up HMC-family ``algorithm`` with Pathfinder's inverse Hessian as
    the (dense) inverse mass matrix.

    ``num_chains == 1`` with one path reproduces the classic scheme;
    ``num_chains > 1`` (or ``n_paths >= 2``) runs multi-path Pathfinder,
    draws chain initializations by PSIS importance resampling, estimates a
    shared dense IMM from the PSIS-weighted mixture covariance, and
    dual-averages the step size per chain (returned as ``(num_chains,)``).
    ``run(rng_key, position, num_steps)`` takes key words and a ``(d,)``
    position."""
    if num_chains < 1:
        raise ValueError(f"num_chains must be >= 1, got {num_chains}")
    if n_paths is not None and n_paths < 1:
        raise ValueError(f"n_paths must be >= 1 or None, got {n_paths}")
    effective_n_paths = n_paths if n_paths is not None else num_chains

    mcmc_kernel = algorithm.build_kernel()
    adapt_init, adapt_init_from_imm, adapt_update, adapt_final = base(target_acceptance_rate)

    def loop(step_keys, state, adaptation_state, axis):
        return _step_size_loop(mcmc_kernel, logdensity_fn, adapt_update, adaptation_info_fn,
                               extra_parameters, step_keys, state, adaptation_state, axis)

    def _run_single(rng_key, position, num_steps):
        init_key, sample_key, rng_key = prng.split(rng_key, 3).unbind(-2)
        pf_state, _ = pathfinder.approximate(init_key, logdensity_fn, position)
        init_adapt = adapt_init(pf_state.alpha, pf_state.beta, pf_state.gamma,
                                initial_step_size)
        new_position, _ = pathfinder.sample(sample_key, pf_state)
        init_state = algorithm.init(new_position, logdensity_fn)
        last_state, last_adapt, info = loop(prng.split(rng_key, num_steps), init_state,
                                            init_adapt, 0)
        step_size, imm = adapt_final(last_adapt)
        parameters = {"step_size": step_size, "inverse_mass_matrix": imm, **extra_parameters}
        return AdaptationResults(last_state, parameters), info

    def _run_multi(rng_key, position, num_steps):
        pf_key, resample_key, chains_key = prng.split(rng_key, 3).unbind(-2)
        d = position.shape[-1]
        # pf_key draws both the paths' starting jitter and their keys, as in
        # the reference
        initial_positions = position[None, :] + 2.0 * prng.normal(
            pf_key, (effective_n_paths, d), position.dtype)
        mpf_state, _ = mpf.multi_approximate(pf_key, logdensity_fn, initial_positions,
                                             num_samples_per_path)
        log_w, pareto_k = mpf.psis_weights(mpf_state)
        imm = _psis_weighted_mixture_covariance(mpf_state, log_w)

        # PSIS-resample one start a chain from the pooled draws
        pool = mpf_state.samples.reshape(-1, d)
        idx = prng.choice(resample_key, log_w.shape[0], (num_chains,), p=torch.exp(log_w))
        init_states = algorithm.init(pool[idx], logdensity_fn)
        step_sizes = torch.full((num_chains,), initial_step_size, dtype=imm.dtype,
                                device=imm.device)
        init_adapts = adapt_init_from_imm(imm.expand(num_chains, d, d), step_sizes)
        step_keys = prng.split(prng.split(chains_key, num_chains), num_steps)
        last_states, last_adapts, infos = loop(step_keys, init_states, init_adapts, 1)
        step_sizes, _ = adapt_final(last_adapts)
        parameters = {
            "step_size": step_sizes,
            "inverse_mass_matrix": imm,
            "_pathfinder_psis_pareto_k": pareto_k,
            **extra_parameters,
        }
        return AdaptationResults(last_states, parameters), infos

    def run(rng_key: PRNGKey, position: ArrayLikeTree, num_steps: int = 400):
        require_tensor_position(position, "pathfinder_adaptation")
        if num_chains == 1 and effective_n_paths == 1:
            return _run_single(rng_key, position, num_steps)
        return _run_multi(rng_key, position, num_steps)

    return AdaptationAlgorithm(run)
